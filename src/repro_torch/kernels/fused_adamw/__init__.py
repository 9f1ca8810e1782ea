"""The global-norm clip and AdamW with an f32 master as two hand-written
launches over a whole parameter tree (``fused_adamw.cu``, ``ops.py``);
the plain version is ``optim/optimizers.py``'s loop."""
