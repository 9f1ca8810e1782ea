"""Redox on PyTorch and CUDA: the training path of ``repro`` on an NVIDIA H100.

Same layout as the JAX package, one port module per reference module. The
data plane (``core``, ``data``, ``obs``, ``configs``, ``launch/cli.py``) is
a numpy-only copy; ``core/device.py``, ``kernels``, ``models``, ``optim``,
``train``, ``checkpoint`` and ``launch/train.py`` are written in PyTorch,
and ``chunk_gather_train`` is a hand-written CUDA kernel for ``sm_90a``.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
