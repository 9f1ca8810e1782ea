"""The FLOP and byte counts against numbers worked by hand."""

from bench.bytes import gather_bytes
from bench.flops import step_flops


def _encoder(**kw):
    m = dict(family="encoder", num_layers=1, d_model=4, num_heads=1, num_kv_heads=1,
             head_dim=4, d_ff=8, vocab_size=3, causal=False, frontend="frame",
             frontend_dim=2)
    m.update(kw)
    return m


def test_encoder_flops_by_hand():
    # B=1, S=2, so 2 tokens. Forward: head 2*2*4*3 = 48; q, k, v 2*2*4*12 = 192
    # and output 2*2*4*4 = 64; SwiGLU 3 * 2*2*4*8 = 384; scores and values
    # 2 * 2*1*1*2*2*4 = 64 (no causal mask). 3x forward, plus the frame
    # stub's 2*2*2*4 = 32 twice (its input needs no gradient).
    assert step_flops(_encoder(), 1, 2) == 3 * (48 + 192 + 64 + 384 + 64) + 2 * 32


def test_causal_attention_counts_half():
    full = step_flops(_encoder(), 1, 2)
    assert full - step_flops(_encoder(causal=True), 1, 2) == 3 * 32


def test_hybrid_flops_by_hand():
    m = dict(family="hybrid", num_layers=2, attn_every=2, d_model=4, num_heads=1,
             num_kv_heads=1, head_dim=4, d_ff=8, vocab_size=3, causal=True,
             ssm_state=2, ssm_expand=2, ssm_head_dim=4, ssm_chunk=2, ssm_conv=4)
    # B=1, S=2: 2 tokens; d_inner 8, 2 heads, state 2, chunk 2.
    # Mamba-2 block: in_proj 2*2*4*(16+4+2) = 352, out_proj 2*2*8*4 = 128,
    # conv 2*2*12*4 = 192, C B^T and its weights on x (2*2*2*2 + 2*2*2*8)/2
    # = 40, into and out of the states 2*2*2*2*8 = 128: 840 a block.
    # One shared site: 192 + 64 + 384 + 32 (causal) = 672. Head 48.
    assert step_flops(m, 1, 2) == 3 * (2 * 840 + 672 + 48)


def test_full_cells_in_range():
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[2]
    hubert = json.loads((root / "bench/configs/hubert-xlarge.json").read_text())["model"]
    zamba = json.loads((root / "bench/configs/zamba2-1.2b.json").read_text())["model"]
    # about 6 x 1.26e9 parameters x 16,384 positions, plus attention
    assert 1.4e14 < step_flops(hubert, 8, 2048) < 1.6e14
    assert 1.4e14 < step_flops(zamba, 8, 2048) < 1.55e14


def test_gather_bytes_by_hand():
    # rows of records 5, 5, 7 (two distinct), S = 8: 3 indices, 2 lengths,
    # min(10, 9) + min(3000, 9) tokens read; 3 outputs of 3 x 8 written.
    lengths = [0] * 8
    lengths[5], lengths[7] = 10, 3000
    assert gather_bytes([5, 5, 7], lengths, 8) == 4 * 3 + 4 * 2 + 4 * 18 + 12 * 3 * 8


def test_gather_bytes_short_records():
    lengths = [33, 40]
    assert gather_bytes([0, 1], lengths, 2048) == 4 * 2 + 4 * 2 + 4 * 73 + 12 * 2 * 2048
