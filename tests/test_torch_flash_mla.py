"""Multi-head latent attention's core, ``flash_attention_mla``: q and k 192
wide, v 128, the softmax at a scale of the caller's. On the CPU the
wrapper runs the plain version (``ref.attention_ref`` with values of
another width), held here to PyTorch's ``scaled_dot_product_attention``
in f32 under autograd; its refusals; the FLOP counts of the
``attn.mla_calls`` tally, the (D, D) kernels' counts at Dqk = Dv; and,
with a card, the (192, 128) training kernels against the plain version.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import (MLA_DIMS, attention_flops, flash_attention,
                                                     flash_attention_mla, kept_pairs, mla_calls)
from repro_torch.kernels.flash_attention.ref import attention_ref

pytestmark = pytest.mark.torch_port

#: Kimi-K2's softmax scale: 192^-0.5 times YaRN's mscale (0.1 ln 32 + 1) squared.
SCALE = 192**-0.5 * (0.1 * math.log(32) + 1) ** 2


def _qkv(b, s, h, dqk, dv, *, device="cpu", seed=0, dtype=torch.float32):
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k = (torch.randn(b, s, h, dqk, generator=gen, device=device).to(dtype)
            for _ in range(2))
    v = torch.randn(b, s, h, dv, generator=gen, device=device).to(dtype)
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,dqk,dv", [(2, 33, 3, 24, 16), (1, 64, 2, 192, 128)])
def test_cpu_path_matches_sdpa_under_autograd(b, s, h, dqk, dv, causal):
    """The wrapper's output and gradients on CPU tensors against
    ``scaled_dot_product_attention`` at the same scale, f32."""
    q, k, v = _qkv(b, s, h, dqk, dv, seed=1)
    got = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention_mla(*got, scale=SCALE, causal=causal)
    assert out.shape == (b, s, h, dv)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    out.backward(g)
    want = [t.transpose(1, 2).clone().requires_grad_() for t in (q, k, v)]
    ref = F.scaled_dot_product_attention(*want, is_causal=causal, scale=SCALE)
    ref.backward(g.transpose(1, 2))
    torch.testing.assert_close(out, ref.transpose(1, 2), rtol=1e-5, atol=1e-5)
    for a, r in zip(got, want):
        torch.testing.assert_close(a.grad, r.grad.transpose(1, 2), rtol=1e-5, atol=1e-5)


def test_plain_version_takes_values_of_another_width_and_a_scale():
    q, k, v = _qkv(1, 20, 2, 24, 8)
    fold = lambda t: t.transpose(1, 2).reshape(2, 20, t.shape[3])  # noqa: E731
    out = attention_ref(fold(q), fold(k), fold(v), causal=True, scale=0.3)
    logits = torch.einsum("bqd,bkd->bqk", fold(q), fold(k)) * 0.3
    mask = torch.ones(20, 20, dtype=torch.bool).tril()
    want = torch.softmax(logits.masked_fill(~mask, -torch.inf), -1) @ fold(v)
    torch.testing.assert_close(out, want)
    # the default scale is still D^-0.5
    torch.testing.assert_close(attention_ref(fold(q), fold(k), fold(v)),
                               attention_ref(fold(q), fold(k), fold(v), scale=24**-0.5))


class _Sub(torch.Tensor):
    """A tensor subclass standing in for a DTensor."""


@pytest.mark.parametrize("bad", ["k_shape", "v_rows", "scale_zero", "scale_inf", "dtype_mix",
                                 "strided", "subclass", "ndim"])
def test_refusals(bad):
    q, k, v = _qkv(1, 16, 2, 24, 8)
    kw = {"scale": SCALE}
    if bad == "k_shape":
        k = k[..., :16].contiguous()
    elif bad == "v_rows":
        v = v[:, :8].contiguous()
    elif bad == "scale_zero":
        kw["scale"] = 0.0
    elif bad == "scale_inf":
        kw["scale"] = math.inf
    elif bad == "dtype_mix":
        v = v.double()
    elif bad == "strided":
        q = q.transpose(1, 2)
    elif bad == "subclass":
        q = q.as_subclass(_Sub)
    elif bad == "ndim":
        q, k, v = q[0], k[0], v[0]
    with pytest.raises((TypeError, ValueError)):
        flash_attention_mla(q, k, v, **kw)


@pytest.mark.parametrize("s,causal", [(1, True), (129, True), (4096, True), (300, False)])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_flops_equal_the_dd_kernels_at_equal_widths(s, causal, d):
    shape = (2, s, 4, d)
    b, _, h, _ = shape
    p = kept_pairs(s, causal, 0)
    assert attention_flops(shape, causal, 0, dv=d) == attention_flops(shape, causal, 0) \
        == 4 * b * h * d * p
    assert attention_flops(shape, causal, 0, dv=d, backward=True) == attention_flops(
        shape, causal, 0, backward=True) == 10 * b * h * d * p


def test_flops_at_the_mla_widths():
    p = kept_pairs(4096, True, 0)
    assert p == 4096 * 4097 // 2
    assert attention_flops((4, 4096, 64, 192), True, 0, dv=128) == 2 * 4 * 64 * p * 320
    assert attention_flops((4, 4096, 64, 192), True, 0, dv=128, backward=True) == \
        2 * 4 * 64 * p * 832


def test_cpu_path_counts_no_launch_and_no_tally():
    before = (flash_attention.launches, dict(mla_calls))
    q, k, v = _qkv(1, 8, 2, 24, 8)
    flash_attention_mla(*(t.requires_grad_() for t in (q, k, v)), scale=SCALE).sum().backward()
    assert (flash_attention.launches, dict(mla_calls)) == before


# ------------------------------------------------------------------- card
#: The training kernels against the plain version in f32 under autograd,
#: as the (D, D) kernels' card tests hold them (``test_torch_flash_attention``):
#: P and dS rounded to bf16 before their products, 2e-2 of the reference's
#: scale; the log-sum-exp in f32, 1e-4.
TRAIN_TOL = 2e-2
LSE_TOL = 1e-4

#: (B, S, H, causal): the tile edges (64-row q tiles and 128-row kv tiles of
#: the backward, 128-row tiles of the forward) and a longer causal case.
CARD_CASES = [(2, s, 3, c) for s in (1, 63, 64, 65, 127, 128, 129, 257)
              for c in (True, False)] + [(1, 1000, 4, True), (2, 640, 2, False)]


def _err(got, want):
    got, want = got.detach().float(), want.detach().float()
    diff = float((got - want).abs().max())
    return diff / max(float(want.abs().max()), 1e-3) if math.isfinite(diff) else math.inf


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


def test_cuda_mla_kernels_match_plain_version():
    """Needs a card: out, dq, dk and dv of the (192, 128) kernels against
    the plain version in f32 under autograd, over the tile edges, causal
    and not; the log-sum-exp (+inf for no row here); one forward and one
    backward launch and tally a call; a second backward bit for bit."""
    _card()
    from repro_torch.kernels.flash_attention.ops import _launch, _launch_bwd

    dqk, dv = MLA_DIMS
    for i, (b, s, h, causal) in enumerate(CARD_CASES):
        q, k, v = _qkv(b, s, h, dqk, dv, device="cuda", seed=i, dtype=torch.bfloat16)
        g = torch.randn(b, s, h, dv, generator=torch.Generator(device="cuda").manual_seed(99),
                        device="cuda").bfloat16()
        before = (flash_attention.launches, mla_calls["forward"], mla_calls["backward"])
        got = [t.clone().requires_grad_() for t in (q, k, v)]
        out = flash_attention_mla(*got, scale=SCALE, causal=causal)
        out.backward(g)
        torch.cuda.synchronize()
        assert (flash_attention.launches, mla_calls["forward"], mla_calls["backward"]) == (
            before[0] + 2, before[1] + 1, before[2] + 1)
        cpu = [t.cpu().float().requires_grad_() for t in (q, k, v)]
        ref = flash_attention_mla(*cpu, scale=SCALE, causal=causal)
        ref.backward(g.float().cpu())
        errs = [_err(out.cpu(), ref)] + [_err(a.grad.cpu(), r.grad) for a, r in zip(got, cpu)]
        assert max(errs) <= TRAIN_TOL, ((b, s, h, causal), errs)
        o2, lse = _launch(q, k, v, causal, 0, 0.0, lse=True, scale=SCALE)
        assert torch.equal(o2, out.detach())
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * SCALE
        if causal:
            logits = logits.masked_fill(~torch.ones(s, s, dtype=torch.bool,
                                                    device="cuda").tril(), -torch.inf)
        assert float((lse - torch.logsumexp(logits, -1)).abs().max()) <= LSE_TOL
        first = _launch_bwd(q, k, v, o2, lse, g, causal, 0, 0.0, SCALE)
        again = _launch_bwd(q, k, v, o2, lse, g, causal, 0, 0.0, SCALE)
        assert all(torch.equal(a, c) for a, c in zip(first, again))


def test_cuda_mla_counters_reset_across_calls_and_graph_replays():
    """Needs a card: a forward and a backward called twice, then captured in
    a CUDA graph and replayed, give the first call's outputs bit for bit
    (the persistent blocks' work counters are back at 0 after a launch)."""
    _card()
    q, k, v = _qkv(2, 700, 4, 192, 128, device="cuda", seed=3, dtype=torch.bfloat16)
    g = torch.randn(2, 700, 4, 128, device="cuda").bfloat16()

    def run():
        t = [x.clone().requires_grad_() for x in (q, k, v)]
        out = flash_attention_mla(*t, scale=SCALE)
        return torch.cat([out.flatten(), *torch.autograd.grad(out, t, g)[0].flatten()[None]])

    first = run()
    runs = [run()]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = run()
    for _ in range(3):
        graph.replay()
        runs.append(out.clone())
    torch.cuda.synchronize()
    assert all(torch.equal(r, first) for r in runs)


@pytest.mark.parametrize("bad", ["f32", "width", "misaligned", "subclass"])
def test_cuda_refusals(bad):
    """Needs a card: a call the (192, 128) kernels cannot take raises."""
    _card()
    dtype = torch.float32 if bad == "f32" else torch.bfloat16
    dqk, dv = (128, 128) if bad == "width" else MLA_DIMS
    q, k, v = _qkv(1, 64, 2, dqk, dv, device="cuda", dtype=dtype)
    if bad == "misaligned":
        q = torch.empty(q.numel() + 1, dtype=q.dtype, device="cuda")[1:].view(q.shape)
    if bad == "subclass":
        q = q.as_subclass(_Sub)
    with pytest.raises((TypeError, ValueError)):
        flash_attention_mla(q, k, v, scale=SCALE)
