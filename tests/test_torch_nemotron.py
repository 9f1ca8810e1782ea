"""The nemotron-h family (nemotron-3-nano-30b-a3b) against its plain
reference, ``bench/reference/nemotron_h.py``, at small sizes on the CPU in
f32: the model's logits, loss and every leaf's gradient; the MoE layer's
expert share (the shares' parts add up to the uncut layer), its correction
bias, its dropless dispatch, and its rows counter, read once a step under
activation checkpointing; the exact parameter counts; and serving (prefill
then decode against a fresh prefill). The JAX package has no such family."""

import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import nemotron_h as ref  # noqa: E402
from bench.reference.common import Precision  # noqa: E402
from repro_torch.configs import RunConfig, get_config, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import flatten_tree, rms_norm  # noqa: E402
from repro_torch.obs import tracer as trace  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.train.losses import lm_loss  # noqa: E402

pytestmark = pytest.mark.torch_port

ARCH = "nemotron-3-nano-30b-a3b"
F32 = Precision("f32")


@pytest.fixture(scope="module")
def cfg():
    return reduced(get_config(ARCH))


def _m(cfg) -> dict:
    """The reference's view of a configuration: its fields by name."""
    return dataclasses.asdict(cfg)


def _batch(cfg, b=2, s=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=g)
    mask = torch.ones((b, s))
    mask[1, s // 2:] = 0  # a padded row
    return {"tokens": tok[:, :-1], "targets": tok[:, 1:], "loss_mask": mask}


def test_reduced_builds_every_kind_with_groups(cfg):
    assert cfg.family == "nemotron_h"
    assert {k for k, _ in cfg.segments()} == {"mamba2", "moe", "attn"}
    assert cfg.ssm_groups > 1 and cfg.moe_num_experts < cfg.moe_routed and not cfg.rope
    assert cfg.d_inner == cfg.ssm_heads * cfg.ssm_head_dim


@pytest.mark.parametrize("seed", [0, 1])
def test_program_follows_the_reference(cfg, seed):
    """Logits, the loss and every leaf's gradient, on the model's own
    seeded weights, two rows (one padded)."""
    model = build_model(cfg, device="cpu").init(seed)
    batch = _batch(cfg, seed=seed)
    leaves = flatten_tree(model.values())
    assert set(leaves) == set(ref.param_specs(_m(cfg)))
    logits, _ = model(batch, remat="dots")
    loss, _ = lm_loss(logits, batch["targets"], batch["loss_mask"])
    grads = torch.autograd.grad(loss, list(leaves.values()))

    params = {k: v.detach().clone().requires_grad_() for k, v in leaves.items()}
    kept = {}
    real = ref.lm_loss_sums

    def keep(lg, tgt, msk):
        kept["logits"] = lg
        return real(lg, tgt, msk)

    ref.lm_loss_sums = keep
    try:
        ce, zl = ref.loss_sums(params, batch["tokens"], batch["targets"], batch["loss_mask"],
                               _m(cfg), F32)
    finally:
        ref.lm_loss_sums = real
    rloss = (ce + 1e-4 * zl) / batch["loss_mask"].sum()
    rgrads = torch.autograd.grad(rloss, list(params.values()))
    torch.testing.assert_close(logits, kept["logits"], rtol=1e-5, atol=1e-5)
    assert abs(loss.item() - rloss.item()) <= 1e-6 * abs(rloss.item())
    for name, g, r in zip(leaves, grads, rgrads):
        scale = r.abs().max().item()
        assert scale > 0, name
        # f32 rounding, largest where a leaf's gradient is a sum over the
        # sequence with cancellation (A_log, dt_bias: about 2e-5 of its scale)
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * scale, msg=name)


def _moe_params(cfg, e, seed):
    g = torch.Generator().manual_seed(seed)
    d, f, sf, r = cfg.d_model, cfg.d_ff, cfg.moe_shared_ff, cfg.moe_routed
    p = {"router": torch.randn(d, r, generator=g) / d**0.5,
         "wi_up": torch.randn(e, d, f, generator=g) / d**0.5,
         "wo": torch.randn(e, f, d, generator=g) / f**0.5,
         "shared": {"wi_up": torch.randn(d, sf, generator=g) / d**0.5,
                    "wo": torch.randn(sf, d, generator=g) / sf**0.5},
         "bias": torch.zeros(r)}
    return p


def _ref_moe(p, x, cfg, first=0):
    """The reference's layer (its own norm, gain zero) on ``p``'s leaves."""
    leaves = {"ln": torch.zeros(cfg.d_model), "router": p["router"], "wi_up": p["wi_up"],
              "wo": p["wo"], "shared_wi_up": p["shared"]["wi_up"],
              "shared_wo": p["shared"]["wo"], "bias": p["bias"]}
    return ref.moe_block(leaves, x, _m(cfg), F32, first=first) - x


def _share_cfg(cfg, held):
    return dataclasses.replace(cfg, moe_num_experts=held)


def test_the_shares_add_up_to_the_uncut_layer(cfg):
    """4 chips' shares of the router's experts, each with the shared
    expert, less the shared expert three times: the uncut layer, both in
    the program and in the reference."""
    r = cfg.moe_routed
    held = r // 4
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(3))
    full = _moe_params(cfg, r, 5)
    hn = rms_norm(x, torch.zeros(cfg.d_model), cfg.norm_eps)
    uncut, _ = moe.moe_share_block(full, hn, _share_cfg(cfg, r))
    sp = full["shared"]
    shared = (torch.relu(hn @ sp["wi_up"]) ** 2) @ sp["wo"]
    parts = []
    for j in range(4):
        cut = slice(j * held, (j + 1) * held)
        p = dict(full, wi_up=full["wi_up"][cut], wo=full["wo"][cut])
        out, _ = moe.moe_share_block(p, hn, _share_cfg(cfg, held), first=j * held)
        torch.testing.assert_close(out, _ref_moe(p, x, _share_cfg(cfg, held), first=j * held),
                                   rtol=1e-5, atol=1e-5)
        parts.append(out - shared)
    torch.testing.assert_close(sum(parts) + shared, uncut, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(uncut, _ref_moe(full, x, _share_cfg(cfg, r)), rtol=1e-5,
                               atol=1e-5)


def test_correction_bias_picks_but_does_not_weigh(cfg):
    x = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(4))
    p = _moe_params(cfg, cfg.moe_num_experts, 6)
    w0, e0 = moe.route_share(p, x, p["bias"], cfg)
    bias = torch.linspace(-2.0, 2.0, cfg.moe_routed)
    w1, e1 = moe.route_share(p, x, bias, cfg)
    assert not torch.equal(e0, e1)
    scores = torch.sigmoid(x @ p["router"])
    chosen = torch.gather(scores, -1, e1)
    torch.testing.assert_close(w1, chosen / chosen.sum(-1, keepdim=True) * cfg.moe_routed_scale)
    assert torch.equal(e1, torch.topk(scores + bias, cfg.moe_top_k, dim=-1).indices)


def test_a_batch_on_one_held_expert_drops_nothing(cfg):
    """The bias sends every token to held expert 1 (its other choices are
    not held): all of them run there, as in the reference, and the rows
    counter says so."""
    c = cfg
    x = torch.randn(2, 24, c.d_model, generator=torch.Generator().manual_seed(7))
    p = _moe_params(c, c.moe_num_experts, 8)
    bias = torch.zeros(c.moe_routed)
    bias[1] = 50.0
    bias[c.moe_num_experts:c.moe_num_experts + c.moe_top_k - 1] = 40.0
    p["bias"] = bias
    p["rows"] = torch.zeros(c.moe_num_experts, dtype=torch.int64)
    hn = rms_norm(x, torch.zeros(c.d_model), c.norm_eps)
    with torch.enable_grad():
        out, _ = moe.moe_share_block(p, hn, c)
    expect = torch.zeros(c.moe_num_experts, dtype=torch.int64)
    expect[1] = 48
    assert torch.equal(p["rows"], expect)
    torch.testing.assert_close(out, _ref_moe(p, x, c), rtol=1e-5, atol=1e-5)


def _step(cfg, seed=0):
    model = build_model(cfg, device="cpu").init(seed)
    run = RunConfig(remat="dots")
    opt = optimizers.make_optimizer(run)
    return model, train_step.fresh_train_state(model, opt), train_step.build_train_step(
        model, run, opt)


def test_rows_counter_reads_once_a_step_under_checkpointing(cfg):
    model, state, step = _step(cfg)
    batch = _batch(cfg, s=32)
    with torch.enable_grad():
        model(batch, remat="none")  # one forward, no recompute
    once = model.expert_rows.clone()
    model.expert_rows.zero_()
    held = cfg.block_layout().count("moe")
    with trace.tracing() as tracer:
        for _ in range(2):
            state, _ = step(state, batch)
    spans = [ev for ev in tracer.events() if ev[0] == "train.step"]
    rows = [torch.tensor(ev[5]["counters"]["moe.expert_rows"]) for ev in spans]
    assert len(rows) == 2 and rows[0].shape == (held, cfg.moe_num_experts)
    assert held == 2
    assert torch.equal(rows[0], once)  # the step's forward, not its recompute too
    assert torch.equal(rows[0] + rows[1], model.expert_rows)
    # every held assignment is counted: a token's held choices
    assert 0 < int(rows[0].sum()) <= held * 2 * 32 * min(cfg.moe_top_k, cfg.moe_num_experts)


def test_device_counters_are_empty_without_moe_layers():
    model = build_model(reduced(get_config("zamba2-1.2b")), device="cpu")
    assert model.device_counters() == {}


def test_param_counts_are_exact(cfg):
    for c in (cfg, dataclasses.replace(cfg, moe_num_experts=cfg.moe_routed),
              dataclasses.replace(cfg, num_layers=3, ssm_gated_norm=False)):
        model = build_model(c, device="meta")
        assert sum(p.numel() for p in model.parameters()) == c.param_count()
        assert set(model.param_axes()) == set(flatten_tree(model.values()))
    full = get_config(ARCH)
    assert full.param_count() == 31_577_937_344  # the published 31.6 B
    # per token: the shared expert and top_k of the routed, none of the others
    expert = 2 * full.d_model * full.d_ff
    assert full.param_count() - full.active_param_count() == 23 * (128 - 6) * expert
    # a chip's share: 32 held, a token reaches 6 * 32 / 128 of them on average
    share = dataclasses.replace(full, num_layers=13, moe_num_experts=32,
                                moe_router_experts=128, vocab_size=32768)
    assert share.param_count() == 2_153_400_192
    assert share.param_count() - share.active_param_count() == 5 * (32 - 1.5) * expert


def test_groups_reach_the_heads_as_views():
    """At one group the grouped scan is the single-group scan, bit for bit:
    (b, s, 1, n) and (b, s, n) inputs give the same outputs."""
    from repro_torch.models.mamba2 import _ssd_chunked

    g = torch.Generator().manual_seed(9)
    b, s, h, p, n = 2, 32, 4, 8, 16
    xh = torch.randn(b, s, h, p, generator=g)
    dt = torch.rand(b, s, h, generator=g) + 0.1
    a = -torch.rand(h, generator=g) - 0.5
    bm, cm = torch.randn(b, s, n, generator=g), torch.randn(b, s, n, generator=g)
    y1, f1 = _ssd_chunked(xh, dt, a, bm, cm, 8)
    y2, f2 = _ssd_chunked(xh, dt, a, bm[:, :, None], cm[:, :, None], 8)
    assert torch.equal(y1, y2) and torch.equal(f1, f2)
    # two groups: each half of the heads against its own group alone
    b2, c2 = torch.randn(b, s, 2, n, generator=g), torch.randn(b, s, 2, n, generator=g)
    y, f = _ssd_chunked(xh, dt, a, b2, c2, 8)
    for i in range(2):
        hs = slice(2 * i, 2 * i + 2)
        yi, fi = _ssd_chunked(xh[:, :, hs], dt[:, :, hs], a[hs], b2[:, :, i], c2[:, :, i], 8)
        torch.testing.assert_close(y[:, :, hs], yi)
        torch.testing.assert_close(f[:, hs], fi)


def test_decode_follows_a_fresh_prefill(cfg):
    """Serving: prefill 12 tokens (the scan once a group in ssd_scan's
    model-layout route), then decode 4 through the cache; each step's
    logits against a fresh prefill of the longer prompt."""
    model = build_model(cfg, device="cpu").init(2)
    tok = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    prefill = train_step.build_prefill_step(model, max_len=32)
    decode = train_step.build_decode_step(model)
    _, caches = prefill({"tokens": tok[:, :12]})
    for i in range(12, 16):
        logits, caches = decode(caches, tok[:, i:i + 1], i)
        with torch.inference_mode():
            full, _ = model({"tokens": tok[:, :i + 1]})
        err = (logits[:, 0] - full[:, -1]).abs().max().item()
        assert err <= 1e-4 * max(1.0, full.abs().max().item()), (i, err)
    assert math.isfinite(err)
