"""Kimi-K2 (kimi-k2-instruct: multi-head latent attention, a leading dense
layer, then a share of a sigmoid router's SwiGLU experts) against its
plain reference, ``bench/reference/kimi_k2.py``, at small sizes on the CPU
in f32: the MLA block, the model's logits, loss and every leaf's gradient,
three AdamW steps through the benchmark's own harness, the expert share
(the shares' parts add up to the uncut layer), the rows counter once a
step under checkpointing, YaRN's frequencies and scale at the published
sizes, the exact parameter counts, the parameter tree against the
reference's ``param_specs``, and the refusal of prefill and decode (no
latent cache). The JAX package has no such family."""

import copy
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import kimi_k2 as ref  # noqa: E402
from bench.reference.common import Precision  # noqa: E402
from repro_torch.configs import RunConfig, get_config, reduced  # noqa: E402
from repro_torch.models import attention, build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.common import flatten_tree, rms_norm  # noqa: E402
from repro_torch.obs import tracer as trace  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.train.losses import lm_loss  # noqa: E402

pytestmark = pytest.mark.torch_port

ARCH = "kimi-k2-instruct"
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


def test_reduced_keeps_the_structure(cfg):
    """A dense layer then moe layers; both latents; both halves of a head;
    2 experts held of 8 routed, a shared one; every width cut."""
    assert cfg.family == "mla_moe" and cfg.block_layout() == ["mla_dense", "mla_moe", "mla_moe"]
    assert cfg.q_lora_rank and cfg.kv_lora_rank and cfg.qk_nope_head_dim and cfg.qk_rope_head_dim
    assert cfg.v_head_dim != cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    assert (cfg.moe_num_experts, cfg.moe_routed, cfg.moe_num_shared) == (2, 8, 1)
    assert cfg.moe_act == "swiglu" and cfg.rope_scaling.factor == 32.0
    assert {s: tuple(shape) for s, (shape, _) in ref.param_specs(_m(cfg)).items()} == {
        k: tuple(v.shape) for k, v in flatten_tree(build_model(cfg, device="meta").values())
        .items()}


def test_mla_block_follows_the_reference(cfg):
    """The block alone, output and input gradient, on random leaves."""
    g = torch.Generator().manual_seed(11)
    p = {k: (torch.randn(shape, generator=g) / math.sqrt(shape[0]) if len(shape) == 2
             else 0.1 * torch.randn(shape, generator=g))
         for k, shape in attention.mla_shapes(cfg).items()}
    x = torch.randn(2, 40, cfg.d_model, generator=g, requires_grad=True)
    out = attention.mla_block(p, x, cfg)
    xr = x.detach().clone().requires_grad_()
    want = ref.mla(p, xr, _m(cfg), F32)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    gy = torch.randn(out.shape, generator=g)
    (gx,) = torch.autograd.grad(out, x, gy)
    (gr,) = torch.autograd.grad(want, xr, gy)
    torch.testing.assert_close(gx, gr, rtol=1e-5, atol=1e-5)


def test_mla_trains_without_the_plain_chunked_paths(cfg, monkeypatch):
    """Training attends through ``flash_attention_mla`` (its plain version on
    the CPU): the GQA block's dense and chunked paths are never entered."""
    def refuse(*a, **k):
        raise AssertionError("an MLA layer took a GQA attention path")

    for name in ("_dense_attention", "_chunked_attention", "_chunked_attention_vecq",
                 "attention_block"):
        monkeypatch.setattr(attention, name, refuse)
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "attention_block", refuse)
    model = build_model(cfg, device="cpu").init(0)
    batch = _batch(cfg, s=40)
    logits, _ = model(batch, remat="dots")
    lm_loss(logits, batch["targets"], batch["loss_mask"])[0].backward()


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
        assert scale > 0 or "moe/w" in name, name  # a held expert no token chose
        # f32 rounding of sums over the sequence, about 1e-5 of a leaf's scale
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * max(scale, 1e-12), msg=name)


#: The cell at sizes that run on the CPU in seconds: every width cut, the
#: structure kept (as ``reduced``), the traffic's records short.
TINY_MODEL = dict(num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=24,
                  d_ff=32, moe_dense_ff=96, moe_shared_ff=32, moe_num_experts=2,
                  moe_router_experts=8, moe_top_k=2, vocab_size=96, q_lora_rank=48,
                  kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                  param_dtype="float32", compute_dtype="float32")
TINY_MIX = dict(seq_len=64, mean_len=32, min_len=4, max_len=128)


def test_three_adamw_steps_through_the_harness_follow_the_reference():
    """The benchmark's own run on the CPU at tiny sizes in f32: the
    program's first three steps through the timed path (loader, stager,
    train step, AdamW with its f32 master) against the reference's, and the
    run ``correct`` under the cell's limits."""
    from bench import harness

    cell = copy.deepcopy(harness.load_cell("kimi-k2-instruct.tokens4k"))
    cell.model.update(TINY_MODEL)
    cell.mix.update(TINY_MIX)
    res = harness.run_cell(cell, 2**31 + 91, 0.2, False, device="cpu", log=lambda *a: None)
    gaps = res["gaps"]
    assert gaps["loss_gap"] < 1e-5 and gaps["grad_gap"] < 1e-5 and gaps["change_gap"] < 1e-4
    assert res["correct"], res["checks"]
    assert res["steps"] == res["epochs"] * cell.mix["records"] // cell.mix["batch"]


def _moe_params(cfg, e, seed):
    g = torch.Generator().manual_seed(seed)
    d, f, sf, r = cfg.d_model, cfg.d_ff, cfg.moe_shared_ff, cfg.moe_routed
    return {"router": torch.randn(d, r, generator=g) / d**0.5,
            "wi_gate": torch.randn(e, d, f, generator=g) / d**0.5,
            "wi_up": torch.randn(e, d, f, generator=g) / d**0.5,
            "wo": torch.randn(e, f, d, generator=g) / f**0.5,
            "shared": {"wi_gate": torch.randn(d, sf, generator=g) / d**0.5,
                       "wi_up": torch.randn(d, sf, generator=g) / d**0.5,
                       "wo": torch.randn(sf, d, generator=g) / sf**0.5},
            "bias": torch.zeros(r)}


def test_the_shares_add_up_to_the_uncut_layer(cfg):
    """4 chips' shares of the router's 8 experts, each with the shared
    expert, less the shared expert three times: the uncut layer, both in
    the program and in the reference."""
    r = cfg.moe_routed
    held = r // 4
    hn = rms_norm(torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(3)),
                  torch.zeros(cfg.d_model), cfg.norm_eps)
    full = _moe_params(cfg, r, 5)
    uncut, _ = moe.moe_share_block(full, hn, dataclasses.replace(cfg, moe_num_experts=r))
    shared = ref.swiglu(full["shared"], hn.reshape(-1, cfg.d_model), F32).reshape(hn.shape)
    parts = []
    for j in range(4):
        cut = slice(j * held, (j + 1) * held)
        p = dict(full, **{k: full[k][cut] for k in ("wi_gate", "wi_up", "wo")})
        c = dataclasses.replace(cfg, moe_num_experts=held)
        out, _ = moe.moe_share_block(p, hn, c, first=j * held)
        want = ref.experts(p, hn.reshape(-1, cfg.d_model), _m(c), F32, first=j * held)
        torch.testing.assert_close(out, want.reshape(hn.shape), rtol=1e-5, atol=1e-5)
        parts.append(out - shared)
    torch.testing.assert_close(sum(parts) + shared, uncut, rtol=1e-5, atol=1e-5)
    want = ref.experts(full, hn.reshape(-1, cfg.d_model),
                       _m(dataclasses.replace(cfg, moe_num_experts=r)), F32)
    torch.testing.assert_close(uncut, want.reshape(hn.shape), rtol=1e-5, atol=1e-5)


def test_rows_counter_reads_once_a_step_under_checkpointing(cfg):
    model = build_model(cfg, device="cpu").init(0)
    run = RunConfig(remat="dots")
    opt = optimizers.make_optimizer(run)
    state = train_step.fresh_train_state(model, opt)
    step = train_step.build_train_step(model, run, opt)
    batch = _batch(cfg, s=32)
    with torch.enable_grad():
        model(batch, remat="none")  # one forward, no recompute
    once = model.expert_rows.clone()
    model.expert_rows.zero_()
    with trace.tracing() as tracer:
        for _ in range(2):
            state, _ = step(state, batch)
    spans = [ev for ev in tracer.events() if ev[0] == "train.step"]
    rows = [torch.tensor(ev[5]["counters"]["moe.expert_rows"]) for ev in spans]
    assert len(rows) == 2 and rows[0].shape == (2, cfg.moe_num_experts)
    assert torch.equal(rows[0], once)  # the step's forward, not its recompute too
    assert torch.equal(rows[0] + rows[1], model.expert_rows)
    assert 0 < int(rows[0].sum()) <= 2 * 2 * 32 * min(cfg.moe_top_k, cfg.moe_num_experts)
    # no card: no MLA launch, so the tally does not move
    assert all(ev[5].get("attn.mla_calls", {}).get("forward", 0) == 0 for ev in spans)


def test_yarn_at_the_published_sizes():
    """Kimi-K2's YaRN (factor 32 over 4096, beta 1 and 1, theta 50,000) on
    its 64 rotary columns: the correction range is [19, 20], so the first
    20 frequencies are theta^(-2i/64) and the other 12 those over 32; the
    softmax scale is 192^-0.5 (0.1 ln 32 + 1)^2; sin and cos are not
    scaled (mscale = mscale_all_dim); the reference agrees."""
    full = get_config(ARCH)
    pos = torch.arange(4096)
    sin, cos = attention.yarn_rope(pos, full)
    i = torch.arange(32, dtype=torch.float64)
    freq = 50_000.0 ** (-2 * i / 64)
    freq[20:] /= 32
    want = (pos.float()[:, None] * freq.float()[None, :]).double()  # the f32 angles
    torch.testing.assert_close(sin, torch.sin(want).float(), rtol=0, atol=2e-6)
    torch.testing.assert_close(cos, torch.cos(want).float(), rtol=0, atol=2e-6)
    assert attention.mla_scale(full) == pytest.approx(192**-0.5 * (0.1 * math.log(32) + 1) ** 2)
    rsin, rcos = ref.yarn_tables(4096, _m(full), "cpu")
    torch.testing.assert_close(rsin, sin, rtol=0, atol=1e-6)
    torch.testing.assert_close(rcos, cos, rtol=0, atol=1e-6)
    assert ref.softmax_scale(_m(full)) == pytest.approx(attention.mla_scale(full))


def test_param_counts_are_exact(cfg):
    for c in (cfg, dataclasses.replace(cfg, moe_num_experts=cfg.moe_routed),
              dataclasses.replace(cfg, num_layers=2, moe_num_shared=0)):
        model = build_model(c, device="meta")
        assert sum(p.numel() for p in model.parameters()) == c.param_count()
        assert set(model.param_axes()) == set(flatten_tree(model.values()))
    full = get_config(ARCH)
    assert full.param_count() == 1_026_408_209_408  # the published 1.04 T
    expert = 3 * full.d_model * full.d_ff
    assert full.param_count() - full.active_param_count() == 60 * (384 - 8) * expert
    # a chip's share: stage 0's 5 layers, 8 experts held, a vocabulary slice of 20,480
    share = dataclasses.replace(full, num_layers=5, moe_num_experts=8, moe_router_experts=384,
                                vocab_size=20480)
    assert share.param_count() == 2_792_119_296
    mla = full._mla_params(full.d_model)
    assert round(mla / 1e5) == 1011  # 101.1 M a layer


def test_prefill_and_decode_raise_without_a_latent_cache(cfg):
    model = build_model(cfg, device="cpu").init(0)
    tok = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="latent"):
        model({"tokens": tok}, want_cache=True)
    with pytest.raises(NotImplementedError, match="latent"):
        model.init_cache(1, 16)


def test_cuda_mla_route_in_a_captured_step():
    """Needs a card: a small Kimi-K2 at the published head widths (q / k
    192, v 128; so the (192, 128) kernels take it), bf16, under
    ``remat="dots"`` in a captured ``GraphTrain`` step: ``attn.mla_calls``
    on each replay's ``train.step`` span is two forwards (the checkpoint's
    recompute) and one backward a layer with their FLOPs, and no GQA flash
    launch; at a learning rate of 0 the eager step and two replays give one
    loss and one gradient norm, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels.flash_attention.ops import attention_flops
    from repro_torch.train.train_step import GraphTrain

    full = get_config(ARCH)
    c = dataclasses.replace(full, num_layers=3, d_model=256, num_heads=2, num_kv_heads=2,
                            q_lora_rank=64, kv_lora_rank=64, d_ff=64, moe_dense_ff=256,
                            moe_shared_ff=64, moe_num_experts=4, moe_router_experts=16,
                            vocab_size=512)
    run = RunConfig(remat="dots", learning_rate=0.0, weight_decay=0.0)
    b, s = 2, 256
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, c.vocab_size, (b, s + 1), generator=g)
    feed = {"tokens": tokens[:, :-1].cuda(), "targets": tokens[:, 1:].cuda(),
            "loss_mask": torch.ones(b, s, device="cuda")}
    model = build_model(c, device="cuda").init(0)
    opt = optimizers.make_optimizer(run)
    state = train_step.fresh_train_state(model, opt)
    step = train_step.build_train_step(model, run, opt)
    assert isinstance(step, GraphTrain)
    with trace.tracing() as tracer:
        metrics = [step(state, feed)[1] for _ in range(3)]
        torch.cuda.synchronize()
        spans = [ev for ev in tracer.events() if ev[0] == "train.step"]
    fwd = attention_flops((b, s, 2, 192), True, 0, dv=128)
    bwd = attention_flops((b, s, 2, 192), True, 0, dv=128, backward=True)
    want = {"forward": 6, "backward": 3, "forward_flops": 6 * fwd, "backward_flops": 3 * bwd,
            "flops": 6 * fwd + 3 * bwd}
    assert [ev[5]["attn.mla_calls"] for ev in spans] == [want] * 3
    assert all(ev[5]["attn.flash_calls"]["forward"] == 0 for ev in spans)
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    assert losses[1] == losses[2] == losses[0] and math.isfinite(losses[0])
    assert norms[1] == norms[2] == norms[0]


@pytest.mark.parametrize("given,ok", [
    ({"type": "yarn", "factor": 32, "original_max_position_embeddings": 4096, "beta_fast": 1,
      "beta_slow": 1, "mscale": 1, "mscale_all_dim": 1}, True),
    ({"type": "yarn", "factor": 32, "original_max_position_embeddings": 4096, "beta_fast": 1,
      "beta_slow": 1, "mscale": 0.707, "mscale_all_dim": 1}, False),
    ({"type": "linear", "factor": 4}, False),
])
def test_rope_scaling_from_a_configuration_file(given, ok):
    """HF's ``rope_scaling`` dict, as a benchmark configuration's model block
    gives it, becomes the ``YarnScaling`` the published configuration holds;
    unequal mscales (which would scale the rotary sin and cos) and other
    scalings raise."""
    full = get_config(ARCH)
    if not ok:
        with pytest.raises((ValueError, TypeError)):
            dataclasses.replace(full, rope_scaling=given)
        return
    cfg = dataclasses.replace(full, rope_scaling=given)
    assert cfg.rope_scaling == full.rope_scaling
    assert hash(cfg) == hash(full)
