"""The fused clip + AdamW kernels (``kernels/fused_adamw``) and their route.

On the CPU: which trees go to the kernels (CUDA leaves, none a DTensor,
under AdamW with its f32 master) and which take the loop of
``optim/optimizers.py`` (CPU and DTensor leaves, AdamW without a master,
Adafactor, SGDM); the route's call into the kernels with the loop's
learning rate and bias corrections; the wrapper's refusal of leaves off
the card; and the bytes the ``optim.update_bytes`` tally counts, against a
hand count.

On the card (they skip without one): given the kernel's own clip scale,
the kernel's m, v, master and parameters equal the loop's bit for bit,
over leaves of 1, 7, 4,097 and 2^24 + 3 elements, one at an odd element
offset (the scalar path), ranks 1-3, bf16 and f32 gradients, the clip
active and not; the kernel's norm lies within 1e-6 of the loop's and
repeats bit for bit; a strided card leaf raises rather than take the loop;
and three steps of a reduced model through ``GraphTrain`` equal three eager
steps of the loop, with two launches a replay.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import RunConfig, get_config, reduced
from repro_torch.kernels.fused_adamw import ops as fused
from repro_torch.models.common import flatten_tree
from repro_torch.models.transformer import build_model
from repro_torch.obs import tracer as trace
from repro_torch.optim import optimizers
from repro_torch.train import train_step as ts

pytestmark = pytest.mark.torch_port

B1, B2, EPS = 0.9, 0.95, 1e-8


def _tree(shapes: dict, grad_dtypes: dict, param_dtypes: dict, device="cpu", seed=0):
    """Gradients and parameters of ``shapes``, drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    grads, params = {}, {}
    for k, shape in shapes.items():
        grads[k] = torch.randn(shape, generator=gen).to(grad_dtypes[k]).to(device)
        params[k] = torch.randn(shape, generator=gen).to(param_dtypes[k]).to(device)
    return grads, params


def _state(opt, params: dict, seed: int = 1) -> dict:
    """The optimizer's state over ``params`` with non-zero moments (AdamW's
    and SGDM's; Adafactor's factored ones stay at zero)."""
    st = opt.init(params)
    gen = torch.Generator().manual_seed(seed)
    for k in params:
        for name in ("m", "v", "mom"):
            if isinstance(st.get(name, {}).get(k), torch.Tensor):
                x = torch.randn(params[k].shape, generator=gen) * 1e-2
                st[name][k].copy_(x.abs() if name == "v" else x)
    return st


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _equal(a: dict, b: dict) -> bool:
    fa, fb = flatten_tree(a), flatten_tree(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k]) for k in fa)


# ------------------------------------------------------------------- the route
def test_card_leaf_is_a_cuda_tensor_and_not_a_dtensor():
    """The route follows the device type and DTensor alone: a tensor or a
    ``Parameter`` on the card goes to the kernels; the CPU, the meta device
    and a DTensor (the sharded path) take the loop."""
    from torch.distributed.tensor import DTensor

    assert fused.card_leaf(torch.Tensor, "cuda")
    assert fused.card_leaf(torch.nn.Parameter, "cuda")
    assert not fused.card_leaf(torch.Tensor, "cpu")
    assert not fused.card_leaf(torch.Tensor, "meta")
    assert not fused.card_leaf(DTensor, "cuda")
    assert not fused.takes({})
    assert not fused.takes({"w": torch.zeros(3)})
    assert not fused.takes({"w": torch.zeros(3, device="meta")})


def test_the_kernels_refuse_leaves_off_the_card():
    """The wrapper raises on what it does not take: it never falls back to
    the loop."""
    opt = optimizers.make_optimizer(RunConfig())
    dtypes = dict.fromkeys(SHAPES, torch.float32)
    grads, params = _tree(SHAPES, dtypes, dtypes)
    state = opt.init(params)
    with pytest.raises(ValueError, match="plain CUDA tensors"):
        fused.clip_adamw_(grads, state["m"], state["v"], state["master"], params,
                          lr=torch.tensor(1e-3), c1=torch.tensor(0.1), c2=torch.tensor(0.05),
                          b1=B1, b2=B2, eps=EPS, weight_decay=0.1, max_norm=1.0)


@pytest.fixture
def recorder(monkeypatch):
    """``fused.takes`` made to say yes, as on the card, and
    ``fused.clip_adamw_`` replaced by a recorder of its calls."""
    calls = []

    def record(*args, **kw):
        calls.append((args, kw))
        return torch.tensor(7.0)

    monkeypatch.setattr(fused, "takes", lambda *trees: True)
    monkeypatch.setattr(fused, "clip_adamw_", record)
    return calls


SHAPES = {"blocks/w": (3, 4, 5), "blocks/ln": (3, 5), "final_norm": (5,), "head": (5, 7)}


@pytest.mark.parametrize("case", ["cpu", "no_master", "adafactor", "sgdm"])
def test_update_takes_the_loop(case, request):
    """CPU leaves, AdamW without its master, Adafactor and SGDM take the
    loop, clip then update, bit for bit, and launch nothing; all but the
    CPU case with the route's predicate made to say yes."""
    calls = [] if case == "cpu" else request.getfixturevalue("recorder")
    changes = {"no_master": {"master_fp32": False}, "adafactor": {"optimizer": "adafactor"},
               "sgdm": {"optimizer": "sgdm"}}.get(case, {})
    run = RunConfig(**changes)
    opt = optimizers.make_optimizer(run)
    dtypes = dict.fromkeys(SHAPES, torch.float32)
    grads, params = _tree(SHAPES, dtypes, dtypes)
    state = _state(opt, params)
    want_params, want_state = _clone(params), _clone(state)
    clipped, want_norm = optimizers.clip_by_global_norm(grads, 0.5)
    # the default max norm clips nothing, and the norm comes back all the same
    assert torch.equal(opt.update(clipped, want_state, want_params,
                                  torch.tensor(3, dtype=torch.int32)),
                       optimizers.global_norm(clipped))
    launches = fused.clip_adamw_.launches if case == "cpu" else 0
    norm = opt.update(grads, state, params, torch.tensor(3, dtype=torch.int32), 0.5)
    assert not calls
    assert torch.equal(norm, want_norm)
    assert _equal(params, want_params) and _equal(state, want_state)
    if case == "cpu":
        assert fused.clip_adamw_.launches == launches


def test_update_sends_card_trees_to_the_kernels(recorder):
    """AdamW with its master on a tree the kernels take calls them once,
    with the loop's learning rate and bias corrections for the step, its
    hyperparameters and the clip's max norm, and returns their norm; it
    runs no loop (the parameters stay as they were)."""
    run = RunConfig(learning_rate=3e-4, weight_decay=0.1)
    opt = optimizers.make_optimizer(run)
    dtypes = dict.fromkeys(SHAPES, torch.float32)
    grads, params = _tree(SHAPES, dtypes, dtypes)
    state = _state(opt, params)
    before = _clone(params)
    step = torch.tensor(250, dtype=torch.int32)
    norm = opt.update(grads, state, params, step, 1.0)
    assert float(norm) == 7.0 and len(recorder) == 1
    (g, m, v, master, p), kw = recorder[0]
    assert g is grads and p is params
    assert m is state["m"] and v is state["v"] and master is state["master"]
    t = step.float() + 1
    assert torch.equal(kw["lr"], optimizers._lr(step, run))
    assert torch.equal(kw["c1"], 1 - B1**t) and torch.equal(kw["c2"], 1 - B2**t)
    assert (kw["b1"], kw["b2"], kw["eps"]) == (B1, B2, EPS)
    assert kw["weight_decay"] == 0.1 and kw["max_norm"] == 1.0
    assert _equal(params, before)


# ------------------------------------------------------------------ the tally
def test_step_bytes_are_a_hand_count():
    """The compulsory bytes of a mixed tree: the norm reads the gradient
    once, the update reads g, m, v and the master and writes m, v, the
    master and the parameter. bf16 gradient and parameter 2+2+12+12+2 = 30
    bytes an element; f32 gradient and bf16 parameter 4+4+12+12+2 = 34; f32
    both 36; bf16 gradient and f32 parameter 32."""
    bf16, f32 = torch.bfloat16, torch.float32
    shapes = {"a": (3, 4, 5), "b": (7,), "c": (1,), "d": (2, 3), "e": (4097,), "f": (9, 1, 11)}
    g_dt = {"a": bf16, "b": f32, "c": bf16, "d": f32, "e": bf16, "f": bf16}
    p_dt = {"a": bf16, "b": f32, "c": bf16, "d": bf16, "e": bf16, "f": f32}
    grads, params = _tree(shapes, g_dt, p_dt)
    want = 60 * 30 + 7 * 36 + 1 * 30 + 6 * 34 + 4097 * 30 + 99 * 32
    assert fused.step_bytes(grads, params) == want
    assert fused.update_bytes is trace.host_tally("optim.update_bytes")
    assert set(trace.tallies()["optim.update_bytes"]) == {"launches", "bytes"}


# -------------------------------------------------------------------- the card
def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


#: Leaf sizes 1, 7, 4,097 and 2^24 + 3, ranks 1-3; "odd" starts one
#: element into its buffer, off 16 bytes, so it takes the scalar path.
CARD_SHAPES = {"one": (1,), "seven": (7,), "odd": (4097,), "mat": (17, 241),
               "stack": (3, 5, 7), "big": (1, 2**24 + 3)}


def _card_tree(grad_dtype, device, seed=0):
    p_dt = dict.fromkeys(CARD_SHAPES, torch.bfloat16)
    p_dt["stack"] = torch.float32
    grads, params = _tree(CARD_SHAPES, dict.fromkeys(CARD_SHAPES, grad_dtype), p_dt, device,
                          seed)
    for tree in (grads, params):  # the odd leaf at one element past 16 bytes
        t = tree["odd"]
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=device)
        buf[1:].copy_(t)
        tree["odd"] = buf[1:]
    return grads, params


@pytest.mark.parametrize("grad_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("clip", ["active", "inactive"])
def test_cuda_update_equals_the_loop_bit_for_bit(grad_dtype, clip, monkeypatch):
    """Needs a card: one fused clip and update leaves m, v, the master and
    the parameters equal bit for bit to the loop's update on the gradients
    clipped by the kernel's own scale (computed from its norm as the loop
    computes it from its own)."""
    device = _cuda()
    run = RunConfig(learning_rate=3e-4, weight_decay=0.1)
    opt = optimizers.make_optimizer(run)
    grads, params = _card_tree(getattr(torch, grad_dtype), device)
    state = _state(opt, {k: p.cpu() for k, p in params.items()})
    state = {name: {k: t.to(device) for k, t in tree.items()} for name, tree in state.items()}
    step = torch.tensor(5, dtype=torch.int32, device=device)
    max_norm = 0.25 * float(optimizers.global_norm(grads)) if clip == "active" else 1e9
    want_params, want_state = _clone(params), _clone(state)
    before = _clone(state["master"])
    t = step.float() + 1
    launches = fused.clip_adamw_.launches
    norm = fused.clip_adamw_(grads, state["m"], state["v"], state["master"], params,
                             lr=optimizers._lr(step, run), c1=1 - B1**t, c2=1 - B2**t, b1=B1,
                             b2=B2, eps=EPS, weight_decay=0.1, max_norm=max_norm)
    torch.cuda.synchronize()
    assert fused.clip_adamw_.launches == launches + 2
    scale = optimizers.clip_scale(norm, max_norm)
    assert (float(scale) < 1.0) == (clip == "active")
    clipped = {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}
    monkeypatch.setattr(fused, "takes", lambda *trees: False)  # the loop, on the card
    opt.update(clipped, want_state, want_params, step)
    assert fused.clip_adamw_.launches == launches + 2
    for k in CARD_SHAPES:
        for name in ("m", "v", "master"):
            assert torch.equal(state[name][k], want_state[name][k]), (k, name)
        assert torch.equal(params[k], want_params[k]), k
        assert not torch.equal(state["master"][k], before[k]), k


@pytest.mark.parametrize("grad_dtype", ["bfloat16", "float32"])
def test_cuda_norm_is_the_loops_and_repeats(grad_dtype):
    """Needs a card: the kernel's global norm lies within 1e-6 (relative)
    of the loop's and is the same bits in every run on the same gradients."""
    device = _cuda()
    run = RunConfig()
    opt = optimizers.make_optimizer(run)
    norms = []
    for _ in range(3):
        grads, params = _card_tree(getattr(torch, grad_dtype), device)
        state = opt.init(params)
        norms.append(opt.update(grads, state, params,
                                torch.zeros((), dtype=torch.int32, device=device), 1.0))
    want = optimizers.global_norm(grads)
    assert all(torch.equal(n, norms[0]) for n in norms)
    assert abs(float(norms[0]) / float(want) - 1) <= 1e-6


def test_cuda_route_raises_on_a_strided_leaf():
    """Needs a card: a strided card leaf raises, naming the leaf, rather
    than take the loop, and nothing is launched."""
    device = _cuda()
    opt = optimizers.make_optimizer(RunConfig())
    dtypes = dict.fromkeys(SHAPES, torch.bfloat16)
    grads, params = _tree(SHAPES, dtypes, dtypes, device)
    state = opt.init(params)
    grads["head"] = grads["head"].t().contiguous().t()  # (5, 7) with strides (1, 5)
    launches = fused.clip_adamw_.launches
    with pytest.raises(ValueError, match="head grad: the kernels take contiguous"):
        opt.update(grads, state, params, torch.zeros((), dtype=torch.int32, device=device), 1.0)
    assert fused.clip_adamw_.launches == launches


def _feed(cfg, b, s, seed, device):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    out = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:], "loss_mask": mask}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in out.items()}


@pytest.mark.parametrize("changes", [{}, {"microbatch": 2, "grad_allreduce_dtype": "float32"}],
                         ids=["bf16-grads", "f32-grads"])
def test_cuda_graph_train_equals_the_eager_loop(changes, monkeypatch):
    """Needs a card: three steps of reduced tinyllama in bf16 through
    ``GraphTrain`` (the kernels, two launches a replay) against three eager
    steps of the loop from the same weights on the same batches: every
    state leaf and loss bit for bit, the norm within 1e-6. The clip does
    not bind (max norm 1e9), so both sides scale by exactly 1."""
    device = _cuda()
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")), param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    run = RunConfig(remat="dots", grad_clip=1e9, **changes)
    feeds = [_feed(cfg, 4, 64, i, device) for i in range(3)]
    runs = []
    for graph in (True, False):
        if not graph:
            monkeypatch.setattr(fused, "takes", lambda *trees: False)
        model = build_model(cfg, device=device).init(0)
        opt = optimizers.make_optimizer(run)
        state = ts.fresh_train_state(model, opt)
        step = ts.build_train_step(model, run, opt) if graph else ts._eager_train_step(
            model, run, opt)
        launches = fused.clip_adamw_.launches
        metrics = [step(state, feed)[1] for feed in feeds]
        torch.cuda.synchronize()
        if graph:
            assert isinstance(step, ts.GraphTrain) and step.captured
            assert step.tallies["optim.update_bytes"]["launches"] == 2
            assert fused.clip_adamw_.launches == launches + 2 * 3
        else:
            assert fused.clip_adamw_.launches == launches
        runs.append((metrics, {k: v.clone() for k, v in flatten_tree(state).items()}))
    (g_metrics, g_state), (e_metrics, e_state) = runs
    assert _equal(g_state, e_state)
    for gm, em in zip(g_metrics, e_metrics):
        assert torch.equal(gm["loss"], em["loss"])
        assert abs(float(gm["grad_norm"]) / float(em["grad_norm"]) - 1) <= 1e-6
