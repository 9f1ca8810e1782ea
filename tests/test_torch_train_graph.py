"""The port's train step with the step counter on the device, against the
reference's compiled one; its host reads and CPU scalars; the kept losses
of the trainers; and (with a card) the CUDA graph against the eager step.

The reference trains through ``jax.jit(build_train_step(model, run, opt),
donate_argnums=0)``. On a card the port's step is one captured CUDA graph
a step (``train_step.GraphTrain``), which freezes every value it does not
read from a device tensor: the step counter lives on the model's device
and advances in place, and the learning rate and bias corrections are
computed from it there. On the CPU the step runs eagerly, and these tests
hold:

- three steps of reduced tinyllama with AdamW, Adafactor and SGDM, and of
  reduced deepseek-moe-16b and zamba2-1.2b with AdamW (f32, the same
  weights and numpy batches on both sides) against the jitted reference:
  loss and grad_norm at every step, then every parameter and optimizer
  state leaf within 1e-5 scale-normalised (the hybrid's moments within
  its gradients' 5e-5), the step equal; each state
  tensor updated in place, as donation lets the reference update it;
- no host read: two whole train steps of each family and optimizer under
  the dispatch mode of ``tests/test_torch_decode_graph.py``, and no read
  of the RNG state (remat keeps none: a capture may not read it);
- on the meta device no op of a train step mixes a CPU tensor with a meta
  one: the CPU's proxy for a host scalar that a graph would freeze;
- ``build_train_step`` is eager on the CPU and on meta, and its rule picks
  the graph for a CUDA model on one device only;
- the launcher, the example and the smoke's convergence loop keep each
  step's own loss when the step returns one static buffer every step;
- a capture counts only what its own thread queued: a stager's gather
  launched from another thread while a step is captured stays a launch
  and is not added again at every replay.

JAX is imported inside the tests that compare with it, so that the card
test runs where JAX is not installed.
"""

import contextlib
import dataclasses
import importlib.util
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import RunConfig, get_config, reduced
from repro_torch.kernels.chunk_gather.ops import chunk_gather_train
from repro_torch.kernels.common import count_launch
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.launch import train as port_train
from repro_torch.models.common import flatten_tree
from repro_torch.models.transformer import Model, build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.train import train_step as ts
from repro_torch.train.train_step import GraphTrain, build_train_step, fresh_train_state

from test_torch_decode_graph import NoHostRead

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
STEPS = 3

#: name: (arch, optimizer)
JAX_CASES = {
    "tinyllama-adamw": ("tinyllama-1.1b", "adamw"),
    "tinyllama-adafactor": ("tinyllama-1.1b", "adafactor"),
    "tinyllama-sgdm": ("tinyllama-1.1b", "sgdm"),
    "deepseek-moe-adamw": ("deepseek-moe-16b", "adamw"),
    "zamba2-adamw": ("zamba2-1.2b", "adamw"),
}

#: name: (arch, RunConfig changes); every family, every optimizer, and the
#: microbatch path with a grad cast.
FAMILY_CASES = {
    "tinyllama-adamw": ("tinyllama-1.1b", {}),
    "tinyllama-adafactor": ("tinyllama-1.1b", {"optimizer": "adafactor"}),
    "tinyllama-sgdm": ("tinyllama-1.1b", {"optimizer": "sgdm"}),
    "tinyllama-microbatch": ("tinyllama-1.1b", {"microbatch": 2,
                                                "grad_allreduce_dtype": "bfloat16"}),
    "zamba2": ("zamba2-1.2b", {}),
    "deepseek-moe": ("deepseek-moe-16b", {}),
    "xlstm": ("xlstm-350m", {}),
    "llava": ("llava-next-34b", {"optimizer": "adafactor"}),
    "hubert": ("hubert-xlarge", {"optimizer": "sgdm"}),
    "phi3-vecq": ("phi3-medium-14b", {}),
}


def _config(arch):
    cfg = reduced(get_config(arch))
    if arch == "phi3-medium-14b":  # above the dense threshold: the vecq path
        cfg = dataclasses.replace(cfg, attn_dense_threshold=16, attn_chunk=8)
    return cfg


def _feed(cfg, b=4, s=32, seed=0, device="cpu") -> dict:
    """A numpy batch as tensors: the frame arch's frames in place of its
    tokens, the patch arch's patches before them (its targets and mask
    padded over the patches), as the launcher feeds them."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    out = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:], "loss_mask": mask}
    if cfg.frontend == "frame":
        out["frames"] = rng.normal(size=(b, s, cfg.frontend_dim)).astype(np.float32)
        del out["tokens"]
    elif cfg.frontend == "patch":
        p = cfg.frontend_len
        out["patch_embeds"] = rng.normal(size=(b, p, cfg.frontend_dim)).astype(np.float32)
        for k in ("targets", "loss_mask"):
            out[k] = np.concatenate([np.zeros((b, p), out[k].dtype), out[k]], axis=1)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in out.items()}


# ------------------------------------------------------- against the reference
@pytest.mark.parametrize("name", list(JAX_CASES))
def test_device_step_matches_jitted_jax(name):
    """Three steps against ``jax.jit(build_train_step(...))`` from the same
    weights on the same numpy batches: loss and grad_norm at every step,
    then every state leaf (parameters, moments or factored second moments,
    momentum, f32 masters) within TOL and the step equal; the hybrid's
    AdamW moments within ``test_torch_train.GRAD_TOL``, its gradients'
    bound (``A_log``'s first moment reads 3.5e-5 after three steps). The port's state
    keeps its tensors (updated in place) and its step on the model's
    device."""
    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig as JRunConfig
    from repro.configs import get_config as jget_config
    from repro.configs import reduced as jreduced
    from repro.models.transformer import build_model as jbuild
    from repro.optim.optimizers import make_optimizer as jmake_optimizer
    from repro.train.train_step import build_train_step as jbuild_train_step
    from repro_torch.models.convert import load_values
    from test_torch_train import (GRAD_TOL, _batches, _family_values, _flat_jax,
                                  _hybrid_values, _torch_batch, _values, err)

    arch, optimizer = JAX_CASES[name]
    cfg = jreduced(jget_config(arch))
    values = {"tinyllama-1.1b": _values, "zamba2-1.2b": _hybrid_values,
              "deepseek-moe-16b": _family_values}[arch](cfg)
    jrun = JRunConfig(optimizer=optimizer)
    jopt = jmake_optimizer(jrun)
    jvalues = jax.tree.map(jnp.asarray, values)
    jstate = {"values": jvalues, "opt": jopt.init(jvalues), "step": jnp.zeros((), jnp.int32)}
    jstep = jax.jit(jbuild_train_step(jbuild(cfg), jrun, jopt))

    model = build_model(reduced(get_config(arch)), device="cpu")
    load_values(model, values)
    run = RunConfig(optimizer=optimizer)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    step = build_train_step(model, run, opt)
    assert step.captured is False
    assert state["step"].device == model.device and state["step"].dtype == torch.int32
    leaves = flatten_tree(state)
    for i, b in enumerate(_batches(cfg, STEPS)):
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        state, m = step(state, _torch_batch(b))
        for k in ("loss", "grad_norm"):
            assert err(float(m[k]), float(jm[k])) <= TOL, (name, i, k)
    got = flatten_tree(state)
    assert all(got[k] is leaves[k] for k in leaves)  # in place, as donated
    want = _flat_jax(jstate)
    assert want.keys() == got.keys() and any(k.startswith("opt/") for k in got)
    assert int(got["step"]) == int(want["step"]) == STEPS
    for k in want:
        # The hybrid's moments are its gradients' averages, held as those are.
        tol = GRAD_TOL if arch == "zamba2-1.2b" and k.startswith(("opt/m/", "opt/v/")) else TOL
        assert err(got[k].detach().double().numpy(), want[k]) <= tol, (name, k)


# ---------------------------------------------------------- what a graph needs
def _no_rng_state(*args, **kwargs):
    raise AssertionError("the train step read the RNG state")


@pytest.mark.parametrize("name", list(FAMILY_CASES))
def test_train_step_reads_nothing_back_to_the_host(name, monkeypatch):
    """Two whole train steps (forward, remat, backward, clipping, the
    optimizer, the step's increment) under :class:`NoHostRead`, with the
    RNG state unreadable: what a CUDA graph captures."""
    arch, changes = FAMILY_CASES[name]
    cfg = _config(arch)
    model = build_model(cfg, device="cpu").init(0)
    run = RunConfig(remat="dots", **changes)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    step = build_train_step(model, run, opt)
    feed = _feed(cfg)
    monkeypatch.setattr(torch, "get_rng_state", _no_rng_state)
    with NoHostRead():
        for _ in range(2):
            state, metrics = step(state, feed)
    assert int(state["step"]) == 2
    assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics


class NoCpuBesideMeta(TorchDispatchMode):
    """Fails on every op whose inputs and outputs hold both a CPU tensor
    and a meta one: on a card that CPU tensor would be a host value, which
    a captured graph freezes at its capture-time value (or a host-to-device
    copy, which a capture refuses)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        leaves = tree_flatten((args, kwargs, out))[0]
        devices = {t.device.type for t in leaves if isinstance(t, torch.Tensor)}
        if {"cpu", "meta"} <= devices:
            raise AssertionError(f"{func} mixes a CPU tensor with a meta one")
        return out


@pytest.mark.parametrize("name", list(FAMILY_CASES))
def test_meta_train_step_reads_no_cpu_tensor(name):
    """The second train step of each family and optimizer on the meta
    device under :class:`NoCpuBesideMeta`, as ``GraphTrain`` captures its
    second step after an eager one (which makes the model's cached device
    constants, the RoPE frequencies); the step stays on meta."""
    arch, changes = FAMILY_CASES[name]
    cfg = _config(arch)
    model = Model(cfg, device="meta")
    run = RunConfig(remat="dots", **changes)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    step = build_train_step(model, run, opt)
    feed = _feed(cfg, device="meta")
    state, _ = step(state, feed)
    with NoCpuBesideMeta():
        state, metrics = step(state, feed)
    assert state["step"].device.type == "meta"
    assert {v.device.type for v in metrics.values()} == {"meta"}


def test_no_cpu_beside_meta_catches_a_cpu_scalar():
    """The mode itself: a CPU 0-d tensor times a meta tensor fails, and so
    does a copy of a CPU tensor to meta."""
    x = torch.empty(3, device="meta")
    with NoCpuBesideMeta(), pytest.raises(AssertionError, match="CPU tensor"):
        torch.tensor(2.0) * x
    with NoCpuBesideMeta(), pytest.raises(AssertionError, match="CPU tensor"):
        torch.ones(3).to("meta")


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_build_train_step_is_eager_off_the_card(device):
    cfg = reduced(get_config("tinyllama-1.1b"))
    model = Model(cfg, device=device)
    run = RunConfig()
    step = build_train_step(model, run, make_optimizer(run))
    assert not isinstance(step, GraphTrain) and step.captured is False


def test_build_train_step_graphs_one_card_only(monkeypatch):
    """The rule, read off a model that says it is on a card: a graph with no
    sharding context and under a one-device mesh, the eager step under a
    mesh of more devices. Building a ``GraphTrain`` touches no card."""
    cfg = reduced(get_config("tinyllama-1.1b"))
    model = Model(cfg, device="meta")
    model.device = torch.device("cuda", 0)
    run = RunConfig()
    opt = make_optimizer(run)
    graph = build_train_step(model, run, opt)
    assert isinstance(graph, GraphTrain) and graph.captured is False
    for shape, graphed in (({"data": 1, "model": 1}, True), ({"data": 2, "model": 4}, False)):
        ctx = types.SimpleNamespace(mesh=types.SimpleNamespace(shape=shape))
        monkeypatch.setattr(ts, "current_ctx", lambda ctx=ctx: ctx)
        assert isinstance(build_train_step(model, run, opt), GraphTrain) is graphed, shape


# ------------------------------------------------------------- kept losses
class StaticMetricsStep:
    """The eager step behind static metrics buffers: every call overwrites
    the same tensors, as a step returning its graph's outputs would. Each
    step's loss is appended to ``seen`` as it is computed."""

    def __init__(self, model, run_cfg, optimizer, seen: list):
        self.eager = ts._eager_train_step(model, run_cfg, optimizer)
        self.captured = False
        self.metrics = None
        self.seen = seen

    def __call__(self, state, batch):
        state, metrics = self.eager(state, batch)
        if self.metrics is None:
            self.metrics = {k: torch.empty_like(v) for k, v in metrics.items()}
        for k, v in metrics.items():
            self.metrics[k].copy_(v)
        self.seen.append(float(metrics["loss"]))
        return state, self.metrics


def _load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(f"_loaded_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _launcher_losses(tmp_path):
    args = port_train.parse_args(["--arch", "tinyllama-1.1b", "--device", "cpu", "--steps", "4",
                                  "--num-docs", "64", "--seq-len", "32", "--batch", "4",
                                  "--workdir", str(tmp_path)])
    return port_train.train(args)["losses"]


def _example_losses(tmp_path, twin):
    args = twin.parse_args(["--preset", "small", "--device", "cpu", "--steps", "4",
                            "--ckpt-every", "100", "--workdir", str(tmp_path)])
    summary = twin.train(args)
    summary["store"].close()
    return summary["losses"]


def _convergence_losses(smoke):
    cfg = dataclasses.replace(reduced(get_config("tinyllama-1.1b")),
                              vocab_size=smoke.CONV_VOCAB, num_layers=1)
    model = build_model(cfg, device="cpu").init(smoke.CONV_INIT_SEED)
    return smoke.convergence_losses(model, 3e-3, smoke.exact_shuffle_batches(1), 4)


@pytest.mark.parametrize("caller", ["launcher", "example", "convergence"])
def test_trainers_keep_each_steps_loss(caller, tmp_path, monkeypatch):
    """``launch/train.py``, ``examples/train_lm_torch.py`` and the smoke's
    ``convergence_losses`` through a step with static metrics keep each
    step's own loss, the one the step computed, and the losses differ."""
    seen = []
    build = lambda model, run, opt: StaticMetricsStep(model, run, opt, seen)  # noqa: E731
    if caller == "launcher":
        monkeypatch.setattr(port_train, "build_train_step", build)
        got = _launcher_losses(tmp_path)
    elif caller == "example":
        twin = _load("examples/train_lm_torch.py")
        monkeypatch.setattr(twin, "build_train_step", build)
        got = _example_losses(tmp_path, twin)
    else:  # the smoke imports the step where it builds it
        monkeypatch.setattr(ts, "build_train_step", build)
        got = _convergence_losses(_load("chip_smoke.py"))
    assert got == seen and len(set(got)) == len(got) == 4


# ------------------------------------------------------- launch counting
class FakeCapture:
    """``torch.cuda.graph`` and ``CUDAGraph`` without a card: the thread
    that enters the capture is the one whose stream is capturing."""

    def __init__(self):
        self.thread = None

    def capturing(self) -> bool:
        return threading.get_ident() == self.thread

    @contextlib.contextmanager
    def graph(self, graph, **kwargs):
        self.thread = threading.get_ident()
        try:
            yield
        finally:
            self.thread = None

    class CUDAGraph:
        def __init__(self, keep_graph=False):
            pass

        def instantiate(self):
            pass


def test_capture_counts_only_its_own_threads_launches(monkeypatch):
    """A step whose capture queues the flash kernel once while a stager's
    thread launches the gather: the flash launch is the graph's (added at
    each replay, not now), the gather's stays a launch of its own."""
    fake = FakeCapture()
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", fake.capturing)
    monkeypatch.setattr(torch.cuda, "graph", fake.graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeCapture.CUDAGraph)
    for w in (flash_attention, chunk_gather_train):
        monkeypatch.setattr(w, "launches", 5)
        monkeypatch.setattr(w, "captured_launches", 0)

    def step():
        count_launch(flash_attention)
        stager = threading.Thread(target=count_launch, args=(chunk_gather_train,))
        stager.start()
        stager.join()
        return "out"

    graph, out, launches = ts._capture_graph(step)
    assert out == "out" and launches == [(flash_attention, 1)]
    assert flash_attention.launches == 5 and chunk_gather_train.launches == 6
    count_launch(chunk_gather_train)  # after the capture: a launch again
    assert chunk_gather_train.launches == 7 and chunk_gather_train.captured_launches == 0


# ------------------------------------------------------------------ the card
def test_cuda_graph_train_equals_eager_train():
    """Needs a card: reduced tinyllama with AdamW, Adafactor and SGDM (the
    AdamW case with microbatches and a grad cast too) and reduced zamba2,
    f32, 4 steps through the captured graph and 4 through the eager step
    from the same init on the same batches: losses, grad norms, every state
    leaf and the step bit for bit; the graph keeps the state's tensors,
    each call's metrics are its own, and a call with another state or a
    feed of another shape is refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    cases = [("tinyllama-1.1b", {}), ("tinyllama-1.1b", {"optimizer": "adafactor"}),
             ("tinyllama-1.1b", {"optimizer": "sgdm"}),
             ("tinyllama-1.1b", {"microbatch": 2, "grad_allreduce_dtype": "bfloat16"}),
             ("zamba2-1.2b", {})]
    for arch, changes in cases:
        cfg = reduced(get_config(arch))
        run = RunConfig(remat="dots", **changes)
        feeds = [_feed(cfg, seed=i, device="cuda") for i in range(4)]
        runs = []
        for graph in (True, False):
            model = build_model(cfg, device="cuda").init(0)
            opt = make_optimizer(run)
            state = fresh_train_state(model, opt)
            leaves = flatten_tree(state)
            step = (build_train_step(model, run, opt) if graph
                    else ts._eager_train_step(model, run, opt))
            metrics = [step(state, feed)[1] for feed in feeds]
            assert all(flatten_tree(state)[k] is leaves[k] for k in leaves)
            if graph:
                assert isinstance(step, GraphTrain) and step.captured
                assert step.nodes["kernel"] > 0
                other = fresh_train_state(build_model(cfg, device="cuda").init(0), opt)
                with pytest.raises(ValueError, match="other state"):
                    step(other, feeds[0])
                short = {k: v[:2] for k, v in feeds[0].items()}
                with pytest.raises(ValueError, match="captured on a feed"):
                    step(state, short)
            runs.append((metrics, {k: v.clone() for k, v in leaves.items()}))
        (g_metrics, g_state), (e_metrics, e_state) = runs
        where = (arch, changes)
        assert int(g_state["step"]) == 4 and g_state["step"].is_cuda, where
        assert len({float(m["loss"]) for m in g_metrics}) == 4, where
        for gm, em in zip(g_metrics, e_metrics):
            for k in em:
                assert torch.equal(gm[k], em[k]), (where, k)
        for k in e_state:
            assert torch.equal(g_state[k], e_state[k]), (where, k)


def test_cuda_graph_train_leaves_a_concurrent_gather_a_launch():
    """Needs a card: while a reduced tinyllama step is captured, another
    thread launches the gather on its own stream, as the stager does while
    the trainer takes step 1. The gather counts one launch, the graph holds
    none of it, and replays leave the gather's count alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    cfg = reduced(get_config("tinyllama-1.1b"))
    run = RunConfig(remat="dots")
    model = build_model(cfg, device="cuda").init(0)
    opt = make_optimizer(run)
    state = fresh_train_state(model, opt)
    step = build_train_step(model, run, opt)
    feed = _feed(cfg, device="cuda")
    rows = np.arange(4 * 48, dtype=np.int32).reshape(4, 48)
    lens = np.full(4, 40, dtype=np.int32)
    idx = np.array([3, 0, 2, 1], dtype=np.int32)
    gathered = []

    def stage():
        """The stager's work: pinned host buffers, their copies and the
        gather, all on a side stream."""
        with torch.cuda.stream(torch.cuda.Stream()):
            dev = []
            for a in (rows, lens, idx):
                host = torch.empty(a.shape, dtype=torch.int32, pin_memory=True)
                host.numpy()[:] = a
                dev.append(host.to("cuda", non_blocking=True))
            gathered.append(chunk_gather_train(*dev, seq_len=32))

    eager_step = step.step

    def step_and_stage(state, batch):
        if torch.cuda.is_current_stream_capturing():
            stager = threading.Thread(target=stage)
            stager.start()
            stager.join()
        return eager_step(state, batch)

    step.step = step_and_stage
    before = chunk_gather_train.launches
    for _ in range(3):
        step(state, feed)
    torch.cuda.synchronize()
    assert len(gathered) == 1 and chunk_gather_train.launches == before + 1
    assert all(w is not chunk_gather_train for w, _ in step._launches)
    want = chunk_gather_train(*(torch.from_numpy(a) for a in (rows, lens, idx)), seq_len=32)
    for got, ref in zip(gathered[0], want):
        assert torch.equal(got.cpu(), ref)
