"""One cell of the benchmark: the program set up, trained for a window, and
judged against the plain reference.

What the window drives is the launcher's own path (``launch/train.py``):
a chunk store of the mix's records (``vfs`` backend), ``RedoxLoader``
from the launcher's ``SessionSpec`` recipe, a ``DeviceStager`` with the
CUDA gather, ``epoch_device``, the launcher's ``_feed`` and the train step
of ``build_train_step`` (one CUDA graph replay a step on one card).

Set-up makes the records and the weights from the seed, writes the store,
and trains three steps, which the reference follows, from a twin of the
loader (the same spec over the same store and stager) that is then
abandoned: Redox drains its memories only at an epoch's end, so the
window's own loader starts at epoch 0 untouched. The window then trains
whole epochs until ``seconds`` have passed: every epoch trains each record
once, so the window's tokens are the same for every seed (the mix's
lengths are). At most ``IN_FLIGHT_STEPS`` steps are queued on the device;
the host reads no loss inside the window. After it, the program is freed
and its outputs are judged: every staged batch against the records, each
epoch's records once each, and the first three steps against the
reference.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import statistics
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from bench import bytes as gather_count
from bench import flops as flop_count
from bench import weights
from bench.reference.common import Precision, adamw_step, clip_by_global_norm
from bench.traffic.generator import TokenDataset, loss_tokens

__all__ = ["Cell", "Program", "load_cell", "model_gaps", "reference_readings", "run_cell"]

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "bench"
#: Leaves whose reference gradient is below this share of the median
#: leaf's are nought to rounding (a leaf the loss never reads) and are
#: left out of the gradient and change comparisons.
NOUGHT_SHARE = 1e-3
#: Steps queued on the device at most: keeps the host's clock check within
#: two steps of the device, so the window closes near ``seconds``.
IN_FLIGHT_STEPS = 2
#: ``Batch.epoch`` of the set-up's steps, which come from the twin loader.
SETUP_EPOCH = -1


# ------------------------------------------------------------------ the cell
@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""

    name: str
    config: dict        # bench/configs/<config>.json
    mix: dict           # bench/traffic/<traffic>.json
    limits: dict        # bench/limits/<workload>.json
    chips: int = 1
    per_layer: tuple = ()

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def train(self) -> dict:
        return self.config["train"]

    def reference(self):
        return importlib.import_module(f"bench.reference.{self.config['reference']}")


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_cell(workload: str, manifest: "dict | None" = None, root: Path = ROOT) -> Cell:
    manifest = manifest or load_manifest(root)
    wl = {w["name"]: w for w in manifest["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = {c["name"]: c for c in manifest["configs"]}[wl["config"]]
    per_layer = tuple(m for m in manifest["per_layer"]
                      if "workloads" not in m or workload in m["workloads"])
    return Cell(
        name=workload,
        config=json.loads((root / conf["file"]).read_text()),
        mix=json.loads((root / "bench" / "traffic" / f"{wl['traffic']}.json").read_text()),
        limits=json.loads((root / "bench" / "limits" / f"{workload}.json").read_text()),
        chips=wl["chips"],
        per_layer=per_layer,
    )


# --------------------------------------------------------------- the program
def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_config(cell: Cell):
    """The program's configuration of ``program_arch`` with every size the
    configuration's file states put in, so that the file is what runs."""
    from repro_torch.configs import get_config

    base = get_config(cell.config["program_arch"])
    unknown = set(cell.model) - {f.name for f in dataclasses.fields(base)}
    if unknown:
        raise ValueError(f"{cell.config['name']}.json names keys the program's "
                         f"configuration lacks: {sorted(unknown)}")
    return dataclasses.replace(base, **cell.model)


def _check_run_config(cell: Cell, run) -> None:
    bad = {k: (cell.train[k], getattr(run, k))
           for k in ("optimizer", "remat", "learning_rate", "weight_decay", "grad_clip",
                     "master_fp32")
           if getattr(run, k) != cell.train[k]}
    if bad:
        raise ValueError(f"the program's run configuration differs from "
                         f"{cell.config['name']}.json: {bad} (file, program)")


class Program:
    """The system under test, set up for one cell and seed on ``device``:
    its store in ``workdir``, its model holding the seed's weights, its
    train state, step, loader and stager."""

    def __init__(self, cell: Cell, seed: int, device, workdir: Path, log=lambda *a: None):
        t0 = time.perf_counter()
        from repro_torch.configs import RunConfig
        from repro_torch.core import ChunkStore, RedoxLoader, SessionSpec
        from repro_torch.core.chunking import ChunkingPlan
        from repro_torch.core.device import DeviceStager
        from repro_torch.launch import train as launcher
        from repro_torch.models import build_model
        from repro_torch.models.common import flatten_tree
        from repro_torch.optim import optimizers
        from repro_torch.train import train_step

        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self._launcher = launcher
        mix, m = cell.mix, cell.model
        self.cfg = program_config(cell)
        run = RunConfig(optimizer=cell.train["optimizer"], remat=cell.train["remat"])
        _check_run_config(cell, run)
        log(f"set-up: the program's modules imported in {time.perf_counter() - t0:.3f} s")

        t0 = time.perf_counter()
        self.data = TokenDataset(mix, m["vocab_size"], seed)
        plan = ChunkingPlan.create(
            self.data.sizes_bytes, mix["chunk_size"],
            memory_bytes=int(self.data.sizes_bytes.sum() * mix["memory_share"]), seed=seed + 1)
        self.store = ChunkStore.build(Path(workdir) / "chunks", plan, self.data, backend="vfs")
        log(f"set-up: records and store in {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()

        self.model = build_model(self.cfg, device=self.device)
        self.specs = cell.reference().param_specs(m)
        leaves = flatten_tree(self.model.values())
        shapes = {k: tuple(v.shape) for k, v in leaves.items()}
        if shapes != {k: tuple(s) for k, (s, _) in self.specs.items()}:
            raise ValueError("the program's parameter tree is not the reference's: "
                             f"{sorted(set(shapes) ^ set(self.specs))}")
        self.names = sorted(self.specs)
        with torch.no_grad():
            for i, k in enumerate(self.names):
                leaves[k].copy_(weights.draw(self.specs[k], seed, i, self.device,
                                             leaves[k].dtype))
        self.optimizer = optimizers.make_optimizer(run)
        self.state = train_step.fresh_train_state(self.model, self.optimizer)
        self.step_fn = train_step.build_train_step(self.model, run, self.optimizer)
        _sync(self.device)
        log(f"set-up: model, weights and state in {time.perf_counter() - t0:.3f} s")

        self.spec = SessionSpec(
            policy=mix["policy"], seed=seed + 2, sampler_seed=seed + 3,
            num_nodes=mix["nodes"], batch_per_node=mix["batch"] // mix["nodes"],
            seq_len=mix["seq_len"], engine=mix["engine"],
            remote_memory_limit_bytes=mix["remote_memory_bytes"])
        self.loader = RedoxLoader.from_spec(self.spec, self.store)
        self.stager = DeviceStager(device=self.device, use_kernel=True, depth=mix["stage_depth"])
        self.steps = 0

    def epoch(self, e: int):
        """Epoch ``e``'s staged batches (device tensors)."""
        return self.loader.epoch_device(e, self.stager)

    def twin_epoch(self):
        """Epoch 0's staged batches from a new loader of the same spec over
        the same store and stager, for set-up to abandon part way."""
        from repro_torch.core import RedoxLoader

        return RedoxLoader.from_spec(self.spec, self.store).epoch_device(0, self.stager)

    def step(self, batch: dict):
        """One train step on a staged batch; returns its loss (a device
        tensor, not read)."""
        feed = self._launcher._feed(batch, self.device, self.cfg)
        self.state, metrics = self.step_fn(self.state, feed)
        self.steps += 1
        return metrics["loss"]

    @torch.no_grad()
    def leaf_norms(self, tree: dict, minus_init: bool = False) -> dict:
        """Per-leaf L2 norms of an f32 state tree (optionally of its
        difference from the seed's initial weights), read to the host."""
        norms = []
        for i, k in enumerate(self.names):
            t = tree[k]
            if minus_init:
                t = t - weights.draw(self.specs[k], self.seed, i, self.device, torch.float32)
            norms.append(torch.linalg.vector_norm(t.float()))
        return dict(zip(self.names, torch.stack(norms).tolist()))

    def close(self) -> None:
        self.stager.close()
        self.store.close()


# ------------------------------------------------------------ set-up and window
@dataclasses.dataclass
class Batch:
    """A staged batch as the window used it (device tensors until moved)."""

    epoch: int
    rows: np.ndarray          # the record id behind each row
    tokens: torch.Tensor
    targets: torch.Tensor
    mask: torch.Tensor

    def to_host(self) -> None:
        self.tokens, self.targets, self.mask = (
            t.cpu().numpy() for t in (self.tokens, self.targets, self.mask))


def _kept(batch: dict, e: int) -> Batch:
    return Batch(e, np.asarray(batch["returned"], dtype=np.int64),
                 batch["tokens"], batch["targets"], batch["loss_mask"])


def first_steps(prog: Program, log=lambda *a: None) -> dict:
    """Set-up: the first three steps (step 1 eager, the capture, replays),
    on the twin loader's first three batches, which it then abandons.
    Returns the program's readings: the three losses, each leaf's first
    gradient as the optimizer got it (AdamW's first moment after one step
    over ``1 - b1``) and its change after three steps (the f32 master
    against the seed's weights), and the three batches."""
    b1 = prog.cell.train["b1"]
    losses, kept, out = [], [], {}
    batches = prog.twin_epoch()
    t0 = time.perf_counter()
    for batch in batches:
        kept.append(_kept(batch, SETUP_EPOCH))
        losses.append(prog.step(batch))
        if prog.steps == 1:
            out["grad_norms"] = {k: v / (1 - b1)
                                 for k, v in prog.leaf_norms(prog.state["opt"]["m"]).items()}
        elif prog.steps == 3:
            out["change_norms"] = prog.leaf_norms(prog.state["opt"]["master"], minus_init=True)
            break
        log(f"set-up: step {prog.steps} done at {time.perf_counter() - t0:.3f} s")
    batches.close()
    if prog.steps < 3:
        raise ValueError(f"epoch 0 has {prog.steps} steps; the reference follows 3")
    _sync(prog.device)
    log(f"set-up: step 3 done at {time.perf_counter() - t0:.3f} s")
    out["losses"] = [float(x) for x in losses]
    out["batches"] = kept
    return out


def _marks(on: bool):
    """``marks(name)``: a profiler range around a host phase of the window
    in a traced run on the card, else nothing."""
    from torch.profiler import record_function

    return record_function if on else (lambda name: contextlib.nullcontext())


def window(prog: Program, seconds: float, *, marks) -> dict:
    """Whole epochs from epoch 0 until ``seconds`` have passed; closes at the
    synchronised end of the last step."""
    cuda = prog.device.type == "cuda"
    pending: collections.deque = collections.deque()
    kept, losses = [], []
    read0 = prog.store.backend_stats.bytes_read
    _sync(prog.device)
    t0 = time.perf_counter()
    e = 0
    while True:
        batches = prog.epoch(e)
        while True:
            with marks("bench.batch_wait"):
                batch = next(batches, None)
            if batch is None:
                break
            kept.append(_kept(batch, e))
            with marks("bench.step"):
                losses.append(prog.step(batch))
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                with marks("bench.in_flight_wait"):
                    while len(pending) > IN_FLIGHT_STEPS:
                        pending.popleft().synchronize()
        e += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(prog.device)
    return {"t0": t0, "seconds": time.perf_counter() - t0, "batches": kept, "losses": losses,
            "epochs": e, "bytes_read": prog.store.backend_stats.bytes_read - read0}


# --------------------------------------------------------------- the reference
def _blocks(n_rows: int, seq: int) -> list:
    per = max(1, 8192 // seq)
    return [slice(i, min(i + per, n_rows)) for i in range(0, n_rows, per)]


def reference_readings(cell: Cell, seed: int, batches: list, device, mode: str = "f32",
                       *, rows: "slice | None" = None) -> dict:
    """The reference's first three steps from the seed's weights on the
    program's first three batches (host arrays), in ``mode`` ("f32", or
    "fp8" for the control). ``rows`` keeps only those rows of each batch
    (a planted fault: half the batch left out). Runs in blocks of rows,
    each layer recomputed in the backward pass, so that it fits beside
    nothing else."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(device)
    ref, m, hp = cell.reference(), cell.model, cell.train
    prec = Precision(mode)
    specs = ref.param_specs(m)
    names = sorted(specs)

    def initial(i, k):
        return weights.draw(specs[k], seed, i, device, torch.float32)

    # The configuration's parameters are bf16 values of an f32 master copy
    # that AdamW updates: each step reads the master rounded to the
    # parameter type, and its gradient updates the master.
    stored = getattr(torch, m["param_dtype"])
    master = {k: initial(i, k) for i, k in enumerate(names)}
    mom = {k: torch.zeros_like(p) for k, p in master.items()}
    vel = {k: torch.zeros_like(p) for k, p in master.items()}
    losses, out = [], {}
    for step, b in enumerate(batches[:3]):
        params = {k: p.to(stored).to(torch.float32, copy=True).requires_grad_()
                  for k, p in master.items()}
        tok, tgt, msk = (torch.from_numpy(np.asarray(a)).to(device)
                         for a in (b.tokens, b.targets, b.mask))
        if rows is not None:
            tok, tgt, msk = tok[rows], tgt[rows], msk[rows]
        denom = torch.clamp(msk.sum(), min=1.0)
        total = 0.0
        for blk in _blocks(tok.shape[0], tok.shape[1]):
            ce, zl = ref.loss_sums(params, tok[blk], tgt[blk], msk[blk], m, prec)
            loss = (ce + hp["z_weight"] * zl) / denom
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        # a leaf the loss never reads (a frame model's token embedding) has
        # a zero gradient
        grads = clip_by_global_norm(
            {k: torch.zeros_like(p) if p.grad is None else p.grad.detach()
             for k, p in params.items()}, hp["grad_clip"])
        del params
        if step == 0:
            norms = torch.stack([torch.linalg.vector_norm(grads[k]) for k in names]).tolist()
            out["grad_norms"] = dict(zip(names, norms))
        adamw_step(master, grads, mom, vel, step, hp)
        del grads
    with torch.no_grad():
        norms = [torch.linalg.vector_norm(master[k] - initial(i, k))
                 for i, k in enumerate(names)]
        out["change_norms"] = dict(zip(names, torch.stack(norms).tolist()))
    out["losses"] = losses
    del master, mom, vel
    return out


def model_gaps(prog: dict, ref: dict) -> dict:
    """The three numbers compared for a training cell:

    - ``loss_gap``: the widest relative gap of the first three losses;
    - ``grad_gap`` and ``change_gap``: over the leaves whose reference
      gradient is not nought to rounding, the widest gap between the
      program's and the reference's norm of a leaf's first gradient (its
      change after three steps), against the reference's norm of that
      leaf or of the median leaf, whichever is larger.
    """
    gmed = statistics.median(ref["grad_norms"].values())
    leaves = [k for k, g in ref["grad_norms"].items() if g >= NOUGHT_SHARE * gmed]
    cmed = statistics.median(ref["change_norms"][k] for k in leaves)

    def gap(key, med):
        worst, at = 0.0, None
        for k in leaves:
            r, p = ref[key][k], prog[key][k]
            g = abs(p - r) / max(r, med) if math.isfinite(p) else math.inf
            if not g <= worst:
                worst, at = g, k
        return worst, at

    loss_gap = max((abs(p - r) / abs(r) if math.isfinite(p) else math.inf)
                   for p, r in zip(prog["losses"], ref["losses"]))
    grad_gap, grad_at = gap("grad_norms", gmed)
    change_gap, change_at = gap("change_norms", cmed)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_worst_leaf": grad_at, "change_worst_leaf": change_at,
            "leaves_compared": len(leaves),
            "leaves_left_out": sorted(set(ref["grad_norms"]) - set(leaves))}


# -------------------------------------------------------------- data checks
def data_faults(batches: list, data: TokenDataset, mix: dict) -> dict:
    """Every staged batch against the records the loader says it returned
    (tokens, next-token targets and loss mask, exactly), every epoch's
    records once each, and no record twice in set-up's part of an epoch.
    Host arrays."""
    s, b = mix["seq_len"], mix["batch"]
    rows_wrong, batches_wrong = 0, 0
    seen = collections.defaultdict(list)
    for bt in batches:
        seen[bt.epoch].extend(bt.rows.tolist())
        wrong = 0 if len(bt.rows) == b else b
        for i, r in enumerate(bt.rows[:b]):
            rec = data.record(int(r))
            n = min(len(rec), s + 1)
            grid = np.zeros(s + 1, dtype=np.int32)
            grid[:n] = rec[:n]
            mask = (np.arange(1, s + 1) < n).astype(np.float32)
            ok = (np.array_equal(bt.tokens[i], grid[:s])
                  and np.array_equal(bt.targets[i], grid[1:])
                  and np.array_equal(bt.mask[i], mask))
            wrong += not ok
        rows_wrong += wrong
        batches_wrong += bool(wrong)
    everyone = list(range(len(data)))
    epochs_wrong = sum((len(set(ids)) != len(ids)) if e == SETUP_EPOCH else (sorted(ids) != everyone)
                       for e, ids in seen.items())
    return {"rows_wrong": rows_wrong, "batches_wrong": batches_wrong,
            "epochs_wrong": epochs_wrong, "epochs": len(seen)}


# ------------------------------------------------------------------- a run
def _gather_counters():
    from repro_torch.kernels.chunk_gather.ops import chunk_gather_train

    return chunk_gather_train.launches, chunk_gather_train.captured_launches


def _profile_window(prog, seconds, marks):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        win = window(prog, seconds, marks=marks)
    from bench import trace_reduce

    return win, trace_reduce.reduce(prof)


def _metric_reader(name: str):
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, *, device="cuda",
             log=print) -> dict:
    """One run of ``cell``: set-up, window, checks. Returns the readings the
    result line is made of (``run.py`` prints it)."""
    from repro_torch.obs import tracer as spans

    device = torch.device(device)
    cuda = device.type == "cuda"
    with tempfile.TemporaryDirectory(prefix="bench-store-") as work:
        prog = Program(cell, seed, device, Path(work), log=log)
        launches0, staged0 = _gather_counters(), prog.stager.stats.kernel_steps
        first = first_steps(prog, log=log)
        setup_steps = prog.steps
        # the window's own counts start here: set-up's twin loader may have
        # staged batches ahead that it never trained
        launches1, staged1 = _gather_counters(), prog.stager.stats.kernel_steps
        marks = _marks(trace and cuda)
        tracer = spans.enable(1 << 20) if trace else None
        if trace and cuda:
            win, prof = _profile_window(prog, seconds, marks)
        else:
            win, prof = window(prog, seconds, marks=marks), None
        events = spans.disable().events() if tracer is not None else []
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        setup_launches = [a - b for a, b in zip(launches1, launches0)]
        launches = [a - b for a, b in zip(_gather_counters(), launches1)]
        setup_staged = staged1 - staged0
        staged = prog.stager.stats.kernel_steps - staged1
        graphed = bool(getattr(prog.step_fn, "captured", False))
        window_losses = torch.stack(win["losses"]).tolist() if win["losses"] else []
        data = prog.data
        prog.close()
        del prog
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

    batches = first["batches"] + win["batches"]
    for b in batches:
        b.to_host()
    steps = setup_steps + len(win["batches"])
    checks = {}
    faults = data_faults(batches, data, cell.mix)
    checks["data_rows_wrong"] = faults["rows_wrong"]
    checks["epochs_not_once_each"] = faults["epochs_wrong"]
    checks["losses_not_finite"] = sum(not math.isfinite(x)
                                      for x in first["losses"] + window_losses)
    if cuda:
        # one gather launch a staged batch, none inside the graph, and one
        # graph replay a step after step 1; the window trains every batch
        # it stages
        checks["gather_launches_off"] = (abs(setup_launches[0] - setup_staged)
                                         + abs(launches[0] - staged)
                                         + abs(staged - len(win["batches"])))
        checks["gather_launches_in_graph"] = setup_launches[1] + launches[1]
        checks["steps_not_graphed"] = 0 if graphed else steps - 1
    log(f"steps: {setup_steps} in set-up ({setup_staged} batches staged, "
        f"{setup_launches[0]} gather launches), {len(win['batches'])} in the window "
        f"({win['epochs']} epochs); gather launches {launches[0]} for {staged} staged "
        f"batches in the window ({setup_launches[1] + launches[1]} captured); "
        f"graph replays {steps - 1 if graphed else 0}")
    if cuda:
        log(f"device memory still allocated with the program freed: "
            f"{torch.cuda.memory_allocated(device) / 2**30:.3f} GiB")
    t_ref = time.perf_counter()
    ref = reference_readings(cell, seed, first["batches"], device)
    log(f"reference: {time.perf_counter() - t_ref:.1f} s")
    gaps = model_gaps(first, ref)
    log(f"model: losses program {first['losses']} reference {ref['losses']}; "
        f"{gaps['leaves_compared']} leaves compared, left out {gaps['leaves_left_out']}; "
        f"worst grad leaf {gaps['grad_worst_leaf']}, change {gaps['change_worst_leaf']}")
    for k in ("loss_gap", "grad_gap", "change_gap"):
        if k in cell.limits:
            checks[k] = gaps[k]
    limits = {k: cell.limits.get(k, 0) for k in checks}
    correct = all(v <= limits[k] for k, v in checks.items())

    rows = [b.rows for b in win["batches"]]
    tokens = int(sum(loss_tokens(data.lengths[r], cell.mix["seq_len"]).sum() for r in rows))
    positions = len(rows) * cell.mix["batch"] * cell.mix["seq_len"]
    out = {
        "correct": correct,
        "attempted": steps,
        "failed": faults["batches_wrong"] + checks["losses_not_finite"],
        "checks": {k: {"value": v, "limit": limits[k]} for k, v in checks.items()},
        "peak_bytes": peak,
        "window_s": win["seconds"],
        "window_open": win["t0"],
        "steps": len(rows),
        "loss_tokens": tokens,
        "positions": positions,
        "epochs": win["epochs"],
        "gaps": gaps,
    }
    out["end_to_end"] = {
        "train_tokens_per_s": (tokens / win["seconds"], "tokens/s"),
        "peak_mem_gib": (peak / 2**30, "GiB"),
    }
    log(f"window: {win['seconds']:.3f} s, {len(rows)} steps, {tokens} loss tokens of "
        f"{positions} positions ({positions / win['seconds']:.1f} positions/s)")
    if trace:
        ctx = _Context(cell, win, events, prof, data, tokens, len(rows))
        per_layer = {}
        for m in cell.per_layer:
            value = _metric_reader(m["name"])(ctx)
            if value is not None:
                per_layer[m["name"]] = (value, m["unit"])
        out["per_layer"] = per_layer
        out["profile"] = prof
    return out


@dataclasses.dataclass
class _Context:
    """What a per-layer metric's reader may read of a traced run."""

    cell: Cell
    win: dict
    spans: list           # the program's tracer events: (name, cat, ts, dur, tid, args)
    profile: "dict | None"  # bench.trace_reduce.reduce's summary of the device trace
    data: TokenDataset
    loss_tokens: int
    steps: int

    @property
    def window_s(self) -> float:
        return self.win["seconds"]

    def step_flops(self) -> int:
        return flop_count.step_flops(self.cell.model, self.cell.mix["batch"],
                                     self.cell.mix["seq_len"])

    def gather_bytes(self) -> list:
        return [gather_count.gather_bytes(b.rows, self.data.lengths, self.cell.mix["seq_len"])
                for b in self.win["batches"]]
