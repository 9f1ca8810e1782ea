"""The train step (``repro/train/train_step.py``).

    loss(values) -> grads -> [cast to grad_allreduce_dtype] -> clip -> optimizer

``build_train_step`` returns ``train_step(state, batch) -> (state,
metrics)``. The state is ``{"values", "opt", "step"}`` with the
reference's structure (``values`` the model's parameter tree, so a
checkpoint's keys are the reference's). The step updates parameters and
optimizer state in place and returns the same state dict; ``metrics``
holds device tensors (``loss``, ``grad_norm``, ``ce``, ``z_loss``,
``aux``) that are not synchronised. Microbatching splits the batch along
its first axis and accumulates gradients in the parameter dtype, or in
``grad_allreduce_dtype`` when one is set, as the reference's scan does.

``build_prefill_step`` / ``build_decode_step`` are the serving programs:
prefill runs the prompt through the model (attention in the flash kernel,
the Mamba-2 scan in the ssd_scan kernel) and sizes its K/V into the decode
cache; decode runs one token (attention in the decode kernel) and updates
that cache, K/V and recurrent states alike, in place, where the reference
donates it. Both run under ``torch.inference_mode()``.

The reference jits all three steps (``jax.jit``; the train step with the
state donated, ``donate_argnums=0``; decode with the cache donated,
``donate_argnums=1``, and the position traced). On the card the port
compiles the train step and decode the same way, each into one CUDA graph
that captured one step and is replayed a step (:class:`GraphTrain`,
:class:`GraphDecode`): the state or the caches are the graph's own static
tensors, updated in place, and the step counter or the position a device
tensor. Run op by op from Python on an H100, a train step at the 100m
preset's widths (f32, B = 24 x 96, about 3,070 device operations) left
the card idle 0.47-0.70 of its time (0.04 as a graph), and decode, a few
hundred small kernels a token, most of it; tinyllama-1.1b's train step at
B = 8 x 2048 (idle under 0.01 either way) hides its launches. Prefill
stays eager: a serve run prefills once per shape, so a graph would be
captured and replayed once.
"""

from __future__ import annotations

import math

import torch

from ..configs.base import RunConfig
from ..kernels.common import graph_nodes, kernel_wrappers
from ..models.attention import position, quantize_kv
from ..models.common import flatten_tree
from ..models.transformer import ATTN_KINDS, Model
from ..obs import tracer as trace
from ..optim.optimizers import Optimizer, clip_by_global_norm
from ..parallel.axes import current_ctx
from .losses import lm_loss

__all__ = ["GraphDecode", "GraphTrain", "build_decode_step", "build_prefill_step",
           "build_train_step", "fresh_train_state", "init_train_state"]


def init_train_state(model: Model, optimizer: Optimizer, seed: int = 0) -> dict:
    """Initialise ``model``'s parameters from ``seed`` and the optimizer
    state over them."""
    model.init(seed)
    return fresh_train_state(model, optimizer)


def fresh_train_state(model: Model, optimizer: Optimizer) -> dict:
    """Train state over ``model``'s current parameters (e.g. loaded weights).

    ``step`` is a 0-d int32 tensor on the model's device, so that the
    learning rate and the bias corrections are computed there and a
    captured step reads and advances it at every replay."""
    values = model.values()
    return {
        "values": values,
        "opt": optimizer.init(flatten_tree(values)),
        "step": torch.zeros((), dtype=torch.int32, device=model.device),
    }


def _one_card(model: Model) -> bool:
    """Whether ``model``'s steps are captured in CUDA graphs: a CUDA model
    with no sharding context installed, or with one over a one-device mesh."""
    ctx = current_ctx()
    return model.device.type == "cuda" and (
        ctx is None or math.prod(ctx.mesh.shape.values()) == 1)


def build_train_step(model: Model, run_cfg: RunConfig, optimizer: Optimizer):
    """``train_step(state, batch) -> (state, metrics)``, the state updated
    in place.

    On a CUDA model this is a :class:`GraphTrain`, unless a sharding
    context is installed whose mesh spans more than one device (the
    DTensor ops and collectives then run eagerly); on the CPU (the tests)
    and the meta device (the dry run) it is :func:`_eager_train_step`'s
    function. The choice is made here, once, as :func:`build_decode_step`
    makes it. ``step.captured`` is False for the eager step, and for the
    graph step says whether its first call has captured.

    With a tracer installed each call is a ``train.step`` device span
    (category ``compute``; args ``step``, the step's own call count, and
    ``replay``), whose device interval is the step's work on the current
    stream, and which reads the model's ``device_counters()`` around the
    step (``args["counters"]``); a graph's capture records none. It also
    carries each of the tracer's host tallies (``trace.host_tally``, e.g.
    ``attn.flash_calls``) under its name: the eager step's own counts, and
    a replay's those its capture queued, since it runs the same nodes.
    """
    step = _eager_train_step(model, run_cfg, optimizer)
    return GraphTrain(model, step) if _one_card(model) else step


def _eager_train_step(model: Model, run_cfg: RunConfig, optimizer: Optimizer):
    """The train step run op by op from Python (what :class:`GraphTrain`
    runs once and captures)."""
    cfg = model.cfg

    def loss_fn(batch):
        logits, aux = model(batch, remat=run_cfg.remat)
        return lm_loss(
            logits,
            batch["targets"],
            batch["loss_mask"],
            aux=aux,
            aux_weight=cfg.router_aux_weight if cfg.moe_num_experts else 0.0,
        )

    def grad_fn(params: dict, batch):
        loss, metrics = loss_fn(batch)
        # A leaf the loss never reads (a frame arch's token embedding) gets
        # a zero gradient, as jax.grad gives it.
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                    materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return loss.detach(), metrics, dict(zip(params, grads))

    def compute_grads(params: dict, batch):
        k = run_cfg.microbatch
        if not (k and k > 1):
            return grad_fn(params, batch)
        micro = [
            {key: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i] for key, x in batch.items()}
            for i in range(k)
        ]
        # Accumulate in the param dtype (bf16 for big models) unless a
        # grad dtype is forced, as the reference does.
        acc_dt = (getattr(torch, run_cfg.grad_allreduce_dtype)
                  if run_cfg.grad_allreduce_dtype else None)
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        grads = {p: torch.zeros_like(v, dtype=acc_dt or v.dtype) for p, v in params.items()}
        for mb in micro:
            l, metrics, g = grad_fn(params, mb)
            loss = loss + l
            for p, gp in g.items():
                grads[p] = grads[p] + gp.to(grads[p].dtype)
        return loss / k, metrics, {p: g / k for p, g in grads.items()}

    def one_step(state: dict, batch: dict):
        params = flatten_tree(state["values"])
        loss, metrics, grads = compute_grads(params, batch)
        if run_cfg.grad_allreduce_dtype:
            dt = getattr(torch, run_cfg.grad_allreduce_dtype)
            grads = {p: g.to(dt) for p, g in grads.items()}
        grads, gnorm = clip_by_global_norm(grads, run_cfg.grad_clip)
        optimizer.update(grads, state["opt"], params, state["step"])
        state["step"].add_(1)
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    def train_step(state: dict, batch: dict):
        train_step.calls += 1
        tracer = trace.get()
        if tracer is None:
            return one_step(state, batch)
        before = trace.tallies()
        with tracer.device_span("train.step", "compute", model.device,
                                counters=model.device_counters(), step=train_step.calls,
                                replay=False) as span:
            out = one_step(state, batch)
            span.note(**trace.tallies_since(before))
            return out

    train_step.calls = 0
    train_step.captured = False
    return train_step


def _warm_up(fn, device: torch.device):
    """``fn()`` eagerly on a side stream, which waits for the current one
    and which the current one then waits for: the eager pass that loads the
    libraries and sizes the buffers a capture may not allocate. The caller
    marks what it keeps of the outputs as used on the current stream."""
    here = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(here)
    with torch.cuda.stream(side):
        out = fn()
    here.wait_stream(side)
    return out, here


def _capture_graph(fn) -> tuple:
    """``fn()`` captured into an instantiated CUDA graph (capture runs
    nothing): ``(graph, fn's outputs, launches)``, ``launches`` the
    ``(wrapper, n)`` of each kernel wrapper that the capture queued ``n``
    times, counted in ``captured_launches`` (a replay adds them to
    ``launches``). A stager's thread may stage batches meanwhile: its
    launches are on its own stream, so they stay launches and out of the
    graph, and the capture restricts only this thread's CUDA calls."""
    wrappers = list(kernel_wrappers().values())
    before = [w.captured_launches for w in wrappers]
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    # torch.cuda.graph synchronises and empties the allocator's cache
    # first, so the warm-up's freed blocks do not stay reserved beside the
    # graph's pool.
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
    graph.instantiate()
    launches = [(w, w.captured_launches - n) for w, n in zip(wrappers, before)
                if w.captured_launches != n]
    return graph, out, launches


def _state_ptrs(state: dict) -> list[int]:
    return [t.data_ptr() for t in flatten_tree(state).values()]


def _feed_spec(batch: dict) -> dict:
    return {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}


class GraphTrain:
    """The train step as one CUDA graph a step, as the reference's
    ``jax.jit(build_train_step(...), donate_argnums=0)``.

    The first call is step 1: it copies the feed into static input
    buffers, one per feed key, sized from that feed, and runs the eager
    step on them on a side stream (the warm-up that the autograd engine
    and cuBLAS need before a capture). It then captures one whole step
    into a ``torch.cuda.CUDAGraph`` (capture runs nothing): the forward and
    backward of every microbatch, the optional grad cast, the clipping,
    the optimizer's in-place update and the step's increment, all reading
    the static inputs and the state's own tensors. Each later call checks
    that the feed's keys, shapes and dtypes are the captured ones and that
    ``state`` holds the captured tensors, copies the feed into the static
    inputs and replays; it raises ``ValueError`` on a mismatch and never
    captures again or falls back to the eager step.

    It returns the same ``state`` dict, updated in place, and metrics
    (``loss``, ``grad_norm``, ``ce``, ``z_loss``, ``aux``) that are fresh
    device copies of the graph's, made after the replay without a
    synchronisation, so that a caller may keep them. As in
    :class:`GraphDecode`, each kernel wrapper's ``launches`` gains at every
    replay what capture added, and ``nodes`` counts the graph's device
    operations by kind.

    With a tracer installed, a replay (the static-input copies and the
    graph) is a ``train.step`` device span with ``replay=True`` and
    ``step`` this object's call count and the host tallies' counts its
    capture queued; the first call's eager step is the eager function's
    own span, and its capture records nothing.
    """

    def __init__(self, model: Model, step):
        self.model = model
        self.step = step
        self.graph = None
        self.nodes: dict = {}
        self.calls = 0

    @property
    def captured(self) -> bool:
        """Whether the graph has been captured (at the first call)."""
        return self.graph is not None

    def __call__(self, state: dict, batch: dict):
        self.calls += 1
        if self.graph is None:
            return self._capture(state, batch)
        if _feed_spec(batch) != self._spec:
            raise ValueError(f"this train step was captured on a feed of {self._spec}, "
                             f"got {_feed_spec(batch)}")
        if _state_ptrs(state) != self._ptrs:
            raise ValueError("this train step was captured on other state tensors; build "
                             "a new step with build_train_step for this state")
        tracer = trace.get()
        if tracer is None:
            return state, self._replay(batch)
        with tracer.device_span("train.step", "compute", self.model.device,
                                counters=self.model.device_counters(), step=self.calls,
                                replay=True, **self.tallies):
            return state, self._replay(batch)

    def _replay(self, batch: dict) -> dict:
        """The static-input copies, the replay and the metrics' copies."""
        for k, buf in self.inputs.items():
            buf.copy_(batch[k])
        self.graph.replay()
        for wrapper, n in self._launches:
            wrapper.launches += n
        return {k: v.clone() for k, v in self.metrics.items()}

    def _capture(self, state: dict, batch: dict):
        device = self.model.device
        self._spec = _feed_spec(batch)
        self.inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                       for k, v in batch.items()}
        for k, buf in self.inputs.items():
            buf.copy_(batch[k])
        (state, metrics), here = _warm_up(lambda: self.step(state, self.inputs), device)
        for v in metrics.values():
            v.record_stream(here)
        before = trace.tallies()
        graph, (_, self.metrics), self._launches = _capture_graph(
            lambda: self.step(state, self.inputs))
        self.tallies = trace.tallies_since(before)
        self.nodes = graph_nodes(graph)
        self._ptrs = _state_ptrs(state)
        self.graph = graph
        return state, metrics


# ------------------------------------------------------------------ serving
def _size_cache(t, s_c: int) -> torch.Tensor:
    """(n, B, S, KVH, D) prompt K or V -> (n, B, S_c, KVH, D) decode slots:
    positions 0..S-1 in slots 0..S-1 when they fit, else the last S_c
    positions in the rotating-window layout ``slot = position % S_c``."""
    s = t.shape[2]
    out = t.new_zeros(t.shape[:2] + (s_c,) + t.shape[3:])
    if s_c >= s:
        out[:, :, :s] = t
    else:
        pos = torch.arange(s - s_c, s, device=t.device)
        out[:, :, torch.remainder(pos, s_c)] = t[:, :, pos]
    return out


def build_prefill_step(model: Model, max_len: int):
    """Full-prompt pass that builds the decode cache (sized to ``max_len``).

    ``prefill(inputs) -> (logits[:, -1:], caches)``; ``inputs`` holds
    ``tokens`` and, for a ``patch`` frontend, ``patch_embeds``, whose
    positions come first. As in the reference, a prefill longer than
    ``max_len`` (patches included) keeps only its last ``max_len``
    positions, in the rotating layout. Attention K/V are sized
    into decode slots (a shared_attn site's gaining its leading axis 1 and
    int8 applying where configured); a recurrent state is already the
    cache and passes through.
    """
    cfg = model.cfg

    @torch.inference_mode()
    def prefill(inputs: dict):
        logits, _, caches = model(inputs, want_cache=True)
        s_c = min(max_len, cfg.window) if cfg.window else max_len
        sized = []
        for (kind, _), cache in zip(cfg.segments(), caches):
            if kind not in ATTN_KINDS:
                sized.append(cache)  # recurrent state is already the cache
                continue
            if kind == "shared_attn":
                cache = {name: t[None] for name, t in cache.items()}
            k_c, v_c = _size_cache(cache["k"], s_c), _size_cache(cache["v"], s_c)
            if cfg.kv_cache_dtype == "int8":
                kq, ks = quantize_kv(k_c)
                vq, vs = quantize_kv(v_c)
                sized.append({"k": kq, "k_scale": ks, "v": vq, "v_scale": vs})
            else:
                sized.append({"k": k_c, "v": v_c})
        return logits[:, -1:], sized

    return prefill


def _cache_ptrs(caches) -> list[int]:
    return [t.data_ptr() for entry in caches for t in entry.values()]


class GraphDecode:
    """The decode step as one CUDA graph a token.

    The first call runs the step eagerly at its real position, on a side
    stream, and returns its logits: that is the warm-up that loads the
    kernels' libraries and sizes their counters, which may not be
    allocated under capture. It then captures one step into a
    ``torch.cuda.CUDAGraph`` (capture runs nothing) that reads two static
    buffers, the tokens (B, 1) int32 and the position, a 0-d int32 tensor,
    and writes static logits; the caches it captured are its state and are
    updated in place by every replay. Each later call copies ``tokens``
    and ``cache_pos`` into the static buffers and replays, and returns the
    static logits, which the next call overwrites: a caller that keeps
    them copies them.

    The step belongs to the caches it captured: a call with other cache
    tensors raises. Python runs only at capture, so each kernel wrapper's
    ``launches`` gains at every replay what capture added (capture itself
    launches nothing). ``nodes`` counts the device operations the graph
    holds, by kind (``kernels.common.graph_nodes``).
    """

    def __init__(self, model: Model):
        self.model = model
        self.graph = None
        self.nodes: dict = {}

    @property
    def captured(self) -> bool:
        """Whether the graph has been captured (at the first call)."""
        return self.graph is not None

    @torch.inference_mode()
    def __call__(self, caches, tokens, cache_pos):
        if self.graph is None:
            return self._capture(caches, tokens, cache_pos)
        if _cache_ptrs(caches) != self._ptrs:
            raise ValueError("this decode step was captured on other caches; build a new "
                             "step with build_decode_step for these")
        self.tokens.copy_(tokens)
        if isinstance(cache_pos, torch.Tensor):
            self.pos.copy_(cache_pos)
        else:
            self.pos.fill_(cache_pos)
        self.graph.replay()
        for wrapper, n in self._launches:
            wrapper.launches += n
        return self.logits, caches

    def _capture(self, caches, tokens, cache_pos):
        model, device = self.model, self.model.device
        self.tokens = torch.empty(tokens.shape, dtype=torch.int32, device=device)
        self.tokens.copy_(tokens)
        self.pos = position(cache_pos, device).clone()
        (logits, _), here = _warm_up(
            lambda: model.decode_step(caches, self.tokens, self.pos), device)
        logits.record_stream(here)
        graph, (self.logits, _), self._launches = _capture_graph(
            lambda: model.decode_step(caches, self.tokens, self.pos))
        self.nodes = graph_nodes(graph)
        self._ptrs = _cache_ptrs(caches)
        self.graph = graph
        return logits, caches


def _eager_decode(model: Model):
    @torch.inference_mode()
    def decode(caches, tokens, cache_pos):
        return model.decode_step(caches, tokens, cache_pos)

    decode.captured = False
    return decode


def build_decode_step(model: Model):
    """``decode(caches, tokens (B, 1), cache_pos) -> (logits (B, 1, V),
    caches)``, the caches updated in place; ``cache_pos`` a 0-d int32
    tensor or a Python int.

    On a CUDA model this is a :class:`GraphDecode`, unless a sharding
    context is installed whose mesh spans more than one device (decode's
    DTensor ops and collectives then run eagerly); on the CPU (the tests)
    and the meta device the step runs eagerly. The choice is made here,
    once, from those two facts. ``decode.captured`` is False for the eager
    step, and for the graph step says whether its first call has captured.
    """
    return GraphDecode(model) if _one_card(model) else _eager_decode(model)
