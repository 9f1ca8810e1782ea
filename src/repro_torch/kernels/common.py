"""Shared kernel-dispatch conventions.

The counterpart of ``repro/kernels/common.py``: there ``interpret=None``
picks compiled Pallas on a TPU and the interpreter elsewhere. Here the
choice is the device. ``resolve_device()`` defaults to the CUDA card and
refuses anything but a Hopper (capability 9.0) card; the CPU is taken only
when the caller asks for it, and then the kernels' plain versions run.
The meta device (the dry run: shapes and dtypes, no data) is taken on
request as well.
"""

from __future__ import annotations

import ctypes
import functools
import statistics

import torch

__all__ = ["checked_cuda", "count_launch", "graph_ms", "graph_nodes", "kernel_wrappers",
           "resolve_device", "round_up", "zeroed_counters"]

#: Compute capability the CUDA sources are built for (``sm_90a``).
CAPABILITY = (9, 0)
_counters: dict[tuple[str, int], torch.Tensor] = {}
_outgrown: list[torch.Tensor] = []  # kept alive for CUDA graphs that captured them


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``n``."""
    return -(-n // multiple) * multiple


def resolve_device(device=None) -> torch.device:
    """Resolve a device request to a concrete ``torch.device``.

    ``None`` -> the current CUDA card. ``"cpu"`` -> the CPU (tests, and
    the plain kernel versions); ``"meta"`` -> the meta device (the dry
    run). A CUDA request raises if there is no card or the card is not
    capability (9, 0); it never falls back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type in ("cpu", "meta"):
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda', 'cpu' or 'meta'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU"
        )
    return checked_cuda(dev.index if dev.index is not None else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def checked_cuda(index: int) -> torch.device:
    """``cuda:index`` once its capability has been checked (once per card)."""
    cap = torch.cuda.get_device_capability(index)
    if cap != CAPABILITY:
        raise RuntimeError(
            f"cuda:{index} ({torch.cuda.get_device_name(index)}) has "
            f"capability {cap}; the kernels are built for sm_90a {CAPABILITY}"
        )
    return torch.device("cuda", index)


def zeroed_counters(owner: str, device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters on ``device`` for ``owner``'s kernel.

    They are zeroed once, when allocated, and every launch of the kernel
    leaves them at 0 again, so a call costs no memset. That assumes one
    stream at a time per device, as prefill and decode run. A buffer is
    allocated, or grown, only outside CUDA graph capture.
    """
    key = (owner, device.index)
    have = _counters.get(key)
    if have is None or have.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{owner}'s counters must be allocated outside CUDA graph "
                               "capture: call it once at this size before capturing")
        if have is not None:
            _outgrown.append(have)
        have = torch.zeros(max(n, 0 if have is None else 2 * have.numel()), dtype=torch.int32,
                           device=device)
        _counters[key] = have
    return have


def graph_ms(call, calls: int = 10, reps: int = 5) -> float:
    """Device ms per call of ``call`` on the card: ``calls`` calls captured
    in one CUDA graph, the median of ``reps`` replays between CUDA events
    (the kernel sweeps' timer)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            call()
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / calls)
    return statistics.median(samples)


def count_launch(wrapper) -> None:
    """Count one call of ``wrapper`` that queued its kernel: a launch, in
    ``wrapper.launches``, or, while the calling thread's current stream is
    being captured into a CUDA graph (capture runs nothing), in
    ``wrapper.captured_launches``, which a graph adds to ``launches`` at
    every replay. The stream is the thread's own, so a stager that launches
    the gather on its side stream while another thread captures a step
    counts a launch, not a node of that step's graph."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured_launches += 1
    else:
        wrapper.launches += 1


def kernel_wrappers() -> dict:
    """Every kernel wrapper, by name; each counts its launches in
    ``<wrapper>.launches`` (:func:`count_launch`)."""
    from .chunk_gather.ops import chunk_gather, chunk_gather_train
    from .decode_attention.ops import decode_attention
    from .flash_attention.ops import flash_attention
    from .fused_adamw.ops import clip_adamw_
    from .ssd_scan.ops import ssd_scan

    return {"chunk_gather_train": chunk_gather_train, "chunk_gather": chunk_gather,
            "flash_attention": flash_attention, "decode_attention": decode_attention,
            "ssd_scan": ssd_scan, "fused_adamw": clip_adamw_}


#: ``CUgraphNodeType`` values (libcuda's graph API) of the nodes a
#: captured step holds.
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


@functools.lru_cache(maxsize=None)
def _libcuda() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphGetNodes.restype = lib.cuGraphNodeGetType.restype = ctypes.c_int  # CUresult
    return lib


def graph_nodes(graph: torch.cuda.CUDAGraph) -> dict:
    """The device operations a captured graph holds, by kind: ``{"total",
    "kernel", "memcpy", "memset", "other"}``, read with libcuda's
    ``cuGraphGetNodes``. ``graph`` must have been made with
    ``keep_graph=True``."""
    lib = _libcuda()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if lib.cuGraphGetNodes(raw, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if lib.cuGraphGetNodes(raw, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    out = {"total": n.value, **{kind: 0 for kind in _NODE_TYPES.values()}, "other": 0}
    kind = ctypes.c_int()
    for node in nodes:
        if lib.cuGraphNodeGetType(node, ctypes.byref(kind)):
            raise RuntimeError("cuGraphNodeGetType failed")
        out[_NODE_TYPES.get(kind.value, "other")] += 1
    return out
