"""DeviceStager: the host→device half of the data plane (DESIGN.md §12).

The PyTorch counterpart of ``repro/core/device.py``, with the same
contract. Everything before this module ends at host memory; the stager
moves the tail off the train step's critical path:

* a dedicated **staging thread** drives the host batch pipeline (the
  protocol walk stays on the loader's own worker thread), so decode/pack,
  the host→device copy and the gather run while the consumer's previous
  train step computes;
* batches are **double-buffered** (``depth`` staged batches in flight);
* with ``use_kernel`` the host ships one int32 *slot buffer* plus the
  length and redirection tables instead of three assembled grids, and the
  hand-written CUDA ``chunk_gather_train`` assembles tokens, targets and
  loss mask on the card (on the CPU its plain version does).

On CUDA the staging thread packs a pack's three arrays into one pinned
host buffer, copies it in one ``non_blocking`` copy and launches the
gather on three views of the copy, all on a side stream of its own (two
device operations a batch), then records one event per batch. The
consumer makes its current stream wait on that event and marks the staged
tensors with ``record_stream`` so the caching allocator never hands their
memory out while the consumer's stream may still read them. On the CPU
the packed buffer is the staged batch (a grid is copied), all on the
staging thread, which still buys the overlap.

Buffer lifetime: staged-but-unconsumed batches are tracked and released
on teardown, abandoned consumers included, so a ``break`` mid-epoch never
strands device memory. Releasing is dropping the references (the JAX
version calls ``Array.delete()``); the allocator reclaims the memory once
the side stream's work on it is done.

Per-step accounting lands in :class:`~repro_torch.core.stats.StepIO`
(``stage_s`` / ``stage_wait_s``) and the stream-level aggregate in
:class:`~repro_torch.core.stats.DeviceStats` (``loss_tokens`` among them).
With a tracer installed, ``stager.stage`` carries the device interval of
the batch's copy and gather on the side stream, and ``stager.wait`` the
consumer's wait for it; both carry the batch's ``step`` (and ``epoch``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time

import numpy as np
import torch

from repro_torch.obs import tracer as trace

from ..kernels.chunk_gather.ops import check_indices, chunk_gather_train
from ..kernels.common import resolve_device, round_up
from .stats import DeviceStats

__all__ = ["DeviceStager", "HostPack", "pack_loss_tokens", "pack_records"]

_GRID_KEYS = ("tokens", "targets", "loss_mask")
_READY = "_ready"  # per-batch CUDA event, private to stage() -> stream()
_LOSS = "_loss_tokens"  # the batch's loss-bearing tokens, likewise


class HostPack(dict):
    """Host-side staging payload for the on-device gather: one slot-padded
    token buffer (``slot_tokens``), the clipped record lengths and the
    redirection index table, plus the batch metadata that rides along
    (``step`` / ``epoch`` / ``io_by_node`` / ``returned`` / ``seq_len`` /
    ``pad_id`` / ``loss_tokens``)."""


def pack_records(
    records: "list[np.ndarray]",
    returned: "np.ndarray | None",
    *,
    seq_len: int,
    pad_id: int = 0,
    row_pad: int = 8,
) -> tuple:
    """Pack decoded records into (slot_tokens, lens, idx) for the gather.

    Rows redirected to the same record share one slot (``returned`` file
    ids key the dedup — exactly-once makes them distinct within an epoch,
    but the pack stays correct for any index pattern). Slot rows are
    padded to a multiple of ``row_pad`` columns.
    """
    n_rows = len(records)
    if returned is not None and len(returned) == n_rows:
        uniq, first, inv = np.unique(
            np.asarray(returned), return_index=True, return_inverse=True
        )
    else:
        first = np.arange(n_rows)
        inv = np.arange(n_rows)
    full = seq_len + 1
    lp = round_up(full, row_pad)
    slot_tokens = np.full((len(first), lp), pad_id, dtype=np.int32)
    lens = np.zeros(len(first), dtype=np.int32)
    for s, r in enumerate(first):
        rec = records[int(r)]
        n = min(rec.shape[0], full)
        slot_tokens[s, :n] = rec[:n]
        lens[s] = n
    return slot_tokens, lens, inv.astype(np.int32)


def pack_loss_tokens(lens: np.ndarray, idx: np.ndarray, seq_len: int) -> int:
    """Loss-bearing tokens of a packed batch: ``min(len, S+1) - 1`` a row,
    the ones of the loss mask the gather will make from it."""
    per_row = np.asarray(lens, dtype=np.int64)[np.asarray(idx)] - 1
    return int(np.clip(per_row, 0, seq_len).sum())


def _ids(item) -> dict:
    """The batch's identifiers for its spans (-1 where it has none)."""
    return {"step": int(item.get("step", -1)), "epoch": int(item.get("epoch", -1))}


class DeviceStager:
    """Double-buffered host→device staging with optional on-device gather.

    ``use_kernel=None`` (auto) takes the gather whenever the input stream
    carries :class:`HostPack` items (the ``RedoxLoader.epoch_device``
    path) and plain grid staging for assembled batches. ``device=None``
    is the CUDA card; pass ``device="cpu"`` to stage on the CPU.
    """

    #: Slot-row column padding the packer must honour. The TPU reference
    #: padded to its 128-lane width; a multiple of 4 tokens lets the CUDA
    #: kernel load the rows 16 bytes at a time, and 8 serves the CPU and
    #: the card alike.
    row_pad = 8

    def __init__(
        self,
        *,
        device=None,
        use_kernel: "bool | None" = None,
        depth: int = 2,
    ):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self.depth = depth
        self.stats = DeviceStats()
        self._cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self._inflight: list = []
        self._lock = threading.Lock()
        self._thread: "threading.Thread | None" = None
        self._streaming = False

    @property
    def live_buffers(self) -> int:
        """Staged-but-unconsumed device batches currently held."""
        with self._lock:
            return len(self._inflight)

    # ---------------------------------------------------------------- stage
    def _copy(self, host: torch.Tensor) -> torch.Tensor:
        """A fresh host buffer's one copy to the device (queued on the
        current stream on CUDA; on the CPU the buffer itself)."""
        return host.to(self.device, non_blocking=True) if self._cuda else host

    def _put(self, arr) -> torch.Tensor:
        """One host array onto the device (through pinned memory on CUDA)."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        host = torch.empty(src.shape, dtype=src.dtype, pin_memory=self._cuda)
        host.copy_(src)
        return self._copy(host)

    def _put_pack(self, item: dict) -> tuple:
        """A pack's ``slot_tokens``, ``lens`` and ``idx`` onto the device in
        one copy: one int32 host buffer laid out ``idx | lens | pad | slot
        rows``, the pad putting the slot rows on a 16-byte boundary, and
        three views of its device copy (the device allocation starts on 512
        bytes)."""
        slot, lens, idx = item["slot_tokens"], item["lens"], item["idx"]
        b, (u, lp) = len(idx), slot.shape
        rows_at = round_up(b + u, 4)
        # Pinned on CUDA, from PyTorch's caching host allocator, which keeps
        # the block until the copy that reads it is done.
        host = torch.empty(rows_at + u * lp, dtype=torch.int32, pin_memory=self._cuda)
        flat = host.numpy()
        flat[:b] = idx
        flat[b:b + u] = lens
        flat[b + u:rows_at] = 0
        flat[rows_at:].reshape(u, lp)[:] = slot
        dev = self._copy(host)
        return dev[rows_at:].view(u, lp), dev[b:b + u], dev[:b]

    def stage(self, item: dict) -> dict:
        """Ship one host batch/pack to the device; returns the device batch.

        On CUDA the copies and the gather are queued on the side stream and
        the batch carries the event that marks them done; :meth:`stream`
        makes the consumer wait on it.
        """
        t0 = time.perf_counter()
        is_pack = "slot_tokens" in item
        gather = is_pack and self.use_kernel is not False
        if is_pack and not gather:
            raise ValueError(
                "DeviceStager(use_kernel=False) cannot stage HostPacks; "
                "feed it assembled batches (epoch_async) instead"
            )
        ready = mark = None
        tracer = trace.get()
        # torch.cuda.stream(None) is a no-op: the CPU stages inline.
        with torch.cuda.stream(self._side):
            if tracer is not None:
                mark = tracer.device_mark(self.device)
            if gather:
                check_indices(item["idx"], item["slot_tokens"].shape[0])
                slot, lens, idx = self._put_pack(item)
                tokens, targets, loss_mask = chunk_gather_train(
                    slot, lens, idx,
                    seq_len=int(item["seq_len"]),
                    pad_id=int(item["pad_id"]),
                )
                moved = (
                    item["slot_tokens"].nbytes
                    + item["lens"].nbytes
                    + item["idx"].nbytes
                )
                loss_tokens = item.get("loss_tokens")
                if loss_tokens is None:
                    loss_tokens = pack_loss_tokens(item["lens"], item["idx"],
                                                   int(item["seq_len"]))
                self.stats.kernel_steps += 1
            else:
                tokens, targets, loss_mask = (self._put(item[k]) for k in _GRID_KEYS)
                moved = sum(np.asarray(item[k]).nbytes for k in _GRID_KEYS)
                loss_tokens = int(np.count_nonzero(item["loss_mask"]))
            if self._cuda:
                ready = torch.cuda.Event()
                ready.record(self._side)
        stage_s = time.perf_counter() - t0
        if tracer is not None:
            tracer.complete(
                "stager.stage", "stage", t0, stage_s,
                {**_ids(item), "bytes": int(moved), "kernel": bool(gather)},
                mark=mark,
            )
        # Copy the StepIO entries before annotating: replay-engine batches
        # share them with the EpochPlan, which must stay reusable.
        io = {
            n: dataclasses.replace(s, stage_s=0.0, stage_wait_s=0.0)
            for n, s in item.get("io_by_node", {}).items()
        }
        if io:
            io[min(io)].stage_s = stage_s
        out = dict(item)
        for k in ("slot_tokens", "lens", "idx", "seq_len", "pad_id", "loss_tokens"):
            out.pop(k, None)
        out.update(
            tokens=tokens, targets=targets, loss_mask=loss_mask,
            io_by_node=io, stage_s=stage_s, stage_wait_s=0.0,
        )
        out[_LOSS] = int(loss_tokens)
        if ready is not None:
            out[_READY] = ready
        self.stats.steps += 1
        self.stats.bytes_to_device += int(moved)
        self.stats.stage_s += stage_s
        return out

    def _hand_over(self, batch: dict) -> None:
        """Order the consumer's current stream after the batch's staging."""
        ready = batch.pop(_READY, None)
        if ready is None:
            return
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ready)
        for k in _GRID_KEYS:
            batch[k].record_stream(consumer)

    # --------------------------------------------------------------- stream
    def stream(self, batches):
        """Yield device-resident batches for a host batch/pack iterator.

        The staging thread drives ``batches`` (so a generator's own
        pipeline — e.g. the loader's protocol worker — runs ahead too),
        stages each item, and feeds a bounded queue of ``depth`` device
        batches. Abandoning this generator tears everything down
        deterministically: the staging thread is signalled and joined, the
        inner iterator is closed *from the staging thread* (its
        ``finally`` runs immediately, not at GC time), and every staged
        batch the consumer never saw has its device buffers released.
        """
        if self._streaming:
            raise RuntimeError("DeviceStager.stream is one-at-a-time; "
                               "create one stager per concurrent stream")
        self._streaming = True
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        end = object()
        stop = threading.Event()
        failure: list[BaseException] = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            it = iter(batches)
            try:
                for item in it:
                    staged = self.stage(item)
                    with self._lock:
                        self._inflight.append(staged)
                    if not put(staged):
                        return
            except BaseException as e:
                failure.append(e)
            finally:
                # Close the inner generator from the thread that iterated
                # it — legal (it is suspended) and deterministic.
                close = getattr(it, "close", None)
                if close is not None:
                    try:
                        close()
                    except BaseException as e:
                        failure.append(e)
                put(end)

        t = threading.Thread(target=worker, daemon=True)
        self._thread = t
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                wait = time.perf_counter() - t0
                tracer = trace.get()
                if tracer is not None:
                    # The slice of staging the double buffer failed to hide.
                    tracer.complete("stager.wait", "stage", t0, wait,
                                    None if item is end else _ids(item))
                if item is end:
                    break
                with self._lock:
                    self._inflight.remove(item)
                self._hand_over(item)
                self.stats.wait_s += wait
                self.stats.loss_tokens += item.pop(_LOSS)
                item["stage_wait_s"] = wait
                io = item["io_by_node"]
                if io:
                    io[min(io)].stage_wait_s = wait
                yield item
            if failure:
                raise failure[0]
        finally:
            stop.set()
            t.join()
            self._release_inflight()
            self._streaming = False

    # ------------------------------------------------------------- teardown
    def _release_inflight(self) -> None:
        with self._lock:
            stranded, self._inflight = self._inflight, []
        for batch in stranded:
            for k in (*_GRID_KEYS, _READY, _LOSS):
                batch.pop(k, None)
            self.stats.buffers_released += 1

    def close(self) -> None:
        """Release any staged-but-unconsumed device buffers (idempotent).

        ``stream``'s own ``finally`` already does this on abandonment;
        ``close`` exists for explicit lifecycle management and for
        symmetry with the loader/client teardown paths."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("close() while a stream is active; abandon "
                               "or exhaust the stream generator first")
        self._release_inflight()

