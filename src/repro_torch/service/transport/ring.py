"""Shared-memory batch rings: the transport's data plane (DESIGN.md §11).

One ring per session, memory-mapped (``MAP_SHARED``) by server and client
from a file the server creates next to its socket. The control plane
(:mod:`.wire`) only ever carries small JSON messages; batch payloads flow
through the ring as raw array bytes — the server copies each step's token
grid ONCE into the ring (straight from ``_to_grid`` output, never
pickled), and the client reconstructs ndarray views over one copy out.

Layout (little-endian)::

    [64-byte header][capacity bytes of frame data, circular]

    header:  magic "RDX1" | u32 version | u64 capacity
             | u64 head (consumer-owned) | u64 tail (producer-owned)
             | u32 state (0 open / 1 closed / 2 suspended)

``head``/``tail`` are monotonically increasing byte counters (positions
are taken mod capacity), so ``tail - head`` is exactly the unread bytes
and a full ring is unambiguous. Single-producer/single-consumer: the
server only writes ``tail``+``state``, the client only writes ``head`` —
no locks. Frames are written payload-first, counter-last; on x86-64's
total store order (and under CPython's byte-wise memcpy into an aligned
mmap) the consumer can never observe a counter ahead of its payload.

Frames: ``u32 payload_len | u8 kind | payload`` (payloads wrap around the
ring edge). Kinds: BATCH (one GlobalBatch, see :func:`encode_step_frame`),
EOE (end-of-epoch sentinel, JSON), ERROR and SUSPENDED (JSON; the client
raises). The server sizes each ring to ``queue_depth + 1`` worst-case
batch frames (:func:`frame_budget`) and skips a session whose ring has
less than one budget free — that skip IS the per-session backpressure.
"""

from __future__ import annotations

import json
import mmap
import struct
import time
from pathlib import Path

import numpy as np

from repro_torch.obs import tracer as trace

from ...core.loader import GlobalBatch, _to_grid
from ...core.stats import StepIO
from ...data.tokens import decode_record

__all__ = [
    "BatchRing",
    "RingClosed",
    "FRAME_BATCH",
    "FRAME_EOE",
    "FRAME_ERROR",
    "FRAME_SUSPENDED",
    "STATE_OPEN",
    "STATE_CLOSED",
    "STATE_SUSPENDED",
    "frame_budget",
    "encode_step_frame",
    "decode_batch_frame",
]

MAGIC = b"RDX1"
VERSION = 1
HEADER = 64
_OFF_CAPACITY = 8
_OFF_HEAD = 16
_OFF_TAIL = 24
_OFF_STATE = 32
FRAME_OVERHEAD = 5  # u32 length + u8 kind

FRAME_BATCH = 1
FRAME_EOE = 2
FRAME_ERROR = 3
FRAME_SUSPENDED = 4

STATE_OPEN = 0
STATE_CLOSED = 1
STATE_SUSPENDED = 2


class RingClosed(ConnectionError):
    """The producer marked the ring closed/suspended and no frames remain."""

    def __init__(self, state: int):
        self.state = state
        word = "suspended" if state == STATE_SUSPENDED else "closed"
        super().__init__(f"batch ring {word} by the data service")


class BatchRing:
    """SPSC byte ring over an mmap'd file; see the module docstring."""

    def __init__(self, path: Path, file, mm: mmap.mmap, capacity: int):
        self.path = Path(path)
        self._file = file
        self._mm = mm
        self.capacity = capacity

    # ------------------------------------------------------------ lifecycle
    @classmethod
    def create(cls, path: "str | Path", capacity: int) -> "BatchRing":
        """Server side: create the backing file and initialise the header."""
        capacity = max(int(capacity), 4096)
        path = Path(path)
        with open(path, "wb") as f:
            f.truncate(HEADER + capacity)
        file = open(path, "r+b")
        mm = mmap.mmap(file.fileno(), HEADER + capacity)
        mm[0:4] = MAGIC
        struct.pack_into("<I", mm, 4, VERSION)
        struct.pack_into("<Q", mm, _OFF_CAPACITY, capacity)
        struct.pack_into("<Q", mm, _OFF_HEAD, 0)
        struct.pack_into("<Q", mm, _OFF_TAIL, 0)
        struct.pack_into("<I", mm, _OFF_STATE, STATE_OPEN)
        return cls(path, file, mm, capacity)

    @classmethod
    def attach(cls, path: "str | Path") -> "BatchRing":
        """Client side: map an existing ring (validates magic/version)."""
        path = Path(path)
        file = open(path, "r+b")
        head = file.read(HEADER)
        if head[0:4] != MAGIC:
            file.close()
            raise ValueError(f"{path} is not a Redox batch ring")
        version = struct.unpack_from("<I", head, 4)[0]
        if version != VERSION:
            file.close()
            raise ValueError(f"ring version {version} != {VERSION}")
        capacity = struct.unpack_from("<Q", head, _OFF_CAPACITY)[0]
        mm = mmap.mmap(file.fileno(), HEADER + capacity)
        return cls(path, file, mm, capacity)

    def close(self) -> None:
        try:
            self._mm.close()
        except (BufferError, ValueError):
            pass  # an ndarray view may still pin the map; dropped with it
        try:
            self._file.close()
        except OSError:
            pass

    def unlink(self) -> None:
        self.path.unlink(missing_ok=True)

    # -------------------------------------------------------------- header
    @property
    def head(self) -> int:
        return struct.unpack_from("<Q", self._mm, _OFF_HEAD)[0]

    @property
    def tail(self) -> int:
        return struct.unpack_from("<Q", self._mm, _OFF_TAIL)[0]

    @property
    def state(self) -> int:
        return struct.unpack_from("<I", self._mm, _OFF_STATE)[0]

    def mark_state(self, state: int) -> None:
        """Producer side: closed/suspended. Wakes a polling consumer."""
        struct.pack_into("<I", self._mm, _OFF_STATE, state)

    @property
    def used_bytes(self) -> int:
        return self.tail - self.head

    @property
    def free_bytes(self) -> int:
        return self.capacity - self.used_bytes

    def writable(self, budget: int) -> bool:
        """Producer-side backpressure probe: room for one budget'd frame?"""
        return self.state == STATE_OPEN and self.free_bytes >= budget

    # ------------------------------------------------------------- producer
    def _copy_in(self, pos: int, data) -> int:
        """Copy ``data`` into the circular data area at byte counter ``pos``."""
        view = memoryview(data)
        if view.format != "B":
            view = view.cast("B")
        n = view.nbytes
        off = pos % self.capacity
        first = min(n, self.capacity - off)
        self._mm[HEADER + off:HEADER + off + first] = view[:first]
        if first < n:
            self._mm[HEADER:HEADER + n - first] = view[first:]
        return n

    def try_write(self, kind: int, parts) -> bool:
        """Write one frame from buffer ``parts`` iff it fits; False if not.

        ``parts`` may be bytes or C-contiguous ndarrays — each is copied
        exactly once, directly into the mapped ring.
        """
        views = [p if isinstance(p, (bytes, bytearray, memoryview))
                 else memoryview(p).cast("B") for p in parts]
        total = sum(memoryview(v).nbytes for v in views)
        if self.free_bytes < FRAME_OVERHEAD + total:
            return False
        with trace.span("ring.write", "ring", kind=kind, nbytes=total):
            pos = self.tail
            self._copy_in(pos, struct.pack("<IB", total, kind))
            pos += FRAME_OVERHEAD
            for v in views:
                pos += self._copy_in(pos, v)
            # counter-last: the frame only becomes visible once fully copied
            struct.pack_into("<Q", self._mm, _OFF_TAIL, pos)
        return True

    def write(self, kind: int, parts) -> None:
        """Write a frame the producer already knows fits (backpressure was
        checked via :meth:`writable`); a full ring here is a logic error."""
        if not self.try_write(kind, parts):
            raise BufferError(
                f"ring overflow: {self.free_bytes} bytes free (backpressure "
                "probe should have skipped this session)"
            )

    # ------------------------------------------------------------- consumer
    def _copy_out(self, pos: int, n: int) -> bytes:
        off = pos % self.capacity
        first = min(n, self.capacity - off)
        out = self._mm[HEADER + off:HEADER + off + first]
        if first < n:
            out += self._mm[HEADER:HEADER + n - first]
        return out

    def try_read(self) -> "tuple[int, bytes] | None":
        """Pop the next frame as ``(kind, payload)``; None if none pending."""
        head, tail = self.head, self.tail
        if tail - head < FRAME_OVERHEAD:
            return None
        length, kind = struct.unpack("<IB", self._copy_out(head, FRAME_OVERHEAD))
        payload = self._copy_out(head + FRAME_OVERHEAD, length)
        struct.pack_into("<Q", self._mm, _OFF_HEAD, head + FRAME_OVERHEAD + length)
        return kind, payload

    def read(self, *, timeout: float = 60.0, poll: float = 0.0005):
        """Blocking pop: poll until a frame arrives, the producer marks the
        ring closed/suspended (-> :class:`RingClosed`), or ``timeout``."""
        deadline = time.monotonic() + timeout
        # The span covers poll-wait + copy-out: consumer-visible ring time.
        with trace.span("ring.read", "ring"):
            while True:
                frame = self.try_read()
                if frame is not None:
                    return frame
                state = self.state
                if state != STATE_OPEN:
                    raise RingClosed(state)
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no frame within {timeout}s (server stalled or gone)"
                    )
                time.sleep(poll)


# ------------------------------------------------------------ batch frames
def frame_budget(global_batch: int, seq_len: int, num_nodes: int) -> int:
    """Worst-case BATCH frame bytes for one step of a session.

    grid+mask are ``(B, seq_len+1)`` int32/float32, returned ids int64, and
    the JSON meta (step + per-node StepIO counters) is generously bounded.
    """
    b, s1 = int(global_batch), int(seq_len) + 1
    meta = 1024 + 512 * int(num_nodes)
    raw = FRAME_OVERHEAD + 4 + meta + 8 * b * s1 + 8 * b
    return -(-raw // 1024) * 1024  # round up to 1 KiB


def encode_step_frame(item, seq_len: int, pad_id: int) -> list:
    """Serialize one raw pump step (``co_epoch(raw=True)`` item) to frame
    parts. Token decode + grid assembly happen here, server-side, and the
    contiguous grid goes straight into the ring — one copy, no pickle."""
    payloads, step, io_by_node, returned = item
    with trace.span("ring.encode", "decode", step=int(step)):
        flat = [decode_record(p) for p in payloads]
        grid, mask = _to_grid(flat, seq_len + 1, pad_id)
    ret = (
        np.concatenate(returned)
        if returned is not None and len(returned)
        else np.empty(0, dtype=np.int64)
    ).astype(np.int64, copy=False)
    if not ret.flags.c_contiguous:
        ret = np.ascontiguousarray(ret)
    meta = json.dumps({
        "step": int(step),
        "shape": [int(grid.shape[0]), int(grid.shape[1])],
        "nret": int(ret.size),
        "io": {
            str(int(r)): io.to_dict()
            for r, io in (io_by_node or {}).items()
        },
    }).encode()
    return [struct.pack("<I", len(meta)), meta, grid, mask, ret]


def decode_batch_frame(payload: bytes) -> GlobalBatch:
    """Rebuild the GlobalBatch a co-located loader's ``_assemble`` would
    have produced (arrays are read-only views over the one copied-out
    buffer)."""
    (meta_len,) = struct.unpack_from("<I", payload)
    meta = json.loads(payload[4:4 + meta_len])
    off = 4 + meta_len
    b, s1 = meta["shape"]
    grid = np.frombuffer(payload, np.int32, b * s1, off).reshape(b, s1)
    off += 4 * b * s1
    mask = np.frombuffer(payload, np.float32, b * s1, off).reshape(b, s1)
    off += 4 * b * s1
    returned = np.frombuffer(payload, np.int64, meta["nret"], off)
    return GlobalBatch(
        tokens=grid[:, :-1],
        targets=grid[:, 1:],
        loss_mask=mask[:, 1:],
        step=meta["step"],
        io_by_node={int(r): StepIO.from_dict(v) for r, v in meta["io"].items()},
        returned=returned,
    )
