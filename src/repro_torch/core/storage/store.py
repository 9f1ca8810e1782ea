"""Chunk store: the on-disk batched layout (paper §3.2 "Data Chunk Generation").

A chunk is one file on disk: the concatenation of its member records, plus a
sidecar offset index. This is the paper's one-time dataset re-organisation
("the pre-organized data chunks can be re-used to train different models").
Reads happen at two granularities:

* ``read_chunk``  — one sequential read of the whole chunk (Redox path);
* ``read_file``   — a ranged read of one record (baseline path — models
  PyTorch's per-file access against the same bytes).

*How* bytes are read is delegated to a :class:`StorageBackend`
(``backend="vfs" | "mmap" | "parallel"``, or an instance) — see
``base.py``. The layout itself stays storage-agnostic, like the paper's
implementation: "it does not depend on any specific storage".

*What* bytes sit in a chunk file is described by a frozen
:class:`~repro.core.spec.StoreSpec` (DESIGN.md §15): the default spec is
the legacy raw concatenation, while ``codec``/``bands`` select the framed
progressive layout of ``codec.py`` — per-chunk compressed fidelity bands.
``build`` persists the spec as ``store.json`` in the root, so
``ChunkStore.open(root)`` reopens any store with no flags; only the byte
representation changes, never the offsets index, the redirection
protocol, or the exactly-once semantics.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from pathlib import Path

import numpy as np

from repro_torch.obs import tracer as trace

from ..chunking import ChunkingPlan
from ..spec import StoreSpec
from .base import BackendStats, StorageBackend
from .codec import (
    FRAME_PEEK_BYTES,
    ChunkFrame,
    band_cuts,
    encode_frame,
    get_codec,
    parse_frame,
    peek_frame,
)
from .mapped import MmapBackend
from .parallel import ParallelBackend
from .vfs import VFSBackend

__all__ = [
    "ChunkStore",
    "BACKENDS",
    "make_backend",
    "merge_read_schedules",
    "first_read_order",
]


def merge_read_schedules(per_session_steps: "list[list[list[int]]]") -> "list[int]":
    """Merge per-session, per-step chunk-read schedules into one global order.

    ``per_session_steps[j][s]`` is the list of chunk ids session ``j`` reads
    during its step ``s``. The merge interleaves by step — for each step,
    every session's loads in session order — which is exactly the claim
    order produced by a round-robin serving pump driving the sessions in
    lockstep (``repro.service.DataService.co_epoch``). Duplicates are kept:
    this is the *claim* schedule; :func:`first_read_order` derives the
    physical read schedule a shared refcounted cache actually issues.
    """
    merged: "list[int]" = []
    depth = max((len(steps) for steps in per_session_steps), default=0)
    for s in range(depth):
        for steps in per_session_steps:
            if s < len(steps):
                merged.extend(steps[s])
    return merged


def first_read_order(claims: "list[int]") -> "list[int]":
    """Physical read order of a claim schedule under a refcounted cache.

    With release-on-last-claim refcounts (``repro.service.SharedResidency``)
    a chunk stays cache-resident from its first claim until its last, so
    only each chunk's *first* occurrence reaches storage — later claims,
    including a job's own repeat loads, are shared hits. The result is what
    the service hands to ``ChunkStore.schedule_reads`` as the backend's
    exact readahead schedule.
    """
    seen: "set[int]" = set()
    order: "list[int]" = []
    for k in claims:
        if k not in seen:
            seen.add(k)
            order.append(k)
    return order

BACKENDS = {
    "vfs": VFSBackend,
    "mmap": MmapBackend,
    "parallel": ParallelBackend,
}


def make_backend(spec: "str | StorageBackend", **kwargs) -> StorageBackend:
    """Factory: a backend name (``BACKENDS`` key) or a ready instance."""
    if isinstance(spec, StorageBackend):
        return spec
    try:
        cls = BACKENDS[spec]
    except KeyError:
        raise ValueError(
            f"unknown storage backend {spec!r}; expected one of {sorted(BACKENDS)}"
        ) from None
    return cls(**kwargs)


class ChunkStore:
    """Directory of chunk files + offset indexes for one dataset.

    ``spec`` fixes the byte layout (codec/level/bands) and the default
    backend; an explicit ``backend`` argument overrides the spec's
    *backend* only — the layout always comes from the spec (persisted as
    ``store.json`` by :meth:`build`). ``default_fidelity`` is the store's
    standing band count for progressive reads; ``read_chunk(fidelity=...)``
    overrides it per call.
    """

    # read_file() against a framed store decodes whole chunks; a tiny LRU
    # keeps the baseline's sequential-in-chunk accesses from paying one
    # decompression per record.
    _DECODE_CACHE_CAP = 4

    def __init__(
        self,
        root: str | Path,
        plan: ChunkingPlan,
        *,
        backend: "str | StorageBackend | None" = None,
        spec: "StoreSpec | None" = None,
        fidelity: "int | None" = None,
    ):
        self.root = Path(root)
        self.plan = plan
        self._offsets: dict[int, np.ndarray] | None = None
        if spec is None:
            spec = StoreSpec.from_kwargs(backend if backend is not None else "vfs")
        self.spec = spec
        if backend is not None:
            self._backend = make_backend(backend)
        else:
            self._backend = make_backend(spec.backend, **spec.backend_kwargs)
        self.default_fidelity = fidelity
        self._codec = get_codec(spec.codec)
        self._band_offs: "dict[int, list[np.ndarray]]" = {}
        self._decode_cache: "OrderedDict[int, list]" = OrderedDict()
        if spec.framed:
            self._backend.set_decoder(self._decode_payload)

    # ------------------------------------------------------------- backend
    @property
    def backend(self) -> StorageBackend:
        return self._backend

    @property
    def backend_stats(self) -> BackendStats:
        return self._backend.stats

    def chunk_path(self, chunk: int) -> Path:
        return self.root / f"chunk_{chunk:08d}.bin"

    @property
    def wants_prefetch(self) -> bool:
        """Whether computing prefetch hints for this store is worthwhile."""
        return self._backend.wants_prefetch

    def prefetch_chunks(self, chunks: "list[int]") -> None:
        """Hint upcoming chunk loads to the backend (bounded readahead)."""
        if chunks and self._backend.wants_prefetch:
            self._backend.prefetch([self.chunk_path(k) for k in chunks])

    def schedule_reads(self, chunks: "list[int]") -> None:
        """Hand the planner's exact chunk-read schedule to the backend."""
        if chunks:
            trace.instant(
                "store.schedule_reads", "read",
                backend=self._backend.name, chunks=len(chunks),
            )
            self._backend.schedule_reads([self.chunk_path(k) for k in chunks])

    @property
    def has_schedule(self) -> bool:
        """True while the backend is driven by an exact read schedule."""
        return self._backend.scheduled_active

    def close(self) -> None:
        self._decode_cache.clear()
        self._backend.close()

    # -------------------------------------------------------------- writing
    @staticmethod
    def build(
        root: str | Path,
        plan: ChunkingPlan,
        records,
        *,
        backend: "str | StorageBackend | None" = None,
        spec: "StoreSpec | None" = None,
        codec: "str | None" = None,
        level: "int | None" = None,
        bands: "int | None" = None,
    ) -> "ChunkStore":
        """One-time chunk-file generation (paper Fig. 2a).

        ``records`` is anything indexable by file id returning the record
        bytes (a list, or a provider like ``SyntheticTokenDataset``).
        Pass either a full ``spec`` or the individual ``codec``/``level``/
        ``bands`` knobs (legacy ``backend=`` spelling included); the
        resolved spec is persisted as ``store.json`` so ``open(root)``
        needs no flags. The index always stores *logical* offsets — the
        sizes validated here are pre-encode record sizes, whatever the
        codec does to the bytes on disk.
        """
        if spec is not None:
            if codec is not None or level is not None or bands is not None:
                raise ValueError(
                    "pass either spec= or codec/level/bands, not both"
                )
            if backend is not None:
                raise ValueError("with spec=, the backend belongs in the spec")
        else:
            spec = StoreSpec.from_kwargs(
                backend if backend is not None else "vfs",
                codec=codec if codec is not None else "none",
                level=level if level is not None else -1,
                bands=bands if bands is not None else 1,
            )
        codec_obj = get_codec(spec.codec)
        root = Path(root)
        root.mkdir(parents=True, exist_ok=True)
        offsets = {}
        for k in range(plan.num_chunks):
            files = plan.files_in_chunk(k)
            blobs = [records[int(f)] for f in files]
            sizes = np.array([len(b) for b in blobs], dtype=np.int64)
            if not np.array_equal(sizes, plan.file_sizes[files]):
                raise ValueError(f"record sizes disagree with plan for chunk {k}")
            offs = np.zeros(len(blobs) + 1, dtype=np.int64)
            np.cumsum(sizes, out=offs[1:])
            path = root / f"chunk_{k:08d}.bin"
            if spec.framed:
                cuts = [band_cuts(len(b), spec.bands) for b in blobs]
                payloads = [
                    codec_obj.encode(
                        b"".join(
                            blob[c[b] : c[b + 1]] for blob, c in zip(blobs, cuts)
                        ),
                        spec.level,
                    )
                    for b in range(spec.bands)
                ]
                path.write_bytes(encode_frame(spec.codec, payloads))
            else:
                with open(path, "wb") as fh:
                    for b in blobs:
                        fh.write(b)
            offsets[k] = offs
        index = {
            str(k): [int(x) for x in offs] for k, offs in offsets.items()
        }
        (root / "index.json").write_text(json.dumps(index))
        plan.save(root / "plan.npz")
        (root / "store.json").write_text(json.dumps(spec.to_json(), indent=1))
        store = ChunkStore(root, plan, backend=backend, spec=spec)
        store._offsets = {int(k): np.asarray(v) for k, v in index.items()}
        return store

    # -------------------------------------------------------------- reading
    def _index(self) -> dict[int, np.ndarray]:
        if self._offsets is None:
            raw = json.loads((self.root / "index.json").read_text())
            self._offsets = {int(k): np.asarray(v, dtype=np.int64) for k, v in raw.items()}
        return self._offsets

    def _decode_payload(self, raw) -> ChunkFrame:
        """Backend decoder hook: parse + eagerly decompress one chunk frame.

        Runs wherever the physical read ran — the ParallelBackend's worker
        threads for scheduled/prefetched chunks, so decompression overlaps
        disk I/O. The eager decode stops at the store's standing fidelity;
        a later call asking for more bands decodes from the kept
        compressed payloads.
        """
        frame = parse_frame(raw)
        if frame.codec_name != self.spec.codec:
            raise ValueError(
                f"chunk frame codec {frame.codec_name!r} does not match "
                f"store codec {self.spec.codec!r}"
            )
        frame.ensure_decoded(self._effective_fidelity(None))
        return frame

    def _effective_fidelity(self, fidelity: "int | None") -> int:
        f = self.default_fidelity if fidelity is None else fidelity
        return self.spec.bands if f is None else max(1, min(int(f), self.spec.bands))

    def _band_offset_arrays(self, chunk: int) -> "list[np.ndarray]":
        """Per-band record offsets, derived from the logical index (no extra
        on-disk metadata: cut points are a pure function of record sizes)."""
        cached = self._band_offs.get(chunk)
        if cached is None:
            sizes = np.diff(self._index()[chunk])
            cuts = [band_cuts(int(s), self.spec.bands) for s in sizes]
            cached = []
            for b in range(self.spec.bands):
                offs = np.zeros(len(cuts) + 1, dtype=np.int64)
                np.cumsum([c[b + 1] - c[b] for c in cuts], out=offs[1:])
                cached.append(offs)
            self._band_offs[chunk] = cached
        return cached

    def read_chunk(
        self, chunk: int, fidelity: "int | None" = None
    ) -> "list[tuple[int, bytes | memoryview]]":
        """One batched read -> [(file_id, record_bytes), ...] in slot order.

        On a progressive store, ``fidelity=k`` decodes only the first ``k``
        bands: every record comes back as a strict token-prefix of its
        full self (the Progressive Compressed Records move for I/O-bound
        jobs). Full fidelity is byte-identical to the raw layout.
        """
        with trace.span(
            "store.read_chunk", "read",
            chunk=chunk, backend=self._backend.name, codec=self.spec.codec,
        ):
            payload = self._backend.read(self.chunk_path(chunk))
        return self.decode_chunk(chunk, payload, fidelity)

    def read_chunk_raw(self, chunk: int):
        """The chunk's *cacheable* payload: a parsed-but-compressed
        :class:`ChunkFrame` on framed stores, the raw blob otherwise.
        :meth:`decode_chunk` turns it into records; ``payload_nbytes``
        gives its physical footprint. This is the pair ``SharedResidency``
        uses to cache compressed bytes and decode per-claim.
        """
        with trace.span(
            "store.read_chunk", "read",
            chunk=chunk, backend=self._backend.name, codec=self.spec.codec,
        ):
            return self._backend.read(self.chunk_path(chunk))

    @staticmethod
    def payload_nbytes(payload) -> int:
        """Physical bytes of a :meth:`read_chunk_raw` payload."""
        if isinstance(payload, ChunkFrame):
            return payload.physical_bytes
        return memoryview(payload).nbytes

    def decode_chunk(
        self, chunk: int, payload, fidelity: "int | None" = None
    ) -> "list[tuple[int, bytes | memoryview]]":
        """Slice a chunk payload into records (per-claim decode path).

        Never mutates a cached frame beyond consuming its one-shot eager
        decode, so concurrent claims at different fidelities are safe.
        """
        offs = self._index()[chunk]
        files = self.plan.files_in_chunk(chunk)
        if not self.spec.framed:
            return [
                (int(f), payload[offs[j] : offs[j + 1]])
                for j, f in enumerate(files)
            ]
        if not isinstance(payload, ChunkFrame):
            payload = parse_frame(payload)
        eff = self._effective_fidelity(fidelity)
        with trace.span(
            "store.decode_chunk", "decode",
            chunk=chunk, codec=self.spec.codec,
            fidelity=eff, bands=self.spec.bands,
        ):
            data = payload.take_decoded(eff)
            if data is None:
                data = payload.decode_bands(eff)
            boffs = self._band_offset_arrays(chunk)
            if eff == 1:
                b0, o = data[0], boffs[0]
                return [
                    (int(f), b0[o[j] : o[j + 1]]) for j, f in enumerate(files)
                ]
            return [
                (
                    int(f),
                    b"".join(
                        data[b][boffs[b][j] : boffs[b][j + 1]]
                        for b in range(eff)
                    ),
                )
                for j, f in enumerate(files)
            ]

    def read_file(self, file_id: int) -> "bytes | memoryview":
        """Ranged read of a single record (baseline access pattern).

        Offsets come from the cached index and the backend reuses its open
        handle for the chunk file, so repeated calls cost one ``pread`` —
        not an ``open`` + index parse per record. On a framed store a
        ranged ``pread`` of a compressed frame would hand back garbage
        mid-stream bytes, so the record is sliced from a whole-chunk
        decode instead, LRU-cached so in-chunk locality amortises the
        decompression. Always full fidelity: the baseline path models
        exact per-file bytes.
        """
        k = int(self.plan.chunk_of[file_id])
        j = int(self.plan.slot_of[file_id])
        if self.spec.framed:
            records = self._decode_cache.get(k)
            if records is not None:
                self._decode_cache.move_to_end(k)
            else:
                records = self.read_chunk(k, fidelity=self.spec.bands)
                self._decode_cache[k] = records
                while len(self._decode_cache) > self._DECODE_CACHE_CAP:
                    self._decode_cache.popitem(last=False)
            return records[j][1]
        offs = self._index()[k]
        return self._backend.read_range(
            self.chunk_path(k), int(offs[j]), int(offs[j + 1] - offs[j])
        )

    # -------------------------------------------------------------- opening
    def _verify_frames(self) -> None:
        """Reject a mixed-codec store at open(): every chunk file's frame
        header must agree with the spec (a store root assembled from two
        differently-encoded builds would otherwise fail mid-epoch)."""
        for k in range(self.plan.num_chunks):
            path = self.chunk_path(k)
            with open(path, "rb") as fh:
                head = peek_frame(fh.read(FRAME_PEEK_BYTES))
            if head is None:
                raise ValueError(
                    f"{path} is not a {self.spec.codec!r} frame "
                    f"(mixed-codec or legacy-raw chunk in a framed store)"
                )
            codec_name, nbands = head
            if codec_name != self.spec.codec or nbands != self.spec.bands:
                raise ValueError(
                    f"mixed-codec store: {path} is {codec_name!r}/{nbands} "
                    f"bands, store.json says {self.spec.codec!r}/"
                    f"{self.spec.bands}"
                )

    @staticmethod
    def open(
        root: str | Path,
        *,
        backend: "str | StorageBackend | None" = None,
        spec: "StoreSpec | None" = None,
        fidelity: "int | None" = None,
    ) -> "ChunkStore":
        """Reopen a built store. With no arguments the persisted
        ``store.json`` supplies everything; an explicit ``spec`` that
        disagrees with it is refused, and an explicit ``backend`` overrides
        the spec's default read path only (never the layout).
        """
        root = Path(root)
        plan = ChunkingPlan.load(root / "plan.npz")
        sidecar = root / "store.json"
        stored = None
        if sidecar.exists():
            stored = StoreSpec.from_json(json.loads(sidecar.read_text()))
        if spec is not None and stored is not None and spec != stored:
            raise ValueError(
                f"explicit spec conflicts with {sidecar}: "
                f"{spec.to_json()} != {stored.to_json()}"
            )
        resolved = spec if spec is not None else stored
        store = ChunkStore(
            root, plan, backend=backend, spec=resolved, fidelity=fidelity
        )
        if store.spec.framed:
            store._verify_frames()
        return store
