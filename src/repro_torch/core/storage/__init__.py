"""Pluggable storage: one chunk layout, three ways to read it.

``ChunkStore`` owns the on-disk chunk layout (paper §3.2); a
:class:`StorageBackend` decides how bytes are fetched:

========  =====================================================  ==========
backend   mechanism                                              returns
========  =====================================================  ==========
vfs       ``open``/``pread`` with a descriptor cache (default)   ``bytes``
mmap      files mapped once; reads are zero-copy views           ``memoryview``
parallel  threadpool reads + bounded readahead over an inner
          backend, driven by protocol prefetch hints             inner's type
========  =====================================================  ==========

Select one with ``ChunkStore.open(root, backend="mmap")`` or pass an
instance for custom tuning (``ParallelBackend(workers=8, readahead=16)``).

Orthogonally to *how* bytes are read, ``codec.py`` decides *what* bytes
sit on disk: per-chunk framed compression (``none``/``zlib``/``lz4``)
with progressive fidelity bands, described by a frozen
:class:`~repro.core.spec.StoreSpec` persisted as ``store.json`` — see
DESIGN.md §15. ``ChunkStore.open(root)`` with no flags reopens any built
store.
"""

from .base import BackendStats, StorageBackend
from .codec import CODECS, ChunkFrame, Codec, band_cuts, get_codec
from .mapped import MmapBackend
from .parallel import ParallelBackend
from .store import (
    BACKENDS,
    ChunkStore,
    first_read_order,
    make_backend,
    merge_read_schedules,
)
from .vfs import VFSBackend

__all__ = [
    "BACKENDS",
    "BackendStats",
    "CODECS",
    "ChunkFrame",
    "ChunkStore",
    "Codec",
    "MmapBackend",
    "ParallelBackend",
    "StorageBackend",
    "VFSBackend",
    "band_cuts",
    "first_read_order",
    "get_codec",
    "make_backend",
    "merge_read_schedules",
]
