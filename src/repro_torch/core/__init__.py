"""Redox core: batched random access with file redirection (the paper's contribution)."""

from .abstract_memory import AbstractMemory
from .baselines import CoorDLLoader, NoIOLoader, PyTorchStyleLoader, run_baseline_epoch
from .chunking import ChunkingPlan
from .distributed import Cluster, EpochResult, RemoteMemory
from .elastic import ClusterSnapshot
from .loader import RedoxLoader
from .planner import EpochPlan, EpochPlanner
from .protocol import LocalNode, RequestResult
from .sampler import EpochSampler
from .spec import SessionSpec, StoreSpec
from .stats import (
    DeviceStats,
    NodeStats,
    PipelineTimeModel,
    PlannerStats,
    ServiceStats,
    StepIO,
)
from .storage import (
    BACKENDS,
    CODECS,
    BackendStats,
    ChunkStore,
    MmapBackend,
    ParallelBackend,
    StorageBackend,
    VFSBackend,
    get_codec,
    make_backend,
)

__all__ = [
    "AbstractMemory",
    "BACKENDS",
    "BackendStats",
    "CODECS",
    "ChunkingPlan",
    "ChunkStore",
    "Cluster",
    "ClusterSnapshot",
    "CoorDLLoader",
    "DeviceStager",
    "DeviceStats",
    "EpochPlan",
    "EpochPlanner",
    "EpochResult",
    "EpochSampler",
    "LocalNode",
    "MmapBackend",
    "NoIOLoader",
    "NodeStats",
    "ParallelBackend",
    "PipelineTimeModel",
    "PlannerStats",
    "PyTorchStyleLoader",
    "RedoxLoader",
    "RemoteMemory",
    "RequestResult",
    "run_baseline_epoch",
    "ServiceStats",
    "SessionSpec",
    "StepIO",
    "StorageBackend",
    "StoreSpec",
    "VFSBackend",
    "get_codec",
    "make_backend",
]


def __getattr__(name):
    # DeviceStager lives behind a lazy import: core itself is numpy-only,
    # and the transport's subprocess trainers must not pay the torch import
    # unless they actually take the device path.
    if name in ("DeviceStager", "HostPack", "pack_records"):
        from . import device

        return getattr(device, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
