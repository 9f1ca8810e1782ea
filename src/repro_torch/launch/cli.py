"""Shared argparse builders for the launch CLIs.

``train.py`` and ``data_service.py`` grew the same data-plane knobs with
drifting spellings; these builders define each shared flag ONCE —
identical option string, type, choices, default, and help — and each
launcher composes the groups it needs. ``tests/test_transport.py`` pins
the two parsers to identical spellings for every shared flag.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..core.storage.codec import CODECS
from ..core.storage.store import BACKENDS

__all__ = [
    "DEVICE_PATHS",
    "RESUME_AUTO",
    "add_autotune_args",
    "add_data_plane_args",
    "add_device_args",
    "add_elastic_args",
    "add_obs_args",
    "add_storage_args",
    "resolve_resume_dir",
]

#: ``--device-path`` spellings (DESIGN.md §12): ``naive`` is the per-step
#: ``jnp.asarray`` copy, ``stage`` double-buffers host grids onto the
#: device through a DeviceStager, ``gather`` additionally assembles the
#: batch on-device via the Pallas chunk_gather_train pass.
DEVICE_PATHS = ("naive", "stage", "gather")

#: Sentinel for a bare ``--resume-data`` (no directory): the launcher
#: resolves it to its own default location (train: ``workdir/ckpt/data``);
#: launchers with no natural default reject it with a usage error.
RESUME_AUTO = "__auto__"


def add_data_plane_args(
    ap: argparse.ArgumentParser,
    *,
    batch: int = 8,
    seq_len: int = 128,
    num_docs: int = 1024,
) -> None:
    """The session-shaping knobs every data-plane launcher shares.

    Per-launcher defaults differ only where the historical CLIs did
    (batch/seq-len/num-docs); spelling, type and semantics are identical.
    """
    g = ap.add_argument_group("data plane")
    g.add_argument("--batch", type=int, default=batch,
                   help="global batch size (records per training step)")
    g.add_argument("--seq-len", type=int, default=seq_len)
    g.add_argument("--num-docs", type=int, default=num_docs,
                   help="synthetic dataset size when building a fresh store")
    g.add_argument("--vocab-size", type=int, default=None,
                   help="synthetic vocab (default: launcher-specific)")
    g.add_argument("--seed", type=int, default=0,
                   help="base seed; protocol/sampler/dataset seeds derive "
                        "from it identically in every launcher")
    g.add_argument("--policy", choices=["max_fill", "random"],
                   default="max_fill", help="redirection refill policy")
    g.add_argument("--engine", choices=["replay", "step", "per_access"],
                   default="replay", help="epoch execution engine")
    add_storage_args(ap)


def add_storage_args(ap: argparse.ArgumentParser) -> None:
    """The chunk-store byte-representation knobs (DESIGN.md §15), shared
    verbatim: how chunks are read (``--backend``), how a *fresh* store is
    written (``--codec``/``--bands`` — an existing store's ``store.json``
    wins), and how much of a progressive store to read (``--fidelity``).
    """
    g = ap.add_argument_group("storage")
    g.add_argument("--backend", choices=sorted(BACKENDS), default=None,
                   help="storage backend (default: the store's default)")
    g.add_argument("--codec", choices=sorted(CODECS), default=None,
                   help="per-chunk compression codec when building a fresh "
                        "store (existing stores keep their store.json spec)")
    g.add_argument("--bands", type=int, default=None, metavar="N",
                   help="progressive fidelity bands per record when building "
                        "a fresh store (1: flat records)")
    g.add_argument("--fidelity", type=int, default=None, metavar="K",
                   help="read only the first K fidelity bands of a "
                        "progressive store (default: the autotuner's §6 "
                        "choice under --autotune, else full fidelity)")


def add_device_args(ap: argparse.ArgumentParser) -> None:
    """The host→device staging knobs (DESIGN.md §12), shared verbatim."""
    g = ap.add_argument_group("device data path")
    g.add_argument("--device-path", choices=DEVICE_PATHS, default="naive",
                   help="how batches reach the accelerator: naive per-step "
                        "copies, double-buffered staging, or staged + "
                        "on-device Pallas gather assembly")
    g.add_argument("--stage-depth", type=int, default=2, metavar="N",
                   help="staged device batches kept in flight "
                        "(stage/gather paths)")


def add_elastic_args(ap: argparse.ArgumentParser) -> None:
    """Suspend/resume flags (DESIGN.md §10), shared verbatim."""
    g = ap.add_argument_group("elastic data plane")
    g.add_argument("--resume-data", type=str, nargs="?", const=RESUME_AUTO,
                   default=None, metavar="DIR",
                   help="data-plane suspend/resume directory: resumed from "
                        "if it holds suspend files, written by "
                        "--suspend-after; bare --resume-data uses the "
                        "launcher's default location (if it has one)")
    g.add_argument("--suspend-after", type=int, default=None, metavar="N",
                   help="suspend the data plane to --resume-data after N "
                        "steps and exit (restart with the same flags to "
                        "continue byte-identically)")


def add_autotune_args(ap: argparse.ArgumentParser) -> None:
    """Model-fitted autotuning flags (DESIGN.md §14), shared verbatim."""
    g = ap.add_argument_group("autotuning")
    g.add_argument("--autotune", action="store_true",
                   help="calibrate the chunk store (repro_torch.autotune) and "
                        "auto-select storage backend, readahead depth, and "
                        "cache byte cap from the fitted §6 time model; an "
                        "explicit --backend (or --cache-mb where it exists) "
                        "overrides the corresponding choice")
    g.add_argument("--autotune-memory-mb", type=float, default=None,
                   metavar="MB", help="ceiling for the autotuned cache cap")
    g.add_argument("--compute-per-step", type=float, default=0.0,
                   metavar="SECONDS",
                   help="per-step compute time fed to the autotuner's epoch "
                        "prediction and the service's admission control "
                        "(0: treat the run as I/O bound)")


def add_obs_args(ap: argparse.ArgumentParser) -> None:
    """Observability flags (DESIGN.md §13), shared verbatim."""
    g = ap.add_argument_group("observability")
    g.add_argument("--trace", type=str, default=None, metavar="FILE",
                   help="record a span trace of the run and write Chrome-"
                        "trace JSON to FILE (open in Perfetto UI or "
                        "chrome://tracing); prints the per-stage epoch-time "
                        "attribution report on exit")
    g.add_argument("--trace-capacity", type=int, default=262144, metavar="N",
                   help="trace ring capacity in events (oldest dropped)")
    g.add_argument("--metrics", action="store_true",
                   help="print the Prometheus-style metrics exposition "
                        "(counters/stats snapshot) on exit")


def resolve_resume_dir(
    ap: argparse.ArgumentParser, value, default: "Path | None"
) -> "Path | None":
    """Resolve ``--resume-data``'s value: None passes through, a directory
    is taken literally, and the bare-flag sentinel becomes ``default`` —
    or a usage error for launchers that have no default location."""
    if value is None:
        return None
    if value != RESUME_AUTO:
        return Path(value)
    if default is None:
        ap.error("--resume-data requires a directory with this launcher")
    return default
