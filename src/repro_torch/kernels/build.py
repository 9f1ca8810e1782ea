"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each kernel package ``kernels/<name>/`` holds ``*.cu`` sources with a plain
``extern "C"`` launcher (no PyTorch headers, so a build takes seconds). The
library goes to ``build/kernels/<name>-<hash>.so`` at the repository root,
keyed by a hash of the sources and the flags, so an edited source is
rebuilt and an unchanged one is reused. A failed build raises; nothing
falls back. The build only ever runs inside a call that launches a kernel
(or in ``chip_smoke.py``), never when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "library_path", "load"]

KERNEL_DIR = Path(__file__).resolve().parent
#: ``<repo>/build/kernels`` (listed in .gitignore).
BUILD_DIR = KERNEL_DIR.parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _sources(name: str) -> list[Path]:
    srcs = sorted((KERNEL_DIR / name).glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under {KERNEL_DIR / name}")
    return srcs


def library_path(name: str) -> Path:
    """Where the library of kernel package ``name`` is built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    nvcc = Path(home) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA "
                           "kernels need the CUDA toolkit to build")
    return str(nvcc)


def build(name: str) -> str | None:
    """Compile kernel package ``name`` unless its library exists.

    Returns the compiler output (``-Xptxas -v``: registers, shared memory,
    spills), or None when the library was already built; raises if
    ``nvcc`` fails.
    """
    out = library_path(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources(name))]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a reader never sees half a library
    return proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel package ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
    return lib
