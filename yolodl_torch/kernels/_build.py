"""Build and load the port's CUDA kernels.

Each source under ``yolodl_torch/csrc/`` is compiled by ``nvcc`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Nothing
includes PyTorch's headers, so a build takes seconds.  Libraries go to
``build/yolodl_torch/`` at the repository root, named by a hash of the
source, of every header under ``csrc/`` (a source may include any of them)
and of the flags, so an edited source or header is rebuilt and an unchanged
one is loaded as it is.  A failed build raises; nothing falls back.  A
file lock in the build directory keeps two processes (the ranks of a
data-parallel run) from building one library at once: the second waits
and loads what the first built.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` so that nvcc never
contracts a product and a sum into one FMA — the kernels round every
operation as their plain PyTorch versions do.  Never ``--use_fast_math``.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "yolodl_torch"

# kernel name → source file under csrc/
SOURCES: Dict[str, str] = {
    "iou": "iou.cu",
    "wgrad_lowch": "wgrad_lowch.cu",
    "wgrad_db": "wgrad_db.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-I", str(CSRC),
)
LINK_FLAGS = ("-ldl",)   # wgrad_common.cuh finds libcuda's tensor-map encoder with dlsym
HEADER_GLOBS = ("*.cuh", "*.h")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc" if cand else None
        if path is not None and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def headers() -> list:
    """Every header under csrc/ that a source can include, in a fixed order."""
    return sorted(h for pattern in HEADER_GLOBS for h in CSRC.glob(pattern))


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [CSRC / SOURCES[name], *headers()]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    # the include path is where the checkout lies, not what is compiled
    flags = [f for f in (*NVCC_FLAGS, *LINK_FLAGS) if f != str(CSRC)]
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for one source; returns (process, tmp, final) or None when
    the library is already built."""
    final = library_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name]), *LINK_FLAGS]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, final


def _finish_build(name: str, started) -> None:
    proc, tmp, final = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {SOURCES[name]}:\n{out}")
    os.replace(tmp, final)  # atomic: a concurrent loader sees all or nothing


@contextlib.contextmanager
def _file_lock():
    """Held across processes while libraries are built."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_all() -> float:
    """Build every kernel library, one nvcc per source, all started together.
    Returns the seconds taken."""
    t0 = time.perf_counter()
    with _lock, _file_lock():
        started = {n: _start_build(n) for n in SOURCES}
        for name, s in started.items():
            if s is not None:
                _finish_build(name, s)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if not library_path(name).exists():
            with _file_lock():
                started = _start_build(name)
                if started is not None:
                    _finish_build(name, started)
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
        return lib
