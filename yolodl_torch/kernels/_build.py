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

The host libraries (``HOST_SOURCES``: the pipeline's jitter and warp, and
the JPEG/PNG decode) are C++ for the CPU, built by ``g++`` with the JAX
package's ``native/build.sh`` flags (``-O3 -march=native``), so that they
compute what its ``native/libyolodl_loader.so`` does, bit for bit.  Their
names also hash the compiler's version and what ``-march=native`` resolves
to on this host, so a library built for another CPU never loads.  The
decode library needs libjpeg's and libpng's headers: :func:`decode_probe`
says, before any build, whether the compiler finds them.
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
from typing import Dict, List, Tuple

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

# host library name → C++ source under csrc/, built by g++ for the CPU
HOST_SOURCES: Dict[str, str] = {
    "host_augment": "host_augment.cpp",
    "host_decode": "host_decode.cpp",
}
GXX = "g++"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")  # native/build.sh:4
HOST_LINK_FLAGS: Dict[str, Tuple[str, ...]] = {
    "host_augment": (),
    "host_decode": ("-ljpeg", "-lpng", "-lpthread"),
}
DECODE_HEADERS = ("jpeglib.h", "png.h")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
_gxx_identities: Dict[str, bytes] = {}
_gxx_include_dirs: Dict[str, List[str]] = {}
# seconds from each compile's start until it was waited out, by name;
# build_all waits in order, so each number is at least the one before it
BUILD_SECONDS: Dict[str, float] = {}


class KernelBuildError(RuntimeError):
    """The compiler (nvcc, or g++ for a host library) is missing or refused
    a source."""


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc" if cand else None
        if path is not None and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _run_gxx(*args: str) -> subprocess.CompletedProcess:
    try:
        return subprocess.run([GXX, *args], input="", capture_output=True, text=True)
    except OSError as e:
        raise KernelBuildError(f"{GXX} cannot be run: {e}") from e


def gxx_identity() -> bytes:
    """The compiler's version and what ``-march=native`` resolves to here:
    part of every host library's name."""
    ident = _gxx_identities.get(GXX)
    if ident is None:
        version = _run_gxx("--version").stdout
        target = _run_gxx("-march=native", "-Q", "--help=target")
        if target.returncode != 0:
            raise KernelBuildError(f"{GXX} -march=native -Q --help=target failed:\n{target.stderr}")
        ident = (version + "\0" + target.stdout).encode()
        _gxx_identities[GXX] = ident
    return ident


def resolved_march() -> str:
    """The CPU that ``-march=native`` names on this host (e.g. ``cooperlake``)."""
    for line in gxx_identity().decode().split("\0", 1)[1].splitlines():
        parts = line.split()
        if parts and parts[0] == "-march=" and len(parts) > 1:
            return parts[1]
    return "unknown"


def compiler_include_dirs() -> List[str]:
    """The directories g++ searches for ``<...>`` includes, in its order."""
    dirs = _gxx_include_dirs.get(GXX)
    if dirs is None:
        err = _run_gxx("-xc++", "-E", "-v", "-").stderr.splitlines()
        marks = ("#include <...> search starts here:", "End of search list.")
        dirs = ([line.strip() for line in err[err.index(marks[0]) + 1:err.index(marks[1])]]
                if all(m in err for m in marks) else [])
        _gxx_include_dirs[GXX] = dirs
    return dirs


def decode_probe() -> Tuple[bool, str]:
    """Whether the decode library can be built here: (found, reason).  The
    one test is whether the compiler finds ``jpeglib.h`` and ``png.h``; it
    is decided before any build, and builds nothing."""
    try:
        dirs = compiler_include_dirs()
    except KernelBuildError as e:
        return False, str(e)
    missing = [h for h in DECODE_HEADERS if not any((Path(d) / h).is_file() for d in dirs)]
    if missing:
        return False, f"{' and '.join(missing)} not in the include path ({':'.join(dirs)})"
    return True, f"{GXX} finds {' and '.join(DECODE_HEADERS)}"


def headers() -> list:
    """Every header under csrc/ that a source can include, in a fixed order."""
    return sorted(h for pattern in HEADER_GLOBS for h in CSRC.glob(pattern))


def library_path(name: str) -> Path:
    if name in HOST_SOURCES:
        digest = hashlib.sha256()
        path = CSRC / HOST_SOURCES[name]
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
        digest.update(" ".join((*GXX_FLAGS, *HOST_LINK_FLAGS[name])).encode() + b"\0")
        digest.update(gxx_identity())
        return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"
    digest = hashlib.sha256()
    for path in [CSRC / SOURCES[name], *headers()]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    # the include path is where the checkout lies, not what is compiled
    flags = [f for f in (*NVCC_FLAGS, *LINK_FLAGS) if f != str(CSRC)]
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start the compiler for one source; returns (process, tmp, final,
    start time) or None when the library is already built."""
    final = library_path(name)
    if final.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = final.with_suffix(f".{os.getpid()}.tmp.so")
    if name in HOST_SOURCES:
        cmd = [GXX, *GXX_FLAGS, "-o", str(tmp), str(CSRC / HOST_SOURCES[name]),
               *HOST_LINK_FLAGS[name]]
    else:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name]), *LINK_FLAGS]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
    except OSError as e:
        raise KernelBuildError(f"{cmd[0]} cannot be run: {e}") from e
    return proc, tmp, final, time.perf_counter()


def _finish_build(name: str, started) -> None:
    proc, tmp, final, t0 = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        compiler, source = (GXX, HOST_SOURCES[name]) if name in HOST_SOURCES else (
            "nvcc", SOURCES[name])
        raise KernelBuildError(f"{compiler} failed for {source}:\n{out}")
    os.replace(tmp, final)  # atomic: a concurrent loader sees all or nothing
    BUILD_SECONDS[name] = time.perf_counter() - t0


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


def host_libraries() -> List[str]:
    """The host libraries this machine can build: the decode library only
    where :func:`decode_probe` finds its headers."""
    return [n for n in HOST_SOURCES if n != "host_decode" or decode_probe()[0]]


def build_all() -> float:
    """Build the host libraries this machine can build and every kernel
    library, one compiler per source, all started together, the host
    libraries first.  Returns the seconds taken."""
    t0 = time.perf_counter()
    with _lock, _file_lock():
        started = {n: _start_build(n) for n in (*host_libraries(), *SOURCES)}
        for name, s in started.items():
            if s is not None:
                _finish_build(name, s)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (a kernel's or a host library's), built
    first if needed."""
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
