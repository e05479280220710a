"""Which route the port's host pipeline takes, and the g++ build behind it
(``kernels/_build.py``): ``make_decode_loader``'s rule (native by default,
PIL under ``YDL_NO_NATIVE_DECODE`` or when the compiler does not find
libjpeg's and libpng's headers, a raise when they are found and the build
fails); jitter and warp raise, and do not fall back, without g++; the
library's name follows the source, the flags and the compiler; two
processes build one library once."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from _torch_parity import REPO
from yolodl_torch.data import affine as t_affine
from yolodl_torch.data import cache as t_cache
from yolodl_torch.data import color as t_color
from yolodl_torch.data import native_loader as t_native
from yolodl_torch.kernels import _build


@pytest.fixture
def fresh(monkeypatch):
    """No library loaded yet in this process, and no route said yet."""
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(t_native, "_aug_lib_cache", None)
    monkeypatch.setattr(t_cache, "_routes_said", set())
    monkeypatch.delenv("YDL_NO_NATIVE_DECODE", raising=False)
    return monkeypatch


@pytest.fixture
def scratch_build(fresh, tmp_path):
    """Builds into a temp dir from a copy of csrc/."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    fresh.setattr(_build, "CSRC", csrc)
    fresh.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return csrc


def test_decode_native_by_default(fresh, capsys):
    loader = t_cache.make_decode_loader((32, 32))
    assert isinstance(loader, t_native.NativeLoader)
    assert t_native.native_loader_available()
    err = capsys.readouterr().err
    assert "decode: native (g++ finds jpeglib.h and png.h;" in err
    assert _build.library_path("host_decode").name in err
    t_cache.make_decode_loader((32, 32))
    assert capsys.readouterr().err == ""  # said once


def test_decode_pil_when_asked(fresh, tmp_path, capsys):
    fresh.setenv("YDL_NO_NATIVE_DECODE", "1")
    assert type(t_cache.make_decode_loader((32, 32))) is t_cache.OnDemandLoader
    assert capsys.readouterr().err == "decode: PIL (YDL_NO_NATIVE_DECODE is set)\n"
    assert type(t_cache.FileCache(str(tmp_path), (32, 32))._loader) is t_cache.OnDemandLoader
    assert type(t_cache.MemoryCache((32, 32))._loader) is t_cache.OnDemandLoader


def test_decode_pil_without_headers(fresh, tmp_path, capsys):
    """The compiler's include path without jpeglib.h → PIL, and nothing is
    built."""
    fresh.setattr(_build, "compiler_include_dirs", lambda: [str(tmp_path)])
    fresh.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.decode_probe() == (
        False, f"jpeglib.h and png.h not in the include path ({tmp_path})")
    assert not t_native.native_loader_available()
    assert type(t_cache.make_decode_loader((32, 32))) is t_cache.OnDemandLoader
    assert capsys.readouterr().err == (
        f"decode: PIL (jpeglib.h and png.h not in the include path ({tmp_path}))\n")
    assert "host_decode" not in _build.host_libraries()
    with pytest.raises(FileNotFoundError, match="cannot be built here"):
        t_native.NativeLoader((32, 32))
    assert not (tmp_path / "build").exists()
    (tmp_path / "png.h").write_text("")
    assert _build.decode_probe()[1] == f"jpeglib.h not in the include path ({tmp_path})"


def test_decode_build_failure_raises(scratch_build):
    """The headers are found, the source is broken: the loader raises, it
    does not take PIL."""
    (scratch_build / "host_decode.cpp").write_text(
        (scratch_build / "host_decode.cpp").read_text() + "\nint broken(\n")
    assert _build.decode_probe()[0]
    with pytest.raises(_build.KernelBuildError, match="g\\+\\+ failed for host_decode.cpp"):
        t_cache.make_decode_loader((32, 32))
    assert not list((_build.BUILD_DIR).glob("*.so"))  # no half-written library


def test_augment_raises_without_gxx(scratch_build, monkeypatch):
    monkeypatch.setattr(_build, "GXX", str(_build.BUILD_DIR / "no-such-g++"))
    img = np.random.default_rng(0).uniform(0, 1, (3, 8, 8)).astype(np.float32)
    m_rc, b_rc = t_affine.pixel_affine(np.diag([-1.0, 1.0, 1.0]), 8, 8)
    with pytest.raises(_build.KernelBuildError, match="cannot be run"):
        t_affine.warp_image(img, m_rc, b_rc)
    with pytest.raises(_build.KernelBuildError, match="cannot be run"):
        t_color.ColorJitter(0.1, 0.1, 0.1).apply(img, 0.05, 0.05, 0.05)
    assert t_native._aug_lib_cache is None  # nothing switched to the plain route
    assert _build.decode_probe()[0] is False


def test_augment_build_failure_raises(scratch_build):
    (scratch_build / "host_augment.cpp").write_text("#error broken\n")
    img = np.zeros((3, 8, 8), np.float32)
    with pytest.raises(_build.KernelBuildError, match="g\\+\\+ failed for host_augment.cpp"):
        t_color.ColorJitter(0.1, 0.1, 0.1).apply(img, 0.05, 0.05, 0.05)


def test_library_name_follows_source_flags_and_compiler(scratch_build, monkeypatch):
    base = {n: _build.library_path(n) for n in _build.HOST_SOURCES}
    cuda = {n: _build.library_path(n) for n in _build.SOURCES}
    path = scratch_build / "host_augment.cpp"
    path.write_text(path.read_text() + "\n// edited\n")
    assert _build.library_path("host_augment") != base["host_augment"]
    assert _build.library_path("host_decode") == base["host_decode"]
    monkeypatch.setattr(_build, "GXX_FLAGS", (*_build.GXX_FLAGS, "-DX"))
    assert _build.library_path("host_decode") != base["host_decode"]
    monkeypatch.setattr(_build, "_gxx_identities", {_build.GXX: b"another compiler"})
    flags_only = _build.library_path("host_decode")
    monkeypatch.setattr(_build, "_gxx_identities", {})
    assert _build.library_path("host_decode") != flags_only
    # the CUDA libraries' names are as they were, whatever g++ is
    monkeypatch.setattr(_build, "GXX", "no-such-g++")
    assert {n: _build.library_path(n) for n in _build.SOURCES} == cuda


def test_identity_names_the_host_cpu():
    march = _build.resolved_march()
    out = subprocess.run([_build.GXX, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True).stdout
    assert march != "unknown"
    assert ["-march=", march] in [line.split() for line in out.splitlines()]
    assert _build.library_path("host_augment").parent == _build.BUILD_DIR


BUILD_ONCE = """
import sys
from pathlib import Path
from yolodl_torch.kernels import _build
from yolodl_torch.data import native_loader
_build.BUILD_DIR = Path(sys.argv[1])
_build.GXX = sys.argv[2]
lib = native_loader._aug_lib()
print(_build.library_path("host_augment"), sorted(_build.BUILD_SECONDS))
"""


def test_two_processes_build_once(tmp_path):
    """Two processes that want the library at once: one compiles, under the
    file lock, and both load what it built."""
    log = tmp_path / "compiles.log"
    wrapper = tmp_path / "gxx"
    wrapper.write_text(f"#!/bin/sh\ncase \"$*\" in *-shared*) echo x >> {log}; sleep 1;; esac\n"
                       f"exec {shutil.which('g++')} \"$@\"\n")
    wrapper.chmod(0o755)
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_ONCE, str(tmp_path / "build"),
                               str(wrapper)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    paths = {out.split()[0] for out, _ in outs}
    assert len(paths) == 1 and os.path.exists(paths.pop())
    assert log.read_text() == "x\n"
    assert sorted(out.split(" ", 1)[1].strip() for out, _ in outs) == [
        "['host_augment']", "[]"]
