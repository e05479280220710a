"""The port's conv weight-gradient modules (yolodl_torch.kernels.wgrad_lowch
and wgrad_db) against the JAX reference's Pallas kernels.

On the CPU the wrappers take their plain version, so these tests hold the
plain version against ``wgrad_lowch(..., interpret=True)`` and
``wgrad_db(..., interpret=True)`` at the shapes of tests/test_wgrad.py, and
``conv2d_lowch``/``conv2d_db`` (y, dX and dW through autograd) against the
reference's custom-vjp convs through ``jax.grad``, dW at the reference's
own tolerance (3e-6 of max|dW|, test_wgrad.py:71-72).  y and dX come from
two frameworks' library convolutions, which sum in another order, so they
cannot be bitwise as the reference's y is against XLA's, nor within its
atol 1e-4 on dX, whose entries reach 2e3 here: y within rtol 1e-5 /
atol 1e-5, and dX within 3e-6 of max|dX| as dW.  The
CUDA kernels themselves are checked against the plain version on the card
(chip_smoke.py, and the test marked ``cuda`` below).
"""

import importlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolodl_tpu.kernels import wgrad_db as j_db
from yolodl_tpu.kernels import wgrad_pallas as j_lowch
from yolodl_torch.kernels import _build

torch.set_num_threads(2)

# yolodl_torch.kernels re-exports the wrappers under the modules' names
t_db = importlib.import_module("yolodl_torch.kernels.wgrad_db")
t_lowch = importlib.import_module("yolodl_torch.kernels.wgrad_lowch")

LOWCH_SHAPES = [(16, 32, 64, 3), (16, 64, 32, 1)]            # test_wgrad.py:55
DB_SHAPES = [(16, 32, 64, 3), (16, 64, 32, 1), (8, 16, 8, 3)]  # test_wgrad.py:75
MODULES = {"lowch": (t_lowch, t_lowch.wgrad_lowch, t_lowch.conv2d_lowch),
           "db": (t_db, t_db.wgrad_db, t_db.conv2d_db)}


def _operands(batch, hw, ci, co, k, seed):
    rng = np.random.default_rng(seed)
    pad = (k - 1) // 2
    x = rng.normal(size=(batch, hw, hw, ci)).astype(np.float32)
    xp = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    g = rng.normal(size=(batch, hw, hw, co)).astype(np.float32)
    return xp, g


@pytest.mark.parametrize("which,shape", [("lowch", s) for s in LOWCH_SHAPES]
                         + [("db", s) for s in DB_SHAPES])
def test_plain_wgrad_matches_pallas_interpret(which, shape):
    hw, ci, co, k = shape
    batch = 2 if which == "lowch" else 3
    xp, g = _operands(batch, hw, ci, co, k, seed=hw * 100 + ci)
    j_fn = j_lowch.wgrad_lowch if which == "lowch" else j_db.wgrad_db
    ref = np.asarray(j_fn(jnp.asarray(xp), jnp.asarray(g), k, interpret=True))
    module, wrapper, _ = MODULES[which]
    before = wrapper.launches
    out = wrapper(torch.from_numpy(xp), torch.from_numpy(g), k, device="cpu")
    assert wrapper.launches == before  # the plain version is no launch
    plain = getattr(module, f"wgrad_{which}_reference")(torch.from_numpy(xp),
                                                        torch.from_numpy(g), k)
    assert out.shape == (k, k, ci, co) and out.dtype == torch.float32
    torch.testing.assert_close(out, plain, rtol=0, atol=0)
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(out.numpy() / scale, ref / scale, atol=3e-6)


@pytest.mark.parametrize("which,shape", [("lowch", s) for s in LOWCH_SHAPES]
                         + [("db", s) for s in DB_SHAPES])
def test_conv2d_matches_reference_through_grad(which, shape):
    hw, ci, co, k = shape
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, hw, hw, ci)).astype(np.float32)
    w = rng.normal(size=(k, k, ci, co)).astype(np.float32)
    j_conv = j_lowch.conv2d_lowch if which == "lowch" else j_db.conv2d_db
    y0 = np.asarray(j_conv(jnp.asarray(x), jnp.asarray(w), k))
    gx0, gw0 = jax.grad(lambda a, b: jnp.sum(j_conv(a, b, k) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))

    _, _, t_conv = MODULES[which]
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    y1 = t_conv(tx, tw, k)
    torch.sum(y1 ** 2).backward()
    assert y1.shape == (3, hw, hw, co)
    np.testing.assert_allclose(y1.detach().numpy(), y0, rtol=1e-5, atol=1e-5)
    gx_scale = float(np.abs(np.asarray(gx0)).max())
    np.testing.assert_allclose(tx.grad.numpy() / gx_scale, np.asarray(gx0) / gx_scale,
                               atol=3e-6)
    scale = float(np.abs(np.asarray(gw0)).max())
    np.testing.assert_allclose(tw.grad.numpy() / scale, np.asarray(gw0) / scale, atol=3e-6)


@pytest.mark.parametrize("which", list(MODULES))
def test_conv2d_input_only_gradient(which):
    """A frozen weight: dX flows, no dW is computed."""
    _, wrapper, conv = MODULES[which]
    x = torch.randn((1, 6, 6, 4), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    w = torch.randn((3, 3, 4, 5), generator=torch.Generator().manual_seed(1))
    conv(x, w, 3).sum().backward()
    assert x.grad is not None and x.grad.shape == x.shape


@pytest.mark.parametrize("which", list(MODULES))
def test_cuda_request_raises_without_a_card(which):
    _, wrapper, _ = MODULES[which]
    xp, g = _operands(1, 4, 3, 5, 3, seed=0)
    with pytest.raises(ValueError, match="caller asked for cuda"):
        wrapper(torch.from_numpy(xp), torch.from_numpy(g), 3)  # default device: cuda


@pytest.mark.parametrize("which", list(MODULES))
def test_wrapper_rejects_bad_operands(which):
    _, wrapper, conv = MODULES[which]
    xp, g = _operands(1, 4, 3, 5, 3, seed=0)
    xp, g = torch.from_numpy(xp), torch.from_numpy(g)
    with pytest.raises(ValueError, match="both be float32 or bfloat16"):
        wrapper(xp, g.to(torch.bfloat16), 3, device="cpu")
    with pytest.raises(ValueError, match="padded for an odd kernel size"):
        wrapper(xp, g, 1, device="cpu")
    with pytest.raises(ValueError, match="contiguous"):
        wrapper(xp.transpose(1, 2), g.transpose(1, 2), 3, device="cpu")
    with pytest.raises(ValueError, match="HWIO disagree"):
        conv(torch.zeros((1, 4, 4, 3)), torch.zeros((3, 3, 2, 5)), 3)


def test_sources_are_registered_for_the_build(tmp_path, monkeypatch):
    for name in ("wgrad_lowch", "wgrad_db"):
        src = _build.CSRC / _build.SOURCES[name]
        assert src.is_file()
        text = src.read_text()
        assert "extern \"C\"" in text and "cudaGetLastError" in text
        assert "mma_bf16" in text and '#include "wgrad_common.cuh"' in text
        assert _build.library_path(name).parent == _build.BUILD_DIR
    header = _build.CSRC / "wgrad_common.cuh"
    assert header in _build.headers() and "mma.sync" in header.read_text()
    assert str(_build.CSRC) in _build.NVCC_FLAGS  # -I csrc

    # a library is named by its source and by every header it may include:
    # touching a header changes the name, so no stale library is loaded
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    assert before == {n: _build.library_path(n) for n in _build.SOURCES}
    with open(copy / "wgrad_common.cuh", "a") as f:
        f.write("// touched\n")
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert all(after[n] != before[n] for n in _build.SOURCES)
    with open(copy / "iou.cu", "a") as f:
        f.write("// touched\n")
    assert _build.library_path("iou") != after["iou"]
    assert _build.library_path("wgrad_db") == after["wgrad_db"]


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(MODULES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version_on_card(which, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    module, wrapper, _ = MODULES[which]
    for shape in [(2, 9, 33, 3, 32, 3), (2, 8, 40, 130, 20, 1), (1, 5, 5, 3, 3, 1),
                  # ragged: odd widths, channels that are no multiple of 8, k = 5
                  (2, 37, 53, 3, 24, 3), (3, 19, 19, 40, 72, 1), (2, 20, 20, 64, 64, 5),
                  (2, 24, 40, 32, 64, 3)]:
        b, h, w, ci, co, k = shape
        gen = torch.Generator().manual_seed(0)
        xp = torch.randn((b, h + k - 1, w + k - 1, ci), generator=gen).to(dtype).cuda()
        g = torch.randn((b, h, w, co), generator=gen).to(dtype).cuda()
        before = wrapper.launches
        out = wrapper(xp, g, k)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        ref = getattr(module, f"wgrad_{which}_reference")(xp, g, k)
        scale = float(ref.abs().max())
        assert float((out - ref).abs().max()) <= 1e-5 * scale, shape
        again = wrapper(xp, g, k)  # two launches give the same bits
        assert wrapper.launches == before + 2 and torch.equal(out, again), shape
