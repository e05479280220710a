"""yolodl_torch/ops/wgrad.py against yolodl_tpu/ops/wgrad.py over
tests/test_wgrad.py's SHAPES (17² with stride 2, where the last padded row
is not read; 15² with k3; 19² with stride 2).

``conv2d_packed_wgrad``'s forward and dX are the stock conv's: bit for bit
the port's own ``F.conv2d`` and its autograd (the reference test's
"identical to the stock conv"), and within 3e-6 of the largest value of
the reference's custom-vjp outputs (f32 sums in another order).  dW within
3e-6 of its largest entry against the reference's dW, the reference
test's tolerance against its stock conv, and against the port's
``conv2d_weight``.  ``wgrad_im2col`` on its own, and the f32 result of
bf16 operands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_weight

from yolodl_torch.bridge import _kernel_to_jax, _kernel_to_torch
from yolodl_torch.ops import wgrad as t_wgrad
from yolodl_tpu.ops import wgrad as j_wgrad

torch.set_num_threads(2)

SHAPES = [
    (16, 12, 128, 3, 1),
    (16, 64, 32, 1, 1),
    (17, 32, 64, 3, 2),
    (16, 32, 64, 3, 2),
    (16, 64, 64, 1, 2),
    (15, 8, 16, 3, 1),
    (19, 16, 8, 3, 2),
]


def close(got, want, what, tol=3e-6):
    scale = float(np.abs(want).max()) + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=tol, err_msg=what)


@pytest.mark.parametrize("hw,ci,co,k,s", SHAPES)
def test_packed_wgrad_matches_the_reference(hw, ci, co, k, s):
    rng = np.random.default_rng(hw * 100 + ci)
    x = rng.normal(size=(2, hw, hw, ci)).astype(np.float32)
    w = rng.normal(size=(k, k, ci, co)).astype(np.float32)

    def j_fn(xx, ww):
        return j_wgrad.conv2d_packed_wgrad(xx, ww, k, s)

    y0 = np.asarray(j_fn(jnp.asarray(x), jnp.asarray(w)))
    gx0, gw0 = jax.grad(lambda xx, ww: jnp.sum(j_fn(xx, ww) ** 2), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))

    def port(fn):
        tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
        tw = _kernel_to_torch(w).requires_grad_(True)
        y = fn(tx, tw)
        (y ** 2).sum().backward()
        return y.detach(), tx.grad, tw.grad

    y1, gx1, gw1 = port(lambda xx, ww: t_wgrad.conv2d_packed_wgrad(xx, ww, k, s))
    y_lib, gx_lib, _ = port(lambda xx, ww: F.conv2d(xx, ww, stride=s, padding=(k - 1) // 2))
    assert torch.equal(y1, y_lib) and torch.equal(gx1, gx_lib)
    gw_lib = conv2d_weight(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), (co, ci, k, k),
                           2 * y_lib, stride=s, padding=(k - 1) // 2)
    assert gw1.dtype == torch.float32
    close(y1.permute(0, 2, 3, 1).numpy(), y0, "y")
    close(gx1.permute(0, 2, 3, 1).numpy(), np.asarray(gx0), "dX")
    close(_kernel_to_jax(gw1.numpy()), np.asarray(gw0), "dW vs reference")
    close(gw1.numpy(), gw_lib.numpy(), "dW vs conv2d_weight")


@pytest.mark.parametrize("hw,ci,co,k,s", [(17, 5, 6, 3, 2), (9, 4, 3, 1, 1)])
def test_wgrad_im2col_matches_the_reference(hw, ci, co, k, s):
    rng = np.random.default_rng(hw + k)
    h = (hw + 2 * ((k - 1) // 2) - k) // s + 1
    xp = rng.normal(size=(2, (h - 1) * s + k, (h - 1) * s + k, ci)).astype(np.float32)
    g = rng.normal(size=(2, h, h, co)).astype(np.float32)
    ref = np.asarray(j_wgrad.wgrad_im2col(jnp.asarray(xp), jnp.asarray(g), k, s))
    got = t_wgrad.wgrad_im2col(torch.from_numpy(xp.transpose(0, 3, 1, 2).copy()),
                               torch.from_numpy(g.transpose(0, 3, 1, 2).copy()), k, s)
    assert got.shape == (co, ci, k, k) and got.is_contiguous()
    close(_kernel_to_jax(got.numpy()), ref, "dW")


def test_bf16_operands_give_an_f32_dw():
    """bf16 operands: dW in f32 from the exact bf16 products (the CPU casts
    the operands; a card uses mm's f32 output), equal to the f32 product of
    the same bf16 values."""
    assert t_wgrad.mm_route(torch.device("cpu"), torch.bfloat16) == "f32 operands"
    assert t_wgrad.mm_route(torch.device("cuda"), torch.bfloat16) == "mm out_dtype"
    assert t_wgrad.mm_route(torch.device("cuda"), torch.float32) == "f32 operands"
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 6, 8, 8), generator=gen).bfloat16()
    xp = F.pad(x, (1, 1, 1, 1))
    g = torch.randn((2, 5, 8, 8), generator=gen).bfloat16()
    dw = t_wgrad.wgrad_im2col(xp, g, 3)
    assert dw.dtype == torch.float32
    ref = t_wgrad.wgrad_im2col(xp.float(), g.float(), 3)
    torch.testing.assert_close(dw, ref, rtol=0, atol=0)
    x.requires_grad_(True)
    w = torch.randn((5, 6, 3, 3), generator=gen).requires_grad_(True)
    y = t_wgrad.conv2d_packed_wgrad(x, w, 3)
    assert y.dtype == torch.bfloat16
    y.backward(g)
    assert w.grad.dtype == torch.float32 and x.grad.dtype == torch.bfloat16
    torch.testing.assert_close(w.grad, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="disagree"):
        t_wgrad.conv2d_packed_wgrad(x, w, 1)
