"""Conv weight gradient as one packed im2col matmul.

Counterpart of ``yolodl_tpu/ops/wgrad.py``: all k² taps of a dense conv's
dW packed into one contraction,

    P[(u, v, ci), (b, h, w)] = x_padded[b, ci, h·s + u, w·s + v]
    dW[(u, v, ci), co]       = Σ_{b,h,w} P · g

exposed as :func:`conv2d_packed_wgrad`, a "same"-padded stride-s conv whose
forward and dX are the stock conv's and whose dW is that product.  The
reference computes it as a ``dot_general`` outside any Pallas kernel, so
the product here is ``torch.mm``.

Unlike the reference, whose compiler fuses the tap concatenation into the
dot's operand reads, eager PyTorch materialises the patch tensor: k²·Ci·B·H·W
elements, 9× the input at k = 3.

The product's f32 result (the reference's ``preferred_element_type``) is a
rule on the operands (:func:`mm_route`): bf16 or f16 operands on a card go
through ``torch.mm(..., out_dtype=torch.float32)`` (tensor-core products,
f32 accumulation and output); otherwise the operands are cast to f32 first,
which gives the same products, since a bf16 or f16 product is exact in f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input

Tensor = torch.Tensor


def mm_route(device: torch.device, dtype: torch.dtype) -> str:
    """How :func:`wgrad_im2col` gets an f32 product for operands of
    ``dtype`` on ``device``: ``"mm out_dtype"`` or ``"f32 operands"``."""
    if device.type == "cuda" and dtype in (torch.bfloat16, torch.float16):
        return "mm out_dtype"
    return "f32 operands"


def wgrad_im2col(xp: Tensor, g: Tensor, k: int, stride: int = 1) -> Tensor:
    """dW of a dense conv from the pre-padded input, as one packed matmul.

    xp: ``[B, Ci, (H−1)s + k, (W−1)s + k]`` (already zero-padded), g:
    ``[B, Co, H, W]`` → ``[Co, Ci, k, k]`` f32 (float64 for float64
    operands)."""
    b, ci, hp, wp = xp.shape
    _, co, h, w = g.shape
    assert hp == (h - 1) * stride + k and wp == (w - 1) * stride + k, (
        tuple(xp.shape), tuple(g.shape), k, stride)
    xt = xp.transpose(0, 1)  # [Ci, B, Hp, Wp], a view
    taps = [xt[:, :, u:u + (h - 1) * stride + 1:stride, v:v + (w - 1) * stride + 1:stride]
            for u in range(k) for v in range(k)]
    # [k²·Ci, B·H·W], row (u·k + v)·Ci + ci: the reference's concat order
    patches = torch.stack(taps).reshape(k * k * ci, b * h * w)
    gt = g.transpose(0, 1).reshape(co, b * h * w)
    if mm_route(xp.device, xp.dtype) == "mm out_dtype":
        dw = torch.mm(gt, patches.t(), out_dtype=torch.float32)
    else:
        acc = torch.promote_types(xp.dtype, torch.float32)
        dw = torch.mm(gt.to(acc), patches.t().to(acc))
    return dw.reshape(co, k, k, ci).permute(0, 3, 1, 2).contiguous()


class _PackedWgradConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, k, stride):
        ctx.save_for_backward(x, w)
        ctx.k, ctx.stride = k, stride
        return F.conv2d(x, w.to(x.dtype), stride=stride, padding=(k - 1) // 2)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, stride = ctx.k, ctx.stride
        pad = (k - 1) // 2
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the conv's own transposed conv (its backward-data)
            dx = conv2d_input(x.shape, w.to(g.dtype), g, stride=stride, padding=pad)
        if ctx.needs_input_grad[1]:
            xp = F.pad(x, (pad, pad, pad, pad)) if pad else x
            # a strided conv may not read the last padded rows and columns
            h, w_ = g.shape[2], g.shape[3]
            xp = xp[:, :, :(h - 1) * stride + k, :(w_ - 1) * stride + k]
            dw = wgrad_im2col(xp, g.to(x.dtype), k, stride).to(w.dtype)
        return dx, dw, None, None


def conv2d_packed_wgrad(x: Tensor, w: Tensor, k: int, stride: int = 1) -> Tensor:
    """Dense "same"-padded conv (padding (k−1)/2) of NCHW ``x`` and OIHW
    ``w``, ``F.conv2d``'s values and dX, with dW from :func:`wgrad_im2col`."""
    if x.dim() != 4 or tuple(w.shape[2:]) != (k, k) or w.shape[1] != x.shape[1]:
        raise ValueError(f"conv2d_packed_wgrad: x {tuple(x.shape)} NCHW and w "
                         f"{tuple(w.shape)} OIHW disagree for k={k}")
    return _PackedWgradConv.apply(x, w, k, stride)
