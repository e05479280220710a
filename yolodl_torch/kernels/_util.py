"""Shared helpers of the wgrad kernel modules.

Counterpart of ``yolodl_tpu/kernels/_util.py``: :func:`make_conv2d_with_wgrad`
builds the stride-1 "same" conv whose weight gradient comes from a given
``wgrad_fn``, so that ``conv2d_lowch`` and ``conv2d_db`` cannot drift apart
on the surrounding algebra.  The other helpers check and launch the two
wgrad kernels, which share their signature and their scratch layout.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# contraction chunks are sized so that a launch has about this many blocks
# per SM: enough waves to hide a ragged last one
BLOCKS_PER_SM = 4
ROWS_PER_SUBTILE = 2  # R in the .cu sources: a chunk is a multiple of it


def wgrad_reference(xp: Tensor, g: Tensor, k: int) -> Tensor:
    """Plain version of both wgrad kernels: per tap an f32 einsum of the
    shifted ``xp`` window with ``g`` → ``[k, k, Ci, Co]`` f32."""
    _, h, w, co = g.shape
    x32 = xp.to(torch.float32)
    g32 = g.to(torch.float32)
    out = torch.empty((k, k, xp.shape[-1], co), dtype=torch.float32, device=xp.device)
    for u in range(k):
        for v in range(k):
            out[u, v] = torch.einsum("bhwc,bhwo->co", x32[:, u:u + h, v:v + w, :], g32)
    return out


def check_wgrad_args(name: str, xp: Tensor, g: Tensor, k: int, device) -> torch.device:
    """Validate the operands of a wgrad call; returns the resolved device."""
    device = torch.device(device)
    if xp.device.type != device.type or g.device != xp.device:
        raise ValueError(
            f"{name}: xp on {xp.device}, g on {g.device}, caller asked for {device}")
    if xp.dtype != g.dtype or xp.dtype not in _DTYPES:
        raise ValueError(f"{name}: xp and g must both be float32 or bfloat16, "
                         f"got {xp.dtype} and {g.dtype}")
    if xp.dim() != 4 or g.dim() != 4:
        raise ValueError(f"{name}: expected NHWC xp and g, got {tuple(xp.shape)}, "
                         f"{tuple(g.shape)}")
    b, hp, wp, _ = xp.shape
    gb, h, w, _ = g.shape
    if k < 1 or k % 2 == 0 or gb != b or hp != h + k - 1 or wp != w + k - 1:
        raise ValueError(f"{name}: xp {tuple(xp.shape)} is not g {tuple(g.shape)} "
                         f"padded for an odd kernel size k={k}")
    if not (xp.is_contiguous() and g.is_contiguous()):
        raise ValueError(f"{name}: xp and g must be contiguous NHWC")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {device}")
    return device


def launch_wgrad(lib, prefix: str, xp: Tensor, g: Tensor, k: int) -> Tensor:
    """Launch ``<prefix>`` of ``lib`` (the kernel then the chunk reduction) on
    the current stream; scratch and output come from ``torch.empty``."""
    b, _, _, ci = xp.shape
    _, h, w, co = g.shape
    out = torch.empty((k, k, ci, co), dtype=torch.float32, device=xp.device)
    if xp.numel() == 0 or g.numel() == 0:
        return out.zero_()
    tiles_fn = getattr(lib, f"{prefix}_tiles")
    tiles_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    tiles_fn.restype = ctypes.c_int
    tiles = tiles_fn(ci, co, k)
    if tiles <= 0:
        raise ValueError(f"{prefix}: unsupported shape ci={ci} co={co} k={k}")
    sms = torch.cuda.get_device_properties(xp.device).multi_processor_count
    rows = max(1, math.ceil(b * h * tiles / (BLOCKS_PER_SM * sms)),
               math.ceil(b * h / 65535))
    rows = ROWS_PER_SUBTILE * math.ceil(rows / ROWS_PER_SUBTILE)
    chunks = b * math.ceil(h / rows)
    partial = torch.empty((chunks, k * k * ci * co), dtype=torch.float32, device=xp.device)
    fn = getattr(lib, prefix)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(xp.device).cuda_stream
    err = fn(xp.data_ptr(), g.data_ptr(), partial.data_ptr(), out.data_ptr(),
             _DTYPES[xp.dtype], b, h, w, ci, co, k, rows, stream)
    if err != 0:
        raise RuntimeError(f"{prefix} launch failed: cudaError {err}")
    return out


def make_conv2d_with_wgrad(wgrad_fn, doc: str):
    """Stride-1 "same" NHWC conv ``conv2d(x, w, k)`` (w HWIO, output NHWC)
    whose weight gradient is ``wgrad_fn(xp, g, k, device=...)`` on the
    pre-padded input.

    The forward pads x once and keeps the padded ``xp`` for the backward, as
    the reference's custom-vjp forward does.  The forward conv and dX are
    the library's (cuDNN on the card): the NHWC tensors are handed to it as
    NCHW views, which it reads as channels-last without a copy, and dX is
    the library's backward-data of that same call, cropped by the padding.
    Only dW goes through ``wgrad_fn``.
    """

    class Conv2dWithWgrad(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, w, k):
            pad = (k - 1) // 2
            xp = F.pad(x, (0, 0, pad, pad, pad, pad)) if pad else x.contiguous()
            w_oihw = w.to(x.dtype).permute(3, 2, 0, 1)
            y = F.conv2d(xp.permute(0, 3, 1, 2), w_oihw)
            ctx.save_for_backward(xp, w)
            ctx.k = k
            return y.permute(0, 2, 3, 1)

        @staticmethod
        def backward(ctx, gy):
            xp, w = ctx.saved_tensors
            k = ctx.k
            pad = (k - 1) // 2
            g = gy.contiguous()
            dx = dw = None
            if ctx.needs_input_grad[0]:
                dxp = torch.ops.aten.convolution_backward(
                    g.permute(0, 3, 1, 2), xp.permute(0, 3, 1, 2),
                    w.to(g.dtype).permute(3, 2, 0, 1), None, [1, 1], [0, 0], [1, 1],
                    False, [0, 0], 1, [True, False, False])[0].permute(0, 2, 3, 1)
                dx = dxp[:, pad:dxp.shape[1] - pad, pad:dxp.shape[2] - pad, :] if pad else dxp
            if ctx.needs_input_grad[1]:
                dw = wgrad_fn(xp, g.to(xp.dtype), k, device=xp.device).to(w.dtype)
            return dx, dw, None

    def conv2d(x: Tensor, w: Tensor, k: int) -> Tensor:
        if x.dim() != 4 or w.shape[:2] != (k, k) or w.shape[2] != x.shape[-1]:
            raise ValueError(f"conv2d: x {tuple(x.shape)} NHWC and w {tuple(w.shape)} "
                             f"HWIO disagree for k={k}")
        return Conv2dWithWgrad.apply(x, w, k)

    conv2d.__doc__ = doc
    return conv2d
