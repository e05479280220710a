"""Pairwise IoU matrix: the hand-written CUDA kernel and its plain version.

Counterpart of ``yolodl_tpu/kernels/iou_pallas.py`` (``pairwise_iou_pallas``).
The kernel is ``yolodl_torch/csrc/iou.cu``; its source note says what bounds
it and how the design answers that.  Unlike the TPU kernel it takes a batch,
``[B, K, 4]`` → ``[B, K, K]``, so NMS launches it once per batch.

:func:`pairwise_iou` takes the kernel for a CUDA tensor and the plain version
:func:`pairwise_iou_reference` for a CPU tensor.  On a CUDA tensor it
launches or raises: nothing falls back.  ``pairwise_iou.launches`` counts the
launches of the kernel.
"""

from __future__ import annotations

import ctypes

import torch

EPSILON = 1e-16  # geometry/boxes.py EPSILON


def pairwise_iou_reference(tlbr: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [..., K, 4] TLBR → [..., K, K] f32 IoU, with
    the same operations in the same order as the kernel."""
    t = tlbr.to(torch.float32)
    rt, rl, rb, rr = t[..., :, None, 0], t[..., :, None, 1], t[..., :, None, 2], t[..., :, None, 3]
    ct, cl, cb, cr = t[..., None, :, 0], t[..., None, :, 1], t[..., None, :, 2], t[..., None, :, 3]
    inner_h = torch.clamp(torch.minimum(rb, cb) - torch.maximum(rt, ct), min=0.0)
    inner_w = torch.clamp(torch.minimum(rr, cr) - torch.maximum(rl, cl), min=0.0)
    inter = inner_h * inner_w
    area_r = (rb - rt) * (rr - rl)
    area_c = (cb - ct) * (cr - cl)
    union = area_r + area_c - inter + EPSILON
    return inter / union


def _launch(tlbr: torch.Tensor) -> torch.Tensor:
    from . import _build

    lib = _build.load("iou")
    fn = lib.yolodl_iou_pairwise_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    b, k, _ = tlbr.shape
    out = torch.empty((b, k, k), dtype=torch.float32, device=tlbr.device)
    stream = torch.cuda.current_stream(tlbr.device).cuda_stream
    err = fn(tlbr.data_ptr(), out.data_ptr(), b, k, stream)
    if err != 0:
        raise RuntimeError(f"iou kernel launch failed: cudaError {err}")
    pairwise_iou.launches += 1
    return out


def pairwise_iou(tlbr: torch.Tensor, device="cuda") -> torch.Tensor:
    """[B, K, 4] TLBR boxes → [B, K, K] f32 IoU matrices.

    ``device`` is where the caller expects the work to run, and must be the
    tensor's device.  The input is cast to f32 (as ``iou_pallas.py`` casts).
    A CUDA tensor goes to the kernel; a CPU tensor to
    :func:`pairwise_iou_reference`.
    """
    device = torch.device(device)
    if tlbr.device.type != device.type:
        raise ValueError(
            f"pairwise_iou: tensor on {tlbr.device}, caller asked for {device}")
    if tlbr.dim() != 3 or tlbr.shape[-1] != 4:
        raise ValueError(f"expected [B, K, 4] boxes, got {tuple(tlbr.shape)}")
    if device.type == "cpu":
        return pairwise_iou_reference(tlbr)
    if device.type != "cuda":
        raise ValueError(f"pairwise_iou: unsupported device {device}")
    tlbr = tlbr.to(torch.float32)
    if not tlbr.is_contiguous():
        raise ValueError("pairwise_iou: boxes must be contiguous")
    b, k, _ = tlbr.shape
    if b == 0 or k == 0:
        return torch.zeros((b, k, k), dtype=torch.float32, device=tlbr.device)
    if b > 65535 or k * k >= 2**31:
        raise ValueError(
            f"pairwise_iou: shape {tuple(tlbr.shape)} exceeds the kernel's grid")
    return _launch(tlbr)


pairwise_iou.launches = 0
