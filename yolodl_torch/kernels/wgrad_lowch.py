"""Conv weight gradient for low-channel layers: the hand-written CUDA kernel
and its plain version.

Counterpart of ``yolodl_tpu/kernels/wgrad_pallas.py`` (``wgrad_lowch``,
``conv2d_lowch``).  The kernel is ``yolodl_torch/csrc/wgrad_lowch.cu``: all
k² taps packed into one contraction operand, formed in shared memory, and
multiplied on the tensor cores (bf16; f32 inputs keep f32 FMA).  Its source
note says what bounds it and how the design answers that.

:func:`wgrad_lowch` takes the kernel for CUDA tensors and the plain version
:func:`wgrad_lowch_reference` for CPU tensors.  On CUDA tensors it launches
or raises: nothing falls back.  ``wgrad_lowch.launches`` counts the
launches of the kernel.  As in the reference, the model's train step does
not route through :func:`conv2d_lowch`; it is its own entry point.
"""

from __future__ import annotations

import torch

from ._util import check_wgrad_args, launch_wgrad, make_conv2d_with_wgrad, wgrad_reference

Tensor = torch.Tensor


def wgrad_lowch_reference(xp: Tensor, g: Tensor, k: int) -> Tensor:
    """Plain PyTorch version: per-tap f32 einsum, ``[k, k, Ci, Co]`` f32."""
    return wgrad_reference(xp, g, k)


def wgrad_lowch(xp: Tensor, g: Tensor, k: int, device="cuda") -> Tensor:
    """dW of a stride-1 "same" conv from pre-padded input.

    xp: ``[B, H+k−1, W+k−1, Ci]`` (zero-padded by (k−1)/2 per side), g:
    ``[B, H, W, Co]``, both float32 or both bfloat16, contiguous, on
    ``device`` → ``[k, k, Ci, Co]`` f32.  k is odd, at most 7.
    """
    device = check_wgrad_args("wgrad_lowch", xp, g, k, device)
    if device.type == "cpu":
        return wgrad_lowch_reference(xp, g, k)
    if k > 7:
        raise ValueError(f"wgrad_lowch: the kernel takes k <= 7, got {k}")
    from . import _build

    out = launch_wgrad(_build.load("wgrad_lowch"), "lowch", xp, g, k)
    wgrad_lowch.launches += 1
    return out


wgrad_lowch.launches = 0

conv2d_lowch = make_conv2d_with_wgrad(
    wgrad_lowch,
    "Dense stride-1 'same' NHWC conv whose dW comes from the wgrad_lowch kernel.")
