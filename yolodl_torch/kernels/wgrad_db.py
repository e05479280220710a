"""Conv weight gradient staged through an asynchronous ring: the hand-written
CUDA kernel and its plain version.

Counterpart of ``yolodl_tpu/kernels/wgrad_db.py`` (``wgrad_db``,
``conv2d_db``).  The kernel is ``yolodl_torch/csrc/wgrad_db.cu``: the same
function as ``wgrad_lowch``; for bf16 the row strips of xp and g are copied
by TMA into a ring of shared-memory stages while tensor-core MMAs work on
the rows that have arrived, one accumulator per tap (f32 inputs keep the
``cp.async`` double buffer and f32 FMA).  The reference's padding of ci to
128 and of W to 8 served the TPU's tiling only and is not carried over.

:func:`wgrad_db` takes the kernel for CUDA tensors and the plain version
:func:`wgrad_db_reference` for CPU tensors; on CUDA tensors it launches or
raises.  ``wgrad_db.launches`` counts the launches of the kernel.
"""

from __future__ import annotations

import torch

from ._util import check_wgrad_args, launch_wgrad, make_conv2d_with_wgrad, wgrad_reference

Tensor = torch.Tensor

# the kernel is instantiated for these kernel sizes (one accumulator per tap)
KERNEL_SIZES = (1, 3, 5)


def wgrad_db_reference(xp: Tensor, g: Tensor, k: int) -> Tensor:
    """Plain PyTorch version: per-tap f32 einsum, ``[k, k, Ci, Co]`` f32
    (the same function as ``wgrad_lowch_reference``)."""
    return wgrad_reference(xp, g, k)


def wgrad_db(xp: Tensor, g: Tensor, k: int, device="cuda") -> Tensor:
    """dW of a stride-1 "same" conv from pre-padded input, copies overlapped
    with the products.

    xp: ``[B, H+k−1, W+k−1, Ci]``, g: ``[B, H, W, Co]``, both float32 or
    both bfloat16, contiguous, on ``device`` → ``[k, k, Ci, Co]`` f32.
    """
    device = check_wgrad_args("wgrad_db", xp, g, k, device)
    if device.type == "cpu":
        return wgrad_db_reference(xp, g, k)
    if k not in KERNEL_SIZES:
        raise ValueError(f"wgrad_db: the kernel takes k in {KERNEL_SIZES}, got {k}")
    from . import _build

    out = launch_wgrad(_build.load("wgrad_db"), "db", xp, g, k)
    wgrad_db.launches += 1
    return out


wgrad_db.launches = 0

conv2d_db = make_conv2d_with_wgrad(
    wgrad_db,
    "Dense stride-1 'same' NHWC conv whose dW comes from the wgrad_db kernel.")
