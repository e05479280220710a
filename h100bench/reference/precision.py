"""The reference's precision: float32 with TF32 off while it runs, and the
control's float8.

``full_precision`` switches TF32 off for cuDNN and matmuls, through the
older ``allow_tf32`` settings and the newer ``fp32_precision`` ones (where
the older are set to False, the newer read "none", which need not mean
IEEE), and restores them after.  ``fp8`` rounds a tensor (one scale for the tensor;
a conv weight one scale an output channel) to float8 e4m3, the scale
mapping the largest magnitude to 448, the format's largest value: the
control rounds so every conv input and weight and every tensor a layer
hands on, as the program in bfloat16 rounds its tensors to bfloat16.  Its
backward rounds each gradient it passes to float8 e5m2 (largest 57344),
as fp8 training does, as the program's backward rounds to bfloat16.
"""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0          # float8 e4m3, forward tensors
GRAD_FP8_MAX = 57344.0   # float8 e5m2, gradients


def _precision_flags():
    """(object, attribute) of the settings that allow TF32: the newer
    ``fp32_precision`` ones where this PyTorch has them, and the older."""
    flags = [(torch.backends.cudnn, "allow_tf32"), (torch.backends.cuda.matmul, "allow_tf32")]
    for owner in (getattr(torch.backends.cudnn, "conv", None), torch.backends.cuda.matmul):
        if owner is not None and hasattr(owner, "fp32_precision"):
            flags.append((owner, "fp32_precision"))
    return flags


@contextlib.contextmanager
def full_precision():
    flags = _precision_flags()
    saved = [getattr(owner, name) for owner, name in flags]
    for owner, name in flags:
        setattr(owner, name, False if name == "allow_tf32" else "ieee")
    try:
        yield
    finally:
        for (owner, name), value in zip(flags, saved):
            setattr(owner, name, value)


def _round(x: torch.Tensor, dtype, largest: float, per_channel: bool) -> torch.Tensor:
    dims = tuple(range(1, x.dim())) if per_channel else tuple(range(x.dim()))
    amax = torch.amax(torch.abs(x), dim=dims, keepdim=True)
    scale = torch.where(amax > 0, largest / amax, torch.ones_like(amax))
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, per_channel):
        return _round(x, torch.float8_e4m3fn, FP8_MAX, per_channel)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, torch.float8_e5m2, GRAD_FP8_MAX, False), None


def fp8(x: torch.Tensor, per_channel: bool = False) -> torch.Tensor:
    return _Fp8.apply(x, per_channel)
