"""Darknet-flavoured batch normalization as tensor functions.

Counterpart of ``yolodl_tpu/ops/norm.py``: eps 1e-4, momentum 0.03, biased
batch variance to normalize, unbiased variance for the running update.  The
formula is copied rather than delegated to ``F.batch_norm``, so the port
rounds as the reference does: the variance is one-pass ``E[x²] − mean²`` in
f32, clamped at 0, and ``inv``/``shift`` are computed in f32 and cast to the
activation dtype before ``x * inv + shift``.

Layout: activations NCHW; stats and params are [C] vectors for axis 1.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor

DEFAULT_EPS = 1e-4
DEFAULT_MOMENTUM = 0.03


def batch_norm_apply(
    params: Dict[str, Tensor],
    state: Dict[str, Tensor],
    x: Tensor,
    train: bool,
    eps: float = DEFAULT_EPS,
    momentum: float = DEFAULT_MOMENTUM,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Normalize over every axis but the channel one (axis 1).

    Returns (output, new_state); in eval mode the state is returned as it is.
    """
    c = x.shape[1]
    reduce_dims = [d for d in range(x.dim()) if d != 1]
    view = [1, c] + [1] * (x.dim() - 2)

    if train:
        x32 = x.to(torch.float32)
        batch_mean = torch.mean(x32, dim=reduce_dims)
        batch_var = torch.mean(torch.square(x32), dim=reduce_dims) - torch.square(batch_mean)
        batch_var = torch.clamp(batch_var, min=0.0)
        n = x.numel() // c
        unbiased = batch_var * (n / max(n - 1, 1))
        new_state = {
            "mean": (1.0 - momentum) * state["mean"] + momentum * batch_mean,
            "var": (1.0 - momentum) * state["var"] + momentum * unbiased,
        }
        mean, var = batch_mean, batch_var
    else:
        new_state = state
        mean, var = state["mean"], state["var"]

    inv = torch.rsqrt(var + eps)
    scale = params.get("scale")
    bias = params.get("bias")
    if scale is not None:
        inv = inv * scale
    shift = -mean * inv
    if bias is not None:
        shift = shift + bias
    return (x * inv.to(x.dtype).view(view) + shift.to(x.dtype).view(view)), new_state


def clamp_running_var(
    state: Dict[str, Tensor], var_min: Optional[float], var_max: Optional[float]
) -> Dict[str, Tensor]:
    """Clamp the running variance (dark_batch_norm.rs:148-172), applied after
    every optimizer step in the training loop."""
    if var_min is None and var_max is None:
        return state
    var = state["var"]
    if var_min is not None:
        var = torch.clamp(var, min=var_min)
    if var_max is not None:
        var = torch.clamp(var, max=var_max)
    return {**state, "var": var}
