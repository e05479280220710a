"""Darknet-flavoured batch normalization as tensor functions.

Counterpart of ``yolodl_tpu/ops/norm.py``: eps 1e-4, momentum 0.03, biased
batch variance to normalize, unbiased variance for the running update.  The
formula is copied rather than delegated to ``F.batch_norm``, so the port
rounds as the reference does: the variance is one-pass ``E[x²] − mean²`` in
f32, clamped at 0, and ``inv``/``shift`` are computed in f32 and cast to the
activation dtype before ``x * inv + shift``.  A float64 activation keeps its
statistics in float64 (the reference has no float64; the port's float64
runs check the parallel steps' arithmetic to the last bits).

Layout: activations NCHW; stats and params are [C] vectors for axis 1.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

Tensor = torch.Tensor

DEFAULT_EPS = 1e-4
DEFAULT_MOMENTUM = 0.03


def _stats_dtype(x: Tensor) -> torch.dtype:
    """f32 for the statistics of bf16, f16 and f32 activations; f64 for f64."""
    return torch.promote_types(x.dtype, torch.float32)


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
        x32 = x.to(_stats_dtype(x))
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


def batch_norm_apply_sync(
    params: Dict[str, Tensor],
    state: Dict[str, Tensor],
    x: Tensor,
    train: bool,
    group,
    eps: float = DEFAULT_EPS,
    momentum: float = DEFAULT_MOMENTUM,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Batch norm whose training statistics are averaged over ``group``, the
    ranks that hold the other rows of the batch (a ``parallel/mesh.py``
    ``DataMesh``; None or one rank is :func:`batch_norm_apply`): each rank's
    mean and ``E[x²]`` of its own rows, averaged over the group (equal row
    counts), give the whole batch's statistics, so the ranks normalize as
    one device does.  The average is ``mesh.all_reduce_mean``, whose
    backward is the mean of the ranks' gradients.  The variance is the
    one-pass formula clamped at 0, and the unbiased factor takes the
    global count.  Eval mode is :func:`batch_norm_apply`."""
    if not train or group is None or group.world_size == 1:
        return batch_norm_apply(params, state, x, train, eps, momentum)
    from ..parallel.mesh import all_reduce_mean

    c = x.shape[1]
    reduce_dims = [d for d in range(x.dim()) if d != 1]
    view = [1, c] + [1] * (x.dim() - 2)
    x32 = x.to(_stats_dtype(x))
    stats = torch.stack([torch.mean(x32, dim=reduce_dims),
                         torch.mean(torch.square(x32), dim=reduce_dims)])
    mean, meansq = all_reduce_mean(stats, group)
    var = torch.clamp(meansq - torch.square(mean), min=0.0)
    n = (x.numel() // c) * group.world_size
    unbiased = var * (n / max(n - 1, 1))
    new_state = {
        "mean": (1.0 - momentum) * state["mean"] + momentum * mean,
        "var": (1.0 - momentum) * state["var"] + momentum * unbiased,
    }
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


def fold_batch_norm(
    params: Dict[str, Tensor],
    state: Dict[str, Tensor],
    conv_w: Tensor,
    conv_b: Optional[Tensor],
    eps: float = DEFAULT_EPS,
) -> Tuple[Tensor, Tensor]:
    """Fold BN into the preceding conv for inference (reference `denormalize`).

    ``conv_w`` is the port's ``[out, in, k, k]``; returns (folded_w,
    folded_b) such that ``conv(x, fw) + fb == bn(conv(x, w) + b)`` in eval
    mode.  Valid only for darknet's conv→BN→act order (the NEWSLAB default
    conv→act→BN cannot fold).  ``models/fold.py`` ``fold_conv_bn_arrays``
    is its numpy form for the file-level fold.
    """
    inv = torch.rsqrt(state["var"] + eps)
    scale = params.get("scale")
    if scale is not None:
        inv = inv * scale
    bias = params.get("bias")
    if bias is None:
        bias = torch.zeros_like(state["mean"])
    folded_w = conv_w * inv.view(-1, *([1] * (conv_w.dim() - 1)))  # over O (dim 0)
    b0 = conv_b if conv_b is not None else 0.0
    folded_b = (b0 - state["mean"]) * inv + bias
    return folded_w, folded_b


def _affine(out: Tensor, params: Dict[str, Tensor]) -> Tensor:
    view = [1, out.shape[1]] + [1] * (out.dim() - 2)
    scale = params.get("scale")
    bias = params.get("bias")
    if scale is not None:
        out = out * scale.view(view)
    if bias is not None:
        out = out + bias.view(view)
    return out


def instance_norm_apply(params: Dict[str, Tensor], x: Tensor, eps: float = 1e-5) -> Tensor:
    """Instance norm over the spatial dims of NCHW (tch-modules
    instance_norm.rs equivalent; stateless inference form)."""
    mean = torch.mean(x, dim=(2, 3), keepdim=True)
    var = torch.var(x, dim=(2, 3), keepdim=True, unbiased=False)
    return _affine((x - mean) * torch.rsqrt(var + eps), params)


def group_norm_apply(params: Dict[str, Tensor], x: Tensor, num_groups: int,
                     eps: float = 1e-5) -> Tensor:
    """Group norm over NCHW (tch-modules group_norm.rs equivalent): the
    channels split into ``num_groups`` consecutive groups, as the
    reference's NHWC ``reshape(b, h, w, groups, c // groups)`` does."""
    b, c, h, w = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    g = x.reshape(b, num_groups, c // num_groups, h, w)
    mean = torch.mean(g, dim=(2, 3, 4), keepdim=True)
    var = torch.var(g, dim=(2, 3, 4), keepdim=True, unbiased=False)
    return _affine(((g - mean) * torch.rsqrt(var + eps)).reshape(b, c, h, w), params)
