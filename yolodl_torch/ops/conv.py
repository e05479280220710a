"""Convolution blocks: ConvBn2D / Conv2D / DeconvBn2D.

Counterpart of ``yolodl_tpu/ops/conv.py``.  Activations are NCHW and kernels
OIHW, PyTorch's own layout; ``bridge.py`` transposes the reference's HWIO
kernels.  The weight is cast to the activation dtype before the conv, as the
reference casts it (conv.py:48-58), so a bf16 forward runs a bf16 conv.

Both block orders: ``act_bn`` (conv → activation → BN, the NEWSLAB default,
conv_bn_2d.rs:88-101) and ``bn_act`` (conv → BN → activation, darknet).

A DeconvBn2D kernel is kept as the bridge gives every kernel,
``[out, in, k, k]`` (the reference's HWIO ``[k, k, in, out]`` permuted by
``(3, 2, 0, 1)``); ``F.conv_transpose2d`` wants ``[in, out, k, k]``, so
:func:`deconv_bn_apply` passes ``w.transpose(0, 1)``, which is HWIO permuted
by ``(2, 3, 0, 1)``.  ``F.conv_transpose2d`` is the adjoint of the forward
conv itself, so the spatial flip the reference needs for
``lax.conv_transpose`` (conv.py:139-145) is not repeated here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import activations
from ..config import newslab as cfg
from .norm import batch_norm_apply

Tensor = torch.Tensor


def conv2d_apply(
    x: Tensor,
    w: Tensor,
    b: Optional[Tensor] = None,
    stride: int = 1,
    padding: int = 0,
    dilation: int = 1,
    groups: int = 1,
) -> Tensor:
    """Grouped 2-D convolution, symmetric padding in pixels; w is OIHW."""
    out = F.conv2d(x, w.to(x.dtype), None, stride=stride, padding=padding,
                   dilation=dilation, groups=groups)
    if b is not None:
        out = out + b.to(out.dtype).view(1, -1, 1, 1)
    return out


def conv_bn_apply(
    params: Dict[str, Any],
    state: Dict[str, Any],
    x: Tensor,
    layer: cfg.ConvBn2D,
    train: bool,
    shard=None,
) -> Tuple[Tensor, Dict[str, Any]]:
    """conv → activation → BN (``act_bn``) or conv → BN → activation
    (``bn_act``, darknet).

    ``shard`` (``parallel/tp.py`` ``LayerShard``) runs the layer under
    tensor parallelism: ``enter`` takes the full input, the conv and BN run
    on the output channels this rank holds, BN is ``shard.batch_norm``
    (statistics over the data axis), and ``leave`` gathers the channels."""
    groups = layer.g
    if shard is not None:
        x, groups = shard.enter(x, groups)
    out = conv2d_apply(
        x, params["w"], params.get("b"),
        stride=layer.s, padding=layer.padding, dilation=layer.d, groups=groups,
    )
    bn = batch_norm_apply if shard is None else shard.batch_norm
    new_state = state
    if layer.order == "act_bn":
        out = activations.apply(layer.act, out)
        if layer.bn.enabled:
            out, bn_s = bn(params["bn"], state["bn"], out, train)
            new_state = {**state, "bn": bn_s}
    elif layer.order == "bn_act":
        if layer.bn.enabled:
            out, bn_s = bn(params["bn"], state["bn"], out, train)
            new_state = {**state, "bn": bn_s}
        out = activations.apply(layer.act, out)
    else:
        raise ValueError(f"unknown conv order {layer.order!r}")
    if shard is not None:
        out = shard.leave(out)
    return out, new_state


def deconv_bn_apply(
    params: Dict[str, Any],
    state: Dict[str, Any],
    x: Tensor,
    layer: cfg.DeconvBn2D,
    train: bool,
    shard=None,
) -> Tuple[Tensor, Dict[str, Any]]:
    """Transposed conv → activation → BN, with torch's padding and output
    padding: out = (in-1)*s - 2p + d*(k-1) + op + 1 (deconv_bn_2d.rs:164-165);
    the output padding lies on the high side only.  ``shard`` as in
    :func:`conv_bn_apply`."""
    if layer.g != 1:
        raise NotImplementedError(
            "grouped transposed conv is not supported (nor is it in the reference)")
    if shard is not None:
        x, _ = shard.enter(x, 1)
    out = F.conv_transpose2d(
        x, params["w"].transpose(0, 1).to(x.dtype), None, stride=layer.s,
        padding=layer.padding, output_padding=layer.op, dilation=layer.d)
    if "b" in params:
        out = out + params["b"].to(out.dtype).view(1, -1, 1, 1)
    out = activations.apply(layer.act, out)
    new_state = state
    if layer.bn.enabled:
        bn = batch_norm_apply if shard is None else shard.batch_norm
        out, bn_s = bn(params["bn"], state["bn"], out, train)
        new_state = {**state, "bn": bn_s}
    if shard is not None:
        out = shard.leave(out)
    return out, new_state
