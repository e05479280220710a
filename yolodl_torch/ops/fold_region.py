"""Width-fold execution regions: low-channel convs run with 4 adjacent
width positions packed into channels.

Counterpart of ``yolodl_tpu/ops/fold_region.py``:

    fold:   [B, C, H, W] → [B, 4·C, H, W/4]     channel index phase·C + c,
                                                  phase = w mod 4
    1×1 conv → block-diagonal 1×1 conv, 4C → 4C'
    3×3 conv → 3×3 conv over folded cells, 4C → 4C' (output phase b, tap v
               reads phase (b+v−1) mod 4 of cell ⌊(b+v−1)/4⌋: every tap lies
               within ±1 folded cell)
    shortcut/sum → elementwise on folded maps
    unfold: the inverse

The rewrite is exact (the folded conv's zero padding is the canonical
conv's), and BN combines the 4 phases' batch statistics
(``ops/spd_stem.py`` ``phase_grouped_bn``).  Weights stay canonical; the
folded kernels are gathered from them inside the forward
(``spd_stem.scatter_weights``), so gradients sum into the canonical
kernels.

In the reference's NHWC the fold is a free reshape.  In the port's NCHW it
is a permute and a copy, ``[B, C, H, W/4, 4] → [B, 4, C, H, W/4]``, and so
is the unfold: the region pays one copy where a map enters it and one where
a node outside it reads a region node's output (``models/builder.py``
unfolds only those).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .. import activations
from ..config import newslab as cfg
from .conv import conv2d_apply
from .spd_stem import phase_grouped_bn, scatter_weights

Tensor = torch.Tensor

FOLD = 4  # the reference's: lane width 128 / smallest efficient channel count 32

# the reference's eligibility margin: a conv is folded when in_c·out_c is at
# most this (its measured crossover on its own hardware)
MAX_CHANNEL_PRODUCT = 2048


def fold_w(x: Tensor, f: int = FOLD) -> Tensor:
    """``[B, C, H, W]`` → ``[B, f·C, H, W/f]``; channel index phase·C + c."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h, w // f, f).permute(0, 4, 1, 2, 3).reshape(b, f * c, h, w // f)


def unfold_w(x: Tensor, f: int = FOLD) -> Tensor:
    """Inverse of :func:`fold_w`."""
    b, cf, h, wf = x.shape
    return x.reshape(b, f, cf // f, h, wf).permute(0, 2, 3, 4, 1).reshape(b, cf // f, h, wf * f)


def fold_conv1x1_weights(w: Tensor, f: int = FOLD) -> Tensor:
    """``[C', C, 1, 1]`` → ``[f·C', f·C, 1, 1]``, block-diagonal over phases."""
    co, c = w.shape[:2]
    return scatter_weights(w, (f * co, f * c, 1, 1),
                           ((p * co, p * c, 0, 0, 0, 0) for p in range(f)))


def fold_conv3x3_weights(w: Tensor, f: int = FOLD) -> Tensor:
    """``[C', C, k, 3]`` (s1, pad 1) → ``[f·C', f·C, k, 3]`` in the folded
    domain: output phase b at folded cell j is canonical position j·f + b;
    its tap v reads position j·f + b + v − 1, which is folded cell
    j + ⌊(b+v−1)/f⌋, phase (b+v−1) mod f."""
    co, c, k = w.shape[:3]

    def taps():
        for b in range(f):
            for v in range(3):
                dj, dx = divmod(b + v - 1, f)
                for u in range(k):
                    yield (b * co, dx * c, u, dj + 1, u, v)

    return scatter_weights(w, (f * co, f * c, k, 3), taps())


def conv_is_foldable(layer: cfg.ModuleCfg, in_c: int) -> bool:
    """The reference's static rule: a shape-preserving dense conv (1×1 or
    3×3, stride 1) with min(in, out)·4 ≥ 128 and in·out ≤
    :data:`MAX_CHANNEL_PRODUCT`."""
    return (
        isinstance(layer, cfg.ConvBn2D)
        and layer.s == 1
        and layer.d == 1
        and layer.g == 1
        and (layer.k, layer.padding) in ((1, 0), (3, 1))
        and min(in_c, layer.c) * FOLD >= 128
        and in_c * layer.c <= MAX_CHANNEL_PRODUCT
    )


def fold_conv_bn_apply(
    params: Dict[str, Any],
    state: Dict[str, Any],
    x: Tensor,
    layer: cfg.ConvBn2D,
    train: bool,
) -> Tuple[Tensor, Dict[str, Any]]:
    """``ops/conv.py`` ``conv_bn_apply`` on W-folded maps, both orders."""
    w = params["w"]
    wf = fold_conv1x1_weights(w) if layer.k == 1 else fold_conv3x3_weights(w)
    b = params.get("b")
    out = conv2d_apply(x, wf, None if b is None else b.repeat(FOLD),
                       padding=0 if layer.k == 1 else 1)

    new_state = state

    def bn(h):
        out_bn, bn_s = phase_grouped_bn(params["bn"], state["bn"], h, train, phases=FOLD)
        return out_bn, {**state, "bn": bn_s}

    if layer.order == "act_bn":
        out = activations.apply(layer.act, out)
        if layer.bn.enabled:
            out, new_state = bn(out)
    elif layer.order == "bn_act":
        if layer.bn.enabled:
            out, new_state = bn(out)
        out = activations.apply(layer.act, out)
    else:
        raise ValueError(f"unknown conv order {layer.order!r}")
    return out, new_state
