"""Composite CSP blocks: DarkCsp2D and SppCsp2D.

Counterpart of ``yolodl_tpu/ops/blocks.py`` (``tch-modules/src/
{dark_csp_2d,spp_csp_2d}.rs``), NCHW:

- DarkCsp2D: skip 1×1 ‖ (1×1 → repeat×[1×1, 3×3 (+residual)] → 1×1),
  channel concat, merge 1×1.  mid_c = int(in_c · c_mul).
- SppCsp2D: 1×1 reduce, skip 1×1 ‖ (1×1 → 3×3 → 1×1 → the **sum** of
  parallel max-pools over the kernel set k (not a concat,
  spp_csp_2d.rs:121-132) → 1×1 → 3×3), concat, 1×1 out.

Every sub-conv is a ConvBn2D with the block's ``bn`` config and the default
Mish.  ``params``/``state`` hold one entry per sub-layer name, as the
reference's trees do (``skip_conv``, ``repeat_{i}_first``, …).  ``shards``
maps a sub-layer name to its tensor-parallel ``LayerShard``
(``ops/conv.py`` ``conv_bn_apply``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from ..config import newslab as cfg
from .conv import conv_bn_apply
from .simple import concat2d, max_pool2d

Tensor = torch.Tensor


def _sub(c: int, k: int, bn: cfg.BatchNormConfig) -> cfg.ConvBn2D:
    return cfg.ConvBn2D(c=c, k=k, bn=bn)


def dark_csp_convs(layer: cfg.DarkCsp2D, in_c: int) -> List[Tuple[str, int, int, int]]:
    """(name, in channels, out channels, kernel) of every sub-conv, in the
    order the reference's ``dark_csp_init`` creates them."""
    mid_c = int(in_c * layer.c_mul)
    convs = [("skip_conv", in_c, mid_c, 1), ("merge_conv", mid_c * 2, layer.c, 1),
             ("before_repeat_conv", in_c, mid_c, 1), ("after_repeat_conv", mid_c, mid_c, 1)]
    for i in range(layer.repeat):
        convs += [(f"repeat_{i}_first", mid_c, mid_c, 1), (f"repeat_{i}_second", mid_c, mid_c, 3)]
    return convs


_SPP_CONVS = (("spp_conv_1", 1), ("spp_conv_2", 3), ("spp_conv_3", 1),
              ("spp_conv_4", 1), ("spp_conv_5", 3))


def spp_csp_convs(layer: cfg.SppCsp2D, in_c: int) -> List[Tuple[str, int, int, int]]:
    """(name, in channels, out channels, kernel) of every sub-conv, in the
    order the reference's ``spp_csp_init`` creates them."""
    mid_c = int(in_c * layer.c_mul)
    return ([("first_conv", in_c, mid_c, 1), ("last_conv", mid_c * 2, layer.c, 1),
             ("skip_conv", mid_c, mid_c, 1)]
            + [(name, mid_c, mid_c, k) for name, k in _SPP_CONVS])


def _runner(params, state, train, new_state, bn, shards):
    def run(name, inp, out_c, k):
        out, s = conv_bn_apply(params[name], state.get(name, {}), inp, _sub(out_c, k, bn), train,
                               shard=shards.get(name) if shards else None)
        if s:
            new_state[name] = s
        return out
    return run


def dark_csp_apply(
    params: Dict[str, Any],
    state: Dict[str, Any],
    x: Tensor,
    layer: cfg.DarkCsp2D,
    in_c: int,
    train: bool,
    shards: Optional[Dict[str, Any]] = None,
) -> Tuple[Tensor, Dict[str, Any]]:
    mid_c = int(in_c * layer.c_mul)
    new_state: Dict[str, Any] = dict(state)
    run = _runner(params, state, train, new_state, layer.bn, shards)

    skip = run("skip_conv", x, mid_c, 1)
    h = run("before_repeat_conv", x, mid_c, 1)
    for i in range(layer.repeat):
        y = run(f"repeat_{i}_first", h, mid_c, 1)
        y = run(f"repeat_{i}_second", y, mid_c, 3)
        h = h + y if layer.shortcut else y
    h = run("after_repeat_conv", h, mid_c, 1)
    out = run("merge_conv", concat2d([skip, h]), layer.c, 1)
    return out, new_state


def spp_csp_apply(
    params: Dict[str, Any],
    state: Dict[str, Any],
    x: Tensor,
    layer: cfg.SppCsp2D,
    in_c: int,
    train: bool,
    shards: Optional[Dict[str, Any]] = None,
) -> Tuple[Tensor, Dict[str, Any]]:
    mid_c = int(in_c * layer.c_mul)
    new_state: Dict[str, Any] = dict(state)
    run = _runner(params, state, train, new_state, layer.bn, shards)

    first = run("first_conv", x, mid_c, 1)
    skip = run("skip_conv", first, mid_c, 1)
    h = run("spp_conv_1", first, mid_c, 1)
    h = run("spp_conv_2", h, mid_c, 3)
    h = run("spp_conv_3", h, mid_c, 1)
    pooled = None
    for k in layer.k:
        p = max_pool2d(h, size=k, stride_y=1, stride_x=1, padding=k // 2)
        pooled = p if pooled is None else pooled + p
    h = run("spp_conv_4", pooled, mid_c, 1)
    h = run("spp_conv_5", h, mid_c, 3)
    out = run("last_conv", concat2d([skip, h]), layer.c, 1)
    return out, new_state
