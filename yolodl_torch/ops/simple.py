"""Shape-plumbing ops: upsample, max/avg pool, sum, concat, pad.

Counterpart of ``yolodl_tpu/ops/simple.py``, NCHW layout throughout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def upsample2d(x: Tensor, scale: float) -> Tensor:
    """Nearest-neighbour upsample by an integer-effective scale
    (up_sample_2d.rs:18-25)."""
    _, _, h, w = x.shape
    out_h, out_w = int(h * scale), int(w * scale)
    if out_h % h == 0 and out_w % w == 0:
        ry, rx = out_h // h, out_w // w
        return x.repeat_interleave(ry, dim=2).repeat_interleave(rx, dim=3)
    rows = torch.arange(out_h, device=x.device) * h // out_h
    cols = torch.arange(out_w, device=x.device) * w // out_w
    return x[:, :, rows][:, :, :, cols]


def downsample2d(x: Tensor, stride: int) -> Tensor:
    """UpSample2D ByStride reverse=true: strided subsample."""
    return x[:, :, ::stride, ::stride]


def max_pool2d(
    x: Tensor,
    size: int,
    stride_y: int,
    stride_x: int,
    padding: int = 0,
    total_padding: Optional[int] = None,
    pool_kind: str = "max",
) -> Tensor:
    """Max-pool with -inf padding, or darknet's local average pool.

    ``padding`` is symmetric per side (torch style); ``total_padding`` when
    given uses darknet's asymmetric split lo=tp//2, hi=tp-tp//2
    (darknet maxpool_layer semantics, out = (in+tp-size)//stride+1).
    ``F.max_pool2d`` pads only symmetrically, so the padding is applied
    first with ``F.pad``.  ``pool_kind="avg"`` divides each window's sum by
    its count of in-bounds cells (darknet local_avgpool's ``counter``), as
    the reference does with two window sums; ``count_include_pad=False``
    cannot, since its padding is symmetric.
    """
    if pool_kind not in ("max", "avg"):
        raise ValueError(f"unknown pool_kind {pool_kind!r}")
    if total_padding is not None:
        lo, hi = total_padding // 2, total_padding - total_padding // 2
    else:
        lo = hi = padding
    stride = (stride_y, stride_x)
    if pool_kind == "avg":
        pads = (lo, hi, lo, hi)
        summed = F.avg_pool2d(F.pad(x, pads), size, stride, divisor_override=1)
        ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
        counts = F.avg_pool2d(F.pad(ones, pads), size, stride, divisor_override=1)
        return summed / counts
    if lo or hi:
        x = F.pad(x, (lo, hi, lo, hi), value=float("-inf"))
    return F.max_pool2d(x, kernel_size=size, stride=stride)


def sum2d(xs: Sequence[Tensor]) -> Tensor:
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


def concat2d(xs: Sequence[Tensor]) -> Tensor:
    """Channel concat (axis 1 in NCHW)."""
    return torch.cat(list(xs), dim=1)


def dynamic_pad2d(x: Tensor, t: int, b: int, l: int, r: int, kind: str = "zero") -> Tensor:
    """Zero/replication/reflection padding (dynamic_pad_nd.rs:11)."""
    mode = {"zero": "constant", "replication": "replicate", "reflection": "reflect"}[kind]
    return F.pad(x, (l, r, t, b), mode=mode)


def space_to_depth(x: Tensor, block: int = 2) -> Tensor:
    """[B, C, H, W] → [B, b·b·C, H/b, W/b], channel index (dy, dx, c): the
    NCHW form of the reference's NHWC ``space_to_depth`` (ops/spd_stem.py),
    whose channel index is the same."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // block, block, w // block, block)  # b c i dy j dx
    x = x.permute(0, 3, 5, 1, 2, 4)                              # b dy dx c i j
    return x.reshape(b, block * block * c, h // block, w // block)


def depth_to_space(x: Tensor, block: int = 2) -> Tensor:
    """Inverse of :func:`space_to_depth`: [B, b·b·C, H, W] → [B, C, bH, bW]
    (darknet's reorg ``reverse``)."""
    b, c4, h, w = x.shape
    c = c4 // (block * block)
    x = x.reshape(b, block, block, c, h, w)                      # b dy dx c i j
    x = x.permute(0, 3, 4, 1, 5, 2)                              # b c i dy j dx
    return x.reshape(b, c, h * block, w * block)
