"""Tensor utility extensions.

Counterpart of ``yolodl_tpu/utils/tensor_ext.py``: the ``TensorExt``
helpers of ``tch-goodies/src/tensor.rs`` that are not first-class
elsewhere: ``crop_by_ratio`` (:716), ``multi_softmax``,
``cartesian_product_nd``, ``sum_tensors`` / ``weighted_mean_tensors``
(:44-80), the NaN/finite checks (:10-12, 283-289), and ``resize2d_exact``
(the stretch resize, :254-261), which resizes as ``jax.image.resize``
"bilinear" does.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def crop_by_ratio(image: Tensor, t: float, b: float, l: float, r: float) -> Tensor:
    """Crop [..., H, W] by 0-1 ratio bounds (tensor.rs:716)."""
    if not (0.0 <= t < b <= 1.0 and 0.0 <= l < r <= 1.0):
        raise ValueError(f"invalid crop ratios {(t, b, l, r)}")
    h, w = image.shape[-2], image.shape[-1]
    return image[..., int(t * h):int(b * h), int(l * w):int(r * w)]


def resize2d_exact(image: Tensor, out_h: int, out_w: int) -> Tensor:
    """Stretch-resize [..., H, W] with bilinear sampling (resize2d_exact):
    half-pixel centres, and a triangle filter widened by the scale along an
    axis that shrinks (antialias), as ``jax.image.resize`` does."""
    lead, (h, w) = image.shape[:-2], image.shape[-2:]
    flat = image.reshape(-1, 1, h, w)
    out = F.interpolate(flat, size=(out_h, out_w), mode="bilinear",
                        align_corners=False, antialias=True)
    return out.reshape(*lead, out_h, out_w)


def multi_softmax(x: Tensor, num_groups: int, axis: int = -1) -> Tensor:
    """Softmax over equal-sized groups along an axis (darknet grouped softmax)."""
    size = x.shape[axis]
    if size % num_groups:
        raise ValueError(f"axis size {size} not divisible by {num_groups}")
    moved = torch.movedim(x, axis, -1)
    grouped = moved.reshape(*moved.shape[:-1], num_groups, size // num_groups)
    out = torch.softmax(grouped, dim=-1).reshape(moved.shape)
    return torch.movedim(out, -1, axis)


def cartesian_product_nd(*arrays: Tensor) -> Tensor:
    """All index combinations of 1-D tensors → [prod(len), n] (tensor.rs helper)."""
    grids = torch.meshgrid(*arrays, indexing="ij")
    return torch.stack([g.reshape(-1) for g in grids], dim=-1)


def sum_tensors(tensors: Sequence[Tensor]) -> Tensor:
    if not tensors:
        raise ValueError("sum_tensors needs at least one tensor")
    out = tensors[0]
    for t in tensors[1:]:
        out = out + t
    return out


def weighted_mean_tensors(pairs: Sequence[Tuple[Tensor, float]]) -> Tensor:
    """Σ wᵢ·tᵢ / Σ wᵢ (tensor.rs:44-80)."""
    if not pairs:
        raise ValueError("weighted_mean_tensors needs at least one pair")
    total_w = sum(w for _, w in pairs)
    if total_w == 0:
        raise ValueError("weighted_mean_tensors weights sum to zero")
    out = pairs[0][0] * (pairs[0][1] / total_w)
    for t, w in pairs[1:]:
        out = out + t * (w / total_w)
    return out


def has_nan(x: Tensor) -> Tensor:
    return torch.isnan(x).any()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def all_finite(tree) -> Tensor:
    """True iff every tensor of a nested dict/list/tuple is finite (the
    train-loop guard); a 0-d bool tensor."""
    ok = torch.tensor(True)
    for leaf in _leaves(tree):
        ok = ok.to(leaf.device) & torch.isfinite(leaf).all()
    return ok
