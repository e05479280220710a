"""Differentiable box algebra on tensors.

Counterpart of ``yolodl_tpu/geometry/boxes.py``.  Boxes are plain tensors
whose last axis has size 4 — ``[..., (cy, cx, h, w)]`` or
``[..., (t, l, b, r)]`` — with broadcastable leading dimensions.  The
operations and their order are the reference's, so values and gradients
agree with ``jax.grad``: ``torch.maximum``/``torch.minimum`` split the
gradient at ties as ``jnp.maximum`` does (``torch.clamp`` would not), and
CIoU's aspect-ratio coefficient is detached as the reference's
``stop_gradient`` is.
"""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

# Matches tch-goodies/src/utils.rs:5.
EPSILON = 1e-16


def _relu(x: Tensor) -> Tensor:
    """``jnp.maximum(x, 0.0)``, with its half gradient at 0."""
    return torch.maximum(x, x.new_zeros(()))


def cycxhw_to_tlbr(boxes: Tensor) -> Tensor:
    """[..., (cy,cx,h,w)] → [..., (t,l,b,r)]."""
    cy, cx, h, w = boxes.unbind(-1)
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], dim=-1)


def tlbr_to_cycxhw(boxes: Tensor) -> Tensor:
    """[..., (t,l,b,r)] → [..., (cy,cx,h,w)]."""
    t, l, b, r = boxes.unbind(-1)
    return torch.stack([(t + b) / 2, (l + r) / 2, b - t, r - l], dim=-1)


def area(cycxhw: Tensor) -> Tensor:
    """Box area, shape [...]."""
    return cycxhw[..., 2] * cycxhw[..., 3]


def intersect_area(tlbr_a: Tensor, tlbr_b: Tensor) -> Tensor:
    """Intersection area of two TLBR boxes (tlbr.rs:81-106)."""
    max_t = torch.maximum(tlbr_a[..., 0], tlbr_b[..., 0])
    max_l = torch.maximum(tlbr_a[..., 1], tlbr_b[..., 1])
    min_b = torch.minimum(tlbr_a[..., 2], tlbr_b[..., 2])
    min_r = torch.minimum(tlbr_a[..., 3], tlbr_b[..., 3])
    inner_h = _relu(min_b - max_t)
    inner_w = _relu(min_r - max_l)
    return inner_h * inner_w


def closure_tlbr(tlbr_a: Tensor, tlbr_b: Tensor) -> Tensor:
    """Smallest TLBR box enclosing both (tlbr.rs:109-134)."""
    return torch.stack(
        [
            torch.minimum(tlbr_a[..., 0], tlbr_b[..., 0]),
            torch.minimum(tlbr_a[..., 1], tlbr_b[..., 1]),
            torch.maximum(tlbr_a[..., 2], tlbr_b[..., 2]),
            torch.maximum(tlbr_a[..., 3], tlbr_b[..., 3]),
        ],
        dim=-1,
    )


def _iou_parts(a_cycxhw: Tensor, b_cycxhw: Tensor):
    ta = cycxhw_to_tlbr(a_cycxhw)
    tb = cycxhw_to_tlbr(b_cycxhw)
    inter = intersect_area(ta, tb)
    union = area(a_cycxhw) + area(b_cycxhw) - inter + EPSILON
    return ta, tb, inter, union


def iou(a: Tensor, b: Tensor) -> Tensor:
    """Elementwise IoU of CyCxHW boxes (cycxhw.rs:67-73)."""
    _, _, inter, union = _iou_parts(a, b)
    return inter / union


def giou(a: Tensor, b: Tensor) -> Tensor:
    """Generalized IoU (cycxhw.rs:75-83)."""
    ta, tb, inter, union = _iou_parts(a, b)
    closure = closure_tlbr(ta, tb)
    closure_area = (closure[..., 2] - closure[..., 0]) * (closure[..., 3] - closure[..., 1])
    return inter / union - (closure_area - union) / (closure_area + EPSILON)


def _center_terms(a: Tensor, b: Tensor):
    ta = cycxhw_to_tlbr(a)
    tb = cycxhw_to_tlbr(b)
    closure = closure_tlbr(ta, tb)
    closure_h = closure[..., 2] - closure[..., 0]
    closure_w = closure[..., 3] - closure[..., 1]
    diagonal_sq = closure_h**2 + closure_w**2 + EPSILON
    center_dist_sq = (a[..., 0] - b[..., 0]) ** 2 + (a[..., 1] - b[..., 1]) ** 2
    return diagonal_sq, center_dist_sq


def diou(a: Tensor, b: Tensor) -> Tensor:
    """Distance-IoU (cycxhw.rs:86-99)."""
    diagonal_sq, center_dist_sq = _center_terms(a, b)
    return iou(a, b) - center_dist_sq / diagonal_sq


def ciou(a: Tensor, b: Tensor) -> Tensor:
    """Complete-IoU with the detached aspect-ratio coefficient (cycxhw.rs:102-121)."""
    iou_score = iou(a, b)
    diagonal_sq, center_dist_sq = _center_terms(a, b)
    pred_angle = torch.atan2(a[..., 2], a[..., 3])
    target_angle = torch.atan2(b[..., 2], b[..., 3])
    shape_loss = (pred_angle - target_angle) ** 2 * 4.0 / (math.pi**2)
    shape_coef = (shape_loss / (1.0 - iou_score + shape_loss + EPSILON)).detach()
    return iou_score - center_dist_sq / diagonal_sq + shape_coef * shape_loss


def hausdorff_distance(a: Tensor, b: Tensor) -> Tensor:
    """Hausdorff distance between CyCxHW boxes (tlbr.rs:137-177)."""
    ta = cycxhw_to_tlbr(a)
    tb = cycxhw_to_tlbr(b)
    dt = tb[..., 0] - ta[..., 0]
    dl = tb[..., 1] - ta[..., 1]
    db = ta[..., 2] - tb[..., 2]
    dr = ta[..., 3] - tb[..., 3]

    dt_l, dl_l, db_l, dr_l = _relu(dt), _relu(dl), _relu(db), _relu(dr)
    dt_r, dl_r, db_r, dr_r = _relu(-dt), _relu(-dl), _relu(-db), _relu(-dr)

    sq = torch.maximum(dt_l**2 + dl_l**2, dt_l**2 + dr_l**2)
    sq = torch.maximum(sq, db_l**2 + dl_l**2)
    sq = torch.maximum(sq, db_l**2 + dr_l**2)
    sq = torch.maximum(sq, dt_r**2 + dl_r**2)
    sq = torch.maximum(sq, dt_r**2 + dr_r**2)
    sq = torch.maximum(sq, db_r**2 + dl_r**2)
    sq = torch.maximum(sq, db_r**2 + dr_r**2)
    return torch.sqrt(sq)


def box_iou_pairwise(tlbr_a: Tensor, tlbr_b: Tensor) -> Tensor:
    """Full IoU matrix between two TLBR box sets: [N,4] × [M,4] → [N,M]."""
    inter = intersect_area(tlbr_a[:, None, :], tlbr_b[None, :, :])
    area_a = (tlbr_a[:, 2] - tlbr_a[:, 0]) * (tlbr_a[:, 3] - tlbr_a[:, 1])
    area_b = (tlbr_b[:, 2] - tlbr_b[:, 0]) * (tlbr_b[:, 3] - tlbr_b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter + EPSILON
    return inter / union


IOU_KINDS = {
    "iou": iou,
    "giou": giou,
    "diou": diou,
    "ciou": ciou,
}


def iou_score(kind: str, a: Tensor, b: Tensor) -> Tensor:
    """Dispatch over the IoU family by name (BoxMetric in loss config)."""
    try:
        return IOU_KINDS[kind.lower()](a, b)
    except KeyError:
        raise KeyError(f"unknown IoU kind {kind!r}; expected one of {sorted(IOU_KINDS)}")
