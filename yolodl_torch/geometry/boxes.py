"""Box algebra on tensors: the part of ``yolodl_tpu/geometry/boxes.py`` that
serving needs.

Boxes are plain tensors whose last axis has size 4 — ``[..., (cy, cx, h, w)]``
or ``[..., (t, l, b, r)]``.  The IoU/GIoU/DIoU/CIoU family the loss
differentiates comes with the training slice.
"""

from __future__ import annotations

import torch

# Matches tch-goodies/src/utils.rs:5.
EPSILON = 1e-16


def cycxhw_to_tlbr(boxes: torch.Tensor) -> torch.Tensor:
    """[..., (cy,cx,h,w)] → [..., (t,l,b,r)]."""
    cy, cx, h, w = boxes.unbind(-1)
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], dim=-1)


def intersect_area(tlbr_a: torch.Tensor, tlbr_b: torch.Tensor) -> torch.Tensor:
    """Intersection area of two TLBR boxes (tlbr.rs:81-106)."""
    max_t = torch.maximum(tlbr_a[..., 0], tlbr_b[..., 0])
    max_l = torch.maximum(tlbr_a[..., 1], tlbr_b[..., 1])
    min_b = torch.minimum(tlbr_a[..., 2], tlbr_b[..., 2])
    min_r = torch.minimum(tlbr_a[..., 3], tlbr_b[..., 3])
    inner_h = torch.clamp(min_b - max_t, min=0.0)
    inner_w = torch.clamp(min_r - max_l, min=0.0)
    return inner_h * inner_w


def box_iou_pairwise(tlbr_a: torch.Tensor, tlbr_b: torch.Tensor) -> torch.Tensor:
    """Full IoU matrix between two TLBR box sets: [N,4] × [M,4] → [N,M]."""
    inter = intersect_area(tlbr_a[:, None, :], tlbr_b[None, :, :])
    area_a = (tlbr_a[:, 2] - tlbr_a[:, 0]) * (tlbr_a[:, 3] - tlbr_a[:, 1])
    area_b = (tlbr_b[:, 2] - tlbr_b[:, 0]) * (tlbr_b[:, 3] - tlbr_b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter + EPSILON
    return inter / union
