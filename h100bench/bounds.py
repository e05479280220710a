"""The least time the chip could take for the postprocess stage on given
inputs, as a frozen copy of the measured program's smoke-test arithmetic
(``conflict_bound``, ``keep_bound``) with an IoU of its own.

Bytes, at the HBM's rate: the dense heads read once; the NMS candidates'
boxes (and their int64 groups) read once and the [B, K, ceil(K/32)] int32
conflict words written once; the words and the valid flags read once and
the keep flags written once; the kept output (boxes and confidences in the
heads' dtype, int64 classes and cells, a bool flag) written once.
Operations, at the f32 rate, counted for this data: over the pairs j < i
of one group, 9 for every pair (the intersection), 5 more where the boxes
intersect (the union, the division, the comparison) and, for DIoU, 18
more where the IoU passes the threshold; 3 a box (its area) and 4 more
for DIoU (its centre).  The stage's bound is the larger of the two times.
"""

from __future__ import annotations

import torch

from .peaks import F32_FLOPS, HBM_BYTES_PER_S


def pairwise_iou(tlbr: torch.Tensor) -> torch.Tensor:
    t = tlbr.float()
    inter = (torch.clamp(torch.minimum(t[..., :, None, 2], t[..., None, :, 2])
                         - torch.maximum(t[..., :, None, 0], t[..., None, :, 0]), min=0)
             * torch.clamp(torch.minimum(t[..., :, None, 3], t[..., None, :, 3])
                           - torch.maximum(t[..., :, None, 1], t[..., None, :, 1]), min=0))
    area = (t[..., 2] - t[..., 0]) * (t[..., 3] - t[..., 1])
    return inter / (area[..., :, None] + area[..., None, :] - inter + 1e-16)


def postprocess_bound_s(dense_bytes: int, tlbr: torch.Tensor, thr: float, kind: str,
                        box_itemsize: int) -> tuple:
    """(seconds, "bytes" or "operations") for one batch whose NMS
    candidates are ``tlbr`` [B, K, 4] (one group: suppression over the
    whole image)."""
    b, k, _ = tlbr.shape
    score = pairwise_iou(tlbr)
    pairs = torch.ones((k, k), dtype=torch.bool, device=tlbr.device).triu(1).expand(b, k, k)
    ops = 9 * int(pairs.sum()) + 5 * int((pairs & (score > 0)).sum()) + 3 * b * k
    if kind == "diou":
        ops += 18 * int((pairs & (score > thr)).sum()) + 4 * b * k
    words = (k + 31) // 32
    conflict_bytes = b * k * (4 * box_itemsize + 8) + b * k * words * 4
    keep_bytes = b * k * words * 4 + 2 * b * k
    out_bytes = b * k * (5 * box_itemsize + 8 + 8 + 1)
    t_bytes = (dense_bytes + conflict_bytes + keep_bytes + out_bytes) / HBM_BYTES_PER_S
    t_ops = ops / F32_FLOPS
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
