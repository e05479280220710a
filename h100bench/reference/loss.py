"""Plain YOLO loss and Adam, as the measured program states them.

The loss is the YOLO reference's at its default options: targets matched
to the cell of their centre and to the neighbours within half a cell
(``rect4``), on anchors whose height and width ratio to the target is at
most 4; one target a cell, the nearest centre first, ties to the lowest
candidate.  It sums 0.05 * (1 - DIoU) of the matched boxes, 0.58 * the BCE
of the matched cells' class logits against one-hot targets smoothed by
0.01, and 1.0 * the BCE of every cell's objectness logit against 1 at the
matched cells and 0 elsewhere; each term a mean over the entries it
covers.  Adam: the update m_hat / (sqrt(v_hat) + eps) at a constant rate.
Everything is float32.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .detect import Dense

EPS = 1e-16
SNAP = 0.5
ANCHOR_RATIO = 4.0
IOU_WEIGHT, CLS_WEIGHT, OBJ_WEIGHT = 0.05, 0.58, 1.0
CLS_SMOOTH = 0.01


def softplus(x):
    return torch.log1p(torch.exp(-torch.abs(x))) + torch.clamp(x, min=0.0)


def bce_with_logits(logits, targets):
    return softplus(logits) - logits * targets


def _masked_mean(values, mask):
    mask = mask.to(values.dtype)
    return torch.sum(values * mask) / torch.clamp(torch.sum(mask), min=1.0)


def match(dense: Dense, gt: torch.Tensor, gt_mask: torch.Tensor):
    """(flat [B, C], target index [B, C], valid [B, C]) over every
    candidate (head, target, neighbour, anchor)."""
    b, m, _ = gt.shape
    dev = gt.device
    cy, cx, th, tw = gt.unbind(-1)
    ok = gt_mask & (th > 0) & (tw > 0)
    flats, valids, dists, idxs = [], [], [], []
    begin = 0
    for (fh, fw), anchors in zip(dense.feature_hw, dense.anchors):
        a = len(anchors)
        gy, gx = cy * fh, cx * fw
        row, col = torch.floor(gy), torch.floor(gx)
        fy, fx = gy - row, gx - col
        off_r = torch.tensor([0, -1, 0, 1, 0], dtype=torch.float32, device=dev)
        off_c = torch.tensor([0, 0, -1, 0, 1], dtype=torch.float32, device=dev)
        near = torch.stack([torch.ones_like(fy, dtype=torch.bool), fy < SNAP, fx < SNAP,
                            fy > 1 - SNAP, fx > 1 - SNAP], -1)
        r2, c2 = row[..., None] + off_r, col[..., None] + off_c
        inside = (r2 >= 0) & (r2 < fh) & (c2 >= 0) & (c2 < fw)
        ah = torch.tensor([h for h, _ in anchors], device=dev)
        aw = torch.tensor([w for _, w in anchors], device=dev)
        rh, rw = th[..., None] / ah, tw[..., None] / aw
        ratio = torch.maximum(torch.maximum(rh, 1 / torch.clamp(rh, min=EPS)),
                              torch.maximum(rw, 1 / torch.clamp(rw, min=EPS)))
        valid = ok[..., None, None] & (near & inside)[..., None] & (ratio <= ANCHOR_RATIO)[..., None, :]
        ri = torch.clamp(r2, 0, fh - 1).long()[..., None]
        ci = torch.clamp(c2, 0, fw - 1).long()[..., None]
        flat = begin + (torch.arange(a, device=dev) * fh + ri) * fw + ci
        dist = (cy[..., None] - (r2 + 0.5) / fh) ** 2 + (cx[..., None] - (c2 + 0.5) / fw) ** 2
        flats.append(flat.reshape(b, -1))
        valids.append(valid.reshape(b, -1))
        dists.append(dist[..., None].expand(flat.shape).reshape(b, -1))
        idxs.append(torch.arange(m, device=dev).view(1, m, 1, 1).expand(flat.shape).reshape(b, -1))
        begin += a * fh * fw
    flat, valid = torch.cat(flats, 1), torch.cat(valids, 1)
    dist, idx = torch.cat(dists, 1), torch.cat(idxs, 1)
    n, c = begin, flat.shape[1]
    masked = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    best = torch.full((b, n), float("inf"), device=dev).scatter_reduce(1, flat, masked, "amin")
    nearest = valid & (masked <= torch.gather(best, 1, flat))
    order = torch.arange(c, device=dev).expand(b, c)
    first = torch.full((b, n), c, device=dev).scatter_reduce(
        1, flat, torch.where(nearest, order, torch.full_like(order, c)), "amin")
    return flat, idx, nearest & (order == torch.gather(first, 1, flat))


def diou(a, b):
    at = torch.cat([a[..., :2] - a[..., 2:] / 2, a[..., :2] + a[..., 2:] / 2], -1)
    bt = torch.cat([b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2], -1)
    inter = (torch.clamp(torch.minimum(at[..., 2], bt[..., 2]) - torch.maximum(at[..., 0], bt[..., 0]), min=0)
             * torch.clamp(torch.minimum(at[..., 3], bt[..., 3]) - torch.maximum(at[..., 1], bt[..., 1]), min=0))
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter + EPS
    eh = torch.maximum(at[..., 2], bt[..., 2]) - torch.minimum(at[..., 0], bt[..., 0])
    ew = torch.maximum(at[..., 3], bt[..., 3]) - torch.minimum(at[..., 1], bt[..., 1])
    centre = (a[..., 0] - b[..., 0]) ** 2 + (a[..., 1] - b[..., 1]) ** 2
    return inter / union - centre / (eh ** 2 + ew ** 2 + EPS)


def yolo_loss(dense: Dense, gt: torch.Tensor, gt_class: torch.Tensor,
              gt_mask: torch.Tensor) -> torch.Tensor:
    flat, idx, valid = match(dense, gt, gt_mask)
    rows = torch.arange(flat.shape[0], device=flat.device)[:, None]
    pred_box = dense.cycxhw[rows, flat]
    pred_cls = dense.class_logit[rows, flat]
    target_box = torch.gather(gt, 1, idx[..., None].expand(-1, -1, 4))
    target_cls = torch.gather(gt_class.long(), 1, idx)
    iou_loss = _masked_mean(1.0 - diou(pred_box, target_box), valid)
    c = dense.class_logit.shape[-1]
    pos = 1.0 - 0.5 * CLS_SMOOTH
    onehot = (target_cls[..., None] == torch.arange(c, device=flat.device)).float()
    cls_loss = _masked_mean(bce_with_logits(pred_cls, onehot * (2 * pos - 1) + 1 - pos),
                            valid[..., None].expand(pred_cls.shape))
    n = dense.obj_logit.shape[1]
    slot = torch.where(valid, flat, torch.full_like(flat, n))
    target_obj = torch.zeros((flat.shape[0], n + 1), device=flat.device).scatter(
        1, slot, valid.float())[:, :n]
    obj_loss = torch.mean(bce_with_logits(dense.obj_logit, target_obj))
    return IOU_WEIGHT * iou_loss + CLS_WEIGHT * cls_loss + OBJ_WEIGHT * obj_loss


class Adam:
    """m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p -= lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)."""

    def __init__(self, params: List[torch.Tensor], lr: float, b1: float, b2: float, eps: float):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, b1, b2, eps
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


def leaves(params: Dict[int, Dict[str, torch.Tensor]], trainable: Tuple[str, ...] = ("w", "b", "scale", "bias")
           ) -> List[Tuple[str, torch.Tensor]]:
    """(name, tensor) of every trained leaf, named as ``<layer>.<leaf>``."""
    return [(f"{i}.{k}", p[k]) for i, p in sorted(params.items()) for k in trainable if k in p]
