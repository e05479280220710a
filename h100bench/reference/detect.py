"""Plain detection path: decode, candidates, greedy NMS, class selection
and the letterbox.

The decode follows darknet's yolo layer (yolo_layer.c get_yolo_box):
x = (sigma(tx) * s - (s - 1) / 2 + col) / W; new_coords=1 takes the box
size as (2 sigma(t))^2 * anchor, else exp(t) * anchor, with anchors in
pixels of the net input.  Cells are flattened per head in (anchor, row,
col) order and the heads concatenated in cfg order.

Candidates: objectness sigma(obj) and confidence sigma(obj) * sigma(class)
must both reach the threshold; each cell offers its best class (the first
of equal maxima); the ``max_dets`` best cells by confidence, ties to the
lower index, enter a greedy NMS over the whole image.  ``diou`` subtracts
(centre distance^2 / enclosing diagonal^2) ^ beta from the IoU (darknet
box.c dia_box_diou).  Class selection then keeps, of the survivors of one
cell, the one of highest confidence.  Everything is float32.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .darknet import Network

EPS = 1e-16


@dataclasses.dataclass
class Dense:
    """The merged heads: boxes (cy, cx, h, w) in ratios of the input."""

    cycxhw: torch.Tensor      # [B, N, 4]
    obj_logit: torch.Tensor   # [B, N]
    class_logit: torch.Tensor  # [B, N, C]
    feature_hw: Tuple[Tuple[int, int], ...]
    anchors: Tuple[Tuple[Tuple[float, float], ...], ...]  # per head, (h, w) ratios


def decode(net: Network, maps: Sequence[torch.Tensor]) -> Dense:
    boxes, objs, classes, anchors = [], [], [], []
    for head, x in zip(net.heads, maps):
        b, _, fh, fw = x.shape
        a, e = len(head.anchors), 5 + head.classes
        t = x.float().reshape(b, a, e, fh, fw).permute(0, 1, 3, 4, 2)
        s = head.scale_xy
        rows = torch.arange(fh, dtype=torch.float32, device=x.device).view(fh, 1)
        cols = torch.arange(fw, dtype=torch.float32, device=x.device).view(1, fw)
        aw = torch.tensor([w for w, _ in head.anchors], device=x.device).view(1, a, 1, 1) / net.size
        ah = torch.tensor([h for _, h in head.anchors], device=x.device).view(1, a, 1, 1) / net.size
        cx = (torch.sigmoid(t[..., 0]) * s - 0.5 * (s - 1.0) + cols) / fw
        cy = (torch.sigmoid(t[..., 1]) * s - 0.5 * (s - 1.0) + rows) / fh
        if head.new_coords:
            w = torch.square(torch.sigmoid(t[..., 2]) * 2.0) * aw
            h = torch.square(torch.sigmoid(t[..., 3]) * 2.0) * ah
        else:
            w = torch.exp(t[..., 2]) * aw
            h = torch.exp(t[..., 3]) * ah
        boxes.append(torch.stack([cy, cx, h, w], -1).reshape(b, -1, 4))
        objs.append(t[..., 4].reshape(b, -1))
        classes.append(t[..., 5:].reshape(b, -1, head.classes))
        anchors.append(tuple((hh / net.size, ww / net.size) for ww, hh in head.anchors))
    return Dense(torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(classes, 1),
                 tuple(h.feature_hw for h in net.heads), tuple(anchors))


def tlbr(cycxhw: torch.Tensor) -> torch.Tensor:
    cy, cx, h, w = cycxhw.unbind(-1)
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1)


def conflicts(boxes: torch.Tensor, iou_thresh: float, kind: str, beta: float) -> torch.Tensor:
    """[B, K, K] bool: box i (column) overlaps the higher-ranked j (row)."""
    t, l, b, r = (boxes[..., i] for i in range(4))
    inter = (torch.clamp(torch.minimum(b[:, :, None], b[:, None]) - torch.maximum(t[:, :, None], t[:, None]), min=0)
             * torch.clamp(torch.minimum(r[:, :, None], r[:, None]) - torch.maximum(l[:, :, None], l[:, None]), min=0))
    area = (b - t) * (r - l)
    score = inter / (area[:, :, None] + area[:, None] - inter + EPS)
    if kind == "diou":
        dy = (t + b)[:, :, None] / 2 - (t + b)[:, None] / 2
        dx = (l + r)[:, :, None] / 2 - (l + r)[:, None] / 2
        eh = torch.maximum(b[:, :, None], b[:, None]) - torch.minimum(t[:, :, None], t[:, None])
        ew = torch.maximum(r[:, :, None], r[:, None]) - torch.minimum(l[:, :, None], l[:, None])
        score = score - torch.pow((dy * dy + dx * dx) / (eh * eh + ew * ew + EPS), beta)
    k = boxes.shape[1]
    upper = torch.ones((k, k), dtype=torch.bool, device=boxes.device).triu(1)
    return (score > iou_thresh) & upper


def confidences(dense: Dense) -> torch.Tensor:
    """[B, N, C]: sigmoid(obj) * sigmoid(class) of every cell and class."""
    return torch.sigmoid(dense.obj_logit)[..., None] * torch.sigmoid(dense.class_logit)


def survivors(dense: Dense, conf_thresh: float, iou_thresh: float, kind: str, beta: float,
              max_dets: int = 512):
    """The candidates ranked by confidence and which of them the greedy
    NMS keeps: (confidence, class, cell, boxes (t, l, b, r), keep), each
    [B, K]."""
    obj = torch.sigmoid(dense.obj_logit)
    conf = confidences(dense)
    passing = (obj[..., None] >= conf_thresh) & (conf >= conf_thresh)
    best, cls = torch.max(torch.where(passing, conf, torch.zeros_like(conf)), dim=-1)
    k = min(max_dets, best.shape[1])
    top, cell = torch.sort(best, dim=-1, descending=True, stable=True)
    top, cell = top[:, :k], cell[:, :k]
    valid = top > 0
    cls = torch.gather(cls, 1, cell)
    boxes = tlbr(torch.gather(dense.cycxhw, 1, cell[..., None].expand(-1, -1, 4)))
    used = int(valid.sum(1).max()) if valid.any() else 0
    keep = torch.zeros_like(valid)
    if used:
        conflict = conflicts(boxes[:, :used], iou_thresh, kind, beta)
        for i in range(used):   # greedy, in rank order
            blocked = (keep[:, :i] & conflict[:, :i, i]).any(1)
            keep[:, i] = valid[:, i] & ~blocked
    return top, cls, cell, boxes, keep


def detections(dense: Dense, conf_thresh: float, iou_thresh: float, kind: str, beta: float,
               max_dets: int = 512) -> List[list]:
    """Per image, the kept detections (class, confidence, (t, l, b, r) in
    ratios of the input, cell), by confidence, highest first."""
    top, cls, cell, boxes, keep = survivors(dense, conf_thresh, iou_thresh, kind, beta, max_dets)
    # class selection: of one cell's survivors the most confident (each
    # cell offers one class here, so this keeps every survivor)
    out = []
    top, cls, cell = top.cpu().numpy(), cls.cpu().numpy(), cell.cpu().numpy()
    keep, boxes = keep.cpu().numpy(), boxes.cpu().numpy()
    for i in range(top.shape[0]):
        best_of_cell = {}
        for j in np.nonzero(keep[i])[0]:
            c = int(cell[i, j])
            if c not in best_of_cell or top[i, j] > top[i, best_of_cell[c]]:
                best_of_cell[c] = j
        rows = sorted(best_of_cell.values(), key=lambda j: (-top[i, j], j))
        out.append([(int(cls[i, j]), float(top[i, j]), tuple(float(v) for v in boxes[i, j]),
                     int(cell[i, j])) for j in rows])
    return out


def letterbox_geometry(src_hw, size: int):
    """(new_h, new_w, off_y, off_x): the content keeps its aspect, rounded
    to whole pixels, centred, the rest padded."""
    src_h, src_w = src_hw
    if size * src_w <= size * src_h:
        new_h, new_w = size, max(1, round(src_w * size / src_h))
    else:
        new_h, new_w = max(1, round(src_h * size / src_w)), size
    return new_h, new_w, (size - new_h) // 2, (size - new_w) // 2


def letterbox(frame: np.ndarray, size: int, pad: int = 128) -> np.ndarray:
    """[H, W, 3] uint8 → [size, size, 3] uint8, bilinear (PIL)."""
    from PIL import Image

    new_h, new_w, off_y, off_x = letterbox_geometry(frame.shape[:2], size)
    out = np.full((size, size, 3), pad, np.uint8)
    if (new_h, new_w) == frame.shape[:2]:
        out[off_y:off_y + new_h, off_x:off_x + new_w] = frame
    else:
        resized = Image.fromarray(frame).resize((new_w, new_h), Image.BILINEAR)
        out[off_y:off_y + new_h, off_x:off_x + new_w] = np.asarray(resized)
    return out

