"""Vectorized YOLOv5-style target↔anchor matcher.

Counterpart of ``yolodl_tpu/loss/matcher.py`` (CyCxHWMatcher of
``yolo-dl/src/loss/pred_target_matching.rs``): per GT × per head, snap to
the center cell plus neighbor cells whose center fraction passes 0.5
(Rect2: top/left only; Rect4: all four), filter anchors by h/w ratio ≤
anchor_scale_thresh, and dedupe cell collisions keeping the nearest-center
GT.

The same fixed-shape lattice as the reference: ground truth padded to
``max_gt`` boxes per image with a validity mask, all (gt × neighbor ×
anchor) candidates materialized as ``[B, C]`` (C = max_gt · (5 or 6) ·
Σ anchors) in the reference's candidate order, and the nearest-center dedupe
as two scatter-min passes over flat cell ids (``scatter_reduce`` "amin" on
an ``inf``-filled and a ``C``-filled tensor), so ties go to the lowest
candidate index and ``valid`` is identical to the reference's.
"""

from __future__ import annotations

import dataclasses
import typing

import torch

from ..ops.detect import MergedDetection
from ..utils.timing import spanned

Tensor = torch.Tensor

SNAP_THRESH = 0.5  # pred_target_matching.rs:56


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Defaults: Rect4, thresh 4.0 (CyCxHWMatcherInit, :17-24).

    ``shape_iou_thresh`` is darknet's [yolo] iou_thresh adoption: anchors
    whose wh-only shape-IoU vs the GT exceeds it also match at the GT's
    center cell, bypassing the ratio gate.  None = off; a scalar applies to
    every head; a tuple is per head in merge order."""

    match_grid: str = "rect4"  # "rect2" | "rect4"
    anchor_scale_thresh: float = 4.0
    shape_iou_thresh: typing.Union[None, float, tuple] = None

    def __post_init__(self):
        if self.anchor_scale_thresh < 1.0:
            raise ValueError("anchor_scale_thresh must be >= 1")
        if self.match_grid not in ("rect2", "rect4"):
            raise ValueError(f"unknown match_grid {self.match_grid!r}")


@dataclasses.dataclass
class MatchingOutput:
    """Fixed-shape matching lattice (MatchingOutput parity, :271-284)."""

    flat: Tensor       # [B, C] int32 — flat cell index into the merged axis
    gt_cycxhw: Tensor  # [B, C, 4] matched target box (ratio units)
    gt_class: Tensor   # [B, C] int32
    valid: Tensor      # [B, C] bool

    def num_matched(self) -> Tensor:
        return torch.sum(self.valid.to(torch.int32))

    def gather_pred(self, prediction: MergedDetection):
        """Predicted boxes/logits at the matched cells (index_by_flats
        parity, merged_dense_detection.rs:280): one batched index per
        field → ([B, C, 4], [B, C], [B, C, num_classes])."""
        idx = self.flat.long()
        rows = torch.arange(idx.shape[0], device=idx.device)[:, None]
        return (prediction.cycxhw[rows, idx], prediction.obj_logit[rows, idx],
                prediction.class_logit[rows, idx])


@spanned("yolodl.loss.match")
def match_targets(
    prediction: MergedDetection,
    gt_cycxhw: Tensor,  # [B, M, 4] ratio units
    gt_class: Tensor,   # [B, M] int
    gt_mask: Tensor,    # [B, M] bool
    config: MatcherConfig = MatcherConfig(),
) -> MatchingOutput:
    infos = prediction.infos
    b, m, _ = gt_cycxhw.shape
    n = prediction.num_flats
    dev = gt_cycxhw.device
    rect4 = config.match_grid == "rect4"
    thresh = config.anchor_scale_thresh

    cy, cx = gt_cycxhw[..., 0], gt_cycxhw[..., 1]
    th, tw = gt_cycxhw[..., 2], gt_cycxhw[..., 3]
    # zero-sized boxes are skipped (pred_target_matching.rs:64-69)
    size_ok = (th > 0.0) & (tw > 0.0)
    base_ok = gt_mask.bool() & size_ok  # [B, M]

    flats, valids, dists = [], [], []
    block_widths = []  # candidate-block width per head (5, or 6 with the shape gate)
    for k, info in enumerate(infos):
        fh, fw = info.feature_h, info.feature_w
        a = len(info.anchors)
        thr_k = config.shape_iou_thresh
        if isinstance(thr_k, tuple):
            if len(thr_k) != len(infos):
                raise ValueError(
                    f"per-head shape_iou_thresh has {len(thr_k)} entries "
                    f"for {len(infos)} detect heads")
            thr_k = thr_k[k]
        use_shape = thr_k is not None and float(thr_k) < 1.0

        gy = cy * fh
        gx = cx * fw
        row = torch.floor(gy)
        col = torch.floor(gx)
        fy = gy - row
        fx = gx - col

        # neighbor offsets: center, top, left, bottom, right (:101-112)
        off_r = torch.tensor([0, -1, 0, 1, 0], dtype=torch.float32, device=dev)
        off_c = torch.tensor([0, 0, -1, 0, 1], dtype=torch.float32, device=dev)
        ones = torch.ones_like(fy, dtype=torch.bool)
        zeros = torch.zeros_like(ones)
        cond = torch.stack(
            [
                ones,
                fy < SNAP_THRESH,
                fx < SNAP_THRESH,
                (fy > 1.0 - SNAP_THRESH) if rect4 else zeros,
                (fx > 1.0 - SNAP_THRESH) if rect4 else zeros,
            ],
            dim=-1,
        )  # [B, M, 5]

        r2 = row[..., None] + off_r  # [B, M, 5]
        c2 = col[..., None] + off_c
        in_bounds = (r2 >= 0) & (r2 < fh) & (c2 >= 0) & (c2 < fw)

        # anchor size gate (:139-150)
        ah = torch.tensor([x for x, _ in info.anchors], dtype=torch.float32, device=dev)
        aw = torch.tensor([x for _, x in info.anchors], dtype=torch.float32, device=dev)
        rh = th[..., None] / ah  # [B, M, A]
        rw = tw[..., None] / aw
        eps = rh.new_tensor(1e-16)
        ratio = torch.maximum(
            torch.maximum(rh, 1.0 / torch.maximum(rh, eps)),
            torch.maximum(rw, 1.0 / torch.maximum(rw, eps)),
        )
        anchor_ok = ratio <= thresh  # [B, M, A]

        valid = (
            base_ok[..., None, None]
            & (cond & in_bounds)[..., :, None]
            & anchor_ok[..., None, :]
        )  # [B, M, 5, A]

        r2i = torch.clamp(r2, 0, fh - 1).to(torch.int32)
        c2i = torch.clamp(c2, 0, fw - 1).to(torch.int32)
        anchor_idx = torch.arange(a, dtype=torch.int32, device=dev)
        flat = (
            info.flat_begin
            + (anchor_idx[None, None, None, :] * fh + r2i[..., None]) * fw
            + c2i[..., None]
        )  # [B, M, 5, A]

        # nearest-center distance for dedupe (:195-205)
        pcy = (r2 + 0.5) / fh
        pcx = (c2 + 0.5) / fw
        dist = (cy[..., None] - pcy) ** 2 + (cx[..., None] - pcx) ** 2  # [B, M, 5]
        dist = dist[..., None].expand(flat.shape)

        if use_shape:
            # darknet iou_thresh adoption: anchors passing the wh-only
            # shape-IoU gate match at the CENTER cell, ratio gate bypassed
            inter = torch.minimum(tw[..., None], aw) * torch.minimum(th[..., None], ah)
            union = tw[..., None] * th[..., None] + aw * ah - inter
            safe_union = torch.where(union == 0, torch.ones_like(union), union)
            shape_iou = torch.where(
                (inter == 0) | (union == 0), torch.zeros_like(inter), inter / safe_union)
            extra_valid = (
                base_ok[..., None, None]
                & in_bounds[..., 0:1, None]          # center-cell bounds
                & (shape_iou > float(thr_k))[..., None, :]
            )  # [B, M, 1, A]
            valid = torch.cat([valid, extra_valid], dim=2)
            flat = torch.cat([flat, flat[..., 0:1, :]], dim=2)
            dist = torch.cat([dist, dist[..., 0:1, :]], dim=2)

        block_widths.append(valid.shape[2])
        flats.append(flat.reshape(b, -1))
        valids.append(valid.reshape(b, -1))
        dists.append(dist.reshape(b, -1))

    flat = torch.cat(flats, dim=1)    # [B, C]
    valid = torch.cat(valids, dim=1)  # [B, C]
    dist = torch.cat(dists, dim=1)    # [B, C]
    c_total = flat.shape[1]

    # gt index per candidate (head blocks each expand [M, width, A])
    gt_idx = torch.cat([
        torch.arange(m, dtype=torch.int64, device=dev)[None, :, None, None]
        .expand(b, m, width, len(info.anchors)).reshape(b, -1)
        for info, width in zip(infos, block_widths)
    ], dim=1)  # [B, C]

    # dedupe: keep the nearest-center candidate per cell (:180-217), ties to
    # the lowest candidate index
    flat_l = flat.long()
    masked = torch.where(valid, dist, torch.full_like(dist, float("inf")))
    best = torch.full((b, n), float("inf"), dtype=dist.dtype, device=dev).scatter_reduce(
        1, flat_l, masked, reduce="amin", include_self=True)
    is_best = valid & (masked <= torch.gather(best, 1, flat_l))
    order = torch.arange(c_total, dtype=torch.int64, device=dev).expand(b, c_total)
    first = torch.full((b, n), c_total, dtype=torch.int64, device=dev).scatter_reduce(
        1, flat_l, torch.where(is_best, order, torch.full_like(order, c_total)),
        reduce="amin", include_self=True)
    final_valid = is_best & (order == torch.gather(first, 1, flat_l))

    boxes = torch.gather(gt_cycxhw, 1, gt_idx[..., None].expand(b, c_total, 4))
    classes = torch.gather(gt_class.to(torch.int32), 1, gt_idx)

    return MatchingOutput(
        flat=flat.to(torch.int32),
        gt_cycxhw=boxes,
        gt_class=classes,
        valid=final_valid,
    )
