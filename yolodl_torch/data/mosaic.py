"""Mosaic 4-image mixing.

Equivalent capability to ``yolo-dl/src/processor/mosaic_processor.rs``:
random pivot in [margin, 1−margin]², crop the 4 images to the quadrant
ranges, concatenate into one canvas, merge boxes with min-size and
min-cropping-ratio filters (:59-152, crop at 300-350).

Counterpart of ``yolodl_tpu/data/mosaic.py``, numpy only: every mixer draws
from the caller's ``np.random.Generator`` in the reference's order, so the
same generator state gives the same pixels and boxes.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np

from .records import DataRecord


@dataclasses.dataclass
class MosaicMixer:
    mosaic_margin: float = 0.25
    min_bbox_size: float = 0.0           # ratio units
    min_bbox_cropping_ratio: float = 0.0

    def __post_init__(self):
        if not 0.0 <= self.mosaic_margin <= 0.5:
            raise ValueError("mosaic_margin must be in [0, 0.5]")

    def sample(self, rng: np.random.Generator) -> Tuple[float, float]:
        pivot_row = rng.uniform(self.mosaic_margin, 1.0 - self.mosaic_margin)
        pivot_col = rng.uniform(self.mosaic_margin, 1.0 - self.mosaic_margin)
        return pivot_row, pivot_col

    def mix_boxes(
        self,
        records: Sequence[DataRecord],
        pivot_row: float,
        pivot_col: float,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Label side of the mosaic (shared with the device-augment path,
        which composes the pixel quadrants on the accelerator)."""
        # quadrant ranges (t, b, l, r) in ratio units (mosaic_processor.rs:84-90)
        ranges = [
            (0.0, pivot_row, 0.0, pivot_col),
            (0.0, pivot_row, pivot_col, 1.0),
            (pivot_row, 1.0, 0.0, pivot_col),
            (pivot_row, 1.0, pivot_col, 1.0),
        ]
        all_boxes, all_classes = [], []
        for record, (rt, rb, rl, rr) in zip(records, ranges):
            boxes, classes = _crop_boxes(
                record.boxes, record.classes, rt, rb, rl, rr,
                self.min_bbox_size, self.min_bbox_cropping_ratio,
            )
            all_boxes.append(boxes)
            all_classes.append(classes)
        return (
            np.concatenate(all_boxes, axis=0) if all_boxes else np.zeros((0, 4)),
            np.concatenate(all_classes, axis=0) if all_classes else np.zeros((0,)),
        )

    def __call__(self, records: Sequence[DataRecord], rng: np.random.Generator) -> DataRecord:
        if len(records) != 4:
            raise ValueError("expect exactly 4 images")
        shapes = {r.image.shape for r in records}
        if len(shapes) != 1:
            raise ValueError("images must have identical shape")
        c, h, w = records[0].image.shape

        pivot_row, pivot_col = self.sample(rng)

        pr = round(pivot_row * h)
        pc = round(pivot_col * w)
        pixel_ranges = [
            (0, pr, 0, pc),
            (0, pr, pc, w),
            (pr, h, 0, pc),
            (pr, h, pc, w),
        ]
        crops = [
            record.image[:, pt:pb, pl:prt]
            for record, (pt, pb, pl, prt) in zip(records, pixel_ranges)
        ]
        top = np.concatenate([crops[0], crops[1]], axis=2)
        bottom = np.concatenate([crops[2], crops[3]], axis=2)
        merged = np.concatenate([top, bottom], axis=1)

        boxes, classes = self.mix_boxes(records, pivot_row, pivot_col)
        return DataRecord(image=merged, boxes=boxes, classes=classes)


def _crop_boxes(
    boxes: np.ndarray,
    classes: np.ndarray,
    t: float, b: float, l: float, r: float,
    min_size: float,
    min_crop_ratio: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Intersect ratio-unit boxes with the crop window; the crop is NOT
    re-normalized (the canvas keeps the original unit frame, since the
    quadrants tile the unit square exactly)."""
    if len(boxes) == 0:
        return boxes.reshape(0, 4), classes
    cy, cx, bh, bw = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    bt, bb = cy - bh / 2, cy + bh / 2
    bl, br = cx - bw / 2, cx + bw / 2

    new_t = np.clip(bt, t, b)
    new_b = np.clip(bb, t, b)
    new_l = np.clip(bl, l, r)
    new_r = np.clip(br, l, r)
    nh, nw = new_b - new_t, new_r - new_l

    keep = (nh > 0) & (nw > 0)
    if min_size > 0:
        keep &= (nh >= min_size) & (nw >= min_size)
    if min_crop_ratio > 0:
        orig_area = bh * bw
        with np.errstate(invalid="ignore", divide="ignore"):
            ratio = np.where(orig_area > 0, (nh * nw) / orig_area, 0.0)
        keep &= ratio >= min_crop_ratio

    out = np.stack(
        [(new_t + new_b) / 2, (new_l + new_r) / 2, nh, nw], axis=-1
    ).astype(np.float32)
    return out[keep], classes[keep]


@dataclasses.dataclass
class MixUpMixer:
    """MixUp blending of two records.

    The reference declares mixup in its config but does not implement it
    (training_stream.rs:548-555 warns and keeps the first record); this is a
    real implementation: image = λ·A + (1−λ)·B with λ ~ Beta(α, α), labels =
    union of both.
    """

    alpha: float = 8.0

    def sample(self, rng: np.random.Generator) -> float:
        return float(rng.beta(self.alpha, self.alpha))

    def __call__(self, a: DataRecord, b: DataRecord, rng: np.random.Generator) -> DataRecord:
        if a.image.shape != b.image.shape:
            raise ValueError("images must have identical shape")
        lam = self.sample(rng)
        image = (lam * a.image + (1.0 - lam) * b.image).astype(np.float32)
        return DataRecord(
            image=image,
            boxes=np.concatenate([a.boxes, b.boxes], axis=0),
            classes=np.concatenate([a.classes, b.classes], axis=0),
        )


@dataclasses.dataclass
class CutMixMixer:
    """CutMix: paste a random crop of B into A (also unimplemented in the
    reference).  A-boxes mostly covered by the pasted region are dropped;
    B-boxes are clipped to the region."""

    min_ratio: float = 0.3
    max_ratio: float = 0.6
    min_bbox_keep_ratio: float = 0.25

    def sample(self, rng: np.random.Generator) -> Tuple[float, float, float, float]:
        """Ratio bounds (t, b, l, r) of the pasted window."""
        rh = rng.uniform(self.min_ratio, self.max_ratio)
        rw = rng.uniform(self.min_ratio, self.max_ratio)
        t = rng.uniform(0.0, 1.0 - rh)
        l = rng.uniform(0.0, 1.0 - rw)
        return (t, t + rh, l, l + rw)

    def mix_boxes(
        self, a: DataRecord, b: DataRecord, bnd: Tuple[float, float, float, float]
    ) -> Tuple[np.ndarray, np.ndarray]:
        # keep A boxes whose remaining visible area is large enough
        keep_a, cls_a = self._filter_a(a.boxes, a.classes, bnd)
        # clip B boxes into the pasted window
        keep_b, cls_b = _crop_boxes(
            b.boxes, b.classes, bnd[0], bnd[1], bnd[2], bnd[3],
            min_size=0.0, min_crop_ratio=self.min_bbox_keep_ratio,
        )
        return (np.concatenate([keep_a, keep_b], axis=0),
                np.concatenate([cls_a, cls_b], axis=0))

    def __call__(self, a: DataRecord, b: DataRecord, rng: np.random.Generator) -> DataRecord:
        if a.image.shape != b.image.shape:
            raise ValueError("images must have identical shape")
        _, h, w = a.image.shape
        bnd = self.sample(rng)
        t, b_, l, r = bnd

        image = a.image.copy()
        pt, pb = round(t * h), round(b_ * h)
        pl, pr = round(l * w), round(r * w)
        image[:, pt:pb, pl:pr] = b.image[:, pt:pb, pl:pr]

        boxes, classes = self.mix_boxes(a, b, bnd)
        return DataRecord(image=image, boxes=boxes, classes=classes)

    def _filter_a(self, boxes, classes, bnd):
        if len(boxes) == 0:
            return boxes.reshape(0, 4), classes
        t, b_, l, r = bnd
        cy, cx, bh, bw = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
        bt, bb = cy - bh / 2, cy + bh / 2
        bl, br = cx - bw / 2, cx + bw / 2
        inter_h = np.clip(np.minimum(bb, b_) - np.maximum(bt, t), 0, None)
        inter_w = np.clip(np.minimum(br, r) - np.maximum(bl, l), 0, None)
        covered = inter_h * inter_w
        area = bh * bw
        with np.errstate(invalid="ignore", divide="ignore"):
            vis = np.where(area > 0, 1.0 - covered / area, 0.0)
        keep = vis >= self.min_bbox_keep_ratio
        return boxes[keep], classes[keep]
