"""The numbers that decide ``correct``, and their limits.

Detections (serving, bulk).  bfloat16 moves a head's logits by parts in a
hundred against float32, so where the reference's decision is nearly tied
(two classes, a confidence at the threshold, an IoU at the NMS threshold,
the identical cells of the letterbox's flat padding) the program may
rightly decide the other way.  The comparison therefore judges amounts
at the program's own cells, and coverage, not each decision.
``score_gap_p75`` is the 75th percentile, over the program's detections,
of |program confidence - the reference's confidence of the program's class
at the cell whose reference box lies nearest (L1) to the program's box|: a
wrong class, score, cell or box decode shows there.  Where several cells'
boxes lie within ``TIED_PX`` of the nearest (boxes clipped alike to a
frame's edge), the program's detection may have come from any of them, and
the closest of their confidences counts.  ``missed_share``: the
reference's detections are matched, most confident first, to the
program's detection in the same image of highest IoU, if that reaches 0.5,
each used once, whatever their classes; it is the excess over the
confidence threshold of the detections left unmatched on either side, over
the excess of all detections on both.  A box mapped to the wrong place, an
image swapped, a detection dropped or a suppression undone shows there,
while a detection at the threshold weighs nothing.  IoU takes a box at
least one pixel high and wide, so that boxes clipped to a frame's edge
still match.

Training: the program's losses of the first three steps, each leaf's
first gradient (from Adam's first moment after one step) and each leaf's
change over the three steps, against the reference's from the same
weights and rows.  A gap of norms is |‖program‖ - ‖reference‖| over the
larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's are left out of the change: Adam moves them by round-off alone.
The cells compare ``grad_median_gap`` (the median leaf's relative gap of
the first gradient's norms), ``grad_total_gap`` (the gap of the whole
first gradient's norm) and ``delta_total_gap`` (the gap of the norm of
the whole change over three steps); the worst leaf's gaps and the losses'
are read and reported, not compared (PERF.md gives why).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Sequence, Tuple

import numpy as np

Det = Tuple[int, float, Tuple[float, float, float, float]]   # class, confidence, x0 y0 x1 y1
MATCH_IOU = 0.5
TIED_PX = 2.0   # cells whose boxes lie this close to the nearest are all "the program's cell"
STILL_GRAD = 1e-3


def _iou(a, b) -> float:
    a = _at_least_a_pixel(a)
    b = _at_least_a_pixel(b)
    iw = min(a[2], b[2]) - max(a[0], b[0])
    ih = min(a[3], b[3]) - max(a[1], b[1])
    if iw <= 0 or ih <= 0:
        return 0.0
    inter = iw * ih
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union


def _at_least_a_pixel(box):
    x0, y0, x1, y1 = box
    cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
    hw, hh = max(x1 - x0, 1.0) / 2, max(y1 - y0, 1.0) / 2
    return cx - hw, cy - hh, cx + hw, cy + hh


class DetectionTally:
    """Adds up the comparison of one image's detections at a time."""

    def __init__(self, conf_thresh: float):
        self.thresh = conf_thresh
        self.gaps: List[float] = []
        self.missed = 0.0
        self.mass = 0.0
        self.images = 0

    def add(self, program: Sequence[Det], reference: Sequence, cell_boxes, cell_conf) -> None:
        """``reference``: (class, confidence, box, cell) of the reference's
        detections; ``cell_boxes`` [N, 4] (x0, y0, x1, y1) and ``cell_conf``
        [N, C]: the reference's box and confidences of every cell, in the
        frame the detections are given in (torch tensors)."""
        import torch

        self.images += 1
        if program:
            boxes = torch.tensor([d[2] for d in program], dtype=cell_boxes.dtype,
                                 device=cell_boxes.device)
            dist = torch.cdist(boxes, cell_boxes, p=1)
            near = dist <= dist.min(1, keepdim=True).values + TIED_PX
            for i, (cls, score, _) in enumerate(program):
                if not 0 <= cls < cell_conf.shape[1]:
                    self.gaps.append(1.0)
                    continue
                gaps = torch.abs(cell_conf[near[i], cls] - score)
                self.gaps.append(float(gaps.min()))
        free = list(range(len(program)))
        for _, conf, box, _ in sorted(reference, key=lambda d: -d[1]):
            best, best_iou = None, MATCH_IOU
            for j in free:
                iou = _iou(program[j][2], box)
                if iou >= best_iou:
                    best, best_iou = j, iou
            if best is None:
                self.missed += conf - self.thresh
            else:
                free.remove(best)
        self.missed += sum(program[j][1] - self.thresh for j in free)
        self.mass += sum(d[1] - self.thresh for d in program) + \
            sum(d[1] - self.thresh for d in reference)

    def numbers(self) -> Dict[str, float]:
        gaps = sorted(self.gaps)
        return {"score_gap_p50": float(np.percentile(gaps, 50)) if gaps else 0.0,
                "score_gap_p75": float(np.percentile(gaps, 75)) if gaps else 0.0,
                "score_gap_p95": float(np.percentile(gaps, 95)) if gaps else 0.0,
                "score_gap_max": gaps[-1] if gaps else 0.0,
                "missed_share": self.missed / self.mass if self.mass > 0 else 0.0,
                "detections": len(gaps)}


def norm_gaps(program: Dict[str, float], reference: Dict[str, float],
              keep=None) -> Tuple[float, str]:
    """(worst gap of norms, its leaf) over the leaves of ``reference``
    (those ``keep`` names, when given)."""
    median = statistics.median(reference.values())
    worst, where = 0.0, ""
    for leaf, ref in reference.items():
        if keep is not None and leaf not in keep:
            continue
        gap = abs(program[leaf] - ref) / max(ref, median)
        if gap > worst:
            worst, where = gap, leaf
    return worst, where


def _total(norms: Dict[str, float], keep=None) -> float:
    return sum(v * v for k, v in norms.items() if keep is None or k in keep) ** 0.5


def _median_gap(program, reference, keep=None) -> float:
    return statistics.median(abs(program[k] - v) / v for k, v in reference.items()
                             if (keep is None or k in keep) and v > 0)


def training_numbers(program: Dict, reference: Dict) -> Dict[str, object]:
    """``program``/``reference``: {"losses": [3], "grad": {leaf: norm},
    "delta": {leaf: norm}}."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(program["losses"], reference["losses"])]
    median_grad = statistics.median(reference["grad"].values())
    moving = {k for k, v in reference["grad"].items() if v >= STILL_GRAD * median_grad}
    grad_gap, grad_leaf = norm_gaps(program["grad"], reference["grad"])
    delta_gap, delta_leaf = norm_gaps(program["delta"], reference["delta"], moving)
    g_ref, d_ref = _total(reference["grad"]), _total(reference["delta"], moving)
    return {"loss1_gap": gaps[0], "loss_gap": max(gaps), "loss_gaps": gaps,
            "grad_gap": grad_gap, "delta_gap": delta_gap,
            "grad_total_gap": abs(_total(program["grad"]) - g_ref) / g_ref,
            "delta_total_gap": abs(_total(program["delta"], moving) - d_ref) / d_ref,
            "grad_median_gap": _median_gap(program["grad"], reference["grad"]),
            "delta_median_gap": _median_gap(program["delta"], reference["delta"], moving),
            "grad_leaf": grad_leaf, "delta_leaf": delta_leaf,
            "still_leaves": len(reference["grad"]) - len(moving)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
