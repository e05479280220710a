"""COCO-style interpolated average precision.

Equivalent capability to ``yolo-dl/src/loss/average_precision.rs`` (the
101-point COCO integration strategy, ``new_coco`` at :68-70; precision
envelope at :87-138) and the ``pred_gt_matching.rs`` detection/GT pairing.

Documented divergence (README "divergences" list): TP assignment here is
pycocotools' confidence-descending greedy first-match-wins.  The
reference's ``compute_by_detections`` (average_precision.rs:157-199)
instead groups detections by a pre-assigned GT and marks only the
highest-IoU detection per GT as TP regardless of confidence — with one GT
and two detections (conf .9/IoU .6 vs conf .5/IoU .8) it credits the
low-confidence one, producing a different PR curve.  We follow the COCO
protocol (the ecosystem standard the reference's own docs cite), not the
reference's variant.

Host-side numpy: evaluation is per-epoch, not per-step, so it does not need
to live in the jitted path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Detection:
    image_id: int
    class_id: int
    confidence: float
    tlbr: Tuple[float, float, float, float]
    #: box area in ORIGINAL-image pixels for COCO size buckets; < 0 means
    #: "derive from tlbr" (whatever units tlbr is in)
    area: float = -1.0


@dataclasses.dataclass(frozen=True)
class GroundTruth:
    image_id: int
    class_id: int
    tlbr: Tuple[float, float, float, float]
    area: float = -1.0


def _iou(a, b) -> float:
    t = max(a[0], b[0])
    l = max(a[1], b[1])
    bb = min(a[2], b[2])
    r = min(a[3], b[3])
    inter = max(bb - t, 0.0) * max(r - l, 0.0)
    area_a = (a[2] - a[0]) * (a[3] - a[1])
    area_b = (b[2] - b[0]) * (b[3] - b[1])
    union = area_a + area_b - inter + 1e-16
    return inter / union


def match_detections(
    detections: Sequence[Detection],
    ground_truths: Sequence[GroundTruth],
    iou_threshold: float,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sort by confidence desc; greedily mark TP/FP (first match wins).

    Returns (tp_flags, confidences, num_gt) for one class.

    Confidence ties break image-major (ascending ``image_id``, original
    order within an image) — the order pycocotools' per-image evaluation +
    mergesort accumulate produces, and the order the shared-IoU-matrix
    fast path (:func:`_class_buckets` + stable conf argsort) scans in.
    """
    pre = sorted(range(len(detections)),
                 key=lambda i: detections[i].image_id)
    order = sorted(pre, key=lambda i: -detections[i].confidence)
    gt_by_image: Dict[int, List[int]] = {}
    for gi, gt in enumerate(ground_truths):
        gt_by_image.setdefault(gt.image_id, []).append(gi)
    used = set()

    tp = np.zeros(len(detections), bool)
    conf = np.zeros(len(detections), np.float64)
    for rank, di in enumerate(order):
        det = detections[di]
        conf[rank] = det.confidence
        best_iou, best_gi = 0.0, None
        for gi in gt_by_image.get(det.image_id, ()):
            if gi in used:
                continue
            iou = _iou(det.tlbr, ground_truths[gi].tlbr)
            # >= : among equal-IoU GTs the LAST scanned wins, matching
            # pycocotools' `if iou < best: continue` update rule (and
            # _greedy_tp / _match_with_ignores here)
            if iou >= best_iou:
                best_iou, best_gi = iou, gi
        if best_gi is not None and best_iou >= iou_threshold and best_iou > 0.0:
            used.add(best_gi)
            tp[rank] = True
    return tp, conf, len(ground_truths)


def interpolated_ap(
    tp: np.ndarray, num_gt: int, num_points: int = 101
) -> float:
    """N-point interpolated AP over the precision envelope
    (average_precision.rs:87-155)."""
    if num_gt == 0:
        return 0.0
    if len(tp) == 0:
        return 0.0
    cum_tp = np.cumsum(tp)
    recall = cum_tp / num_gt
    precision = cum_tp / np.arange(1, len(tp) + 1)

    # precision envelope: running max from the right
    envelope = np.maximum.accumulate(precision[::-1])[::-1]

    points = np.linspace(0.0, 1.0, num_points)
    interpolated = np.zeros_like(points)
    for i, r in enumerate(points):
        mask = recall >= r
        interpolated[i] = envelope[mask].max() if mask.any() else 0.0
    return float(interpolated.mean())


def _class_buckets(dets, gts):
    """Per-image (conf-desc confidences, [D, G] IoU matrix) pairs for ONE
    class — IoUs computed once and shared across thresholds."""
    by_d: Dict[int, list] = {}
    by_g: Dict[int, list] = {}
    for d in dets:
        by_d.setdefault(d.image_id, []).append(d)
    for g in gts:
        by_g.setdefault(g.image_id, []).append(g)
    out = []
    for img in sorted(set(by_d) | set(by_g)):
        ds = sorted(by_d.get(img, []), key=lambda d: -d.confidence)
        out.append((
            np.asarray([d.confidence for d in ds], np.float64),
            _iou_matrix(ds, by_g.get(img, [])),
        ))
    return out


def _greedy_tp(ious: np.ndarray, thr: float) -> np.ndarray:
    """Conf-descending greedy first-match-wins TP flags for one image
    (rows already conf-desc) — same semantics as :func:`match_detections`
    and :func:`_match_with_ignores`, from a precomputed IoU matrix.  Among
    equal-IoU GTs the LAST one wins (pycocotools' scan updates on ties)."""
    n_det, n_gt = ious.shape
    tp = np.zeros(n_det, bool)
    if n_gt == 0:
        return tp
    used = np.zeros(n_gt, bool)
    for di in range(n_det):
        row = np.where(used, -1.0, ious[di])
        gi = n_gt - 1 - int(row[::-1].argmax())  # last max-IoU GT
        if row[gi] >= thr and row[gi] > 0.0:
            used[gi] = True
            tp[di] = True
    return tp


def _mean_ap(per_class: Dict[int, float], gt_counts: Dict[int, int],
             num_classes: Optional[int]) -> float:
    """mAP denominator rule: a fixed ``num_classes``, or (pycocotools /
    average_precision.rs:193-197) the count of classes that HAVE ground
    truth — a hallucinated class (detections, no GT) never dilutes the
    mean."""
    if num_classes is not None:
        return sum(per_class.values()) / num_classes if num_classes else 0.0
    vals = [v for c, v in per_class.items() if gt_counts.get(c, 0) > 0]
    return float(np.mean(vals)) if vals else 0.0


def ap_at_thresholds(
    detections: Sequence[Detection],
    ground_truths: Sequence[GroundTruth],
    thresholds: Sequence[float],
    num_points: int = 101,
    num_classes: Optional[int] = None,
) -> Dict[float, Dict[str, object]]:
    """Per-class AP + mAP at each IoU threshold, from ONE pass over the
    data: pairwise IoUs are computed once per (image, class) and shared by
    every threshold (only the greedy matching re-runs per threshold).

    The single shared pipeline behind :func:`average_precision` and
    :func:`coco_map_50_95` — returns ``{thr: {"per_class": …, "mAP": …}}``.
    """
    # one O(N) pre-pass instead of re-filtering the full lists per class
    # (80 classes x 500k detections would be 40M predicate calls)
    dets_by_class: Dict[int, list] = {}
    gts_by_class: Dict[int, list] = {}
    for d in detections:
        dets_by_class.setdefault(d.class_id, []).append(d)
    for g in ground_truths:
        gts_by_class.setdefault(g.class_id, []).append(g)
    class_ids = sorted(set(dets_by_class) | set(gts_by_class))
    per_thr: Dict[float, Dict[int, float]] = {t: {} for t in thresholds}
    gt_counts: Dict[int, int] = {}
    for cid in class_ids:
        dets = dets_by_class.get(cid, [])
        gts = gts_by_class.get(cid, [])
        buckets = _class_buckets(dets, gts)
        conf = (np.concatenate([c for c, _ in buckets])
                if buckets else np.zeros(0))
        order = np.argsort(-conf, kind="stable")
        gt_counts[cid] = len(gts)
        for t in thresholds:
            tp = (np.concatenate([_greedy_tp(i, t) for _, i in buckets])
                  if buckets else np.zeros(0, bool))
            per_thr[t][cid] = interpolated_ap(tp[order], len(gts), num_points)
    return {
        t: {"per_class": per_thr[t],
            "mAP": _mean_ap(per_thr[t], gt_counts, num_classes)}
        for t in thresholds
    }


def average_precision(
    detections: Sequence[Detection],
    ground_truths: Sequence[GroundTruth],
    iou_threshold: float = 0.5,
    num_points: int = 101,
    num_classes: Optional[int] = None,
) -> Dict[str, object]:
    """Per-class AP + mAP at one IoU threshold (COCO 101-point).

    ``per_class`` carries every class seen in detections OR ground truth;
    the default mAP averages only classes present in the ground truth
    (see :func:`_mean_ap`)."""
    return ap_at_thresholds(detections, ground_truths, [iou_threshold],
                            num_points, num_classes)[iou_threshold]


# COCO size buckets in original-image pixel area (pycocotools convention:
# closed intervals; "all" spans everything)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _area_of(obj) -> float:
    if obj.area >= 0:
        return float(obj.area)
    t, l, b, r = obj.tlbr
    return float(max(b - t, 0.0) * max(r - l, 0.0))


def _iou_matrix(dets, gts) -> np.ndarray:
    """[D, G] pairwise IoU — computed once per (image, class) and shared
    by all 10 IoU thresholds."""
    d = np.asarray([det.tlbr for det in dets], np.float64).reshape(-1, 4)
    g = np.asarray([gt.tlbr for gt in gts], np.float64).reshape(-1, 4)
    t = np.maximum(d[:, None, 0], g[None, :, 0])
    l = np.maximum(d[:, None, 1], g[None, :, 1])
    b = np.minimum(d[:, None, 2], g[None, :, 2])
    r = np.minimum(d[:, None, 3], g[None, :, 3])
    inter = np.clip(b - t, 0, None) * np.clip(r - l, 0, None)
    area_d = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
    area_g = (g[:, 2] - g[:, 0]) * (g[:, 3] - g[:, 1])
    return inter / (area_d[:, None] + area_g[None, :] - inter + 1e-16)


def _match_with_ignores(ious, gt_ig, thr):
    """Greedy conf-descending match with COCO ignore semantics.

    ``ious`` is the [D, G] IoU matrix with detections pre-sorted by
    confidence desc; ``gt_ig`` marks ground truths outside the area
    range.  Non-ignored GTs are preferred: a detection only falls back to
    an ignored GT when no eligible non-ignored GT clears ``thr`` (GTs are
    scanned non-ignored first, and once a non-ignored match is held the
    scan stops at the ignored tail).
    Returns (matched_gt_index_or_-1, det_matched_to_ignored_gt) per det.
    """
    n_det, n_gt = ious.shape
    order = sorted(range(n_gt), key=lambda g: gt_ig[g])  # ignored last
    gt_matched = [False] * n_gt
    dtm = np.full(n_det, -1, np.int64)
    dt_ig = np.zeros(n_det, bool)
    for di in range(n_det):
        best, m = thr, -1
        for gi in order:
            if gt_matched[gi]:
                continue
            if gt_ig[gi] and m > -1 and not gt_ig[m]:
                break  # only ignored GTs remain and we already hold a match
            iou = ious[di, gi]
            if iou < best:
                continue
            best, m = iou, gi
        if m > -1:
            gt_matched[m] = True
            dtm[di] = m
            dt_ig[di] = gt_ig[m]
    return dtm, dt_ig


def coco_summary(
    detections: Sequence[Detection],
    ground_truths: Sequence[GroundTruth],
    num_points: int = 101,
    max_dets: Tuple[int, ...] = (1, 10, 100),
) -> Dict[str, float]:
    """The 12-number COCO detection summary (pycocotools semantics).

    AP / AP50 / AP75 / AP_{small,medium,large} and AR@{1,10,100} /
    AR_{small,medium,large}: AP and AR average over IoU 0.50:0.05:0.95 and
    over classes **present** in the ground truth of each area range
    (pycocotools' convention — unlike :func:`average_precision`, which can
    take a fixed class denominator).  Size buckets use each box's ``area``
    field (original-image pixels) with COCO's ignore semantics: GTs outside
    the range are ignored (matching one neither scores nor penalizes) and
    unmatched detections outside the range are discarded rather than
    counted as false positives.  A bucket with no eligible GT anywhere
    reports **-1.0** (pycocotools' "N/A" marker), never 0.0.

    The reference ships only the single-threshold calculator
    (yolo-dl/src/loss/average_precision.rs:62-155); this extends it to the
    full COCO protocol.
    """
    thresholds = [round(0.5 + 0.05 * i, 2) for i in range(10)]
    top = max(max_dets)
    class_ids = sorted(
        {d.class_id for d in detections} | {g.class_id for g in ground_truths}
    )
    # bucket by (image, class), detections conf-desc capped at max(max_dets)
    dets_by: Dict[Tuple[int, int], List[Detection]] = {}
    for d in detections:
        dets_by.setdefault((d.image_id, d.class_id), []).append(d)
    for key in dets_by:
        dets_by[key] = sorted(dets_by[key], key=lambda d: -d.confidence)[:top]
    gts_by: Dict[Tuple[int, int], List[GroundTruth]] = {}
    for g in ground_truths:
        gts_by.setdefault((g.image_id, g.class_id), []).append(g)
    images = sorted({i for i, _ in dets_by} | {i for i, _ in gts_by})

    # ap[area][thr] / ar[area][maxdet][thr] = list over classes-with-GT
    ap = {a: {t: [] for t in thresholds} for a in AREA_RANGES}
    ar = {a: {k: {t: [] for t in thresholds} for k in max_dets}
          for a in AREA_RANGES}
    for cid in class_ids:
        # pairwise IoUs once per (image, class), shared by all thresholds
        # and area ranges
        ious = {
            img: _iou_matrix(dets_by.get((img, cid), []),
                             gts_by.get((img, cid), []))
            for img in images
            if (img, cid) in dets_by or (img, cid) in gts_by
        }
        for aname, (lo, hi) in AREA_RANGES.items():
            # cheap pre-pass: npig (non-ignored GT count) from areas alone —
            # most (class, size-bucket) pairs are empty and skip the 10x
            # matching entirely
            per_img = []
            npig = 0
            for img in images:
                dets = dets_by.get((img, cid), [])
                gts = gts_by.get((img, cid), [])
                if not dets and not gts:
                    continue
                gt_ig = [not (lo <= _area_of(g) <= hi) for g in gts]
                npig += sum(1 for ig in gt_ig if not ig)
                per_img.append((img, dets, gts, gt_ig))
            if npig == 0:
                continue  # class absent from this area range
            # per threshold: (conf, tp, ignore) fragments across images
            frags = {t: [] for t in thresholds}
            for img, dets, gts, gt_ig in per_img:
                d_out = [not (lo <= _area_of(d) <= hi) for d in dets]
                for t in thresholds:
                    dtm, dt_ig = _match_with_ignores(ious[img], gt_ig, t)
                    # unmatched dets outside the range are ignored too
                    dt_ig |= (dtm == -1) & np.asarray(d_out, bool)
                    frags[t].append((
                        np.asarray([d.confidence for d in dets], np.float64),
                        (dtm > -1) & ~dt_ig,
                        dt_ig,
                    ))
            for t in thresholds:
                # npig > 0 guarantees at least one contributing image
                conf = np.concatenate([f[0] for f in frags[t]])
                tp = np.concatenate([f[1] for f in frags[t]])
                ig = np.concatenate([f[2] for f in frags[t]])
                order = np.argsort(-conf, kind="stable")
                tp, ig = tp[order], ig[order]
                ap[aname][t].append(
                    interpolated_ap(tp[~ig], npig, num_points))
                # recall at each max-det cap; the per-image cap was applied
                # when bucketing, so re-cap per image for smaller k
                for k in max_dets:
                    if k == top:
                        nmatch = int(tp.sum())
                    else:
                        nmatch = sum(int(f_tp[:k].sum())
                                     for _, f_tp, _ in frags[t])
                    ar[aname][k][t].append(nmatch / npig)

    def _mean(lists) -> float:
        # pycocotools prints -1 for a bucket with no eligible GT anywhere
        # ("N/A"), distinct from a genuine 0.0
        vals = [v for lst in lists for v in lst]
        return float(np.mean(vals)) if vals else -1.0

    out = {
        "AP": _mean(ap["all"].values()),
        "AP50": _mean([ap["all"][0.5]]),
        "AP75": _mean([ap["all"][0.75]]),
    }
    for a in ("small", "medium", "large"):
        out[f"AP_{a}"] = _mean(ap[a].values())
    for k in max_dets:
        out[f"AR@{k}"] = _mean(ar["all"][k].values())
    for a in ("small", "medium", "large"):
        out[f"AR_{a}"] = _mean(ar[a][top].values())
    return {k: round(v, 4) for k, v in out.items()}


def coco_map_50_95(
    detections: Sequence[Detection],
    ground_truths: Sequence[GroundTruth],
    num_points: int = 101,
    num_classes: Optional[int] = None,
) -> float:
    """mAP averaged over IoU 0.50:0.05:0.95 (the COCO headline metric).

    ``num_classes`` uses the same fixed denominator as
    :func:`average_precision` so both reported metrics are consistent.
    Pairwise IoUs are computed once per (image, class) and shared by all
    10 thresholds (only the greedy matching re-runs per threshold).
    """
    thresholds = [float(t) for t in np.arange(0.5, 1.0, 0.05)]
    per_thr = ap_at_thresholds(detections, ground_truths, thresholds,
                               num_points, num_classes)
    return float(np.mean([per_thr[t]["mAP"] for t in thresholds]))
