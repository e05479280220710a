"""Fixed-shape batched NMS.

Counterpart of ``yolodl_tpu/loss/nms.py``, with the same outputs:

1. candidates are pre-filtered to a static ``max_dets`` per image by a
   top-k on masked confidence;
2. greedy suppression over the score-sorted candidates takes two
   hand-written CUDA kernels (``kernels/iou.py``) for CUDA tensors, and
   their plain versions for CPU tensors: one writes a bit per candidate
   pair that conflicts, the other resolves the keep mask from those bits —
   two launches for the whole batch, no host sync;
3. the output is fixed-shape with a validity mask instead of ragged lists.

Suppression is per group: same image (and same class when
``suppress_by_class``).

The batch is written out where the reference uses ``jax.vmap``.  The top-k
is a stable descending sort, so ties keep the lower index first, as
``jax.lax.top_k`` does; with ``confidence_threshold`` most masked
confidences are exactly 0, and this keeps ``instances`` and ``classes``
equal to the reference's even on invalid rows.
"""

from __future__ import annotations

import dataclasses

import torch

from ..geometry.boxes import cycxhw_to_tlbr
from ..kernels.iou import nms_conflict_bits, nms_keep_from_bits
from ..ops.detect import MergedDetection
from ..utils.timing import span, spanned

Tensor = torch.Tensor

DEFAULT_IOU_THRESHOLD = 0.6
DEFAULT_CONFIDENCE_THRESHOLD = 0.1


@dataclasses.dataclass
class NmsOutput:
    """Fixed-size survivors per image; ``valid`` masks live entries."""

    tlbr: Tensor        # [B, K, 4]
    confidence: Tensor  # [B, K]
    classes: Tensor     # [B, K] int64
    instances: Tensor   # [B, K] int64 flat cell index
    valid: Tensor       # [B, K] bool


def _suppress(tlbr: Tensor, group: Tensor, valid: Tensor, iou_threshold: float,
              kind: str = "greedy", beta: float = 0.6) -> Tensor:
    """Greedy NMS over score-sorted candidates, whole batch at once.

    tlbr [B,K,4], group [B,K], valid [B,K] (rank order) → keep [B,K].
    ``kind="diou"`` subtracts the normalized center distance raised to
    ``beta`` from the IoU before thresholding (darknet box.c dia_box_diou).

    Greedy NMS is the unique solution of the triangular recurrence
        keep[i] = valid[i] ∧ ∀ j<i: ¬(keep[j] ∧ conflict[j,i]).
    The IoU is f32 whatever the box dtype, as the reference's
    backend="pallas" gives it (its default XLA backend computes in the box
    dtype).  Two calls, two launches on the card: the conflict matrix
    (threshold, group, rank mask) as one bit per pair, then the recurrence
    resolved in rank order; nothing is read back to the host.  On the CPU
    both take their plain versions (kernels/iou.py).
    """
    with span("yolodl.nms.conflict"):
        bits = nms_conflict_bits(tlbr, group, iou_threshold, kind, beta, device=tlbr.device)
    with span("yolodl.nms.keep"):
        return nms_keep_from_bits(bits, valid, device=tlbr.device)


def nms_options_from_darknet(darknet) -> tuple:
    """(kind, beta) for NMS from a parsed darknet cfg's yolo layers.

    Mirrors detector.c:774: diounms_sort is used when any yolo layer sets
    nms_kind=diounms, with that layer's beta_nms (parser.c:490, default .6).
    """
    for layer in darknet.layers:
        if getattr(layer, "nms_kind", "") == "diounms":
            return "diou", float(getattr(layer, "beta_nms", 0.6))
    return "greedy", 0.6


def _top_k(x: Tensor, k: int):
    """Descending top-k along the last axis, ties to the lower index first
    (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


@spanned("yolodl.nms")
def non_max_suppression(
    prediction: MergedDetection,
    iou_threshold: float = DEFAULT_IOU_THRESHOLD,
    confidence_threshold: float = DEFAULT_CONFIDENCE_THRESHOLD,
    suppress_by_class: bool = False,
    max_dets: int = 512,
    kind: str = "greedy",
    class_mode: str = "pairs",
    beta: float = 0.6,
) -> NmsOutput:
    """Batched NMS on a merged detection tensor.

    Candidate gating matches nms.rs:97-103: obj_prob ≥ τ AND confidence ≥ τ,
    per (instance, class) pair.  ``class_mode``: "pairs" considers every
    (instance, class) pair; "argmax" pre-selects each instance's best class
    before the top-k (the serving default).
    """
    b = prediction.batch_size
    n = prediction.num_flats
    c = prediction.num_classes

    obj = prediction.obj_prob()          # [B, N]
    conf = prediction.confidence()       # [B, N, C]
    mask = (obj[..., None] >= confidence_threshold) & (conf >= confidence_threshold)
    masked_conf = torch.where(mask, conf, torch.zeros((), dtype=conf.dtype,
                                                      device=conf.device))

    if class_mode == "argmax":
        best_conf, best_class = torch.max(masked_conf, dim=-1)  # first max index
        k = min(max_dets, n)
        top_conf, instances = _top_k(best_conf, k)
        classes = torch.gather(best_class, 1, instances)
    elif class_mode == "pairs":
        k = min(max_dets, n * c)
        top_conf, top_idx = _top_k(masked_conf.reshape(b, n * c), k)
        instances = top_idx // c
        classes = top_idx % c
    else:
        raise ValueError(f"unknown class_mode {class_mode!r}")
    valid = top_conf > 0.0

    boxes = torch.gather(prediction.cycxhw, 1,
                         instances[..., None].expand(-1, -1, 4))
    tlbr = cycxhw_to_tlbr(boxes)  # [B, K, 4]
    group = classes if suppress_by_class else torch.zeros_like(classes)
    keep = _suppress(tlbr, group, valid, iou_threshold, kind, beta)
    return NmsOutput(tlbr=tlbr, confidence=top_conf, classes=classes,
                     instances=instances, valid=keep)
