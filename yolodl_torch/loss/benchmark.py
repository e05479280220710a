"""Per-step quality telemetry.

Counterpart of ``yolodl_tpu/loss/benchmark.py`` (``yolo-dl/src/loss/
benchmark.rs:33-101`` YoloBenchmark): objectness accuracy / recall /
precision against the matcher output at a confidence threshold, plus
classification accuracy on matched cells.  Fixed shape and mask-aware; the
results stay on the device.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.detect import MergedDetection
from .matcher import MatchingOutput

Tensor = torch.Tensor


@dataclasses.dataclass
class BenchmarkOutput:
    obj_accuracy: Tensor
    obj_recall: Tensor
    obj_precision: Tensor
    class_accuracy: Tensor


def _ratio_or_one(num: Tensor, den: Tensor) -> Tensor:
    """num / den where den > 0, else 1 (the reference's empty-set value)."""
    return torch.where(den > 0, num / torch.clamp(den, min=1),
                       torch.ones_like(num, dtype=torch.float32))


def yolo_benchmark(
    prediction: MergedDetection,
    matching: MatchingOutput,
    confidence_threshold: float = 0.5,
) -> BenchmarkOutput:
    obj_prob = prediction.obj_prob()                         # [B, N]
    all_pos_mask = obj_prob >= confidence_threshold
    all_count = obj_prob.numel()
    all_pos = torch.sum(all_pos_mask)

    _, pred_obj, pred_class = matching.gather_pred(prediction)
    matched_prob = torch.sigmoid(pred_obj)                   # [B, C]
    valid = matching.valid
    matched_count = torch.sum(valid)
    matched_pos = torch.sum(valid & (matched_prob >= confidence_threshold))
    matched_neg = matched_count - matched_pos

    all_neg = all_count - all_pos
    unmatched_neg = all_neg - matched_neg

    accuracy = (matched_pos + unmatched_neg) / all_count
    recall = _ratio_or_one(matched_pos, matched_count)
    precision = _ratio_or_one(matched_pos, all_pos)

    # classification accuracy on matched cells whose confidence passes the
    # threshold for any class (benchmark.rs:79-95), with the head's declared
    # class activation
    if prediction.infos and prediction.infos[0].class_act == "softmax":
        class_prob = torch.softmax(pred_class, dim=-1)
    else:
        class_prob = torch.sigmoid(pred_class)
    conf = matched_prob[..., None] * class_prob
    conf_ok = torch.any(conf >= confidence_threshold, dim=-1)
    pred_label = torch.argmax(pred_class, dim=-1)
    correct = valid & conf_ok & (pred_label == matching.gt_class)
    class_accuracy = _ratio_or_one(torch.sum(correct), matched_count)

    return BenchmarkOutput(
        obj_accuracy=accuracy,
        obj_recall=recall,
        obj_precision=precision,
        class_accuracy=class_accuracy,
    )
