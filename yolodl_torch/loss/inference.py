"""Post-NMS per-instance class selection.

Counterpart of ``yolodl_tpu/loss/inference.py``: among the NMS survivors of
one image, keep only the best-confidence class per flat instance.  The
group-argmax is a segment max over the flat-instance axis
(``scatter_reduce`` with ``amax``), exact ties broken to the first
candidate by a segment min of ranks (``amin``) — no host round trip, fixed
shapes.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from ..utils.timing import spanned
from .nms import NmsOutput


@dataclasses.dataclass
class YoloInferenceOutput(NmsOutput):
    """Same layout as NmsOutput, but at most one class per (batch, instance)."""


@spanned("yolodl.inference.select")
def yolo_inference(nms_out: NmsOutput, num_flats: int) -> YoloInferenceOutput:
    """Keep only the best-confidence class per surviving instance."""
    conf, instances, valid = nms_out.confidence, nms_out.instances, nms_out.valid
    b, k = conf.shape
    masked = torch.where(valid, conf, torch.full_like(conf, -1.0))
    best = torch.full((b, num_flats), -2.0, dtype=conf.dtype, device=conf.device)
    best = best.scatter_reduce(1, instances, masked, reduce="amax")
    is_best = valid & (masked >= torch.gather(best, 1, instances)) & (masked > -1.0)
    order = torch.arange(k, device=conf.device).expand(b, k)
    first = torch.full((b, num_flats), k, dtype=order.dtype, device=conf.device)
    first = first.scatter_reduce(
        1, instances, torch.where(is_best, order, torch.full_like(order, k)),
        reduce="amin")
    keep = is_best & (order == torch.gather(first, 1, instances))
    return YoloInferenceOutput(tlbr=nms_out.tlbr, confidence=conf,
                               classes=nms_out.classes, instances=instances,
                               valid=keep)


@spanned("yolodl.inference.to_host")
def to_host_detections(out: NmsOutput) -> List[List[dict]]:
    """Unpack fixed-shape output into per-image python lists (host side)."""
    tlbr = out.tlbr.detach().to("cpu", torch.float32).numpy()
    conf = out.confidence.detach().to("cpu", torch.float32).numpy()
    classes = out.classes.detach().cpu().numpy()
    valid = out.valid.detach().cpu().numpy()
    result: List[List[dict]] = []
    for b in range(tlbr.shape[0]):
        dets = []
        for k in np.nonzero(valid[b])[0]:
            t, l, bb, r = tlbr[b, k]
            dets.append({
                "tlbr": (float(t), float(l), float(bb), float(r)),
                "confidence": float(conf[b, k]),
                "class": int(classes[b, k]),
            })
        dets.sort(key=lambda d: -d["confidence"])
        result.append(dets)
    return result
