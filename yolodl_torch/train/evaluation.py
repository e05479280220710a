"""Dataset mAP evaluation, reusable from the eval CLI and a train loop.

Counterpart of ``yolodl_tpu/train/evaluation.py``.  The reference has only
in-training benchmark telemetry (obj/class accuracy at a confidence
threshold, yolo-dl/src/loss/benchmark.rs:33-101) and an AP calculator
library (average_precision.rs); this module runs the full inference path
(forward → NMS by class → class selection → COCO 101-point AP) over a
record list.

The model is evaluated as it stands: the port keeps parameters in the
module and updates them in place, so a call after a training step sees the
new weights.  On a card, suppression is B1's two kernels
(``kernels/iou.py``) with one group per class: two launches per batch.

``devices=N`` evaluates data-parallel in this one process, as the
reference's ``devices`` (evaluation.py:64-75) does over a mesh: one model
replica per device (``parallel/mesh.py`` ``ModelReplicas``, refreshed from
the model at each call), each batch split into N equal parts, each
replica's forward and NMS issued in order from this thread so that the
devices overlap, and the outputs joined in order on the host: two
launches per replica per batch.  A list of devices names each replica's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..config.app_config import compute_dtype_of
from ..loss import non_max_suppression, yolo_inference
from ..loss.average_precision import (
    Detection, GroundTruth, ap_at_thresholds, coco_summary,
)
from ..parallel.mesh import ModelReplicas, join_outputs, replica_devices


class DatasetEvaluator:
    """Callable () → mAP report of ``model`` over a fixed record list."""

    def __init__(
        self,
        model,
        records: List,
        loader,
        num_classes: int,
        batch_size: int = 4,
        iou_threshold: float = 0.45,
        confidence_threshold: float = 0.005,
        nms_kind: str = "greedy",
        nms_beta: float = 0.6,
        cache_bytes: int = 1 << 30,
        devices: int = 1,
        extended: bool = False,
        precision: str = "float32",
    ):
        #: also compute the 12-number COCO summary (AP by size, AR@k) with
        #: size buckets in ORIGINAL-image pixel areas (requires records to
        #: carry .height/.width, as FileRecord does)
        self.extended = extended
        self.model = model
        self.records = list(records)
        self.loader = loader
        self.batch_size = max(1, int(batch_size))
        self.num_classes = num_classes
        self._replicas = None
        n_devices = len(devices) if isinstance(devices, (list, tuple)) else int(devices)
        if n_devices > 1:
            if self.batch_size % n_devices:
                raise ValueError(
                    f"eval batch_size {self.batch_size} not divisible by "
                    f"devices {n_devices}")
            if isinstance(devices, (list, tuple)):
                devs = replica_devices(list(devices))
            else:
                devs = replica_devices(next(model.parameters()).device.type, n_devices)
            self._replicas = ModelReplicas(model, devs)
        self.cache_bytes = cache_bytes
        self.iou_threshold = iou_threshold
        self.confidence_threshold = confidence_threshold
        self.nms_kind = nms_kind
        self.nms_beta = nms_beta
        # "bfloat16" runs the conv path in bf16 (the serving path's
        # production precision); parameters stay f32
        self.compute_dtype = compute_dtype_of(precision)
        # decoded images + GT are reused verbatim across calls — but only
        # when they fit ``cache_bytes``; a real val set (5k × 608² f32 ≈
        # 22 GB) must stream per call, not pin the host's RAM
        self._decoded: Optional[list] = None

    def _iter_decoded(self):
        if self._decoded is not None:
            yield from self._decoded
            return
        kept: Optional[list] = None
        for i, r in enumerate(self.records):
            d = self.loader.load(r)
            if i == 0:
                per = np.asarray(d.image).nbytes
                if per * len(self.records) <= self.cache_bytes:
                    kept = []
            if kept is not None:
                kept.append(d)
            yield d
        if kept is not None:
            self._decoded = kept

    def infer(self, images: np.ndarray):
        """[B,3,S,S] f32 host batch → YoloInferenceOutput: forward, NMS with
        one group per class, class selection; on the model's device, or,
        with several replicas, joined on the host."""
        if self._replicas is None:
            return self._infer(self.model, images)
        return join_outputs(self._replicas.map(
            lambda i, part: self._infer(self._replicas.models[i], part), images))

    def _infer(self, model, images: np.ndarray):
        device = next(model.parameters()).device
        with torch.inference_mode():
            x = torch.from_numpy(images).to(device).to(self.compute_dtype)
            pred = model(x)
            nms = non_max_suppression(
                pred,
                iou_threshold=self.iou_threshold,
                confidence_threshold=self.confidence_threshold,
                suppress_by_class=True,
                class_mode="argmax",
                kind=self.nms_kind,
                beta=self.nms_beta,
            )
            return yolo_inference(nms, pred.num_flats)

    def __call__(self) -> Dict:
        if self._replicas is not None:
            self._replicas.refresh()
        dets, gts = [], []
        bs = self.batch_size
        it = self._iter_decoded()
        start = 0
        while True:
            chunk = [d for _, d in zip(range(bs), it)]
            if not chunk:
                break
            n_real = len(chunk)
            while len(chunk) < bs:
                chunk.append(chunk[-1])  # pad — extra rows are dropped below
            out = self.infer(np.stack([d.image for d in chunk]))
            tlbr = out.tlbr.to("cpu", torch.float32).numpy()
            conf = out.confidence.to("cpu", torch.float32).numpy()
            classes = out.classes.cpu().numpy()
            valid = out.valid.cpu().numpy()
            for i in range(n_real):
                img_id = start + i
                # ratio→original-pixel area scale: an aspect-preserving
                # letterbox into a square frame maps a ratio-h box to
                # h·max(orig_h, orig_w) original pixels
                scale = 1.0
                if self.extended:
                    rec = self.records[img_id]
                    oh = getattr(rec, "height", 0)
                    ow = getattr(rec, "width", 0)
                    if not (oh and ow):  # DataRecord: decoded dims
                        oh, ow = getattr(rec, "hw", (0, 0))
                    if not (oh and ow):
                        # silently using scale=1 would put EVERY box in the
                        # 'small' COCO bucket (ratio² areas are < 32²) and
                        # report -1 for medium/large with no hint why
                        raise ValueError(
                            f"{getattr(rec, 'path', rec)}: extended (COCO "
                            "size-bucket) evaluation needs original image "
                            "dimensions on the records")
                    scale = float(max(oh, ow)) ** 2
                for (cy, cx, h, w), cls in zip(chunk[i].boxes, chunk[i].classes):
                    gts.append(GroundTruth(
                        img_id, int(cls),
                        (cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2),
                        area=float(h) * float(w) * scale))
                for k in np.nonzero(valid[i])[0]:
                    t, l, b, r = (float(v) for v in tlbr[i, k])
                    dets.append(Detection(
                        img_id, int(classes[i, k]), float(conf[i, k]),
                        (t, l, b, r),
                        area=max(b - t, 0.0) * max(r - l, 0.0) * scale))
            start += n_real
        # one pass: the COCO threshold grid includes 0.5, so ap50 and the
        # 50:95 mean share the same per-(image, class) IoU matrices
        thresholds = [round(0.5 + 0.05 * i, 10) for i in range(10)]
        per_thr = ap_at_thresholds(dets, gts, thresholds,
                                   num_classes=self.num_classes)
        ap50 = per_thr[thresholds[0]]
        map5095 = float(np.mean([per_thr[t]["mAP"] for t in thresholds]))
        report = {
            "images": len(self.records),
            "detections": len(dets),
            "ground_truths": len(gts),
            "mAP@0.5": round(ap50["mAP"], 4),
            "mAP@0.5:0.95": round(map5095, 4),
            "per_class": ap50["per_class"],
        }
        if self.extended:
            report["coco"] = coco_summary(dets, gts)
        return report
