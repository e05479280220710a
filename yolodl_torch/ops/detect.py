"""YOLO detection head: decode + multi-scale merge.

Counterpart of ``yolodl_tpu/ops/detect.py``.  The port's head maps arrive
NCHW, ``[b, A*E, H, W]``; the decoded fields keep the reference's layout —
a head is ``[b, A, H, W, ...]`` and the merged tensor ``[b, N, ...]`` with
N = Σ A·H·W flattened in (anchor, row, col) order per layer — so that the
tests compare like with like and flat indices carry over.

Two decode variants:

* ``scaled``: scaled-YOLOv4 power decode,
  cy = (σ(t)·s − 0.5·(s−1) + row)/H, h = (σ(t)·2)²·anchor_h.
* ``darknet``: classic darknet yolo layer,
  cy = (σ(t)·s − 0.5·(s−1) + row)/H, h = exp(t)·anchor_h.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class DetectionInfo:
    """Static per-head metadata."""

    feature_h: int
    feature_w: int
    anchors: Tuple[Tuple[float, float], ...]  # (h, w) in image-ratio units
    flat_begin: int
    flat_end: int
    class_act: str = "sigmoid"  # "sigmoid" | "softmax" (region heads)

    @property
    def num_anchors(self) -> int:
        return len(self.anchors)


@dataclasses.dataclass
class DenseDetection:
    """One head's decoded output; fields [b, A, H, W, ...], boxes in ratio units.

    ``uncertainty`` is the Gaussian-YOLO per-box mean sigma (None for plain
    heads)."""

    cycxhw: Tensor  # [b, A, H, W, 4]
    obj_logit: Tensor  # [b, A, H, W]
    class_logit: Tensor  # [b, A, H, W, C]
    anchors: Tuple[Tuple[float, float], ...]
    class_act: str = "sigmoid"
    uncertainty: Optional[Tensor] = None  # [b, A, H, W] (mean sigma)
    sigmas: Optional[Tensor] = None  # [b, A, H, W, 4] per-coord (y, x, h, w)

    @property
    def num_classes(self) -> int:
        return self.class_logit.shape[-1]


@dataclasses.dataclass
class MergedDetection:
    """All heads merged on the flat cell axis.

    N = Σ_layers A·H·W, per-layer flat order = (anchor, row, col).
    """

    cycxhw: Tensor  # [b, N, 4]
    obj_logit: Tensor  # [b, N]
    class_logit: Tensor  # [b, N, C]
    infos: Tuple[DetectionInfo, ...]
    uncertainty: Optional[Tensor] = None  # [b, N] (Gaussian-YOLO heads)
    sigmas: Optional[Tensor] = None  # [b, N, 4] per-coord (y, x, h, w)

    @property
    def batch_size(self) -> int:
        return self.cycxhw.shape[0]

    @property
    def num_flats(self) -> int:
        return self.cycxhw.shape[1]

    @property
    def num_classes(self) -> int:
        return self.class_logit.shape[-1]

    def obj_prob(self) -> Tensor:
        return torch.sigmoid(self.obj_logit)

    def class_prob(self) -> Tensor:
        if self.infos and self.infos[0].class_act == "softmax":
            return torch.softmax(self.class_logit, dim=-1)
        return torch.sigmoid(self.class_logit)

    def confidence(self) -> Tensor:
        """obj_prob × class_prob, [b, N, C] (merged_dense_detection.rs:143-153).
        Gaussian heads additionally scale by (1 − uncertainty)
        (gaussian_yolo_layer.c:823-825)."""
        conf = self.obj_prob()[..., None] * self.class_prob()
        if self.uncertainty is not None:
            conf = conf * (1.0 - self.uncertainty)[..., None]
        return conf


def detect_decode(
    x: Tensor,
    anchors: Sequence[Tuple[float, float]],
    num_classes: int,
    order: str = "entry_major",
    variant: str = "scaled",
    scale_xy: float = 2.0,
    entry_layout: str = "cycxhw",
    gaussian: bool = False,
    class_activation: str = "sigmoid",
) -> DenseDetection:
    """Decode a head feature map [b, A*(5+C), H, W] (NCHW) into boxes.

    ``order`` selects the channel grouping: "entry_major" (channel =
    entry*A + anchor) or "anchor_major" (channel = anchor*(5+C) + entry —
    darknet layout).  ``entry_layout`` selects the meaning of the first four
    entries: "cycxhw" (NEWSLAB: cy, cx, h, w) or "xywh" (darknet: tx, ty,
    tw, th).
    """
    b, c, fh, fw = x.shape
    a = len(anchors)
    e = (9 if gaussian else 5) + num_classes
    if c != a * e:
        raise ValueError(f"head channels {c} != anchors*entries = {a * e}")

    if order == "entry_major":
        x = x.reshape(b, e, a, fh, fw).permute(0, 2, 3, 4, 1)  # [b, A, H, W, E]
    elif order == "anchor_major":
        x = x.reshape(b, a, e, fh, fw).permute(0, 1, 3, 4, 2)
    else:
        raise ValueError(f"unknown channel order {order!r}")

    uncertainty = None
    sigmas = None
    if gaussian:
        # interleaved mean/sigma entries (gaussian_yolo_layer.c:809-816):
        # mu_x, s_x, mu_y, s_y, mu_w, s_w, mu_h, s_h, obj, classes
        tx, ty, tw, th = x[..., 0], x[..., 2], x[..., 4], x[..., 6]
        sigmas = torch.sigmoid(
            torch.stack([x[..., 3], x[..., 1], x[..., 7], x[..., 5]], dim=-1))
        uncertainty = torch.mean(sigmas, dim=-1)
        obj_logit = x[..., 8]
        class_logit = x[..., 9:]
    elif entry_layout == "cycxhw":
        ty, tx, th, tw = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        obj_logit = x[..., 4]
        class_logit = x[..., 5:]
    elif entry_layout == "xywh":
        tx, ty, tw, th = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
        obj_logit = x[..., 4]
        class_logit = x[..., 5:]
    else:
        raise ValueError(f"unknown entry layout {entry_layout!r}")

    rows = torch.arange(fh, dtype=x.dtype, device=x.device).view(fh, 1)
    cols = torch.arange(fw, dtype=x.dtype, device=x.device).view(1, fw)
    anchor_h = torch.tensor([ah for ah, _ in anchors], dtype=x.dtype,
                            device=x.device).view(1, a, 1, 1)
    anchor_w = torch.tensor([aw for _, aw in anchors], dtype=x.dtype,
                            device=x.device).view(1, a, 1, 1)

    if variant not in ("scaled", "darknet"):
        raise ValueError(f"unknown decode variant {variant!r}")
    cy = (torch.sigmoid(ty) * scale_xy - 0.5 * (scale_xy - 1.0) + rows) / fh
    cx = (torch.sigmoid(tx) * scale_xy - 0.5 * (scale_xy - 1.0) + cols) / fw
    if variant == "scaled":
        # wh is s-independent: (σ·2)² · a (get_yolo_box new_coords branch)
        h = torch.square(torch.sigmoid(th) * 2.0) * anchor_h
        w = torch.square(torch.sigmoid(tw) * 2.0) * anchor_w
    else:
        h = torch.exp(th) * anchor_h
        w = torch.exp(tw) * anchor_w

    return DenseDetection(
        cycxhw=torch.stack([cy, cx, h, w], dim=-1),
        obj_logit=obj_logit,
        class_logit=class_logit,
        anchors=tuple((float(ah), float(aw)) for ah, aw in anchors),
        class_act=class_activation,
        uncertainty=uncertainty,
        sigmas=sigmas,
    )


def merge_detections(heads: Sequence[DenseDetection]) -> MergedDetection:
    """Concatenate heads on the flat axis (merged_dense_detection.rs:19-119)."""
    if not heads:
        raise ValueError("merge_detections needs at least one head")
    num_classes = heads[0].num_classes
    infos: List[DetectionInfo] = []
    boxes, objs, classes, uncs, sigs = [], [], [], [], []
    begin = 0
    for head in heads:
        if head.num_classes != num_classes:
            raise ValueError("all heads must share num_classes")
        b, a, fh, fw, _ = head.cycxhw.shape
        n = a * fh * fw
        infos.append(DetectionInfo(
            feature_h=fh, feature_w=fw, anchors=head.anchors,
            flat_begin=begin, flat_end=begin + n, class_act=head.class_act))
        begin += n
        boxes.append(head.cycxhw.reshape(b, n, 4))
        objs.append(head.obj_logit.reshape(b, n))
        classes.append(head.class_logit.reshape(b, n, num_classes))
        if head.uncertainty is not None:
            uncs.append(head.uncertainty.reshape(b, n))
        if head.sigmas is not None:
            sigs.append(head.sigmas.reshape(b, n, 4))

    if uncs and len(uncs) != len(heads):
        raise ValueError("either all heads are gaussian or none")
    return MergedDetection(
        cycxhw=torch.cat(boxes, dim=1),
        obj_logit=torch.cat(objs, dim=1),
        class_logit=torch.cat(classes, dim=1),
        infos=tuple(infos),
        uncertainty=torch.cat(uncs, dim=1) if uncs else None,
        sigmas=torch.cat(sigs, dim=1) if sigs else None,
    )


def instance_to_flat(infos: Sequence[DetectionInfo], layer: int, anchor, row, col):
    """(layer, anchor, row, col) → flat index (instances_to_flats parity,
    merged_dense_detection.rs:417).  anchor/row/col may be tensors."""
    info = infos[layer]
    return info.flat_begin + (anchor * info.feature_h + row) * info.feature_w + col


def flat_to_instance(infos: Sequence[DetectionInfo], flat: int):
    """flat index → (layer, anchor, row, col) (flats_to_instances parity,
    merged_dense_detection.rs:384).  Python ints (host-side debugging)."""
    for layer, info in enumerate(infos):
        if info.flat_begin <= flat < info.flat_end:
            local = flat - info.flat_begin
            anchor, rest = divmod(local, info.feature_h * info.feature_w)
            row, col = divmod(rest, info.feature_w)
            return layer, anchor, row, col
    raise IndexError(f"flat index {flat} out of range")
