"""YOLO training loss: IoU + classification + objectness.

Counterpart of ``yolodl_tpu/loss/yolo_loss.py`` (``yolo-dl/src/loss/loss_.rs``
YoloLoss): match targets (:mod:`.matcher`), IoU loss = 1 − metric
(Hausdorff = raw distance) over matched pairs, classification loss against
label-smoothed dense targets, objectness loss with target
(1−coef) + coef·clamp(IoU, 0, 1) scattered at matched cells, and the
weighted total with the reference defaults (DIoU, iou_w 0.05, obj_w 1.0,
cls_w 0.58, smooth_cls 0.01, smooth_obj 0.0).

Every reduction is a mask-aware mean over the fixed-shape lattice, so the
loss reads nothing back to the host.  ``bce_with_logits`` uses JAX's
softplus formula (``activations.softplus``), not ``F.softplus``, whose
threshold of 20 would differ.  The ``"auto"`` options resolve to "off" here
as they do in the reference; adopting a darknet cfg's values is the train
CLI's job (ROADMAP A11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..activations import softplus
from ..geometry import boxes as geom
from ..ops.detect import MergedDetection
from .matcher import MatcherConfig, MatchingOutput, match_targets

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# elementwise losses (no reduction)


def bce_with_logits(logits: Tensor, targets: Tensor, pos_weight: Optional[float] = None) -> Tensor:
    """−[pw·t·log σ(x) + (1−t)·log(1−σ(x))] elementwise."""
    pw = 1.0 if pos_weight is None else pos_weight
    return pw * targets * softplus(-logits) + (1.0 - targets) * softplus(logits)


def focal(base_loss: Tensor, logits: Tensor, targets: Tensor,
          gamma: float = 1.5, alpha: float = 0.25) -> Tensor:
    """Focal modulation of an elementwise loss (focal_loss.rs:96-101)."""
    prob = torch.sigmoid(logits)
    p_t = targets * prob + (1.0 - targets) * (1.0 - prob)
    alpha_factor = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    return base_loss * alpha_factor * torch.pow(1.0 - p_t, gamma)


def soft_cross_entropy(logits: Tensor, targets: Tensor) -> Tensor:
    """−Σ_k t_k·log softmax(x)_k over the last axis."""
    return -torch.sum(targets * torch.log_softmax(logits, dim=-1), dim=-1)


def l2(logits: Tensor, targets: Tensor) -> Tensor:
    return torch.square(logits - targets)


def _masked_mean(values: Tensor, mask: Tensor) -> Tensor:
    """Mean over masked elements; 0 when the mask is empty (loss_.rs:307-313)."""
    total = torch.sum(torch.where(mask, values, torch.zeros_like(values)))
    count = torch.sum(mask.to(values.dtype))
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), torch.zeros_like(total))


class _ClipGrad(torch.autograd.Function):
    """Identity whose cotangent is clamped to [-bound, bound] elementwise —
    the autodiff analogue of darknet's max_delta delta clipping
    (clip_value, yolo_layer.c:161-172)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(bound)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (bound,) = ctx.saved_tensors
        return torch.clamp(g, -bound, bound), None


def _clip_grad(x: Tensor, bound: Tensor) -> Tensor:
    return _ClipGrad.apply(x, bound)


# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """YoloLossInit defaults (loss_.rs:169-189); the darknet adoptions as in
    the reference's LossConfig (ignore_thresh, iou_thresh,
    objectness_smooth, max_delta: scalar or per-head tuple, "auto" = off
    until the train CLI resolves it)."""

    box_metric: str = "diou"  # iou|giou|diou|ciou|hausdorff
    iou_loss_weight: float = 0.05
    objectness_loss_weight: float = 1.0
    classification_loss_weight: float = 0.58
    smooth_classification_coef: float = 0.01
    smooth_objectness_coef: float = 0.0
    objectness_loss_kind: str = "bce"  # bce|focal|l2
    classification_loss_kind: str = "bce"  # bce|focal|cross_entropy|l2
    focal_gamma: float = 1.5
    focal_alpha: float = 0.25
    objectness_pos_weight: Optional[float] = None
    ignore_thresh: Union[None, str, float, Tuple[float, ...]] = "auto"
    iou_thresh: Union[None, str, float, Tuple[float, ...]] = "auto"
    objectness_smooth: Union[bool, str] = "auto"
    max_delta: Union[None, str, float, Tuple[Optional[float], ...]] = "auto"
    # Gaussian-YOLO uncertainty NLL weight; None = iou_loss_weight when the
    # head is gaussian
    uncertainty_loss_weight: Optional[float] = None
    matcher: MatcherConfig = MatcherConfig()


@dataclasses.dataclass
class LossOutput:
    total_loss: Tensor
    iou_loss: Tensor
    classification_loss: Tensor
    objectness_loss: Tensor
    uncertainty_loss: Optional[Tensor] = None  # gaussian heads only


@dataclasses.dataclass
class LossAuxiliary:
    matching: MatchingOutput
    iou_score: Optional[Tensor]  # [B, C] or None for hausdorff
    pred_cycxhw: Tensor  # [B, C, 4]


def _per_flat(prediction: MergedDetection, values, dev) -> Tensor:
    """[N] tensor holding values[i] on the flats of head i."""
    return torch.cat([
        torch.full((info.flat_end - info.flat_begin,), v, dtype=torch.float32, device=dev)
        for info, v in zip(prediction.infos, values)
    ])


def yolo_loss(
    prediction: MergedDetection,
    gt_cycxhw: Tensor,
    gt_class: Tensor,
    gt_mask: Tensor,
    config: LossConfig = LossConfig(),
) -> Tuple[LossOutput, LossAuxiliary]:
    # the network may run in bf16; the loss/matcher math runs in f32
    if prediction.cycxhw.dtype != torch.float32:
        prediction = MergedDetection(
            cycxhw=prediction.cycxhw.to(torch.float32),
            obj_logit=prediction.obj_logit.to(torch.float32),
            class_logit=prediction.class_logit.to(torch.float32),
            infos=prediction.infos,
            uncertainty=(prediction.uncertainty.to(torch.float32)
                         if prediction.uncertainty is not None else None),
            sigmas=(prediction.sigmas.to(torch.float32)
                    if prediction.sigmas is not None else None),
        )
    gt_cycxhw = gt_cycxhw.to(torch.float32)
    dev = gt_cycxhw.device
    gt_mask = gt_mask.bool()

    # darknet iou_thresh adoption: fold the per-head thresholds into the
    # matcher's shape-IoU multi-anchor gate
    iou_thr = config.iou_thresh
    if iou_thr == "auto":  # unresolved auto (no cfg wiring ran) = disabled
        iou_thr = None
    mcfg = config.matcher
    if iou_thr is not None and mcfg.shape_iou_thresh is None:
        mcfg = dataclasses.replace(
            mcfg,
            shape_iou_thresh=(tuple(float(t) for t in iou_thr)
                              if isinstance(iou_thr, (tuple, list)) else float(iou_thr)),
        )
    matching = match_targets(prediction, gt_cycxhw, gt_class, gt_mask, mcfg)
    pred_boxes, pred_obj, pred_class = matching.gather_pred(prediction)
    valid = matching.valid  # [B, C]

    # darknet max_delta adoption: clamp the gradient into the matched
    # pred-box coordinates (scalar, or per head with None = unclipped)
    md = config.max_delta
    if md == "auto":
        md = None
    if md is not None:
        if isinstance(md, (tuple, list)):
            if len(md) != len(prediction.infos):
                raise ValueError(
                    f"per-head max_delta has {len(md)} entries for "
                    f"{len(prediction.infos)} detect heads")
            per_flat = _per_flat(prediction, [float("inf") if t is None else float(t)
                                              for t in md], dev)
            bound = per_flat[matching.flat.long()][..., None]
        else:
            bound = torch.tensor(float(md), dtype=torch.float32, device=dev)
        pred_boxes = _clip_grad(pred_boxes, bound)

    # -- IoU loss (loss_.rs:279-322) ------------------------------------
    metric = config.box_metric.lower()
    if metric == "hausdorff":
        dist = geom.hausdorff_distance(pred_boxes, matching.gt_cycxhw)
        iou_loss = _masked_mean(dist, valid)
        iou_score = None
    else:
        score = geom.iou_score(metric, pred_boxes, matching.gt_cycxhw)
        iou_loss = _masked_mean(1.0 - score, valid)
        iou_score = score

    # -- classification loss (loss_.rs:324-374) --------------------------
    num_classes = prediction.num_classes
    pos = 1.0 - 0.5 * config.smooth_classification_coef
    neg = 1.0 - pos
    # jax.nn.one_hot: a class outside [0, C) gives a row of zeros
    onehot = (matching.gt_class[..., None].long()
              == torch.arange(num_classes, device=dev)).to(pred_class.dtype)
    target_dense = onehot * (pos - neg) + neg

    kind = config.classification_loss_kind.lower()
    dense_mask = valid[..., None].expand(pred_class.shape)
    if kind == "bce":
        cls_loss = _masked_mean(bce_with_logits(pred_class, target_dense), dense_mask)
    elif kind == "focal":
        base = bce_with_logits(pred_class, target_dense)
        cls_elem = focal(base, pred_class, target_dense, config.focal_gamma, config.focal_alpha)
        cls_loss = _masked_mean(cls_elem, dense_mask)
    elif kind == "cross_entropy":
        cls_loss = _masked_mean(soft_cross_entropy(pred_class, target_dense), valid)
    elif kind == "l2":
        cls_loss = _masked_mean(l2(pred_class, target_dense), dense_mask)
    else:
        raise ValueError(f"unknown classification loss {kind!r}")

    # -- objectness loss (loss_.rs:376-468) -------------------------------
    coef = config.smooth_objectness_coef
    target_score = torch.full(valid.shape, 1.0 - coef, dtype=pred_obj.dtype, device=dev)
    if iou_score is not None and coef != 0.0:
        target_score = target_score + torch.clamp(iou_score.detach(), 0.0, 1.0) * coef
    target_score = torch.where(valid, target_score, torch.zeros_like(target_score))

    n = prediction.num_flats
    b = prediction.batch_size
    # scatter into n+1 slots, invalid candidates to the last one, which is
    # dropped (matched cells are unique after the matcher's dedupe)
    slot = torch.where(valid, matching.flat.long(), torch.full_like(matching.flat.long(), n))
    target_obj = torch.zeros((b, n + 1), dtype=pred_obj.dtype, device=dev).scatter(
        1, slot, target_score)[:, :n]

    ignore = config.ignore_thresh
    if ignore == "auto":  # unresolved auto (no cfg wiring ran) = disabled
        ignore = None
    osm = config.objectness_smooth
    if osm == "auto":  # unresolved auto = disabled
        osm = False
    ignored = None
    if ignore is not None:
        if isinstance(ignore, tuple):
            if len(ignore) != len(prediction.infos):
                raise ValueError(
                    f"per-layer ignore_thresh has {len(ignore)} entries "
                    f"for {len(prediction.infos)} detect heads")
            thr = _per_flat(prediction, ignore, dev)[None, :]  # [1, N]
        else:
            thr = torch.tensor(float(ignore), dtype=torch.float32, device=dev)
        # best IoU of every predicted box vs every (valid) GT: [B, N]
        ious = geom.iou(prediction.cycxhw[:, :, None, :], gt_cycxhw[:, None, :, :])
        ious = torch.where(gt_mask[:, None, :], ious, torch.zeros_like(ious))
        best_iou = torch.max(ious, dim=-1).values
        matched_cells = target_obj > 0.0
        ignored = (best_iou > thr) & ~matched_cells
        if osm:
            # overlapping unmatched cells train toward their best IoU
            # instead of dropping out of the objectness loss
            target_obj = torch.where(ignored, torch.clamp(best_iou, 0.0, 1.0).detach(),
                                     target_obj)
            ignored = None

    okind = config.objectness_loss_kind.lower()
    if okind == "bce":
        obj_elem = bce_with_logits(prediction.obj_logit, target_obj, config.objectness_pos_weight)
    elif okind == "focal":
        base = bce_with_logits(prediction.obj_logit, target_obj, config.objectness_pos_weight)
        obj_elem = focal(base, prediction.obj_logit, target_obj,
                         config.focal_gamma, config.focal_alpha)
    elif okind == "l2":
        obj_elem = l2(prediction.obj_logit, target_obj)
    else:
        raise ValueError(f"unknown objectness loss {okind!r}")

    if ignored is not None:
        obj_elem = torch.where(ignored, torch.zeros_like(obj_elem), obj_elem)
    obj_loss = torch.mean(obj_elem)

    # -- Gaussian uncertainty NLL (gaussian heads only) -------------------
    # per-coordinate NLL = 1/2 (d/sigma)^2 + log(sigma + 0.3) with residuals
    # in grid/log units, masked mean over matched cells
    unc_weight = config.uncertainty_loss_weight
    if unc_weight is None:
        unc_weight = config.iou_loss_weight if prediction.sigmas is not None else 0.0
    unc_loss = torch.zeros((), dtype=torch.float32, device=dev)
    if prediction.sigmas is not None and unc_weight != 0.0:
        flat = matching.flat.long()
        fh_m = _per_flat(prediction, [i.feature_h for i in prediction.infos], dev)[flat]
        fw_m = _per_flat(prediction, [i.feature_w for i in prediction.infos], dev)[flat]
        rows = torch.arange(b, device=dev)[:, None]
        sig = prediction.sigmas[rows, flat]  # [B, C, 4]
        gt = matching.gt_cycxhw
        eps = torch.tensor(1e-9, dtype=torch.float32, device=dev)
        d = torch.stack([
            (gt[..., 0] - pred_boxes[..., 0]) * fh_m,
            (gt[..., 1] - pred_boxes[..., 1]) * fw_m,
            torch.log(torch.maximum(gt[..., 2], eps) / torch.maximum(pred_boxes[..., 2], eps)),
            torch.log(torch.maximum(gt[..., 3], eps) / torch.maximum(pred_boxes[..., 3], eps)),
        ], dim=-1)  # [B, C, 4]
        sig = torch.maximum(sig, sig.new_tensor(1e-4))
        nll = 0.5 * torch.square(d / sig) + torch.log(sig + 0.3)
        unc_loss = _masked_mean(torch.mean(nll, dim=-1), valid)

    total = (
        config.iou_loss_weight * iou_loss
        + config.classification_loss_weight * cls_loss
        + config.objectness_loss_weight * obj_loss
        + unc_weight * unc_loss
    )

    return (
        LossOutput(
            total_loss=total,
            iou_loss=iou_loss,
            classification_loss=cls_loss,
            objectness_loss=obj_loss,
            uncertainty_loss=unc_loss if prediction.sigmas is not None else None,
        ),
        LossAuxiliary(matching=matching, iou_score=iou_score, pred_cycxhw=pred_boxes),
    )
