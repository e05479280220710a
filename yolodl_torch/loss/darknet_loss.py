"""darknet-exact [yolo]/[Gaussian_yolo]/[region]/[detection] training loss.

Counterpart of ``yolodl_tpu/loss/darknet_loss.py``: AlexeyAB darknet-C's
training deltas reproduced value for value, with darknet's convention that
the gradient of a head's raw output is the delta itself (no activation
gradient, except the σ′ of a ``new_coords=1`` head, whose logistic belongs
to the head conv).  The semantics, option by option, are the reference's;
its module docstring lists them with their darknet file:line.

Every function takes the batch as dimension 0, where the reference
``vmap``s a per-image function.  The head input is the port's NCHW conv
output ``[B, A·E, H, W]`` (:func:`reshape_head_raw`).

The per-truth pass, a ``lax.scan`` over the T truths in the reference, is a
Python loop over T here.  Everything a truth computes from the activated
output alone (its cell, best anchor, candidate anchors, box deltas, the
positive objectness, the fresh class rows, the telemetry) is computed for
all truths at once before the loop; the loop keeps only what depends on
the deltas that earlier truths wrote: box deltas accumulate (+=),
objectness overwrites (or lands on a zero cell under
``objectness_smooth``), class rows take delta_yolo_class's first-branch
overwrite.  Each iteration reads the rows its truth writes, for the whole
batch and all its candidate anchors, with one gather and writes them with
one scatter; the indices of one write are distinct (one cell per image and
anchor slot), so the write is deterministic on the card.  Validity (the
``!truth.x`` break and the class range) stays a mask: nothing in the loss
reads a value back to the host.

JAX's index semantics are kept where an index may be out of range:
gathers wrap a negative index and clamp (:func:`_take`), ``.at[c]`` writes
wrap a negative index and drop one out of range, ``jax.nn.one_hot`` of an
index out of range is all zeros (:func:`_onehot`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

SIGMA_CONST = 0.3  # gaussian_yolo_layer.c:186
EPSI = 1e-9        # gaussian_yolo_layer.c:187
_SQRT_2PI = float(np.sqrt(np.float32(2.0 * np.pi)))  # f32 sqrt, as jnp.sqrt

METRIC_KEYS = ("iou_loss", "objectness_loss", "classification_loss", "num_matched",
               "avg_iou", "avg_obj", "avg_cat", "recall50", "recall75", "no_obj")


@dataclasses.dataclass(frozen=True)
class DarknetHeadParams:
    """Static per-[yolo]-layer loss parameters (parser.c parse_yolo)."""

    anchors: Tuple[Tuple[float, float], ...]  # all `num` biases, (w, h) px
    mask: Tuple[int, ...]
    classes: int
    net_w: int
    net_h: int
    ignore_thresh: float = 0.5
    truth_thresh: float = 1.0
    iou_normalizer: float = 0.75
    obj_normalizer: float = 1.0
    cls_normalizer: float = 1.0
    uc_normalizer: float = 1.0
    scale_x_y: float = 1.0
    new_coords: bool = False
    gaussian: bool = False
    iou_loss: str = "mse"  # mse|iou|giou|diou|ciou (IOU_LOSS, box.c)
    iou_thresh: float = 1.0
    iou_thresh_kind: str = "iou"  # box_iou_kind for the extra-anchor gate
    objectness_smooth: bool = False
    max_delta: Optional[float] = None  # None = FLT_MAX (no clipping)
    focal_loss: bool = False
    label_smooth_eps: float = 0.0
    # max_count/count per class, capped at max_delta (get_classes_multipliers)
    classes_multipliers: Optional[Tuple[float, ...]] = None

    def __post_init__(self):
        if self.gaussian and self.new_coords:
            raise ValueError(
                "[Gaussian_yolo] with new_coords=1 is unsupported: "
                "darknet's gaussian_yolo_layer.c has no new_coords "
                "branch, so the darknet-exact loss has no oracle "
                "semantics to reproduce")
        if self.iou_loss not in ("mse", "iou", "giou", "diou", "ciou"):
            raise ValueError(f"unknown iou_loss {self.iou_loss!r}")
        if self.iou_thresh_kind not in ("iou", "giou", "diou", "ciou"):
            raise ValueError(f"unknown iou_thresh_kind {self.iou_thresh_kind!r}")
        if self.classes_multipliers is not None and \
                len(self.classes_multipliers) != self.classes:
            raise ValueError("classes_multipliers length != classes")

    @property
    def num_anchors(self) -> int:
        return len(self.mask)

    @property
    def entries(self) -> int:
        return (9 if self.gaussian else 5) + self.classes


@dataclasses.dataclass(frozen=True)
class RegionHeadParams:
    """Static per-[region]-layer loss parameters (parser.c
    parse_region:667-702).  Anchors are in GRID units (DOABS=1)."""

    anchors: Tuple[Tuple[float, float], ...]  # all `num` biases, grid units
    classes: int
    thresh: float = 0.5
    object_scale: float = 1.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    bias_match: bool = False
    rescore: bool = False
    classfix: int = 0
    focal_loss: bool = False
    softmax: bool = True
    # net.seen < 12800 (region_layer.c:288-296): early-training prior-box
    # regression toward the anchor at EVERY cell, scale 0.01
    seen_lt_12800: bool = True

    @property
    def num_anchors(self) -> int:
        return len(self.anchors)

    @property
    def entries(self) -> int:
        return 5 + self.classes


@dataclasses.dataclass(frozen=True)
class V1DetectionParams:
    """Static per-[detection]-layer (YOLOv1) loss parameters
    (detection_layer.c; parser.c parse_detection).  The layer input is a
    FLAT vector per image: [side²·classes probs][side²·num confidences]
    [side²·num·coords boxes]; truth is the v1 grid layout
    [side², 1 + classes + 4] (is_obj, one-hot, x·side, y·side, w, h)."""

    side: int
    num: int
    classes: int
    coords: int = 4
    softmax: bool = False
    sqrt: bool = False
    rescore: bool = False
    object_scale: float = 1.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0

    def __post_init__(self):
        if self.coords != 4:
            raise NotImplementedError("[detection] coords != 4 unsupported")

    @property
    def inputs(self) -> int:
        loc = self.side * self.side
        return loc * (self.classes + self.num * (1 + self.coords))

    @property
    def truth_cols(self) -> int:
        return self.side * self.side * (1 + self.classes + 4)


# ---------------------------------------------------------------------------
# JAX index semantics and per-device constants


def _gather_index(idx: Tensor, n: int) -> Tensor:
    """A JAX gather's index: a negative index wraps once, then the index is
    clamped into range."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """``x[..., idx]`` per leading position, as a JAX gather.  ``idx`` has
    ``x``'s leading shape (without the last dimension)."""
    idx = _gather_index(idx, x.shape[-1])
    return torch.gather(x, -1, idx.unsqueeze(-1)).squeeze(-1)


def _onehot(c: Tensor, n: int) -> Tensor:
    """``jax.nn.one_hot(c, n) != 0``: all False for an index out of range."""
    return torch.arange(n, device=c.device) == c.unsqueeze(-1)


def _at(c: Tensor, n: int) -> Tensor:
    """The entries ``row.at[c]`` writes in JAX: a negative index wraps once,
    an index still out of range writes nothing."""
    return _onehot(torch.where(c < 0, c + n, c), n)


@functools.lru_cache(maxsize=256)
def _head_consts(p, device: torch.device):
    """Per-(params, device) constant tensors of a [yolo] head, uploaded once."""
    n_total = len(p.anchors)
    mask_pos = np.full(n_total, -1, np.int64)
    for k, m in enumerate(p.mask):
        mask_pos[m] = k
    slots_abs = np.asarray([n for n in range(n_total) if mask_pos[n] >= 0], np.int64)

    def t(v, dtype=torch.float32):
        return torch.as_tensor(np.asarray(v), dtype=dtype, device=device)

    # _activate's per-entry select and affine
    e = p.entries
    s, add = p.scale_x_y, -0.5 * (p.scale_x_y - 1.0)
    apply_sig = np.ones((e,), bool)
    mul = np.ones((e,), np.float32)
    off = np.zeros((e,), np.float32)
    if p.gaussian:
        apply_sig[4] = apply_sig[6] = False
        mul[0] = mul[2] = s
        off[0] = off[2] = add
    elif p.new_coords:
        mul[0] = mul[1] = s
        off[0] = off[1] = add
    else:
        apply_sig[2] = apply_sig[3] = False
        mul[4] = s
        off[4] = add
        if e > 5:
            mul[5] = s
            off[5] = add
    return {
        "act_sig": t(apply_sig, torch.bool),
        "act_mul": t(mul),
        "act_off": t(off),
        "anchors_w": t([w for w, _ in p.anchors]),
        "anchors_h": t([h for _, h in p.anchors]),
        "mask_abs": t(list(p.mask), torch.int64),
        "mask_pos": t(mask_pos, torch.int64),
        "slots_abs": t(slots_abs, torch.int64),
        "cls_mults": (t(p.classes_multipliers) if p.classes_multipliers is not None
                      else None),
    }


# ---------------------------------------------------------------------------
# per-cell math


def _iou_xywh(ax, ay, aw, ah, bx, by, bw, bh):
    """darknet box_iou (box.c): 0 when I or U is 0."""
    iw = torch.minimum(ax + aw / 2, bx + bw / 2) - torch.maximum(ax - aw / 2, bx - bw / 2)
    ih = torch.minimum(ay + ah / 2, by + bh / 2) - torch.maximum(ay - ah / 2, by - bh / 2)
    inter = torch.where((iw < 0) | (ih < 0), 0.0, iw * ih)
    union = aw * ah + bw * bh - inter
    return torch.where((inter == 0) | (union == 0), 0.0,
                       inter / torch.where(union == 0, 1.0, union))


def _activate(raw: Tensor, p: DarknetHeadParams) -> Tensor:
    """raw [..., E] → darknet's l.output (activated) buffer.

    - gaussian (gaussian_yolo_layer.c:421-430): logistic on mu_x(0),
      sig_x(1), mu_y(2), sig_y(3), sig_w(5), sig_h(7), obj+cls(8..);
      mu_w(4)/mu_h(6) raw; scal_add on mu_x/mu_y only.
    - new_coords=1 (yolo_layer.c:675-682 if-branch): logistic on every
      entry (the conv's logistic is stripped into this loss); scal_add on
      x(0), y(1).
    - new_coords=0: logistic on x, y, obj, classes; w(2)/h(3) raw; the CPU
      path's scal_add lands on entries 4 and 5 (obj, class0) — the index
      was reassigned inside the else (yolo_layer.c:677-682).  Identity at
      scale_x_y=1.

    The loss computes in f32: a bf16 raw is cast first (the train step
    casts the head outputs, as the reference's does)."""
    c = _head_consts(p, raw.device)
    out = torch.where(c["act_sig"], torch.sigmoid(raw), raw)
    # x*1.0+0.0 is an IEEE identity: untouched entries are bit-exact
    return out * c["act_mul"] + c["act_off"]


def _pred_boxes(out: Tensor, p: DarknetHeadParams, consts) -> Tuple[Tensor, ...]:
    """Decoded boxes for every cell, [B,A,H,W] each (get_yolo_box /
    get_gaussian_yolo_box), in image-ratio units."""
    _, a, fh, fw, _ = out.shape
    dev = out.device
    rows = torch.arange(fh, dtype=torch.float32, device=dev).view(1, 1, fh, 1)
    cols = torch.arange(fw, dtype=torch.float32, device=dev).view(1, 1, 1, fw)
    aw = consts["anchors_w"][consts["mask_abs"]].view(1, a, 1, 1)
    ah = consts["anchors_h"][consts["mask_abs"]].view(1, a, 1, 1)
    if p.gaussian:
        ex, ey, ew, eh = out[..., 0], out[..., 2], out[..., 4], out[..., 6]
    else:
        ex, ey, ew, eh = out[..., 0], out[..., 1], out[..., 2], out[..., 3]
    bx = (cols + ex) / fw
    by = (rows + ey) / fh
    if p.new_coords:
        bw = ew * ew * 4.0 * aw / p.net_w
        bh = eh * eh * 4.0 * ah / p.net_h
    else:
        bw = torch.exp(ew) * aw / p.net_w
        bh = torch.exp(eh) * ah / p.net_h
    return bx, by, bw, bh


def _fix_nan_inf(v: Tensor) -> Tensor:
    return torch.where(torch.isfinite(v), v, 0.0)


def _clip_value(v: Tensor, max_val: Optional[float]) -> Tensor:
    """clip_value (yolo_layer.c:161-172); None = FLT_MAX = no clipping."""
    if max_val is None:
        return v
    return torch.clamp(v, -max_val, max_val)


def _shape_iou_kind(pw, ph, tw, th, kind: str):
    """box_iou_kind on wh-only boxes centered at the origin (the
    truth_shift comparison of the iou_thresh loop, yolo_layer.c:643-647)."""
    inter = torch.minimum(pw, tw) * torch.minimum(ph, th)
    union = pw * ph + tw * th - inter
    iou = torch.where((inter == 0) | (union == 0), 0.0,
                      inter / torch.where(union == 0, 1.0, union))
    if kind == "iou":
        return iou
    if kind == "giou":
        c = torch.maximum(pw, tw) * torch.maximum(ph, th)
        u = union
        return torch.where(c == 0, iou, iou - (c - u) / torch.where(c == 0, 1.0, c))
    # centers coincide → d = 0: diou's penalty and ciou's distance term are 0
    if kind == "diou":
        return iou
    if kind == "ciou":
        ar_loss = 4.0 / (np.pi ** 2) * torch.square(torch.atan(tw / th) - torch.atan(pw / ph))
        alpha = ar_loss / (1.0 - iou + ar_loss + 0.000001)
        c = torch.square(torch.maximum(pw, tw)) + torch.square(torch.maximum(ph, th))
        return torch.where(c == 0, iou, iou - alpha * ar_loss)
    raise ValueError(kind)


def _dx_box_iou(px, py, pw, ph, tx, ty, tw, th, kind: str):
    """dx_box_iou (box.c:258-476), literal translation: gradient of the
    IoU-family score wrt the predicted box (x, y, w, h), with the
    original's sequential corner swap and Iw<=0 overrides."""
    where = torch.where
    pred_top, pred_bot = py - ph / 2, py + ph / 2
    pred_left, pred_right = px - pw / 2, px + pw / 2
    pred_t = torch.minimum(pred_top, pred_bot)
    pred_b = torch.maximum(pred_top, pred_bot)
    pred_l = torch.minimum(pred_left, pred_right)
    pred_r = torch.maximum(pred_left, pred_right)
    tt, tb = ty - th / 2, ty + th / 2
    tl, tr = tx - tw / 2, tx + tw / 2

    X = (pred_b - pred_t) * (pred_r - pred_l)
    Ih = torch.minimum(pred_b, tb) - torch.maximum(pred_t, tt)
    Iw = torch.minimum(pred_r, tr) - torch.maximum(pred_l, tl)
    I = Iw * Ih
    Xhat = (tb - tt) * (tr - tl)
    U = X + Xhat - I
    S = torch.square(px - tx) + torch.square(py - ty)
    giou_Cw = torch.maximum(pred_r, tr) - torch.minimum(pred_l, tl)
    giou_Ch = torch.maximum(pred_b, tb) - torch.minimum(pred_t, tt)
    giou_C = giou_Cw * giou_Ch

    dX_wrt_t = -(pred_r - pred_l)
    dX_wrt_b = pred_r - pred_l
    dX_wrt_l = -(pred_b - pred_t)
    dX_wrt_r = pred_b - pred_t
    dI_wrt_t = where(pred_t > tt, -Iw, 0.0)
    dI_wrt_b = where(pred_b < tb, Iw, 0.0)
    dI_wrt_l = where(pred_l > tl, -Ih, 0.0)
    dI_wrt_r = where(pred_r < tr, Ih, 0.0)
    dU_wrt_t = dX_wrt_t - dI_wrt_t
    dU_wrt_b = dX_wrt_b - dI_wrt_b
    dU_wrt_l = dX_wrt_l - dI_wrt_l
    dU_wrt_r = dX_wrt_r - dI_wrt_r
    dC_wrt_t = where(pred_t < tt, -giou_Cw, 0.0)
    dC_wrt_b = where(pred_b > tb, giou_Cw, 0.0)
    dC_wrt_l = where(pred_l < tl, -giou_Ch, 0.0)
    dC_wrt_r = where(pred_r > tr, giou_Ch, 0.0)

    u_pos = U > 0
    usq = where(u_pos, U * U, 1.0)
    p_dt = where(u_pos, ((U * dI_wrt_t) - (I * dU_wrt_t)) / usq, 0.0)
    p_db = where(u_pos, ((U * dI_wrt_b) - (I * dU_wrt_b)) / usq, 0.0)
    p_dl = where(u_pos, ((U * dI_wrt_l) - (I * dU_wrt_l)) / usq, 0.0)
    p_dr = where(u_pos, ((U * dI_wrt_r) - (I * dU_wrt_r)) / usq, 0.0)
    # sequential corner swap exactly as written (box.c:341-344): the
    # second assignment reads the already-updated p_dt/p_dl
    tb_ok = pred_top < pred_bot
    lr_ok = pred_left < pred_right
    p_dt = where(tb_ok, p_dt, p_db)
    p_db = where(tb_ok, p_db, p_dt)
    p_dl = where(lr_ok, p_dl, p_dr)
    p_dr = where(lr_ok, p_dr, p_dl)

    if kind == "giou":
        # unguarded giou_C*giou_C division exactly as the C: a zero C makes
        # inf/nan that the caller's fix_nan_inf zeroes, same as darknet
        csq = giou_C * giou_C
        g_dt = ((giou_C * dU_wrt_t) - (U * dC_wrt_t)) / csq
        g_db = ((giou_C * dU_wrt_b) - (U * dC_wrt_b)) / csq
        g_dl = ((giou_C * dU_wrt_l) - (U * dC_wrt_l)) / csq
        g_dr = ((giou_C * dU_wrt_r) - (U * dC_wrt_r)) / csq
        p_dt = where(giou_C > 0, p_dt + g_dt, p_dt)
        p_db = where(giou_C > 0, p_db + g_db, p_db)
        p_dl = where(giou_C > 0, p_dl + g_dl, p_dl)
        p_dr = where(giou_C > 0, p_dr + g_dr, p_dr)
        no_i = (Iw <= 0) | (Ih <= 0)
        p_dt = where(no_i, g_dt, p_dt)
        p_db = where(no_i, g_db, p_db)
        p_dl = where(no_i, g_dl, p_dl)
        p_dr = where(no_i, g_dr, p_dr)

    # DIoU/CIoU enclosing-diagonal terms (box.c:357-449)
    Ct = torch.minimum(py - ph / 2, ty - th / 2)
    Cb = torch.maximum(py + ph / 2, ty + th / 2)
    Cl = torch.minimum(px - pw / 2, tx - tw / 2)
    Cr = torch.maximum(px + pw / 2, tx + tw / 2)
    Cw = Cr - Cl
    Ch = Cb - Ct
    C = Cw * Cw + Ch * Ch

    dCt_dy = where(pred_t < tt, 1.0, 0.0)
    dCt_dh = where(pred_t < tt, -0.5, 0.0)
    dCb_dy = where(pred_b > tb, 1.0, 0.0)
    dCb_dh = where(pred_b > tb, 0.5, 0.0)
    dCl_dx = where(pred_l < tl, 1.0, 0.0)
    dCl_dw = where(pred_l < tl, -0.5, 0.0)
    dCr_dx = where(pred_r > tr, 1.0, 0.0)
    dCr_dw = where(pred_r > tr, 0.5, 0.0)
    dCw_dx = dCr_dx - dCl_dx
    dCw_dw = dCr_dw - dCl_dw
    dCh_dy = dCb_dy - dCt_dy
    dCh_dh = dCb_dh - dCt_dh

    p_dx = p_dl + p_dr
    p_dy = p_dt + p_db
    p_dw = p_dr - p_dl
    p_dh = p_db - p_dt

    if kind in ("diou", "ciou"):
        csq = C * C  # unguarded, like the C (fix_nan_inf downstream)
        d_dx = (2 * (tx - px) * C - (2 * Cw * dCw_dx) * S) / csq
        d_dy = (2 * (ty - py) * C - (2 * Ch * dCh_dy) * S) / csq
        d_dw = (2 * Cw * dCw_dw) * S / csq
        d_dh = (2 * Ch * dCh_dh) * S / csq
        if kind == "ciou":
            ar_gt = tw / th
            ar_pred = pw / ph
            d_atan = torch.atan(ar_gt) - torch.atan(ar_pred)
            ar_loss = 4.0 / (np.pi ** 2) * d_atan * d_atan
            alpha = ar_loss / (1.0 - I / U + ar_loss + 0.000001)
            ar_dw = 8.0 / (np.pi ** 2) * d_atan * ph
            ar_dh = -8.0 / (np.pi ** 2) * d_atan * pw
            d_dw = d_dw + alpha * ar_dw
            d_dh = d_dh + alpha * ar_dh
        p_dx = where(C > 0, p_dx + d_dx, p_dx)
        p_dy = where(C > 0, p_dy + d_dy, p_dy)
        p_dw = where(C > 0, p_dw + d_dw, p_dw)
        p_dh = where(C > 0, p_dh + d_dh, p_dh)
        no_i = (Iw <= 0) | (Ih <= 0)
        p_dx = where(no_i, d_dx, p_dx)
        p_dy = where(no_i, d_dy, p_dy)
        p_dw = where(no_i, d_dw, p_dw)
        p_dh = where(no_i, d_dh, p_dh)

    return p_dx, p_dy, p_dw, p_dh


def _stack(values) -> Tensor:
    """``jnp.stack(values)`` of per-coordinate terms, broadcast to one shape
    first (a truth's terms are [..., 1] where its anchors' are [..., K]),
    on a new last dimension."""
    return torch.stack(torch.broadcast_tensors(*values), -1)


def _box_delta_terms(cell, x, y, w, h, i, j, fw, fh, aw_b, ah_b,
                     iou_norm, p: DarknetHeadParams) -> Tensor:
    """delta_yolo_box / delta_gaussian_yolo_box for (cell, truth) pairs:
    cell [..., E], the rest broadcastable to [...]; returns the [..., nbox]
    addition to the accumulated box delta.  `iou_norm` already carries
    the class multiplier."""
    scale = 2.0 - w * h
    fi, fj = i.to(torch.float32), j.to(torch.float32)
    if p.gaussian:
        # NLL sigma deltas always; mu deltas replaced by dx_box_iou when
        # iou_loss != mse (delta_gaussian_yolo_box:215-303)
        t0 = x * fw - fi
        t2 = y * fh - fj
        t4 = torch.log(w * p.net_w / aw_b)
        t6 = torch.log(h * p.net_h / ah_b)
        mu = cell[..., 0:8:2]
        sg = cell[..., 1:8:2]
        d = _stack([t0, t2, t4, t6]) - mu
        in_exp = d / sg
        in_exp2 = in_exp * in_exp
        nd = torch.exp(-0.5 * in_exp2) / (_SQRT_2PI * (sg + SIGMA_CONST))
        temp = 0.5 * nd / (nd + EPSI) * scale.unsqueeze(-1)
        d_sg = temp * (in_exp2 / sg - 1.0 / (sg + SIGMA_CONST)) * p.uc_normalizer
        if p.iou_loss == "mse":
            d_mu = temp * in_exp / sg * iou_norm.unsqueeze(-1)
        else:
            px = (fi + cell[..., 0]) / fw
            py = (fj + cell[..., 2]) / fh
            pw = torch.exp(cell[..., 4]) * aw_b / p.net_w
            ph = torch.exp(cell[..., 6]) * ah_b / p.net_h
            pw = torch.where(pw == 0, 1.0, pw)
            ph = torch.where(ph == 0, 1.0, ph)
            dx, dy, dw, dh = _dx_box_iou(px, py, pw, ph, x, y, w, h, p.iou_loss)
            dw = dw * torch.exp(cell[..., 4])
            dh = dh * torch.exp(cell[..., 6])
            d_mu = _stack([dx, dy, dw, dh]) * iou_norm.unsqueeze(-1)
        d_mu = _clip_value(_fix_nan_inf(d_mu), p.max_delta)
        d_sg = _clip_value(_fix_nan_inf(d_sg), p.max_delta)
        return torch.stack([d_mu, d_sg], -1).flatten(-2)  # mu0 sg0 mu1 sg1 …

    if p.iou_loss == "mse":
        t0 = x * fw - fi
        t1 = y * fh - fj
        if p.new_coords:
            t2 = torch.sqrt(w * p.net_w / (4.0 * aw_b))
            t3 = torch.sqrt(h * p.net_h / (4.0 * ah_b))
        else:
            t2 = torch.log(w * p.net_w / aw_b)
            t3 = torch.log(h * p.net_h / ah_b)
        # MSE mode: scale applies, max_delta does NOT (delta_yolo_box's
        # clip lives only in the IoU branch, yolo_layer.c:193-293)
        return (scale.unsqueeze(-1) * (_stack([t0, t1, t2, t3]) - cell[..., :4])
                * iou_norm.unsqueeze(-1))

    # IoU-family branch (delta_yolo_box:216-285): decode the pred box at
    # the cell, analytic gradient, darknet's literal exp chain factor
    px = (fi + cell[..., 0]) / fw
    py = (fj + cell[..., 1]) / fh
    if p.new_coords:
        pw = cell[..., 2] * cell[..., 2] * 4.0 * aw_b / p.net_w
        ph = cell[..., 3] * cell[..., 3] * 4.0 * ah_b / p.net_h
    else:
        pw = torch.exp(cell[..., 2]) * aw_b / p.net_w
        ph = torch.exp(cell[..., 3]) * ah_b / p.net_h
    pw = torch.where(pw == 0, 1.0, pw)
    ph = torch.where(ph == 0, 1.0, ph)
    dx, dy, dw, dh = _dx_box_iou(px, py, pw, ph, x, y, w, h, p.iou_loss)
    if not p.new_coords:
        dw = dw * torch.exp(cell[..., 2])
        dh = dh * torch.exp(cell[..., 3])
    dv = _stack([dx, dy, dw, dh]) * iou_norm.unsqueeze(-1)
    return _clip_value(_fix_nan_inf(dv), p.max_delta)


def _class_delta_parts(cell_cls, c, cls_mult_c, p: DarknetHeadParams):
    """The parts of delta_yolo_class / delta_gaussian_yolo_class that do not
    depend on the current class-delta row: the truth entry's new value in
    the first branch (before the non-finite fallback and the multiplier)
    and the whole new row of the second.  cell_cls [..., C]; c and
    cls_mult_c [...]."""
    eps = p.label_smooth_eps
    y_true_c = 1.0 * (1.0 - eps) + 0.5 * eps if eps else 1.0
    keep_val = y_true_c - _take(cell_cls, c)
    onehot = _onehot(c, p.classes).to(torch.float32)
    if p.focal_loss and not p.gaussian:
        # focal branch (delta_yolo_class:330-346): alpha=0.5, no smoothing,
        # no class multipliers
        pt = _take(cell_cls, c) + 1e-15
        grad = -(1.0 - pt) * (2.0 * pt * torch.log(pt) + pt - 1.0)
        fresh = (onehot - cell_cls) * (0.5 * grad).unsqueeze(-1)
    else:
        y_true = onehot * (1.0 - eps) + 0.5 * eps if eps else onehot
        fresh = y_true - cell_cls
        if p.classes_multipliers is not None:
            fresh = torch.where(_at(c, p.classes),
                                fresh * (cls_mult_c * p.cls_normalizer).unsqueeze(-1), fresh)
    return keep_val, fresh


def _class_delta_select(row, keep_val, keep_finite, fresh, c_index, c_at, cls_mult_c,
                        p: DarknetHeadParams):
    """The new class-delta row given the current ``row`` [..., C]: the
    first branch (only the truth entry, the entries ``c_at``, is
    rewritten) where the probed entry is nonzero, else ``fresh``.
    ``c_index`` is the truth class as a gather index; ``keep_finite`` is
    ``isfinite(keep_val)`` (the [yolo] first branch keeps the old entry
    where the new one is not finite)."""
    row_c = torch.gather(row, -1, c_index.unsqueeze(-1)).squeeze(-1)
    if not p.gaussian:
        keep_val = torch.where(keep_finite, keep_val, row_c)
    if p.classes_multipliers is not None:
        keep_val = keep_val * cls_mult_c
    keep = torch.where(c_at, keep_val.unsqueeze(-1), row)
    probe = row[..., 0] if p.gaussian else row_c  # gaussian probes delta[index]
    return torch.where((probe != 0.0).unsqueeze(-1), keep, fresh)


def _class_delta_row(row, cell_cls, c, cls_mult_c, p: DarknetHeadParams):
    """delta_yolo_class / delta_gaussian_yolo_class: the new class-delta
    row given the current ``row``.  `cls_mult_c` is the truth class's
    multiplier (1.0 when counters_per_class is absent)."""
    keep_val, fresh = _class_delta_parts(cell_cls, c, cls_mult_c, p)
    return _class_delta_select(row, keep_val, torch.isfinite(keep_val), fresh,
                               _gather_index(c, p.classes), _at(c, p.classes), cls_mult_c, p)


def _truth_columns(truth: Tensor):
    """truth [B,T,5] → x, y, w, h [B,T] f32 and the class [B,T] int64."""
    truth = truth.to(torch.float32)
    return (truth[..., 0], truth[..., 1], truth[..., 2], truth[..., 3],
            truth[..., 4].to(torch.int64))


def _reached(tx: Tensor) -> Tensor:
    """`if(!truth.x) break`: the truths before the first x == 0."""
    return torch.cumprod((tx != 0.0).to(torch.int32), dim=1) == 1


def _cell_ious(out, tx, ty, tw, th, tvalid, p: DarknetHeadParams, consts):
    """The per-cell pass's IoUs: every cell's decoded box against every
    valid truth [B,A,H,W,T], and the best of them at cells where some class
    probability exceeds 0.25 (compare_yolo_class:357-368), else 0."""
    b, t_count = tx.shape
    bx, by, bw, bh = _pred_boxes(out, p, consts)

    def per_truth(v):  # [B,T] → [B,1,1,1,T]
        return v.view(b, 1, 1, 1, t_count)

    ious = _iou_xywh(bx.unsqueeze(-1), by.unsqueeze(-1), bw.unsqueeze(-1), bh.unsqueeze(-1),
                     per_truth(tx), per_truth(ty), per_truth(tw), per_truth(th))
    ious = torch.where(per_truth(tvalid), ious, 0.0)
    cls_e = 9 if p.gaussian else 5
    class_match = torch.any(out[..., cls_e:] > 0.25, dim=-1)  # [B,A,H,W]
    return ious, torch.where(class_match, torch.amax(ious, dim=-1), 0.0)


def _truth_candidates(tx, ty, tw, th, tvalid, a, fh, fw, p: DarknetHeadParams, consts):
    """Where each truth writes: its cell (i, j) [B,T], its best anchor over
    ALL `num` anchors by centered IoU (ties → lowest index) [B,T], and its
    candidate anchors [B,T,K] with whether each is written and its mask
    slot.  The candidates are the best anchor (yolo_layer.c:543-599) plus,
    when iou_thresh < 1, every other MASKED anchor whose shape-IoU
    (iou_thresh_kind) vs the wh-only truth beats the threshold (:601-656);
    distinct anchor slots are distinct cells."""
    b, t_count = tx.shape
    anchors_w, anchors_h = consts["anchors_w"], consts["anchors_h"]
    i = torch.clamp(torch.floor(tx * fw).to(torch.int64), 0, fw - 1)
    j = torch.clamp(torch.floor(ty * fh).to(torch.int64), 0, fh - 1)
    pw_a, ph_a = anchors_w / p.net_w, anchors_h / p.net_h  # [N]
    inter = torch.minimum(pw_a, tw.unsqueeze(-1)) * torch.minimum(ph_a, th.unsqueeze(-1))
    union = pw_a * ph_a + (tw * th).unsqueeze(-1) - inter
    an_iou = torch.where((inter == 0) | (union == 0), 0.0,
                         inter / torch.where(union == 0, 1.0, union))  # [B,T,N]
    best_n = torch.argmax(an_iou, dim=-1)
    if p.iou_thresh < 1.0:
        cand_abs = consts["slots_abs"].expand(b, t_count, -1)
        shape_ious = _shape_iou_kind(
            anchors_w[cand_abs] / p.net_w, anchors_h[cand_abs] / p.net_h,
            tw.unsqueeze(-1), th.unsqueeze(-1), p.iou_thresh_kind)
        sels0 = (cand_abs == best_n.unsqueeze(-1)) | (shape_ious > p.iou_thresh)
    else:
        cand_abs = best_n.unsqueeze(-1)
        sels0 = torch.ones(cand_abs.shape, dtype=torch.bool, device=tx.device)
    mns = consts["mask_pos"][cand_abs]
    sels = tvalid.unsqueeze(-1) & (mns >= 0) & sels0
    return i, j, best_n, cand_abs, sels, torch.remainder(mns, a)


def head_decisions(raw: Tensor, truth: Tensor, p: DarknetHeadParams) -> dict:
    """The discrete decisions of a [yolo]/[Gaussian_yolo] head's loss on raw
    [B,A,H,W,E] and truth [B,T,5], as bool/int64 tensors: the cells whose
    negative objectness the ignore threshold drops (``ignored``) and those
    past ``truth_thresh``, each truth's best anchor and, for each of its
    candidate anchors, whether it is written and at which (slot, j, i)
    (-1 where not).  Two devices train alike only if these agree."""
    b, a, fh, fw, _ = raw.shape
    consts = _head_consts(p, raw.device)
    out = _activate(raw.to(torch.float32), p)
    tx, ty, tw, th, tcls = _truth_columns(truth)
    tvalid = _reached(tx) & (tcls >= 0) & (tcls < p.classes)
    ious, best_match_iou = _cell_ious(out, tx, ty, tw, th, tvalid, p, consts)
    i, j, best_n, _, sels, slot = _truth_candidates(tx, ty, tw, th, tvalid, a, fh, fw,
                                                    p, consts)
    cell = torch.stack([slot, j.unsqueeze(-1).expand_as(slot),
                        i.unsqueeze(-1).expand_as(slot)], -1)
    return {"ignored": best_match_iou > p.ignore_thresh,
            "truth_thresh": torch.amax(ious, dim=-1) > p.truth_thresh,
            "best_anchor": best_n, "written": sels,
            "written_cell": torch.where(sels.unsqueeze(-1), cell, -1)}


def _head_deltas(raw: Tensor, truth: Tensor, p: DarknetHeadParams, stats: bool = False):
    """raw [B,A,H,W,E], truth [B,T,5] → (delta [B,A,H,W,E], tot_iou_loss
    [B], count [B]) — plus, with ``stats``, a 6-tuple of darknet's
    console-telemetry accumulators [B] (tot_iou, recall50, recall75,
    obj_sum, cat_sum, sobj_sum).

    tot_iou_loss and count feed the non-MSE reported cost only
    (yolo_layer.c show_details branch, :901-916): per delta_yolo_box
    application, 1 - IoU (1 - GIoU for iou_loss=giou) of the decoded pred
    box vs the truth, and the number of applications."""
    b, a, fh, fw, e = raw.shape
    t_count = truth.shape[1]
    dev = raw.device
    consts = _head_consts(p, dev)
    out = _activate(raw.to(torch.float32), p)
    obj_e = 8 if p.gaussian else 4
    cls_e = obj_e + 1
    nbox = obj_e
    n_cls = p.classes

    tx, ty, tw, th, tcls = _truth_columns(truth)
    # `if(!truth.x) break` + class-range `continue` (yolo_layer.c:430-438)
    tvalid = _reached(tx) & (tcls >= 0) & (tcls < n_cls)
    cls_mults = consts["cls_mults"]

    # ---- per-cell pass -------------------------------------------------
    ious, best_match_iou = _cell_ious(out, tx, ty, tw, th, tvalid, p, consts)

    def truth_at(v, t_idx):  # v [B,T], t_idx [B,A,H,W] → v at t_idx
        return torch.gather(v, 1, t_idx.reshape(b, -1)).view(t_idx.shape)

    sobj = out[..., obj_e]
    obj_delta = p.obj_normalizer * (0.0 - sobj)
    ignored = best_match_iou > p.ignore_thresh
    cls_delta0 = torch.zeros((b, a, fh, fw, n_cls), dtype=torch.float32, device=dev)
    if p.objectness_smooth:
        if p.gaussian:
            # gaussian_yolo_layer.c:495-505: iou^2 target + class delta at
            # the best-matching truth's class (full-row overwrite — the
            # class deltas are all zero at this point)
            iou_mult = best_match_iou * best_match_iou
            smooth_val = p.obj_normalizer * (iou_mult - sobj)
            obj_delta = torch.where(ignored, smooth_val, obj_delta)
            bm_cls = truth_at(tcls, torch.argmax(ious, dim=-1))  # [B,A,H,W]
            onehot = _onehot(bm_cls, n_cls).to(torch.float32)
            eps = p.label_smooth_eps
            y_true = onehot * (1.0 - eps) + 0.5 * eps if eps else onehot
            fresh = y_true - out[..., cls_e:]
            if cls_mults is not None:
                mult = cls_mults[_gather_index(bm_cls, n_cls)].unsqueeze(-1)
                mult_row = torch.where(_onehot(bm_cls, n_cls), mult * p.cls_normalizer, 1.0)
                fresh = fresh * mult_row
            cls_delta0 = torch.where(ignored.unsqueeze(-1), fresh, cls_delta0)
        else:
            # yolo_layer.c:457-462: keep max(smooth positive, negative)
            smooth_val = p.obj_normalizer * (best_match_iou - sobj)
            obj_delta = torch.where(ignored, torch.maximum(smooth_val, obj_delta), obj_delta)
    else:
        obj_delta = torch.where(ignored, 0.0, obj_delta)

    anchors_w, anchors_h = consts["anchors_w"], consts["anchors_h"]
    box_delta0 = torch.zeros((b, a, fh, fw, nbox), dtype=torch.float32, device=dev)

    def mult_of(c):  # the class multiplier of class index c (1.0 without)
        if cls_mults is None:
            return torch.ones(c.shape, dtype=torch.float32, device=dev)
        return cls_mults[_gather_index(c, n_cls)]

    if p.truth_thresh < 1.0:
        # per-cell multi-positive branch (yolo_layer.c:493-519,
        # gaussian_yolo_layer.c:517-527): every cell whose best pred-IoU
        # over the truths (NOT class-gated) beats truth_thresh receives
        # positive obj/class deltas and an accumulated box delta toward
        # its best truth, at the cell's OWN anchor; before the per-truth
        # pass, as darknet's loop order is.
        best_iou_all = torch.amax(ious, dim=-1)  # [B,A,H,W]
        best_t_all = torch.argmax(ious, dim=-1)
        tt_mask = best_iou_all > p.truth_thresh
        bt_cls = truth_at(tcls, best_t_all)
        iou_mult = best_iou_all * best_iou_all
        if p.objectness_smooth:
            obj_tt = p.obj_normalizer * (iou_mult - sobj)
        else:
            obj_tt = p.obj_normalizer * (1.0 - sobj)
        obj_delta = torch.where(tt_mask, obj_tt, obj_delta)

        cell_cls = out[..., cls_e:]
        cell_mult = mult_of(bt_cls)
        new_rows = _class_delta_row(cls_delta0, cell_cls, bt_cls, cell_mult, p)
        if p.objectness_smooth:
            # l.delta[class] = class_mult * (iou_mult - output[class])
            # overwrite on the truth class (yolo_layer.c:503)
            upd = cell_mult * (iou_mult - _take(cell_cls, bt_cls))
            new_rows = torch.where(_at(bt_cls, n_cls), upd.unsqueeze(-1), new_rows)
        cls_delta0 = torch.where(tt_mask.unsqueeze(-1), new_rows, cls_delta0)

        # box delta toward the best truth at the cell's own anchor
        slot_abs = consts["mask_abs"].view(1, a, 1, 1)
        rows_i = torch.arange(fh, device=dev).view(1, 1, fh, 1)
        cols_i = torch.arange(fw, device=dev).view(1, 1, 1, fw)
        add = _box_delta_terms(
            out, truth_at(tx, best_t_all), truth_at(ty, best_t_all),
            truth_at(tw, best_t_all), truth_at(th, best_t_all), cols_i, rows_i, fw, fh,
            anchors_w[slot_abs], anchors_h[slot_abs], p.iou_normalizer * cell_mult, p)
        box_delta0 = box_delta0 + torch.where(tt_mask.unsqueeze(-1), add, 0.0)

    # ---- per-truth pass ------------------------------------------------
    # What each truth computes from `out` alone, for all T truths at once.
    i, j, _, cand_abs, sels, slot = _truth_candidates(tx, ty, tw, th, tvalid, a, fh, fw,
                                                      p, consts)
    cls_mult_c = mult_of(tcls)  # [B,T]
    iou_norm = p.iou_normalizer * cls_mult_c
    bidx = torch.arange(b, device=dev).view(b, 1, 1)
    ik, jk = i.unsqueeze(-1), j.unsqueeze(-1)
    cells = out[bidx, slot, jk, ik]  # [B,T,K,E]
    aw_c, ah_c = anchors_w[cand_abs], anchors_h[cand_abs]
    xk, yk, wk, hk = (v.unsqueeze(-1) for v in (tx, ty, tw, th))
    adds = _box_delta_terms(cells, xk, yk, wk, hk, ik, jk, fw, fh, aw_c, ah_c,
                            iou_norm.unsqueeze(-1), p)  # [B,T,K,nbox]

    zero_b = torch.zeros((b,), dtype=torch.float32, device=dev)
    tot_l, cnt = zero_b, zero_b
    need_iou = stats or (not p.gaussian and p.iou_loss != "mse")
    if need_iou:
        # reported-cost accumulators (delta_yolo_box's all_ious, computed
        # on the UNfixed pred box, box.c/yolo_layer.c)
        if p.gaussian:
            ex, ey, ew, eh = cells[..., 0], cells[..., 2], cells[..., 4], cells[..., 6]
        else:
            ex, ey, ew, eh = cells[..., 0], cells[..., 1], cells[..., 2], cells[..., 3]
        px = (ik.to(torch.float32) + ex) / fw
        py = (jk.to(torch.float32) + ey) / fh
        if p.new_coords:
            pbw = ew * ew * 4.0 * aw_c / p.net_w
            pbh = eh * eh * 4.0 * ah_c / p.net_h
        else:
            pbw = torch.exp(ew) * aw_c / p.net_w
            pbh = torch.exp(eh) * ah_c / p.net_h
        iou_plain = _iou_xywh(px, py, pbw, pbh, xk, yk, wk, hk)
        if p.iou_loss == "giou" and not p.gaussian:
            c_area = (torch.maximum(px + pbw / 2, xk + wk / 2)
                      - torch.minimum(px - pbw / 2, xk - wk / 2)) * (
                torch.maximum(py + pbh / 2, yk + hk / 2)
                - torch.minimum(py - pbh / 2, yk - hk / 2))
            inter_w = torch.minimum(px + pbw / 2, xk + wk / 2) \
                - torch.maximum(px - pbw / 2, xk - wk / 2)
            inter_h = torch.minimum(py + pbh / 2, yk + hk / 2) \
                - torch.maximum(py - pbh / 2, yk - hk / 2)
            inter_a = torch.where((inter_w < 0) | (inter_h < 0), 0.0, inter_w * inter_h)
            u_area = pbw * pbh + wk * hk - inter_a
            iou_vs = torch.where(c_area == 0, iou_plain,
                                 iou_plain - (c_area - u_area)
                                 / torch.where(c_area == 0, 1.0, c_area))
        else:
            iou_vs = iou_plain
        if not p.gaussian and p.iou_loss != "mse":
            tot_l = torch.sum(torch.where(sels, 1.0 - iou_vs, 0.0), dim=(1, 2))
        cnt = torch.sum(sels.to(torch.float32), dim=(1, 2))
    c_k = tcls.unsqueeze(-1).expand_as(sels)  # each candidate's truth class
    if stats:
        tail = (
            torch.sum(torch.where(sels, iou_plain, 0.0), dim=(1, 2)),
            torch.sum((sels & (iou_plain > 0.5)).to(torch.float32), dim=(1, 2)),
            torch.sum((sels & (iou_plain > 0.75)).to(torch.float32), dim=(1, 2)),
            torch.sum(torch.where(sels, cells[..., obj_e], 0.0), dim=(1, 2)),
            torch.sum(torch.where(sels, _take(cells[..., cls_e:], c_k), 0.0), dim=(1, 2)),
        )

    pos_obj = (cls_mult_c * p.obj_normalizer).unsqueeze(-1) * (1.0 - cells[..., obj_e])
    m_k = cls_mult_c.unsqueeze(-1).expand_as(sels)
    keep_val, fresh = _class_delta_parts(cells[..., cls_e:], c_k, m_k, p)

    # The sequential part, on darknet's l.delta rows [box | obj | classes]:
    # truth t reads the rows of its cells, then writes them back.  Its
    # operands are laid out truth-major, so that each step takes views.
    def by_truth(v):  # [B,T,K,...] → [T, B·K, ...]
        return v.transpose(0, 1).reshape(t_count, b * v.shape[2], *v.shape[3:])

    lin = ((bidx * a + slot) * fh + jk) * fw + ik  # [B,T,K] row of each candidate
    lin, sel_t, add_t, pos_t, keep_t, finite_t, fresh_t, m_t = (
        by_truth(v) for v in (lin, sels, adds, pos_obj, keep_val, torch.isfinite(keep_val),
                              fresh, m_k))
    c_index_t = by_truth(_gather_index(c_k, n_cls))
    c_at_t = by_truth(_at(c_k, n_cls))
    delta = torch.cat([box_delta0, obj_delta.unsqueeze(-1), cls_delta0], dim=-1)
    delta = delta.reshape(b * a * fh * fw, e)
    smooth_yolo = p.objectness_smooth and not p.gaussian
    for t in range(t_count):
        idx = lin[t]
        rows = delta[idx]  # [B·K, E]
        box = rows[:, :nbox] + add_t[t]
        new_obj = pos_t[t]
        if smooth_yolo:
            # only land the positive delta on a zeroed cell (:578-584)
            cur_obj = rows[:, nbox]
            new_obj = torch.where(cur_obj == 0.0, new_obj, cur_obj)
        cls = _class_delta_select(rows[:, cls_e:], keep_t[t], finite_t[t], fresh_t[t],
                                  c_index_t[t], c_at_t[t], m_t[t], p)
        new = torch.cat([box, new_obj.unsqueeze(-1), cls], dim=-1)
        delta[idx] = torch.where(sel_t[t].unsqueeze(-1), new, rows)
    delta = delta.view(b, a, fh, fw, e)

    box_delta, obj_delta, cls_delta = delta[..., :nbox], delta[..., nbox], delta[..., cls_e:]
    if p.gaussian or p.iou_thresh < 1.0:
        n_in_box = torch.sum((cls_delta > 0.0).to(torch.float32), dim=-1)
        if p.gaussian:
            # averages_gaussian_yolo_deltas: every cell, unconditionally
            div = n_in_box > 0
        else:
            # averages_yolo_deltas: only cells with a nonzero obj delta
            # (yolo_layer.c:645-660)
            div = (obj_delta != 0.0) & (n_in_box > 0)
        box_delta = torch.where(div.unsqueeze(-1),
                                box_delta / torch.clamp(n_in_box, min=1.0).unsqueeze(-1),
                                box_delta)
        delta = torch.cat([box_delta, delta[..., nbox:]], dim=-1)
    if stats:
        # avg_anyobj accumulates the activated objectness at EVERY cell
        # (yolo_layer.c:448); the rest came from the per-truth pass
        return delta, tot_l, cnt, tail + (torch.sum(sobj, dim=(1, 2, 3)),)
    return delta, tot_l, cnt


def _head_cost_and_delta(raw: Tensor, truth: Tensor, p):
    """raw [B,A,H,W,E], truth [B,T,5] → (cost, delta [B,A,H,W,E]).

    mse and gaussian heads: cost = |delta|² over the batch (mag_array
    squared, yolo_layer.c:893).  IoU-family [yolo] heads report
    darknet's show_details cost (:901-916): iou_normalizer ·
    tot_iou_loss/count + obj_normalizer · |delta without box entries|².
    [region] heads always report |delta|² (region_layer.c:363)."""
    if isinstance(p, RegionHeadParams):
        delta = _region_head_deltas(raw, truth, p)
        return torch.sum(delta * delta), delta
    delta, tot, cnt = _head_deltas(raw, truth, p)
    if p.gaussian or p.iou_loss == "mse":
        return torch.sum(delta * delta), delta
    nonbox = delta[..., 4:]
    class_cost = p.obj_normalizer * torch.sum(nonbox * nonbox)
    cnt_total = torch.sum(cnt)
    avg_iou_loss = torch.where(
        cnt_total > 0, p.iou_normalizer * torch.sum(tot) / torch.clamp(cnt_total, min=1.0), 0.0)
    return avg_iou_loss + class_cost, delta


def _head_cost_delta_stats(raw: Tensor, truth: Tensor, p: DarknetHeadParams):
    """Like :func:`_head_cost_and_delta` (the same cost and delta), plus
    the per-term cost components (box/obj/cls, summing to the head's
    cost) and darknet's console telemetry accumulators."""
    if isinstance(p, RegionHeadParams):
        raise TypeError("stats path supports [yolo]/[gaussian_yolo] only")
    delta, tot, cnt, st = _head_deltas(raw, truth, p, stats=True)
    nbox = 8 if p.gaussian else 4
    box_sq = torch.sum(delta[..., :nbox] ** 2)
    obj_sq = torch.sum(delta[..., nbox] ** 2)
    cls_sq = torch.sum(delta[..., nbox + 1:] ** 2)
    cnt_total = torch.sum(cnt)
    if p.gaussian or p.iou_loss == "mse":
        terms = (box_sq, obj_sq, cls_sq)
    else:
        avg_iou_loss = torch.where(
            cnt_total > 0,
            p.iou_normalizer * torch.sum(tot) / torch.clamp(cnt_total, min=1.0), 0.0)
        terms = (avg_iou_loss, p.obj_normalizer * obj_sq, p.obj_normalizer * cls_sq)
    cost = terms[0] + terms[1] + terms[2]
    tot_iou, r50, r75, obj_s, cat_s, sobj_s = (torch.sum(v) for v in st)
    stats = {
        "count": cnt_total, "tot_iou": tot_iou, "recall50": r50, "recall75": r75,
        "obj_sum": obj_s, "cat_sum": cat_s, "sobj_sum": sobj_s,
        "n_cells": float(np.prod(delta.shape[:-1])),  # B*A*H*W
    }
    return cost, delta, terms, stats


def _collect_metrics(all_terms, all_stats, n_heads, batch) -> dict:
    denom = float(n_heads * batch)
    count = sum(s["count"] for s in all_stats)
    safe = torch.clamp(count, min=1.0)
    cells = np.float32(sum(s["n_cells"] for s in all_stats))
    return {
        "iou_loss": sum(t[0] for t in all_terms) / denom,
        "objectness_loss": sum(t[1] for t in all_terms) / denom,
        "classification_loss": sum(t[2] for t in all_terms) / denom,
        "num_matched": count.to(torch.int32),
        "avg_iou": sum(s["tot_iou"] for s in all_stats) / safe,
        "avg_obj": sum(s["obj_sum"] for s in all_stats) / safe,
        "avg_cat": sum(s["cat_sum"] for s in all_stats) / safe,
        "recall50": sum(s["recall50"] for s in all_stats) / safe,
        "recall75": sum(s["recall75"] for s in all_stats) / safe,
        "no_obj": sum(s["sobj_sum"] for s in all_stats) / float(cells),
    }


# ---------------------------------------------------------------------------
# [region] (YOLOv2) and [detection] (YOLOv1)


def _region_class_row(probs, c, scale, p: RegionHeadParams):
    """delta_region_class (region_layer.c:117-163, no softmax_tree):
    full-row overwrite scale*(onehot - probs), focal variant alpha=0.5."""
    onehot = _onehot(c, p.classes).to(torch.float32)
    if p.focal_loss:
        pt = _take(probs, c) + 1e-15
        grad = -(1.0 - pt) * (2.0 * pt * torch.log(pt) + pt - 1.0)
        return scale * (onehot - probs) * (0.5 * grad).unsqueeze(-1)
    return scale * (onehot - probs)


def _region_box_delta(cell, x, y, w, h, i, j, fw, fh, aw, ah, scale):
    """delta_region_box (region_layer.c:96-115, DOABS): targets in
    grid/log units; x,y deltas carry sigma-prime; w,h raw diffs.  Returns
    ([..., 4] delta, iou of the decoded pred vs truth)."""
    sx = torch.sigmoid(cell[..., 0])
    sy = torch.sigmoid(cell[..., 1])
    px = (i + sx) / fw
    py = (j + sy) / fh
    pw = torch.exp(cell[..., 2]) * aw / fw
    ph = torch.exp(cell[..., 3]) * ah / fh
    iou = _iou_xywh(px, py, pw, ph, x, y, w, h)
    tx = x * fw - i
    ty = y * fh - j
    tw_t = torch.log(w * fw / aw)
    th_t = torch.log(h * fh / ah)
    d = torch.stack([
        scale * (tx - sx) * sx * (1.0 - sx),
        scale * (ty - sy) * sy * (1.0 - sy),
        scale * (tw_t - cell[..., 2]),
        scale * (th_t - cell[..., 3]),
    ], -1)
    return d, iou


def _region_head_deltas(raw: Tensor, truth: Tensor, p: RegionHeadParams) -> Tensor:
    """raw [B,A,H,W,E], truth [B,T,5] → delta [B,A,H,W,E]
    (forward_region_layer's training pass, region_layer.c:183-368)."""
    b, a, fh, fw, e = raw.shape
    t_count = truth.shape[1]
    fhf, fwf = float(fh), float(fw)
    dev = raw.device
    raw = raw.to(torch.float32)

    sobj = torch.sigmoid(raw[..., 4])
    probs = torch.softmax(raw[..., 5:], dim=-1) if p.softmax else raw[..., 5:]

    tx, ty, tw, th, tcls = _truth_columns(truth)
    # class-range `continue` precedes the `!truth.x` break
    # (region_layer.c:262-266)
    tvalid = _reached(tx) & (tcls < p.classes)

    anchors_w = torch.tensor([w for w, _ in p.anchors], dtype=torch.float32, device=dev)
    anchors_h = torch.tensor([h for _, h in p.anchors], dtype=torch.float32, device=dev)

    # decoded pred boxes for every cell
    rows = torch.arange(fh, dtype=torch.float32, device=dev).view(1, 1, fh, 1)
    cols = torch.arange(fw, dtype=torch.float32, device=dev).view(1, 1, 1, fw)
    aw3 = anchors_w.view(1, a, 1, 1)
    ah3 = anchors_h.view(1, a, 1, 1)
    bx = (cols + torch.sigmoid(raw[..., 0])) / fwf
    by = (rows + torch.sigmoid(raw[..., 1])) / fhf
    bw = torch.exp(raw[..., 2]) * aw3 / fwf
    bh = torch.exp(raw[..., 3]) * ah3 / fhf

    def per_truth(v):
        return v.view(b, 1, 1, 1, t_count)

    ious = _iou_xywh(bx.unsqueeze(-1), by.unsqueeze(-1), bw.unsqueeze(-1), bh.unsqueeze(-1),
                     per_truth(tx), per_truth(ty), per_truth(tw), per_truth(th))
    ious = torch.where(per_truth(tvalid), ious, 0.0)
    best_iou = torch.amax(ious, dim=-1)
    best_t = torch.argmax(ious, dim=-1)
    best_cls = torch.gather(tcls, 1, best_t.reshape(b, -1)).view(best_t.shape)

    # ---- per-cell pass (region_layer.c:255-297) ------------------------
    obj_delta = p.noobject_scale * (0.0 - sobj) * sobj * (1.0 - sobj)
    cls_delta = torch.zeros((b, a, fh, fw, p.classes), dtype=torch.float32, device=dev)
    if p.classfix == -1:
        obj_delta = p.noobject_scale * (best_iou - sobj) * sobj * (1.0 - sobj)
    else:
        over = best_iou > p.thresh
        obj_delta = torch.where(over, 0.0, obj_delta)
        if p.classfix > 0:
            scale = p.class_scale * (sobj if p.classfix == 2 else 1.0)
            if isinstance(scale, Tensor):
                scale = scale.unsqueeze(-1)
            rows_c = _region_class_row(probs, best_cls, scale, p)
            cls_delta = torch.where(over.unsqueeze(-1), rows_c, cls_delta)

    box_delta = torch.zeros((b, a, fh, fw, 4), dtype=torch.float32, device=dev)
    if p.seen_lt_12800:
        # prior-box regression toward the cell's anchor, scale .01
        box_delta, _ = _region_box_delta(
            raw, (cols + 0.5) / fwf, (rows + 0.5) / fhf, aw3 / fwf, ah3 / fhf,
            cols, rows, fwf, fhf, aw3, ah3, 0.01)

    # ---- per-truth pass (sequential overwrites, :300-360) --------------
    i = torch.clamp(torch.floor(tx * fwf).to(torch.int64), 0, fw - 1)  # [B,T]
    j = torch.clamp(torch.floor(ty * fhf).to(torch.int64), 0, fh - 1)
    bidx = torch.arange(b, device=dev).view(b, 1)
    if p.bias_match:
        pw_n = anchors_w / fwf
        ph_n = anchors_h / fhf
    else:
        # decoded pred wh at this cell per anchor
        at_cell = raw[bidx.unsqueeze(-1), torch.arange(a, device=dev), j.unsqueeze(-1),
                      i.unsqueeze(-1)]  # [B,T,A,E]
        pw_n = torch.exp(at_cell[..., 2]) * anchors_w / fwf
        ph_n = torch.exp(at_cell[..., 3]) * anchors_h / fhf
    wk, hk = tw.unsqueeze(-1), th.unsqueeze(-1)
    inter = torch.minimum(pw_n, wk) * torch.minimum(ph_n, hk)
    union = pw_n * ph_n + wk * hk - inter
    an_iou = torch.where((inter == 0) | (union == 0), 0.0,
                         inter / torch.where(union == 0, 1.0, union))
    best_n = torch.argmax(an_iou, dim=-1)  # [B,T]

    cell = raw[bidx, best_n, j, i]  # [B,T,E]
    add, iou = _region_box_delta(cell, tx, ty, tw, th, i.to(torch.float32),
                                 j.to(torch.float32), fwf, fhf, anchors_w[best_n],
                                 anchors_h[best_n], p.coord_scale)
    so = sobj[bidx, best_n, j, i]
    target = iou if p.rescore else 1.0
    pos = p.object_scale * (target - so) * so * (1.0 - so)
    row = _region_class_row(probs[bidx, best_n, j, i], tcls, p.class_scale, p)
    new = torch.cat([add, pos.unsqueeze(-1), row], dim=-1)  # [B,T,E]

    delta = torch.cat([box_delta, obj_delta.unsqueeze(-1), cls_delta], dim=-1)
    delta = delta.reshape(b * a * fh * fw, e)
    lin = ((bidx * a + best_n) * fh + j) * fw + i  # [B,T]
    for t in range(t_count):
        idx = lin[:, t]
        delta[idx] = torch.where(tvalid[:, t].unsqueeze(-1), new[:, t], delta[idx])
    return delta.view(b, a, fh, fw, e)


def _v1_head_deltas(raw: Tensor, truth: Tensor, p: V1DetectionParams) -> Tensor:
    """raw [B, inputs], truth [B, side², 1+C+4] → delta [B, inputs]
    (forward_detection_layer's training pass, detection_layer.c:45-180).
    Pure per-cell math."""
    b = raw.shape[0]
    loc = p.side * p.side
    n, C = p.num, p.classes
    raw = raw.to(torch.float32)
    truth = truth.to(torch.float32)
    cls_out = raw[:, : loc * C].reshape(b, loc, C)
    if p.softmax:
        cls_out = torch.softmax(cls_out, dim=-1)
    conf = raw[:, loc * C: loc * (C + n)].reshape(b, loc, n)
    boxes = raw[:, loc * (C + n):].reshape(b, loc, n, 4)

    is_obj = truth[..., 0] != 0.0                 # [B,loc]
    t_cls = truth[..., 1: 1 + C]                  # [B,loc,C]
    tb = truth[..., 1 + C: 1 + C + 4]             # [B,loc,4] (x·side, y·side, w, h)

    # every confidence starts as a noobject negative
    conf_delta = p.noobject_scale * (0.0 - conf)
    # class deltas at object cells (MSE on the softmaxed probs)
    cls_delta = torch.where(is_obj.unsqueeze(-1), p.class_scale * (t_cls - cls_out), 0.0)

    # best box per object cell: IoU argmax, rmse argmin fallback when every
    # IoU is zero (detection_layer.c:105-121)
    side = float(p.side)
    ox = boxes[..., 0] / side
    oy = boxes[..., 1] / side
    ow = boxes[..., 2] ** 2 if p.sqrt else boxes[..., 2]
    oh = boxes[..., 3] ** 2 if p.sqrt else boxes[..., 3]
    tx = (tb[..., 0] / side).unsqueeze(-1)
    ty = (tb[..., 1] / side).unsqueeze(-1)
    tw_, th_ = tb[..., 2].unsqueeze(-1), tb[..., 3].unsqueeze(-1)
    ious = _iou_xywh(ox, oy, ow, oh, tx, ty, tw_, th_)  # [B,loc,n]
    rmse = torch.sqrt((ox - tx) ** 2 + (oy - ty) ** 2 + (ow - tw_) ** 2 + (oh - th_) ** 2)
    any_iou = torch.any(ious > 0.0, dim=-1)
    best = torch.where(any_iou, torch.argmax(ious, dim=-1), torch.argmin(rmse, dim=-1))

    best_iou = _take(ious, best)
    best_conf = _take(conf, best)
    target = best_iou if p.rescore else 1.0
    pos_conf = p.object_scale * (target - best_conf)
    chosen = (torch.arange(n, device=raw.device) == best.unsqueeze(-1)) & is_obj.unsqueeze(-1)
    conf_delta = torch.where(chosen, pos_conf.unsqueeze(-1), conf_delta)

    best_box = torch.gather(boxes, 2, best.view(b, loc, 1, 1).expand(b, loc, 1, 4))[:, :, 0]
    t_coord = tb
    if p.sqrt:
        t_coord = torch.cat([tb[..., :2], torch.sqrt(tb[..., 2:])], dim=-1)
    box_row = p.coord_scale * (t_coord - best_box)
    box_delta = torch.where(chosen.unsqueeze(-1), box_row.unsqueeze(2), 0.0)  # [B,loc,n,4]

    return torch.cat([cls_delta.reshape(b, -1), conf_delta.reshape(b, -1),
                      box_delta.reshape(b, -1)], dim=-1)


class _V1Loss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, raw, truth_grid, p):
        delta = _v1_head_deltas(raw, truth_grid, p)
        ctx.save_for_backward(delta)
        return torch.sum(delta * delta) / raw.shape[0]

    @staticmethod
    def backward(ctx, g):
        (delta,) = ctx.saved_tensors
        return -delta * g / delta.shape[0], None, None


def darknet_v1_detection_loss(raw: Tensor, truth_grid: Tensor, p: V1DetectionParams) -> Tensor:
    """[detection] (YOLOv1) training loss: value = |delta|²/batch
    (detection_layer.c:213 mag²); gradient wrt the flat layer input =
    -delta/batch (backward_detection_layer's axpy).  ``raw``: [B, inputs];
    ``truth_grid``: [B, side², 1+C+4]."""
    return _V1Loss.apply(raw, truth_grid, p)


# ---------------------------------------------------------------------------
# the losses with darknet's gradient


def truth_rows(gt_boxes: Tensor, gt_classes: Tensor, gt_mask: Tensor) -> Tensor:
    """The train step's padded targets (boxes (cy, cx, h, w) in image-ratio
    units, classes, mask) → darknet truth rows [B, T, 5] (x, y, w, h,
    class) in f32, x = 0 where the mask is off: the `!truth.x` break, so
    the labels must be prefix-packed (every loader fills from the front)."""
    gt_boxes = gt_boxes.to(torch.float32)
    return torch.stack([
        torch.where(gt_mask, gt_boxes[..., 1], 0.0),
        gt_boxes[..., 0], gt_boxes[..., 3], gt_boxes[..., 2],
        gt_classes.to(torch.float32),
    ], dim=-1)


def reshape_head_raw(conv_out: Tensor, p) -> Tensor:
    """NCHW conv output [B, A·E, H, W] → [B, A, H, W, E] (darknet
    entry_index layout: channel = anchor·E + entry); a view."""
    b, c, fh, fw = conv_out.shape
    a, e = p.num_anchors, p.entries
    if c != a * e:
        raise ValueError(f"head channels {c} != anchors*entries {a * e}")
    return conv_out.view(b, a, e, fh, fw).permute(0, 1, 3, 4, 2)


def _raw_gradient(delta: Tensor, braw: Tensor, p) -> Tensor:
    """The head's gradient before the -g/B factor, back in NCHW: the delta
    itself (backward_yolo_layer's axpy), times σ′ on every entry of a
    new_coords=1 head, whose logistic belongs to the head conv."""
    b, a, fh, fw, e = delta.shape
    if getattr(p, "new_coords", False):
        s = torch.sigmoid(braw)
        delta = delta * s * (1.0 - s)
    return delta.permute(0, 1, 4, 2, 3).reshape(b, a * e, fh, fw)


class _DetectionLoss(torch.autograd.Function):
    """Value: darknet's reported loss (mean over heads of the head cost,
    over the batch).  Gradient wrt each raw head output: -delta·g/B."""

    @staticmethod
    def forward(ctx, truth, params_list, with_metrics, *raws):
        if len(raws) != len(params_list):
            raise ValueError(f"{len(raws)} head outputs for {len(params_list)} param sets")
        batch = raws[0].shape[0]
        cost = 0.0
        grads, all_terms, all_stats = [], [], []
        for raw, p in zip(raws, params_list):
            braw = reshape_head_raw(raw.to(torch.float32), p)
            if with_metrics:
                c, d, terms, stats = _head_cost_delta_stats(braw, truth, p)
                all_terms.append(terms)
                all_stats.append(stats)
            else:
                c, d = _head_cost_and_delta(braw, truth, p)
            cost = cost + c
            grads.append(_raw_gradient(d, braw, p))
        ctx.save_for_backward(*grads)
        ctx.batch = batch
        cost = cost / (len(raws) * batch)
        if not with_metrics:
            return cost
        metrics = _collect_metrics(all_terms, all_stats, len(raws), batch)
        values = tuple(metrics[k] for k in METRIC_KEYS)
        ctx.mark_non_differentiable(*values)
        return (cost,) + values

    @staticmethod
    def backward(ctx, g, *unused):
        # the metrics carry no gradient
        return (None, None, None) + tuple(-d * g / ctx.batch for d in ctx.saved_tensors)


def darknet_detection_loss(raws, truth: Tensor, params_list) -> Tensor:
    """Value = darknet's REPORTED training loss for one iteration:
    mean-over-heads cost / batch (get_network_cost averaged over cost
    layers, then train_network_waitkey's sum/(n·batch), network.c:324-336
    + :65).  Gradient wrt each raw head output [B, A·E, H, W] =
    -delta/batch (backward_yolo_layer's axpy, σ′ for new_coords=1).
    ``truth`` [B, T, 5] holds (x, y, w, h, class) rows, x = 0 ending the
    list."""
    return _DetectionLoss.apply(truth, tuple(params_list), False, *raws)


def darknet_detection_loss_with_metrics(raws, truth: Tensor, params_list):
    """:func:`darknet_detection_loss` → (loss, metrics): the same value and
    gradient, with per-term loss components (iou/objectness/
    classification, normalized like the total) and darknet's printed
    training stats (yolo_layer.c:560-575): ``avg_iou``/``avg_obj``/
    ``avg_cat`` = mean over the per-truth delta applications,
    ``recall50/75`` their IoU>.5/.75 fractions, ``no_obj`` the mean
    activated objectness over all cells, ``num_matched`` the application
    count (int32).  The metrics carry no gradient."""
    out = _DetectionLoss.apply(truth, tuple(params_list), True, *raws)
    return out[0], dict(zip(METRIC_KEYS, out[1:]))


# ---------------------------------------------------------------------------
# params from a parsed darknet cfg (config/darknet_cfg.py)


def v1_params_from_darknet(layer) -> V1DetectionParams:
    """Build params from a parsed darknet [detection] layer
    (config.darknet_cfg.Detection)."""
    if getattr(layer, "forced", False) or getattr(layer, "random", 0.0):
        raise NotImplementedError(
            "[detection] forced/random branches unsupported (the random "
            "branch draws rand()%n per truth — irreproducible)")
    return V1DetectionParams(
        side=int(layer.side), num=int(layer.num), classes=int(layer.classes),
        coords=int(layer.coords), softmax=bool(layer.softmax),
        sqrt=bool(layer.sqrt), rescore=bool(layer.rescore),
        object_scale=float(layer.object_scale),
        noobject_scale=float(layer.noobject_scale),
        class_scale=float(layer.class_scale),
        coord_scale=float(layer.coord_scale),
    )


def region_params_from_darknet(layer) -> RegionHeadParams:
    """Build params from a parsed darknet [region] layer
    (config.darknet_cfg.Region)."""
    if getattr(layer, "coords", 4) != 4:
        raise NotImplementedError("[region] coords != 4 unsupported")
    anchors = tuple((float(w), float(h)) for w, h in layer.anchors)
    if not anchors:
        anchors = tuple((0.5, 0.5) for _ in range(int(layer.num)))
    return RegionHeadParams(
        anchors=anchors,
        classes=int(layer.classes),
        thresh=float(layer.thresh),
        object_scale=float(layer.object_scale),
        noobject_scale=float(layer.noobject_scale),
        class_scale=float(layer.class_scale),
        coord_scale=float(layer.coord_scale),
        bias_match=bool(layer.bias_match),
        rescore=bool(layer.rescore),
        classfix=int(layer.classfix),
        focal_loss=bool(layer.focal_loss),
        softmax=bool(layer.softmax),
    )


def head_params_from_darknet(layer, net_w: int, net_h: int) -> DarknetHeadParams:
    """Build params from a parsed darknet [yolo]/[Gaussian_yolo] layer
    (config.darknet_cfg.Yolo), as parser.c parse_yolo /
    parse_gaussian_yolo do, with get_classes_multipliers (:412-431) and the
    l.total anchor truncation (Yolo.total_anchors).

    Raises ValueError at cfg-resolution time (not mid-training) for option
    combinations with no darknet oracle semantics."""
    if getattr(layer, "gaussian", False) and getattr(layer, "new_coords", 0):
        raise ValueError(
            "[Gaussian_yolo] layer sets new_coords=1 — unsupported "
            "combination (darknet's gaussian_yolo_layer.c has no "
            "new_coords branch; no reference cfg combines them)")
    if getattr(layer, "yolo_point", "center") != "center":
        raise NotImplementedError("yolo_point != center unsupported")
    anchors = tuple((float(w), float(h))
                    for w, h in getattr(layer, "total_anchors", layer.anchors))
    mask = tuple(int(m) for m in layer.mask) or tuple(range(len(anchors)))
    max_delta = getattr(layer, "max_delta", None)
    counters = tuple(getattr(layer, "counters_per_class", ()) or ())
    multipliers = None
    if counters:
        if len(counters) != int(layer.classes):
            raise ValueError(
                f"counters_per_class has {len(counters)} entries for "
                f"{layer.classes} classes")
        cap = max_delta if max_delta is not None else float("inf")
        mx = float(max(counters))
        multipliers = tuple(min(mx / c, cap) for c in counters)
    return DarknetHeadParams(
        anchors=anchors,
        mask=mask,
        classes=int(layer.classes),
        net_w=net_w, net_h=net_h,
        ignore_thresh=float(layer.ignore_thresh),
        truth_thresh=float(layer.truth_thresh),
        iou_normalizer=float(getattr(layer, "iou_normalizer", 0.75)),
        obj_normalizer=float(getattr(layer, "obj_normalizer", 1.0)),
        cls_normalizer=float(getattr(layer, "cls_normalizer", 1.0)),
        uc_normalizer=float(getattr(layer, "uc_normalizer", 1.0)),
        scale_x_y=float(layer.scale_x_y),
        new_coords=bool(layer.new_coords),
        gaussian=bool(getattr(layer, "gaussian", False)),
        iou_loss=str(getattr(layer, "iou_loss", "mse")),
        iou_thresh=float(getattr(layer, "iou_thresh", 1.0)),
        iou_thresh_kind=str(getattr(layer, "iou_thresh_kind", "iou")),
        objectness_smooth=bool(getattr(layer, "objectness_smooth", False)),
        max_delta=float(max_delta) if max_delta is not None else None,
        focal_loss=bool(getattr(layer, "focal_loss", False)),
        label_smooth_eps=float(getattr(layer, "label_smooth_eps", 0.0)),
        classes_multipliers=multipliers,
    )
