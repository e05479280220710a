"""Batched augmentation on the device (``preprocessor.pipeline.device``
"cuda"; the reference's tch preprocessor runs its tensor ops on the
configured device, ``train/src/training_stream.rs``).

Counterpart of ``yolodl_tpu/data/device_augment.py``.  Every random
parameter is drawn on the host from the same per-slot RNG stream as the CPU
path (``pipeline.TrainingStream`` with ``defer_images``), and the label
geometry stays on the host, so boxes, classes and mask are bit-identical to
the CPU pipeline's.  The pixel work (HSV jitter, the random affine's
bilinear warp, mosaic / MixUp / CutMix) runs here as eager tensor ops over
the whole batch: no per-record loop, a loop over the k <= 4 mix-source
slots only, so that one slot's f32 images are live at a time.

Arithmetic follows the reference op for op, so the card agrees with the
CPU and with the reference to f32 rounding: ``a + f * (b - a)`` for every
interpolation (``torch.lerp`` switches formula at 0.5), u8 sources times
the f32 constant ``1/255``, taps summed in the reference's order, no fused
multiply-add, Python-semantics ``%`` (``torch.remainder``), and hard-cut
borders judged on the unclipped coordinates.

Record-level gates (apply jitter, apply the affine, the mix kind) vary per
record and ride in as masks, so every batch runs the same ops on the same
shapes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

MIX_NONE, MIX_MOSAIC, MIX_MIXUP, MIX_CUTMIX = 0, 1, 2, 3


@dataclasses.dataclass
class DeferredRecord:
    """One pipeline slot with its pixel work left to the device.

    ``boxes``/``classes`` are final (computed on the host through the same
    affine + mix geometry the pixels will see); ``images`` holds the 1/2/4
    source images the mix needs.
    """

    images: List[np.ndarray]                       # need × [3, H, W] f32
    jit_params: Optional[List[Tuple[float, float, float]]]  # per image
    transforms: List[Optional[np.ndarray]]         # 3×3 ±1-frame, None=skip
    mix_kind: int                                  # MIX_* code
    mix_params: tuple                              # (pivot_row, pivot_col) | (lam,) | (t,b,l,r)
    boxes: np.ndarray
    classes: np.ndarray


def pack_deferred_batch(records: Sequence[DeferredRecord], k_max: int,
                        uint8: bool = True) -> dict:
    """Stack a batch of DeferredRecords into the fixed-shape arrays the
    augment program consumes.  Unused image slots stay zero (their output
    is never selected).

    ``uint8`` (the default) ships the image slots as u8, a quarter of the
    host-to-device bytes of f32 (the pack is B·k_max full-resolution
    slots), and the program rescales to f32/255.  Decoded sources are
    u8/255 grids, so the quantization is exact for them; synthetic
    continuous floats round to the nearest 1/255 step.  ``uint8=False``
    keeps f32 for bitwise host-parity tests."""
    from .affine import pixel_affine

    b = len(records)
    _, h, w = records[0].images[0].shape
    images = np.zeros((b, k_max, 3, h, w),
                      np.uint8 if uint8 else np.float32)
    jit = np.zeros((b, k_max, 3), np.float32)
    jit_on = np.zeros((b, k_max), bool)
    aff_m = np.tile(np.eye(2, dtype=np.float32), (b, k_max, 1, 1))
    aff_b = np.zeros((b, k_max, 2), np.float32)
    aff_on = np.zeros((b, k_max), bool)
    kind = np.zeros((b,), np.int32)
    pivot = np.zeros((b, 2), np.int32)
    lam = np.ones((b,), np.float32)
    cutbox = np.zeros((b, 4), np.int32)

    for i, rec in enumerate(records):
        n = len(rec.images)
        for k in range(n):
            if uint8:
                # round-to-nearest; assignment into the u8 array truncates
                images[i, k] = np.clip(rec.images[k] * 255.0 + 0.5, 0, 255)
            else:
                images[i, k] = rec.images[k]
            if rec.jit_params is not None:
                jit[i, k] = rec.jit_params[k]
                jit_on[i, k] = True
            t = rec.transforms[k]
            if t is not None:
                m_rc, b_rc = pixel_affine(t, h, w)
                aff_m[i, k] = m_rc.astype(np.float32)
                aff_b[i, k] = b_rc.astype(np.float32)
                aff_on[i, k] = True
        kind[i] = rec.mix_kind
        if rec.mix_kind == MIX_MOSAIC:
            pr_, pc_ = rec.mix_params
            # same pixel rounding as MosaicMixer.__call__
            pivot[i] = (round(pr_ * h), round(pc_ * w))
        elif rec.mix_kind == MIX_MIXUP:
            lam[i] = rec.mix_params[0]
        elif rec.mix_kind == MIX_CUTMIX:
            t_, b_, l_, r_ = rec.mix_params
            # same pixel rounding as CutMixMixer.__call__
            cutbox[i] = (round(t_ * h), round(b_ * h),
                         round(l_ * w), round(r_ * w))
    return dict(images=images, jit=jit, jit_on=jit_on, aff_m=aff_m,
                aff_b=aff_b, aff_on=aff_on, kind=kind, pivot=pivot,
                lam=lam, cutbox=cutbox)


# -- the ops, batched over B ------------------------------------------------


def _per_image(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """[B] → [B, 1, ...] of ``ndim`` dims, to broadcast against a batch."""
    return x.reshape(x.shape[0], *([1] * (ndim - 1)))


def _hsv_jitter(img, hs, ss, vs):
    """[B,3,H,W] RGB in [0,1] and per-image shifts [B] → jittered RGB;
    mirrors data/color.py and the reference's ``_hsv_jitter_jnp``."""
    hs, ss, vs = (_per_image(x, 3) for x in (hs, ss, vs))
    r, g, b = img[:, 0], img[:, 1], img[:, 2]
    maxc = img.amax(dim=1)
    minc = img.amin(dim=1)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    s = torch.where(maxc > 0, delta / torch.clamp_min(maxc, 1e-12), zero)
    safe = torch.clamp_min(delta, 1e-12)
    rc = torch.where(delta > 0, (maxc - r) / safe, zero)
    gc = torch.where(delta > 0, (maxc - g) / safe, zero)
    bc = torch.where(delta > 0, (maxc - b) / safe, zero)
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(delta > 0, h, zero)

    h = torch.remainder(h + hs + 1.0, 1.0)
    s = torch.clamp(s + ss, 0.0, 1.0)
    v = torch.clamp(v + vs, 0.0, 1.0)

    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def choose6(c0, c1, c2, c3, c4, c5):
        return torch.where(
            i == 0, c0,
            torch.where(i == 1, c1,
                        torch.where(i == 2, c2,
                                    torch.where(i == 3, c3,
                                                torch.where(i == 4, c4, c5)))))

    return torch.stack([choose6(v, q, p, p, t, v),
                        choose6(t, v, v, q, p, p),
                        choose6(p, p, t, v, v, q)], dim=1)


def _gather_last(src, idx):
    """``src[..., idx]`` with one index vector per leading slice: src
    [B, 3, *lead, N], idx [B, *lead', M] (lead' = lead with 1 where src
    broadcasts) → [B, 3, *lead, M]."""
    idx = idx.unsqueeze(1).expand(*src.shape[:-1], idx.shape[-1])
    return torch.gather(src, -1, idx)


def _coords(m, b, h, w, device):
    """Input coordinates of every output pixel, in_(r,c) = m @ out_(r,c) + b
    per image, and the reference's hard-cut border: whether those
    unclipped coordinates lie inside the image.  ([B,H,W] ×2, [B,H,W] bool)"""
    rr = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    cc = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    m00, m01, m10, m11 = (_per_image(m[:, i, j], 3) for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
    b0, b1 = _per_image(b[:, 0], 3), _per_image(b[:, 1], 3)
    ir = m00 * rr + m01 * cc + b0
    ic = m10 * rr + m11 * cc + b1
    return ir, ic, (ir >= 0) & (ir <= h - 1) & (ic >= 0) & (ic <= w - 1)


def _warp_general(img, m, b):
    """[B,3,H,W] bilinear warp, in_(r,c) = m @ out_(r,c) + b per image;
    scipy order-1 mode="constant" hard-cut borders (``_warp_general_jnp``)."""
    bsz, ch, h, w = img.shape
    ir, ic, valid = _coords(m, b, h, w, img.device)
    r0 = torch.clamp(torch.floor(ir), 0, h - 1)
    c0 = torch.clamp(torch.floor(ic), 0, w - 1)
    fr = (ir - r0).unsqueeze(1)
    fc = (ic - c0).unsqueeze(1)
    r0i = r0.to(torch.int64)
    c0i = c0.to(torch.int64)
    r1i = torch.clamp_max(r0i + 1, h - 1)
    c1i = torch.clamp_max(c0i + 1, w - 1)
    flat = img.reshape(bsz, ch, h * w)

    def at(ri, ci):  # img[:, :, ri, ci] per image
        return _gather_last(flat, (ri * w + ci).reshape(bsz, h * w)).reshape(bsz, ch, h, w)

    v00, v01, v10, v11 = at(r0i, c0i), at(r0i, c1i), at(r1i, c0i), at(r1i, c1i)
    top = v00 + fc * (v01 - v00)
    bot = v10 + fc * (v11 - v10)
    out = top + fr * (bot - top)
    return torch.where(valid.unsqueeze(1), out, torch.zeros((), dtype=out.dtype, device=out.device))


def _warp_separable(img, m, b):
    """The warp for rotation-free transforms (flip / scale / translate give
    a diagonal pixel matrix): a column pass on the full image, then rows;
    the same arithmetic order as the general warp (``_warp_separable_jnp``)."""
    bsz, ch, h, w = img.shape
    rvec = (_per_image(m[:, 0, 0], 2) * torch.arange(h, dtype=torch.float32, device=img.device)
            + _per_image(b[:, 0], 2))                                    # [B, H]
    cvec = (_per_image(m[:, 1, 1], 2) * torch.arange(w, dtype=torch.float32, device=img.device)
            + _per_image(b[:, 1], 2))                                    # [B, W]
    rvalid = (rvec >= 0) & (rvec <= h - 1)
    cvalid = (cvec >= 0) & (cvec <= w - 1)
    r0 = torch.clamp(torch.floor(rvec), 0, h - 1)
    c0 = torch.clamp(torch.floor(cvec), 0, w - 1)
    fr = (rvec - r0)[:, None, :, None]
    fc = (cvec - c0)[:, None, None, :]
    r0i = r0.to(torch.int64)
    c0i = c0.to(torch.int64)
    r1i = torch.clamp_max(r0i + 1, h - 1)
    c1i = torch.clamp_max(c0i + 1, w - 1)
    g0 = _gather_last(img, c0i[:, None, :])                             # img[:, :, :, c0i]
    g1 = _gather_last(img, c1i[:, None, :])
    gc = g0 + fc * (g1 - g0)          # column interpolation on the full image
    gt = gc.transpose(2, 3)                                              # rows last
    t0 = _gather_last(gt, r0i[:, None, :]).transpose(2, 3)               # gc[:, :, r0i, :]
    t1 = _gather_last(gt, r1i[:, None, :]).transpose(2, 3)
    out = t0 + fr * (t1 - t0)
    valid = rvalid[:, None, :, None] & cvalid[:, None, None, :]
    return torch.where(valid, out, torch.zeros((), dtype=out.dtype, device=out.device))


def _warp_twopass(img, m, b, d1: int, d2: int, block: int = 8):
    """The rotation-capable warp of the reference (``_warp_twopass_jnp``):
    a Catmull–Smith decomposition of the affine into a column pass, then a
    row pass, each a 1-D bilinear resample whose line offset varies along
    the other axis.  Lines go in blocks of ``block``; within a block the
    resample coordinate spans at most ``d1``/``d2`` source lines
    (:func:`twopass_bands`), and every tap is a gather with one index
    vector per block.

    Index maps (in_(r,c) = m @ out_(r,c) + b, m[0,0] != 0):
      pass 1 (columns):  tmp(r', c) = img(r', a·c + p·r' + q)
          with p = m10/m00, a = m11 − m01·m10/m00, q = b1 − p·b0
      pass 2 (rows):     out(r, c) = tmp(m00·r + m01·c + b0, c)
    The composite map is exact; the interpolation is not the general
    warp's (each pass interpolates along the true map).  Borders are the
    general warp's hard-cut mask on the composite coordinates."""
    bsz, ch, h, w = img.shape
    dev = img.device
    zero = torch.zeros((), dtype=img.dtype, device=dev)
    # pad to a block multiple; padded lines carry zero weight (their
    # coordinates fall outside every band) and are cropped at the end
    hp = -(-h // block) * block
    wp = -(-w // block) * block

    m00, m01, m10, m11 = (m[:, i, j] for i, j in ((0, 0), (0, 1), (1, 0), (1, 1)))
    p = m10 / m00
    a = m11 - m01 * m10 / m00
    q = b[:, 1] - p * b[:, 0]

    # ---- pass 1: resample columns, per-row coordinate ic = a·c + p·r + q
    nb1 = hp // block
    r_blk = (torch.arange(nb1, dtype=torch.float32, device=dev)[:, None] * block
             + torch.arange(block, dtype=torch.float32, device=dev)[None, :])  # [NB, R]
    o1 = _per_image(p, 3) * r_blk + _per_image(q, 3)                         # [B, NB, R]
    o1_min = o1.amin(dim=2)                                                  # [B, NB]
    c_ar = torch.arange(w, dtype=torch.float32, device=dev)
    base1 = torch.floor(_per_image(a, 3) * c_ar + o1_min[:, :, None])        # [B, NB, W]
    ic = _per_image(a, 4) * c_ar + o1[:, :, :, None]                         # [B, NB, R, W]

    img_b = torch.nn.functional.pad(img, (0, 0, 0, hp - h)).reshape(bsz, ch, nb1, block, w)
    acc = torch.zeros((bsz, ch, nb1, block, w), dtype=img.dtype, device=dev)
    for d in range(d1):
        j = base1 + d                                                        # [B, NB, W]
        wgt = torch.maximum(zero, 1.0 - torch.abs(ic - j[:, :, None, :]))
        idx = torch.clamp(j, 0, w - 1).to(torch.int64)
        g = _gather_last(img_b, idx[:, :, None, :])                          # [B,3,NB,R,W]
        acc = acc + g * wgt[:, None]
    tmp = acc.reshape(bsz, ch, hp, w)[:, :, :h, :]

    # ---- pass 2: resample rows, per-column coordinate ir = m00·r + m01·c + b0
    nb2 = wp // block
    c_blk = (torch.arange(nb2, dtype=torch.float32, device=dev)[:, None] * block
             + torch.arange(block, dtype=torch.float32, device=dev)[None, :])  # [NBc, C]
    o2 = _per_image(m01, 3) * c_blk + _per_image(b[:, 0], 3)                 # [B, NBc, C]
    o2_min = o2.amin(dim=2)                                                  # [B, NBc]
    r_ar = torch.arange(h, dtype=torch.float32, device=dev)
    base2 = torch.floor(_per_image(m00, 3) * r_ar + o2_min[:, :, None])      # [B, NBc, H]
    ir = _per_image(m00, 4) * r_ar + o2[:, :, :, None]                       # [B, NBc, C, H]

    tmp_p = torch.nn.functional.pad(tmp, (0, wp - w))
    # [B, 3, H, NBc, C] → the gathered axis (H) last: [B, 3, NBc, C, H]
    tmp_b = tmp_p.reshape(bsz, ch, h, nb2, block).permute(0, 1, 3, 4, 2)
    acc2 = torch.zeros((bsz, ch, nb2, block, h), dtype=img.dtype, device=dev)
    for d in range(d2):
        i = base2 + d                                                        # [B, NBc, H]
        wgt = torch.maximum(zero, 1.0 - torch.abs(ir - i[:, :, None, :]))
        idx = torch.clamp(i, 0, h - 1).to(torch.int64)
        g = _gather_last(tmp_b, idx[:, :, None, :])                          # [B,3,NBc,C,H]
        acc2 = acc2 + g * wgt[:, None]
    out = acc2.permute(0, 1, 4, 2, 3).reshape(bsz, ch, h, wp)[..., :w]
    return torch.where(_coords(m, b, h, w, dev)[2].unsqueeze(1), out, zero)


def twopass_bands(rotate_degrees: float, scale_min: float,
                  block: int = 8, aspect: float = 1.0) -> Tuple[int, int]:
    """Static band sizes for :func:`_warp_twopass` covering every
    transform ``RandomAffine`` can sample with rotation up to
    ``rotate_degrees`` and isotropic scale down to ``scale_min``:
    |m10/m00| = tan θ (scale cancels) bounds pass 1, |m01| = sin θ / s
    bounds pass 2.  For non-square inputs the pixel-space matrix carries
    aspect factors (m10/m00 = tan θ · w/h, m01 = sin θ / s · h/w), so
    ``aspect`` = max(h/w, w/h) widens both bounds to the worst case."""
    th = float(np.deg2rad(rotate_degrees))
    s = min(1.0, float(scale_min))
    a = max(1.0, float(aspect))
    d1 = int(np.ceil(np.tan(th) * a * (block - 1))) + 2
    d2 = int(np.ceil(np.sin(th) / s * a * (block - 1))) + 2
    return d1, d2


def make_augment_fn(h: int, w: int, *, separable: bool,
                    has_jitter: bool, has_affine: bool,
                    has_mosaic: bool, has_mixup: bool, has_cutmix: bool,
                    bands: Optional[Tuple[int, int]] = None):
    """The batched augment program: pack dict of tensors (one device) →
    images [B,3,H,W] f32.

    Warp choice: ``separable=True`` → the diagonal-matrix path (no
    rotation in the config).  Otherwise ``bands=(d1, d2)`` (from
    :func:`twopass_bands`) selects the two-pass rotation warp, the
    reference's default, while ``bands=None`` (or env
    ``YDL_AUG_GENERAL_WARP=1``) selects the general 2-D gather warp."""
    if separable:
        warp = _warp_separable
    elif bands is None or os.environ.get("YDL_AUG_GENERAL_WARP") == "1":
        warp = _warp_general
    else:
        d1, d2 = bands

        def warp(img, m, bb):
            return _warp_twopass(img, m, bb, d1, d2)

    def slot(img, p, jon, m, bb, aon):
        # one mix-source slot for the whole batch: u8 → f32 here, per slot,
        # so that one slot's f32 source is live at a time
        if img.dtype == torch.uint8:
            img = img.to(torch.float32) * (1.0 / 255.0)
        if has_jitter:
            img = torch.where(_per_image(jon, 4),
                              _hsv_jitter(img, p[:, 0], p[:, 1], p[:, 2]), img)
        if has_affine:
            img = torch.where(_per_image(aon, 4), warp(img, m, bb), img)
        return img

    def augment(pack):
        k_max = pack["images"].shape[1]
        imgs = [slot(pack["images"][:, k], pack["jit"][:, k], pack["jit_on"][:, k],
                     pack["aff_m"][:, k], pack["aff_b"][:, k], pack["aff_on"][:, k])
                for k in range(k_max)]
        dev = imgs[0].device
        kind = pack["kind"]                      # [B]
        out = imgs[0]
        rr = torch.arange(h, device=dev)[None, :, None]    # [1, H, 1]
        cc = torch.arange(w, device=dev)[None, None, :]    # [1, 1, W]

        def sel(mask_b, x, y):                   # [B] mask over [B,3,H,W]
            return torch.where(_per_image(mask_b, 4), x, y)

        if has_mosaic:
            pivot = pack["pivot"]                # [B, 2]
            top = (rr < pivot[:, 0, None, None])[:, None]    # [B,1,H,1]
            left = (cc < pivot[:, 1, None, None])[:, None]   # [B,1,1,W]
            mos = torch.where(
                top & left, imgs[0],
                torch.where(top, imgs[1], torch.where(left, imgs[2], imgs[3])))
            out = sel(kind == MIX_MOSAIC, mos, out)
        if has_mixup:
            lam = _per_image(pack["lam"], 4)
            mixed = lam * imgs[0] + (1.0 - lam) * imgs[1]
            out = sel(kind == MIX_MIXUP, mixed, out)
        if has_cutmix:
            cb = pack["cutbox"]                  # [B, 4]
            inwin = (((rr >= cb[:, 0, None, None]) & (rr < cb[:, 1, None, None]))[:, None]
                     & ((cc >= cb[:, 2, None, None]) & (cc < cb[:, 3, None, None]))[:, None])
            cut = torch.where(inwin, imgs[1], imgs[0])
            out = sel(kind == MIX_CUTMIX, cut, out)
        return out

    return augment


def augment_fn_for(stream_cfg, h: int, w: int):
    """:func:`make_augment_fn` as the reference's
    ``apply_device_augmentation`` chooses it for a stream config and an
    image size: the separable warp without rotation; the two-pass warp
    while tan θ · aspect < tan 60° (the bands stay narrow); the general
    warp beyond, or under env ``YDL_AUG_GENERAL_WARP=1``."""
    aff = stream_cfg.random_affine
    separable = aff is None or not (aff.rotate_prob and aff.rotate_degrees)
    bands = None
    # the pixel-space matrix scales tan θ by max(h/w, w/h), so a
    # non-square input reaches the too-wide-bands regime at a smaller angle
    aspect = max(h / w, w / h)
    if not separable and float(np.tan(np.deg2rad(
            aff.rotate_degrees))) * aspect < float(np.tan(np.deg2rad(60.0))):
        bands = twopass_bands(
            aff.rotate_degrees,
            min(aff.scale) if (aff.scale_prob and aff.scale) else 1.0,
            aspect=aspect)
    return make_augment_fn(
        h, w,
        separable=separable,
        bands=bands,
        has_jitter=stream_cfg.color_jitter is not None,
        has_affine=aff is not None,
        has_mosaic=stream_cfg.mosaic_prob > 0,
        has_mixup=stream_cfg.mixup_prob > 0,
        has_cutmix=stream_cfg.cutmix_prob > 0,
    )


def apply_device_augmentation(iterator, stream_cfg, device="cuda", depth: int = 2):
    """Wrap a deferred TrainingStream: run the augment program on each
    batch and yield ``(TrainingRecord, (images, boxes, classes, mask))`` as
    tensors on ``device``, the contract of ``pipeline.device_prefetch``, so
    the train loop is the same either way.

    The program is chosen on the first batch (:func:`augment_fn_for`).  On
    a card, a worker thread ``depth`` batches ahead copies each pack
    through pinned host memory on a side stream (``record.upload_events``
    time that copy) and runs the program on the same stream; the consumer's
    stream waits for an event recorded after the program, and the outputs
    are marked as used on that stream (``record_stream``).  On the CPU the
    program runs on the worker thread as it is."""
    from .._device import resolve_device
    from .pipeline import lookahead_map

    device = resolve_device(device)
    state: dict = {"fn": None}
    side = torch.cuda.Stream(device) if device.type == "cuda" else None

    def augment_batch(record):
        pack = record.deferred
        if state["fn"] is None:
            _, _, _, h, w = pack["images"].shape
            state["fn"] = augment_fn_for(stream_cfg, h, w)
        targets = (record.boxes, record.classes, record.mask)
        if side is None:
            images = state["fn"]({k: torch.from_numpy(v) for k, v in pack.items()})
            rec = dataclasses.replace(record, images=images, deferred=None)
            return rec, (images, *(torch.from_numpy(a) for a in targets)), None
        pinned = {k: torch.from_numpy(v).pin_memory() for k, v in pack.items()}
        pinned_targets = [torch.from_numpy(a).pin_memory() for a in targets]
        with torch.cuda.stream(side):
            start, copied = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record(side)
            pack_dev = {k: t.to(device, non_blocking=True) for k, t in pinned.items()}
            on_device = [t.to(device, non_blocking=True) for t in pinned_targets]
            copied.record(side)
            images = state["fn"](pack_dev)
            done = torch.cuda.Event()
            done.record(side)
        rec = dataclasses.replace(record, images=images, deferred=None,
                                  upload_events=(start, copied))
        return rec, (images, *on_device), done

    for rec, arrays, done in lookahead_map(iterator, augment_batch, depth):
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in arrays:
                t.record_stream(consumer)
        yield rec, arrays
