"""Letterbox resize (aspect-preserving, centered pad).

Equivalent capability to ``tch-goodies/src/tensor.rs:746-948``
(``resize2d_letterbox``) and the bbox re-mapping in
``yolo-dl/src/processor/file_cache.rs:131-223``.  Host-side numpy; PIL is
imported only inside the functions that resize, and a frame that already
has the target size takes a PIL-free identity path (its geometry has offset
0 and the same size).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..geometry.transform import Transform


def letterbox_geometry(src_hw, tgt_hw):
    """Integer-rounded content size and offsets: (new_h, new_w, off_y, off_x).

    The single source of truth for pixel geometry — box transforms derived
    elsewhere (e.g. the file-cache hit path) must use this same rounding.
    """
    src_h, src_w = src_hw
    tgt_h, tgt_w = tgt_hw
    if tgt_h * src_w <= tgt_w * src_h:
        new_h, new_w = tgt_h, max(1, round(src_w * tgt_h / src_h))
    else:
        new_h, new_w = max(1, round(src_h * tgt_w / src_w)), tgt_w
    return new_h, new_w, (tgt_h - new_h) // 2, (tgt_w - new_w) // 2


def letterbox_unit_transform(src_hw, tgt_hw) -> Transform:
    """Unit-frame (0-1 ratio) box transform matching :func:`letterbox_geometry`."""
    tgt_h, tgt_w = tgt_hw
    new_h, new_w, off_y, off_x = letterbox_geometry(src_hw, tgt_hw)
    return Transform.from_rects(
        (0.0, 0.0, 1.0, 1.0),
        (off_y / tgt_h, off_x / tgt_w, (off_y + new_h) / tgt_h, (off_x + new_w) / tgt_w),
    )


def letterbox_u8(image_hwc: np.ndarray, tgt_hw, pad_value: int = 128) -> np.ndarray:
    """Letterbox a decoded [H,W,3] uint8 frame → [H',W',3] uint8.

    A frame of the target size is returned as it is, with no PIL; any other
    goes through :func:`letterbox_u8_pil`."""
    if tuple(image_hwc.shape[:2]) == tuple(tgt_hw):
        return np.ascontiguousarray(image_hwc)
    from PIL import Image

    return letterbox_u8_pil(Image.fromarray(image_hwc), tgt_hw, pad_value,
                            src_hw=image_hwc.shape[:2])


def letterbox_u8_pil(pil_img, tgt_hw, pad_value: int = 128,
                     src_hw=None) -> np.ndarray:
    """Letterbox a PIL RGB image entirely in uint8 → [H,W,3] array.

    The serving hot path: no float conversions on the host (≤1/510
    quantization vs the f32 path — the same trade the u8 file cache makes),
    and ~4× less data to upload when the device normalizes.  ``pad_value``
    128 ≈ the f32 path's 0.5 gray.  ``src_hw`` overrides the geometry
    source dims: when the caller decoded the JPEG at a reduced scale
    (``Image.draft``), placement must still come from the ORIGINAL size so
    the inverse box transform stays exact.
    """
    from PIL import Image as _Image

    src_w, src_h = pil_img.size
    if src_hw is not None:
        src_h, src_w = src_hw
    tgt_h, tgt_w = tgt_hw
    new_h, new_w, off_y, off_x = letterbox_geometry((src_h, src_w), tgt_hw)
    resized = pil_img.resize((new_w, new_h), _Image.BILINEAR)
    canvas = _Image.new("RGB", (tgt_w, tgt_h), (pad_value,) * 3)
    canvas.paste(resized, (off_x, off_y))
    return np.asarray(canvas, np.uint8)


def letterbox_resize(
    image_chw: np.ndarray,
    target_hw: Tuple[int, int],
    boxes_ratio: Optional[np.ndarray] = None,
    pad_value: float = 0.5,
) -> Tuple[np.ndarray, Optional[np.ndarray], Transform]:
    """Resize [3,H,W] float32 into the letterboxed target frame.

    boxes are in source-ratio units; returns them in target-ratio units plus
    the unit→unit Transform used (for drawing / inversion).
    """
    from PIL import Image

    c, src_h, src_w = image_chw.shape
    tgt_h, tgt_w = target_hw
    new_h, new_w, off_y, off_x = letterbox_geometry((src_h, src_w), target_hw)

    # true float path: PIL mode-"F" bilinear per channel — no u8 round-trip
    # (the reference's resize2d_letterbox is float end-to-end,
    # tch-goodies/src/tensor.rs:746-948; quantizing here would store u8
    # precision in the f32 cache at 4x the bytes)
    resized = np.stack(
        [
            np.asarray(
                Image.fromarray(
                    np.ascontiguousarray(image_chw[ch], np.float32),
                    mode="F").resize(
                    (new_w, new_h), Image.BILINEAR),
                dtype=np.float32,
            )
            for ch in range(c)
        ],
        axis=-1,
    )

    out = np.full((tgt_h, tgt_w, c), pad_value, np.float32)
    out[off_y : off_y + new_h, off_x : off_x + new_w, :] = resized
    out_chw = np.transpose(out, (2, 0, 1))

    # unit-frame transform: source unit square → letterboxed content region
    transform = letterbox_unit_transform((src_h, src_w), target_hw)
    new_boxes = None
    if boxes_ratio is not None:
        new_boxes = transform.apply_cycxhw(np.asarray(boxes_ratio)).astype(np.float32)
    return out_chw, new_boxes, transform
