"""Box overlays for images.

Counterpart of ``yolodl_tpu/train/logging.py``, :func:`draw_boxes_on_image`
only: the detect CLI draws with it.  The TensorBoard ``LoggingWorker``
comes with the training CLI (ROADMAP A11b).
"""

from __future__ import annotations

import numpy as np


def draw_boxes_on_image(
    image_chw: np.ndarray,
    boxes_tlbr_ratio: np.ndarray,
    color=(1.0, 1.0, 0.0),
    thickness: int = 1,
) -> np.ndarray:
    """Rect outlines on a [3,H,W] float image (TensorExt batch-draw parity,
    tch-goodies/src/tensor.rs:419-714)."""
    out = image_chw.copy()
    _, h, w = out.shape
    for t, l, b, r in np.asarray(boxes_tlbr_ratio).reshape(-1, 4):
        t_px = int(np.clip(t * h, 0, h - 1))
        b_px = int(np.clip(b * h, 0, h - 1))
        l_px = int(np.clip(l * w, 0, w - 1))
        r_px = int(np.clip(r * w, 0, w - 1))
        for k in range(thickness):
            # thicken INWARD on every edge: top/left move down/right,
            # bottom/right move up/left — the outline stays h x w pixels
            tt, bb = min(t_px + k, h - 1), max(b_px - k, 0)
            ll, rr = min(l_px + k, w - 1), max(r_px - k, 0)
            for c in range(3):
                out[c, tt, l_px:r_px + 1] = color[c]
                out[c, bb, l_px:r_px + 1] = color[c]
                out[c, t_px:b_px + 1, ll] = color[c]
                out[c, t_px:b_px + 1, rr] = color[c]
    return out
