"""HSV color jitter.

Equivalent capability to ``yolo-dl/src/processor/color_jitter.rs:37-72`` and
the RGB↔HSV conversions in ``tch-goodies/src/tensor.rs:957-1041``: random
hue shift wraps modulo 1, saturation/value shifts clamp to [0,1].

Counterpart of ``yolodl_tpu/data/color.py``, numpy path only: the fused C++
jitter of ``native/loader.cpp`` is not ported yet (ROADMAP A11b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """[3,H,W] float32 in [0,1] → HSV with H in [0,1)."""
    r, g, b = rgb[0], rgb[1], rgb[2]
    maxc = np.max(rgb, axis=0)
    minc = np.min(rgb, axis=0)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)

    with np.errstate(invalid="ignore", divide="ignore"):
        rc = np.where(delta > 0, (maxc - r) / np.maximum(delta, 1e-12), 0.0)
        gc = np.where(delta > 0, (maxc - g) / np.maximum(delta, 1e-12), 0.0)
        bc = np.where(delta > 0, (maxc - b) / np.maximum(delta, 1e-12), 0.0)
    h = np.where(
        maxc == r, bc - gc, np.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = (h / 6.0) % 1.0
    h = np.where(delta > 0, h, 0.0)
    return np.stack([h, s, v]).astype(np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[0], hsv[1], hsv[2]
    i = np.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i.astype(np.int32) % 6

    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b]).astype(np.float32)


@dataclasses.dataclass
class ColorJitter:
    """max shifts; None disables that channel (ColorJitterInit parity)."""

    hue_shift: Optional[float] = None
    saturation_shift: Optional[float] = None
    value_shift: Optional[float] = None

    def sample(self, rng: np.random.Generator):
        """Draw (hue, saturation, value) shifts.  Sampling is separate from
        application so the device-augment path can consume the exact same
        RNG stream while deferring the pixel work to the accelerator."""
        # sample in a fixed order so the augmentation stream is identical
        # whichever backend applies it
        hs = rng.uniform(-self.hue_shift, self.hue_shift) if self.hue_shift else 0.0
        ss = (rng.uniform(-self.saturation_shift, self.saturation_shift)
              if self.saturation_shift else 0.0)
        vs = rng.uniform(-self.value_shift, self.value_shift) if self.value_shift else 0.0
        return hs, ss, vs

    def apply(self, rgb_chw: np.ndarray, hs: float, ss: float, vs: float) -> np.ndarray:
        hsv = rgb_to_hsv(rgb_chw)
        hsv[0] = (hsv[0] + hs + 1.0) % 1.0
        hsv[1] = np.clip(hsv[1] + ss, 0.0, 1.0)
        hsv[2] = np.clip(hsv[2] + vs, 0.0, 1.0)
        return hsv_to_rgb(hsv)

    def __call__(self, rgb_chw: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if rgb_chw.shape[0] != 3:
            raise ValueError(f"channel size must be 3, got {rgb_chw.shape[0]}")
        hs, ss, vs = self.sample(rng)
        return self.apply(rgb_chw, hs, ss, vs)
