"""Axis-aligned affine transforms between rectangle coordinate frames.

Equivalent capability to ``bbox/src/transform.rs`` in the reference: a
scale+translate map ``y' = sy*y + ty, x' = sx*x + tx`` with constructors for
exact resize and letterbox resize, inversion, and composition.  Used by the
letterbox cache (processor/file_cache.rs), the detect CLI's output re-mapping
(detect/src/main.rs:169), and the matcher's unit→grid conversion.

Host-side scalar/numpy math — transforms are tiny and live on the CPU side of
the pipeline; on-device box warping uses plain tensor arithmetic with the
same (sy, sx, ty, tx) quadruple.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Transform:
    """y' = sy*y + ty ; x' = sx*x + tx."""

    sy: float
    sx: float
    ty: float
    tx: float

    @staticmethod
    def identity() -> "Transform":
        return Transform(1.0, 1.0, 0.0, 0.0)

    @staticmethod
    def from_rects(src_tlbr: Tuple[float, float, float, float],
                   tgt_tlbr: Tuple[float, float, float, float]) -> "Transform":
        """Map the src rect onto the tgt rect (transform.rs:16-27)."""
        st, sl, sb, sr = src_tlbr
        tt, tl, tb, tr = tgt_tlbr
        sy = (tb - tt) / (sb - st)
        sx = (tr - tl) / (sr - sl)
        ty = tt - st * sy
        tx = tl - sl * sx
        return Transform(sy, sx, ty, tx)

    @staticmethod
    def from_sizes_exact(src_hw: Tuple[float, float], tgt_hw: Tuple[float, float]) -> "Transform":
        """Stretch (0,0,src_h,src_w) onto (0,0,tgt_h,tgt_w) (transform.rs:29-38)."""
        sh, sw = src_hw
        th, tw = tgt_hw
        return Transform.from_rects((0.0, 0.0, sh, sw), (0.0, 0.0, th, tw))

    @staticmethod
    def from_sizes_letterbox(src_hw: Tuple[float, float], tgt_hw: Tuple[float, float]) -> "Transform":
        """Aspect-preserving resize centered in the target (transform.rs:40-66)."""
        sh, sw = src_hw
        th, tw = tgt_hw
        if th * sw <= tw * sh:
            new_h, new_w = th, sw * th / sh
        else:
            new_h, new_w = sh * tw / sw, tw
        off_y = (th - new_h) / 2.0
        off_x = (tw - new_w) / 2.0
        return Transform.from_rects(
            (0.0, 0.0, sh, sw), (off_y, off_x, off_y + new_h, off_x + new_w)
        )

    def inverse(self) -> "Transform":
        return Transform(
            sy=1.0 / self.sy,
            sx=1.0 / self.sx,
            ty=-self.ty / self.sy,
            tx=-self.tx / self.sx,
        )

    def compose(self, other: "Transform") -> "Transform":
        """self ∘ other: apply ``other`` first (transform.rs:127-141)."""
        return Transform(
            sy=self.sy * other.sy,
            sx=self.sx * other.sx,
            ty=other.ty * self.sy + self.ty,
            tx=other.tx * self.sx + self.tx,
        )

    def __mul__(self, other: "Transform") -> "Transform":
        return self.compose(other)

    # -- application to boxes ------------------------------------------------

    def apply_cycxhw(self, boxes: np.ndarray) -> np.ndarray:
        """Transform [..., (cy,cx,h,w)] boxes. Negative scales re-normalize h/w."""
        boxes = np.asarray(boxes, dtype=np.float64)
        cy = boxes[..., 0] * self.sy + self.ty
        cx = boxes[..., 1] * self.sx + self.tx
        h = np.abs(boxes[..., 2] * self.sy)
        w = np.abs(boxes[..., 3] * self.sx)
        return np.stack([cy, cx, h, w], axis=-1)

    def apply_tlbr(self, boxes: np.ndarray) -> np.ndarray:
        """Transform [..., (t,l,b,r)] boxes, re-sorting corners for flips."""
        boxes = np.asarray(boxes, dtype=np.float64)
        y0 = boxes[..., 0] * self.sy + self.ty
        x0 = boxes[..., 1] * self.sx + self.tx
        y1 = boxes[..., 2] * self.sy + self.ty
        x1 = boxes[..., 3] * self.sx + self.tx
        return np.stack(
            [
                np.minimum(y0, y1),
                np.minimum(x0, x1),
                np.maximum(y0, y1),
                np.maximum(x0, x1),
            ],
            axis=-1,
        )

    def apply_points(self, yx: np.ndarray) -> np.ndarray:
        """Transform [..., (y,x)] points."""
        yx = np.asarray(yx, dtype=np.float64)
        return np.stack(
            [yx[..., 0] * self.sy + self.ty, yx[..., 1] * self.sx + self.tx], axis=-1
        )
