"""Random affine augmentation.

Equivalent capability to ``yolo-dl/src/processor/random_affine.rs:111-350``:
composes flip/scale/rotate/translate 3×3 matrices in the center-origin ±1
coordinate frame (image spans 2 units), warps the image through the inverse
map (the reference uses ``affine_grid_generator``+``grid_sampler``; here
scipy ``affine_transform``), then maps box corners and re-clips with
min-size / min-cropping-ratio filters (:288-350).

Counterpart of ``yolodl_tpu/data/affine.py``, scipy path only: the C++ warp
of ``native/loader.cpp`` is not ported yet (ROADMAP A11b).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class RandomAffine:
    rotate_prob: Optional[float] = None
    rotate_degrees: Optional[float] = None
    translation_prob: Optional[float] = None
    translation: Optional[float] = None
    scale_prob: Optional[float] = None
    scale: Optional[Tuple[float, float]] = None
    horizontal_flip_prob: Optional[float] = None
    vertical_flip_prob: Optional[float] = None
    min_bbox_size: Optional[float] = None          # ratio units
    min_bbox_cropping_ratio: Optional[float] = None

    def sample_transform(self, rng: np.random.Generator) -> np.ndarray:
        """3×3 matrix in the ±1 center-origin frame (x right, y down)."""
        t = np.eye(3)
        if self.horizontal_flip_prob and rng.random() < self.horizontal_flip_prob:
            t = np.diag([-1.0, 1.0, 1.0]) @ t
        if self.vertical_flip_prob and rng.random() < self.vertical_flip_prob:
            t = np.diag([1.0, -1.0, 1.0]) @ t
        if self.scale_prob and self.scale and rng.random() < self.scale_prob:
            ratio = rng.uniform(*self.scale)
            t = np.diag([ratio, ratio, 1.0]) @ t
        if self.rotate_prob and self.rotate_degrees and rng.random() < self.rotate_prob:
            angle = np.deg2rad(rng.uniform(-self.rotate_degrees, self.rotate_degrees))
            c, s = np.cos(angle), np.sin(angle)
            t = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]) @ t
        if self.translation_prob and self.translation and rng.random() < self.translation_prob:
            # image spans 2 units → translations doubled (random_affine.rs:246-250)
            tx = rng.uniform(-self.translation, self.translation) * 2.0
            ty = rng.uniform(-self.translation, self.translation) * 2.0
            t = np.array([[1.0, 0.0, tx], [0.0, 1.0, ty], [0.0, 0.0, 1.0]]) @ t
        return t

    def transform_boxes(
        self,
        transform: np.ndarray,
        boxes_ratio: np.ndarray,
        classes: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Map boxes through the ±1-frame affine and re-clip/filter
        (random_affine.rs:288-350).  Pure box math — shared by the host
        warp path and the device-augment path (which warps pixels on the
        accelerator but keeps label geometry on the host)."""
        if len(boxes_ratio) == 0:
            return boxes_ratio, classes

        # transform box corners (forward map) in the ±1 frame
        cy, cx, bh, bw = (boxes_ratio[:, 0], boxes_ratio[:, 1],
                          boxes_ratio[:, 2], boxes_ratio[:, 3])
        t_, l_, b_, r_ = cy - bh / 2, cx - bw / 2, cy + bh / 2, cx + bw / 2
        corners = np.stack(
            [
                np.stack([l_, t_], -1), np.stack([r_, t_], -1),
                np.stack([l_, b_], -1), np.stack([r_, b_], -1),
            ],
            axis=1,
        )  # [N, 4, (x=col_ratio, y=row_ratio)]
        xy = corners * 2.0 - 1.0
        new_xy = xy @ transform[:2, :2].T + transform[:2, 2]
        new_ratio = (new_xy + 1.0) / 2.0

        new_l = new_ratio[..., 0].min(1)
        new_r = new_ratio[..., 0].max(1)
        new_t = new_ratio[..., 1].min(1)
        new_b = new_ratio[..., 1].max(1)

        # clip to the image and filter (random_affine.rs:288-350)
        clip_l, clip_r = np.clip(new_l, 0, 1), np.clip(new_r, 0, 1)
        clip_t, clip_b = np.clip(new_t, 0, 1), np.clip(new_b, 0, 1)
        new_h = clip_b - clip_t
        new_w = clip_r - clip_l
        keep = (new_h > 0) & (new_w > 0)
        if self.min_bbox_size is not None:
            keep &= (new_h >= self.min_bbox_size) & (new_w >= self.min_bbox_size)
        if self.min_bbox_cropping_ratio is not None:
            orig_area = (new_b - new_t) * (new_r - new_l)
            crop_area = new_h * new_w
            with np.errstate(invalid="ignore", divide="ignore"):
                ratio = np.where(orig_area > 0, crop_area / orig_area, 0.0)
            keep &= ratio >= self.min_bbox_cropping_ratio

        boxes_out = np.stack(
            [(clip_t + clip_b) / 2, (clip_l + clip_r) / 2, new_h, new_w], axis=-1
        ).astype(np.float32)[keep]
        return boxes_out, classes[keep]

    def __call__(
        self,
        image_chw: np.ndarray,
        boxes_ratio: np.ndarray,
        classes: np.ndarray,
        rng: np.random.Generator,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        transform = self.sample_transform(rng)
        if np.allclose(transform, np.eye(3)):
            return image_chw, boxes_ratio, classes

        _, h, w = image_chw.shape
        m_rc, b_rc = pixel_affine(transform, h, w)
        warped = warp_image(image_chw, m_rc, b_rc)
        boxes_out, classes_out = self.transform_boxes(
            transform, boxes_ratio, classes)
        return warped, boxes_out, classes_out


def pixel_affine(transform: np.ndarray, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """±1-frame forward transform → pixel-space inverse map for warping:
    (m_rc, b_rc) with in_(row,col) = m_rc @ out_(row,col) + b_rc — the
    matrix convention of scipy ``affine_transform``."""
    # output pixel (row, col) → ±1 frame (x, y) → inverse map → input pixel
    inv = np.linalg.inv(transform)
    # pixel→unit: x = (col+0.5)/w*2-1, y = (row+0.5)/h*2-1
    a_xy = inv[:2, :2]
    b_xy = inv[:2, 2]
    # convert (x,y)-frame mapping to (row,col)-pixel mapping:
    # in_col = ((a11*x + a12*y + b1) + 1)/2*w - 0.5, x = (out_col+0.5)*2/w - 1
    scale_out = np.array([[2.0 / w, 0.0], [0.0, 2.0 / h]])  # (col,row)→(x,y)
    offset_out = np.array([-1.0 + 1.0 / w, -1.0 + 1.0 / h])
    scale_in = np.array([[w / 2.0, 0.0], [0.0, h / 2.0]])   # (x,y)→(col,row)
    offset_in = np.array([(w - 1) / 2.0, (h - 1) / 2.0])

    m_xy = scale_in @ a_xy @ scale_out           # (out col,row) → (in col,row)
    b_pix = scale_in @ (a_xy @ offset_out + b_xy) + offset_in

    # scipy works in (row, col): swap axes
    swap = np.array([[0.0, 1.0], [1.0, 0.0]])
    m_rc = swap @ m_xy @ swap
    b_rc = swap @ b_pix
    return m_rc, b_rc


def warp_image(image_chw: np.ndarray, m_rc: np.ndarray, b_rc: np.ndarray) -> np.ndarray:
    """Host bilinear warp with scipy order-1 ``mode="constant"`` semantics
    (hard-cut borders: a sample coordinate outside [0, size-1] yields cval)."""
    from scipy import ndimage

    return np.stack(
        [
            ndimage.affine_transform(
                image_chw[ch], m_rc, offset=b_rc, order=1,
                mode="constant", cval=0.0,
            )
            for ch in range(image_chw.shape[0])
        ]
    ).astype(np.float32)
