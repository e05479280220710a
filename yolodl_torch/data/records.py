"""Dataset record types.

Equivalent capability to ``yolo-dl/src/dataset/record.rs``: ``FileRecord``
(path + original size + pixel-unit labels) and ``DataRecord`` (decoded image
+ ratio-unit labels).  Boxes are numpy ``[N, 4]`` cycxhw arrays + ``[N]``
class ids instead of per-field compound structs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass
class FileRecord:
    """An image on disk with pixel-unit cycxhw boxes."""

    path: str
    height: int
    width: int
    boxes_pixel: np.ndarray  # [N, 4] (cy, cx, h, w) in pixels
    classes: np.ndarray      # [N] int32

    def __post_init__(self):
        self.boxes_pixel = np.asarray(self.boxes_pixel, np.float64).reshape(-1, 4)
        self.classes = np.asarray(self.classes, np.int32).reshape(-1)
        assert len(self.boxes_pixel) == len(self.classes)


@dataclasses.dataclass
class DataRecord:
    """A decoded image (float32 CHW in [0,1]) with ratio-unit labels."""

    image: np.ndarray        # [3, H, W] float32
    boxes: np.ndarray        # [N, 4] (cy, cx, h, w) in 0-1 ratio units
    classes: np.ndarray      # [N] int32

    def __post_init__(self):
        self.boxes = np.asarray(self.boxes, np.float32).reshape(-1, 4)
        self.classes = np.asarray(self.classes, np.int32).reshape(-1)

    @property
    def hw(self) -> Tuple[int, int]:
        return self.image.shape[1], self.image.shape[2]
