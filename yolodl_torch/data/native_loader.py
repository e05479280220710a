"""ctypes bridge to the port's native host libraries.

Counterpart of ``yolodl_tpu/data/native_loader.py``, name for name.  The
C++ is the port's own copy of the JAX package's ``native/loader.cpp``:

- ``yolodl_torch/csrc/host_augment.cpp`` — the affine warp and the HSV
  jitter of the training pipeline (``affine_warp_native``,
  ``color_jitter_native``), which ``data/affine.py`` ``warp_image`` and
  ``data/color.py`` ``ColorJitter.apply`` take by default;
- ``yolodl_torch/csrc/host_decode.cpp`` — JPEG/PNG decode and the
  letterbox (:class:`NativeLoader`), a drop-in for ``OnDemandLoader``.

``kernels/_build.py`` builds each with g++ at first use into
``build/yolodl_torch/``.  A failed build raises; nothing falls back.  The
calls go through ctypes, which releases the GIL, so the pipeline's worker
threads run them in parallel.

The plain numpy/scipy versions stay in ``affine.py`` and ``color.py``.
Only an explicit switch selects them: ``_aug_lib_cache = False`` here, the
reference's own switch (its ``tests/test_data.py``), after which the two
``*_native`` functions return ``None``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from .cache import OnDemandLoader, _boxes_to_ratio
from .letterbox import letterbox_unit_transform
from .records import DataRecord, FileRecord


def native_loader_available() -> bool:
    """Whether the decode library can be built here: the compiler finds
    ``jpeglib.h`` and ``png.h`` (``kernels/_build.py`` ``decode_probe``)."""
    from ..kernels import _build

    return _build.decode_probe()[0]


# None: not loaded yet; False: the plain numpy/scipy route, set by hand
_aug_lib_cache = None


def _aug_lib():
    """The loaded augmentation library (ydl_affine_warp / ydl_color_jitter),
    built at first use; a failed build raises.  None only when
    ``_aug_lib_cache`` was set to False."""
    global _aug_lib_cache
    if _aug_lib_cache is not None:
        return _aug_lib_cache or None
    from ..kernels import _build

    lib = _build.load("host_augment")
    lib.ydl_affine_warp.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_float),
    ]
    lib.ydl_affine_warp.restype = None
    lib.ydl_color_jitter.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
    ]
    lib.ydl_color_jitter.restype = None
    _aug_lib_cache = lib
    return lib


def affine_warp_native(image_chw: np.ndarray, m_rc: np.ndarray,
                       b_rc: np.ndarray):
    """C++ bilinear inverse warp (scipy affine_transform order=1 semantics);
    None on the plain route."""
    lib = _aug_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(image_chw, np.float32)
    if src.ndim != 3:
        raise ValueError(f"the warp takes a CHW image, got shape {src.shape}")
    c, h, w = src.shape
    dst = np.empty_like(src)
    m = np.ascontiguousarray(m_rc, np.float64).reshape(4)
    off = np.ascontiguousarray(b_rc, np.float64).reshape(2)
    lib.ydl_affine_warp(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), c, h, w,
        m.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return dst


def color_jitter_native(rgb_chw: np.ndarray, hue_shift: float,
                        sat_shift: float, val_shift: float):
    """Fused C++ HSV jitter; None on the plain route."""
    lib = _aug_lib()
    if lib is None:
        return None
    img = np.ascontiguousarray(rgb_chw, np.float32).copy()
    if img.ndim != 3 or img.shape[0] != 3:
        raise ValueError(f"the jitter takes a 3-channel CHW image, got shape {img.shape}")
    _, h, w = img.shape
    lib.ydl_color_jitter(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w,
        float(hue_shift), float(sat_shift), float(val_shift),
    )
    return img


class NativeLoader:
    """C++ decode+letterbox; same .load contract as OnDemandLoader.

    ``ldr_load`` is synchronous, GIL-free, and thread-safe — parallelism
    comes from the pipeline's worker threads calling it concurrently, not
    from a native pool (the C ABI's thread count is passed as 0)."""

    def __init__(self, cache_hw: Tuple[int, int], scaled_decode: bool = True):
        """``scaled_decode`` turns on libjpeg DCT-domain scaled decode for
        JPEGs much larger than the letterbox frame (a 4000px photo headed
        for 608px decodes ~4-8x cheaper).  Letterbox geometry (and thus box
        transforms) is computed from the original dims either way — only the
        resampling source resolution changes."""
        from ..kernels import _build

        found, reason = _build.decode_probe()
        if not found:
            raise FileNotFoundError(f"the decode library cannot be built here: {reason}")
        self.cache_hw = cache_hw
        self._lib = _build.load("host_decode")
        self._lib.ldr_create.restype = ctypes.c_void_p
        self._lib.ldr_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        self._lib.ldr_create2.restype = ctypes.c_void_p
        self._lib.ldr_create2.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        self._lib.ldr_load.restype = ctypes.c_int
        self._lib.ldr_load.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)
        ]
        self._lib.ldr_destroy.argtypes = [ctypes.c_void_p]
        self._lib.ldr_destroy.restype = None
        if scaled_decode:
            self._handle = ctypes.c_void_p(
                self._lib.ldr_create2(0, cache_hw[0], cache_hw[1], 1))
        else:
            self._handle = ctypes.c_void_p(
                self._lib.ldr_create(0, cache_hw[0], cache_hw[1]))
        self._fallback = OnDemandLoader(cache_hw)

    def load(self, record: FileRecord) -> DataRecord:
        h, w = self.cache_hw
        out = np.empty((3, h, w), np.float32)
        rc = self._lib.ldr_load(
            self._handle,
            record.path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        if rc != 0:
            # a format (or a file) the C++ does not read → PIL, per record
            return self._fallback.load(record)
        if len(record.boxes_pixel):
            if record.height <= 0 or record.width <= 0:
                # the PIL path fails loudly on this corruption
                # (ZeroDivisionError in _boxes_to_ratio) — silently
                # dropping the labels here would train on unlabeled images
                raise ValueError(
                    f"{record.path}: record carries {len(record.boxes_pixel)}"
                    f" boxes but no image dimensions "
                    f"({record.height}x{record.width})")
            unit = letterbox_unit_transform(
                (record.height, record.width), self.cache_hw)
            boxes = unit.apply_cycxhw(_boxes_to_ratio(record)).astype(np.float32)
        else:
            # box-less records (e.g. classification) may carry 0x0 dims
            boxes = np.zeros((0, 4), np.float32)
        return DataRecord(image=out, boxes=boxes, classes=record.classes)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.ldr_destroy(self._handle)
                self._handle = None
        except Exception:
            pass
