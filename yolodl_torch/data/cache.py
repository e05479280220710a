"""Image loading with letterbox caching.

Equivalent capability to ``yolo-dl/src/processor/{file_cache,on_demand,
mem_cache}.rs``:

- OnDemandLoader: decode + letterbox resize per request (on_demand.rs:14-120).
- FileCache: letterboxed images cached as raw f32 files keyed by the
  percent-encoded image path + cache size, validated by source mtime and
  length (file_cache.rs:55-230).  The reference documents an open-vs-write
  race (:111-113); this implementation writes to a temp file and atomically
  renames, closing that race.
- MemoryCache: dict of decoded tensors (mem_cache.rs:18-40).

Boxes come out in target-frame ratio units (cycxhw), exactly like the
reference's cache output.

Counterpart of ``yolodl_tpu/data/cache.py``.  Decoding takes the PIL path
only: the native C++ decoder (``native/loader.cpp`` through
``data/native_loader.py``) is not ported yet (ROADMAP A11b).
"""

from __future__ import annotations

import os
import threading
import urllib.parse
from typing import Dict, Tuple

import numpy as np
from PIL import Image

from .letterbox import letterbox_resize
from .records import DataRecord, FileRecord


def decode_image(path: str) -> np.ndarray:
    """Decode to float32 CHW in [0,1]."""
    with Image.open(path) as im:
        rgb = im.convert("RGB")
        arr = np.asarray(rgb, np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1))


def _boxes_to_ratio(record: FileRecord) -> np.ndarray:
    if len(record.boxes_pixel) == 0:
        return np.zeros((0, 4), np.float32)
    scale = np.array(
        [1.0 / record.height, 1.0 / record.width, 1.0 / record.height, 1.0 / record.width]
    )
    return (record.boxes_pixel * scale).astype(np.float32)


class OnDemandLoader:
    def __init__(self, cache_hw: Tuple[int, int]):
        self.cache_hw = cache_hw

    def load(self, record: FileRecord) -> DataRecord:
        image = decode_image(record.path)
        out, boxes, _ = letterbox_resize(image, self.cache_hw, _boxes_to_ratio(record))
        return DataRecord(image=out, boxes=boxes, classes=record.classes)


def make_decode_loader(cache_hw: Tuple[int, int]):
    """The decode+letterbox loader: PIL, the reference's path under
    ``YDL_NO_NATIVE_DECODE=1``.  The reference's C++ loader is not ported
    yet (ROADMAP A11b)."""
    return OnDemandLoader(cache_hw)


class FileCache:
    """On-disk cache of letterboxed images.

    ``dtype="f32"`` (default) stores raw float32 — byte-exact with the
    decode path, the reference's format (file_cache.rs).  ``dtype="u8"``
    stores uint8 (4× smaller, ≤1/510 quantization — the same payload the
    TFRecord cache uses), the right trade on network filesystems where
    cache IO, not CPU, bounds the pipeline.
    """

    MAGIC = b"YDLC\x01"
    MAGIC_U8 = b"YDLCu8\x01"

    def __init__(self, cache_dir: str, cache_hw: Tuple[int, int],
                 dtype: str = "f32"):
        if dtype not in ("f32", "u8"):
            raise ValueError(f"cache dtype must be f32|u8, got {dtype!r}")
        self.cache_dir = cache_dir
        self.cache_hw = cache_hw
        self.dtype = dtype
        os.makedirs(cache_dir, exist_ok=True)
        self._loader = make_decode_loader(cache_hw)

    def _cache_path(self, record: FileRecord) -> str:
        key = urllib.parse.quote(os.path.abspath(record.path), safe="")
        h, w = self.cache_hw
        suffix = ".u8.bin" if self.dtype == "u8" else ".bin"
        return os.path.join(self.cache_dir, f"{h}x{w}-{key}{suffix}")

    def load(self, record: FileRecord) -> DataRecord:
        cache_path = self._cache_path(record)
        src_stat = os.stat(record.path)
        h, w = self.cache_hw
        magic_bytes = self.MAGIC_U8 if self.dtype == "u8" else self.MAGIC
        itemsize = 1 if self.dtype == "u8" else 4
        expect_bytes = len(magic_bytes) + 3 * h * w * itemsize

        if os.path.exists(cache_path):
            st = os.stat(cache_path)
            # validation: exact size + cache at least as new as the source
            # (file_cache.rs mtime+length check, :55-130)
            if st.st_size == expect_bytes and st.st_mtime >= src_stat.st_mtime:
                with open(cache_path, "rb") as f:
                    magic = f.read(len(magic_bytes))
                    raw = f.read(3 * h * w * itemsize)
                if self.dtype == "u8":
                    data = np.frombuffer(raw, np.uint8).astype(np.float32) / 255.0
                else:
                    data = np.frombuffer(raw, "<f4")
                if magic == magic_bytes and data.size == 3 * h * w:
                    image = data.reshape(3, h, w).copy()
                    # boxes are deterministic from record + cache size; use
                    # the same integer-rounded geometry as the decode path
                    from .letterbox import letterbox_unit_transform

                    unit = letterbox_unit_transform(
                        (record.height, record.width), self.cache_hw
                    )
                    boxes = unit.apply_cycxhw(_boxes_to_ratio(record)).astype(np.float32)
                    return DataRecord(image=image, boxes=boxes, classes=record.classes)

        rec = self._loader.load(record)
        # pid alone is not unique: two pipeline worker THREADS caching the
        # same image would collide on the tmp path and crash on os.replace
        tmp = cache_path + f".tmp{os.getpid()}-{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(magic_bytes)
            if self.dtype == "u8":
                payload = np.clip(rec.image * 255.0 + 0.5, 0, 255).astype(
                    np.uint8)
                f.write(payload.tobytes())
            else:
                f.write(np.ascontiguousarray(rec.image, "<f4").tobytes())
        os.replace(tmp, cache_path)  # atomic: no open-vs-write race
        return rec


class MemoryCache:
    """Thread-safe in-memory decoded-record cache (mem_cache.rs parity)."""

    def __init__(self, cache_hw: Tuple[int, int]):
        self._loader = make_decode_loader(cache_hw)
        self._cache: Dict[str, DataRecord] = {}
        self._lock = threading.Lock()

    def load(self, record: FileRecord) -> DataRecord:
        key = record.path
        with self._lock:
            hit = self._cache.get(key)
        if hit is not None:
            return DataRecord(hit.image, hit.boxes.copy(), hit.classes.copy())
        rec = self._loader.load(record)
        with self._lock:
            self._cache[key] = rec
        return DataRecord(rec.image, rec.boxes.copy(), rec.classes.copy())
