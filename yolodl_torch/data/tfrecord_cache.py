"""TFRecord-format letterbox cache.

This cache stores letterboxed images in standard TFRecord framing
(length + masked-crc32c + payload + masked-crc32c), one shard file per
cache directory with a JSON offset index.  Compared to :class:`FileCache`'s one-file-per-image raw floats,
the single-shard layout is sequential-read friendly and 4× smaller
(uint8 payloads).

Single-writer, many-reader; shard writes append, and the index is an
append-only JSONL (one ``{"k": path, "o": offset, "m": mtime}`` line per record) —
republishing the whole index per miss would rewrite O(n) JSON on every
cache fill, quadratic over a COCO-scale warmup.  A torn final line (crash
mid-append) is skipped on load; that record simply re-caches.

Counterpart of ``yolodl_tpu/data/tfrecord_cache.py``, with the same file
format.  The reference takes CRC-32C from ``google_crc32c``, which the
card's machine lacks, so the port computes it itself (:func:`crc32c`) with
numpy, vectorized over the payload rather than one byte at a time.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from .cache import _boxes_to_ratio, make_decode_loader
from .letterbox import letterbox_unit_transform
from .records import DataRecord, FileRecord

_POLY = 0x82F63B78   # CRC-32C (Castagnoli), bit-reflected
_CHUNK = 16          # bytes per column of the vectorized pass


def _byte_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(_POLY), t >> 1).astype(np.uint32)
    return t


_TABLE = _byte_table()


def _byte_tables(op: np.ndarray) -> np.ndarray:
    """[4, 256] tables applying the GF(2)-linear map ``op`` (the images of
    the 32 register bits) to a register, one byte of it per table."""
    idx = np.arange(256, dtype=np.uint32)
    tables = np.zeros((4, 256), np.uint32)
    for byte in range(4):
        for bit in range(8):
            tables[byte] ^= np.where((idx >> bit) & 1, op[8 * byte + bit],
                                     np.uint32(0)).astype(np.uint32)
    return tables


def _apply(tables: np.ndarray, r: np.ndarray) -> np.ndarray:
    return (tables[0][r & 0xFF] ^ tables[1][(r >> 8) & 0xFF]
            ^ tables[2][(r >> 16) & 0xFF] ^ tables[3][r >> 24])


_SHIFTS: list = []  # [j]: tables of "run the register over _CHUNK·2^j zero bytes"
_SHIFTS_LOCK = threading.Lock()


def _shift(level: int) -> np.ndarray:
    """The tables of _SHIFTS[level], built on first use."""
    if level < len(_SHIFTS):
        return _SHIFTS[level]
    with _SHIFTS_LOCK:
        return _extend_shifts(level)


def _extend_shifts(level: int) -> np.ndarray:
    while len(_SHIFTS) <= level:
        basis = np.uint32(1) << np.arange(32, dtype=np.uint32)
        if not _SHIFTS:
            r = basis
            for _ in range(_CHUNK):
                r = _TABLE[r & 0xFF] ^ (r >> 8)
        else:
            r = _apply(_SHIFTS[-1], _apply(_SHIFTS[-1], basis))
        _SHIFTS.append(_byte_tables(r))
    return _SHIFTS[level]


def crc32c(data: bytes) -> int:
    """CRC-32C of ``data``, as ``google_crc32c`` computes it.

    The CRC without its initial and final inversion is linear in the
    message, and leading zero bytes leave it 0.  The initial 0xFFFFFFFF is
    folded in by inverting the first four bytes; the message, zero-padded in
    front, is cut into 2^m columns of _CHUNK bytes whose CRCs come from one
    vectorized pass over _CHUNK rows; then pairs of neighbours are merged,
    m times, as CRC(a‖b) = shift(CRC(a), len b) ^ CRC(b)."""
    buf = np.frombuffer(bytes(data), np.uint8)
    if len(buf) < 4:
        crc = 0xFFFFFFFF
        for b in buf.tolist():
            crc = int(_TABLE[(crc ^ b) & 0xFF]) ^ (crc >> 8)
        return crc ^ 0xFFFFFFFF
    columns = 1 << max(0, int(np.ceil(np.log2(-(-len(buf) // _CHUNK)))))
    padded = np.zeros(columns * _CHUNK, np.uint8)
    start = len(padded) - len(buf)
    padded[start:] = buf
    padded[start:start + 4] ^= 0xFF
    rows = padded.reshape(columns, _CHUNK).astype(np.uint32)
    r = np.zeros(columns, np.uint32)
    for j in range(_CHUNK):
        r = _TABLE[(r ^ rows[:, j]) & 0xFF] ^ (r >> 8)
    level = 0
    while len(r) > 1:
        r = _apply(_shift(level), r[0::2]) ^ r[1::2]
        level += 1
    return int(r[0]) ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


def write_tfrecord(f, payload: bytes) -> Tuple[int, int]:
    """Append one TFRecord; returns (offset, total_length)."""
    offset = f.tell()
    length = struct.pack("<Q", len(payload))
    f.write(length)
    f.write(struct.pack("<I", _masked_crc(length)))
    f.write(payload)
    f.write(struct.pack("<I", _masked_crc(payload)))
    return offset, 8 + 4 + len(payload) + 4


def read_tfrecord(f, offset: int) -> bytes:
    f.seek(offset)
    length_bytes = f.read(8)
    (length,) = struct.unpack("<Q", length_bytes)
    (length_crc,) = struct.unpack("<I", f.read(4))
    if _masked_crc(length_bytes) != length_crc:
        raise ValueError("tfrecord length CRC mismatch")
    payload = f.read(length)
    (data_crc,) = struct.unpack("<I", f.read(4))
    if _masked_crc(payload) != data_crc:
        raise ValueError("tfrecord data CRC mismatch")
    return payload


class TfrecordCache:
    """Letterboxed-image cache in a TFRecord shard."""

    def __init__(self, cache_dir: str, cache_hw: Tuple[int, int],
                 shard_tag: str = ""):
        """``shard_tag`` namespaces the shard file (e.g. ``-r3`` for rank 3
        of a multi-process run): appends are only thread-safe within one
        process, so processes sharing ``cache_dir`` MUST use distinct tags
        — interleaved cross-process appends would corrupt record framing
        and stale ``f.tell()`` offsets would index into garbage."""
        self.cache_hw = cache_hw
        os.makedirs(cache_dir, exist_ok=True)
        h, w = cache_hw
        self.shard_path = os.path.join(
            cache_dir, f"cache-{h}x{w}{shard_tag}.tfrecord")
        self.index_path = self.shard_path + ".index.jsonl"
        self._loader = make_decode_loader(cache_hw)
        self._lock = threading.Lock()
        self._index: Dict[str, Tuple[int, Optional[float]]] = {}
        if os.path.exists(self.index_path):
            with open(self.index_path) as f:
                for line in f:
                    try:
                        entry = json.loads(line)
                        self._index[entry["k"]] = (entry["o"], entry.get("m"))
                    except (ValueError, KeyError):
                        break  # torn tail from a crash mid-append
        legacy = self.shard_path + ".index.json"
        if not self._index and os.path.exists(legacy):
            with open(legacy) as f:
                self._index = {k: (o, None) for k, o in json.load(f).items()}

    def _key(self, record: FileRecord) -> str:
        return os.path.abspath(record.path)

    def _boxes_for(self, record: FileRecord) -> np.ndarray:
        unit = letterbox_unit_transform(
            (record.height, record.width), self.cache_hw
        )
        return unit.apply_cycxhw(_boxes_to_ratio(record)).astype(np.float32)

    def load(self, record: FileRecord) -> DataRecord:
        key = self._key(record)
        h, w = self.cache_hw
        src_mtime = os.stat(record.path).st_mtime
        with self._lock:
            entry = self._index.get(key)
        offset = mtime = None
        if entry is not None:
            offset, mtime = entry
        # mtime validation like FileCache: a replaced source image must
        # re-cache, not serve the stale pixels forever
        if mtime is not None and src_mtime > mtime:
            offset = None
        if offset is not None and os.path.exists(self.shard_path):
            try:
                with open(self.shard_path, "rb") as f:
                    payload = read_tfrecord(f, offset)
                image = (
                    np.frombuffer(payload, np.uint8)
                    .reshape(3, h, w)
                    .astype(np.float32)
                    / 255.0
                )
                return DataRecord(
                    image=image, boxes=self._boxes_for(record),
                    classes=record.classes,
                )
            except (ValueError, OSError, struct.error):
                pass  # corrupt entry → re-decode below

        rec = self._loader.load(record)
        payload = (
            np.clip(rec.image * 255.0 + 0.5, 0, 255).astype(np.uint8).tobytes()
        )
        with self._lock:
            with open(self.shard_path, "ab") as f:
                offset, _ = write_tfrecord(f, payload)
            self._index[key] = (offset, src_mtime)
            with open(self.index_path, "a") as f:
                f.write(json.dumps(
                    {"k": key, "o": offset, "m": src_mtime}) + "\n")
        return rec
