"""Parsed-annotation (label) cache.

The reference factored label handling into its ``cache`` crate
(``cache/src/label.rs`` — the label type the cached loaders re-emit;
``cache/src/file.rs:195-201`` re-derives ratio-frame labels on every cache
hit).  Per-record label *transforms* are deterministic and cheap, so this
framework recomputes them at load time (``data/cache.py``); what is NOT
cheap is building the record list in the first place: parsing a COCO
instances JSON, thousands of VOC/III XML files, or PIL-opening every image
of a CSV dataset just to read its dimensions.  That work is identical on
every CLI start, so this module caches the *parsed dataset*: the full
``FileRecord`` list + class names, serialized to one ``.npz`` per dataset
config, validated against the (mtime_ns, size) signature of every source
annotation file.

Layout: one compressed npz holding SoA columns (paths / sizes / flattened
boxes with offsets / classes) plus a JSON header with the class list and
the source signature.  Writes are tmp-file + ``os.replace`` atomic — the
same no-open-vs-write-race discipline as the image caches (the reference
documents this race at ``yolo-dl/src/processor/file_cache.rs:111-113``).
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import zipfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .records import FileRecord

# bump when the serialization layout changes
_FORMAT_VERSION = 1


def source_signature(paths: Sequence[str]) -> List[Tuple[str, int, int]]:
    """(path, mtime_ns, size) for every source file — any change (content
    edit, replacement, addition, removal) changes the signature and
    invalidates the cache."""
    sig = []
    for p in sorted(paths):
        st = os.stat(p)
        sig.append((os.path.abspath(p), st.st_mtime_ns, st.st_size))
    return sig


def cache_file_path(cache_dir: str, config_key: dict) -> str:
    """Stable per-dataset-config cache path.  Keyed on the dataset config
    (not the signature) so a source edit REPLACES the entry instead of
    accumulating stale files."""
    digest = hashlib.sha256(
        json.dumps({"v": _FORMAT_VERSION, **config_key}, sort_keys=True).encode()
    ).hexdigest()[:24]
    return os.path.join(cache_dir, f"records-{digest}.npz")


def save_records_cache(
    path: str,
    records: Sequence[FileRecord],
    classes: Sequence[str],
    input_channels: int,
    signature: List[Tuple[str, int, int]],
) -> None:
    n = len(records)
    offsets = np.zeros(n + 1, np.int64)
    for i, r in enumerate(records):
        offsets[i + 1] = offsets[i] + len(r.boxes_pixel)
    boxes = (
        np.concatenate([r.boxes_pixel.reshape(-1, 4) for r in records])
        if n and offsets[-1]
        else np.zeros((0, 4), np.float64)
    )
    cls = (
        np.concatenate([r.classes for r in records])
        if n and offsets[-1]
        else np.zeros((0,), np.int32)
    )
    header = json.dumps(
        {
            "version": _FORMAT_VERSION,
            "classes": list(classes),
            "input_channels": int(input_channels),
            "signature": signature,
        }
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + f".tmp{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f,
            header=np.frombuffer(header.encode(), np.uint8),
            paths=np.asarray([r.path for r in records], dtype=np.str_),
            heights=np.asarray([r.height for r in records], np.int64),
            widths=np.asarray([r.width for r in records], np.int64),
            offsets=offsets,
            boxes=np.asarray(boxes, np.float64),
            classes=cls.astype(np.int32),
        )
    os.replace(tmp, path)


def load_records_cache(
    path: str, signature: List[Tuple[str, int, int]]
) -> Optional[Tuple[List[FileRecord], List[str], int]]:
    """Returns (records, class_names, input_channels), or None on miss /
    stale signature / any decode problem (a corrupt cache is a miss, never
    an error — it gets rebuilt and replaced)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(bytes(z["header"].tobytes()).decode())
            if header.get("version") != _FORMAT_VERSION:
                return None
            stored_sig = [tuple(s) for s in header["signature"]]
            if stored_sig != [tuple(s) for s in signature]:
                return None
            paths = [str(p) for p in z["paths"]]
            heights = z["heights"]
            widths = z["widths"]
            offsets = z["offsets"]
            boxes = z["boxes"]
            classes = z["classes"]
        records = [
            FileRecord(
                path=paths[i],
                height=int(heights[i]),
                width=int(widths[i]),
                boxes_pixel=boxes[offsets[i]:offsets[i + 1]].copy(),
                classes=classes[offsets[i]:offsets[i + 1]].copy(),
            )
            for i in range(len(paths))
        ]
        return records, list(header["classes"]), int(header["input_channels"])
    except (OSError, ValueError, KeyError, json.JSONDecodeError,
            zipfile.BadZipFile):
        # BadZipFile subclasses Exception directly: a truncated npz keeps
        # its PK magic and np.load raises it rather than OSError/ValueError
        return None
