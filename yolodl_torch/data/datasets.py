"""Dataset loaders: COCO / VOC / CSV + sanitizer decorator.

Equivalent capability to ``yolo-dl/src/dataset/``:

- COCO instances JSON (coco_.rs:40-152): category id→contiguous index
  mapping, optional class whitelist, tlhw→cycxhw conversion.  Implemented
  directly on the annotation JSON (no pycocotools dependency).
- PASCAL VOC XML (voc.rs:9-148).
- CSV format ``image_file,class_name,cy,cx,h,w`` in pixel units with a
  ``classes.txt`` (csv.rs:32-199 + tests/csv_dataset fixture layout).
- SanitizedDataset (sanitized.rs:21-148): clamp boxes to the image with an
  out-of-bound tolerance, drop boxes smaller than min_bbox_size.
- classes-file loader (dataset/utils.rs:3-19): one class name per line.

All loaders produce :class:`FileRecord` lists (random access); decoding to
:class:`DataRecord` happens in the cache/loader layer.
"""

from __future__ import annotations

import csv as csv_mod
import json
import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Sequence, Set

import numpy as np
from PIL import Image

from .records import FileRecord


def load_classes_file(path) -> List[str]:
    """One class name per line; order defines the class index."""
    with open(path) as f:
        classes = [line.strip() for line in f if line.strip()]
    if len(set(classes)) != len(classes):
        raise ValueError(f"duplicate class names in {path}")
    return classes


class _ListDataset:
    """Base: a list of FileRecords + class names."""

    def __init__(self, records: List[FileRecord], classes: List[str]):
        self._records = records
        self._classes = classes

    @property
    def classes(self) -> List[str]:
        return self._classes

    @property
    def input_channels(self) -> int:
        return 3

    def __len__(self) -> int:
        return len(self._records)

    def __getitem__(self, index: int) -> FileRecord:
        return self._records[index]

    def records(self) -> List[FileRecord]:
        return self._records


class PrebuiltDataset(_ListDataset):
    """A dataset rebuilt from already-parsed records (the records cache)."""

    def __init__(self, records: List[FileRecord], classes: List[str],
                 input_channels: int = 3):
        self._input_channels = input_channels
        super().__init__(records, classes)

    @property
    def input_channels(self) -> int:
        return self._input_channels


def coco_annotation_file(dataset_dir: str,
                         annotation_file: Optional[str] = None,
                         dataset_name: str = "") -> str:
    """Conventional layout: {dir}/annotations/instances_{split}.json.

    ``dataset_name`` is the split (``train2017``, ``val2017`` — the
    reference's required Coco config field, train/src/config.rs:79-84).
    Without it, a directory holding exactly ONE instances_*.json resolves
    to that file; several splits raise rather than silently picking one
    (a stock COCO dir sorts ``instances_train2017`` first — an eval config
    would quietly score the training split)."""
    ann_dir = os.path.join(dataset_dir, "annotations")
    if annotation_file is not None:
        return annotation_file
    if dataset_name:
        path = os.path.join(ann_dir, f"instances_{dataset_name}.json")
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} (dataset_name={dataset_name!r})")
        return path
    candidates = []
    if os.path.isdir(ann_dir):
        candidates = [
            os.path.join(ann_dir, n)
            for n in sorted(os.listdir(ann_dir))
            if n.startswith("instances_") and n.endswith(".json")
        ]
    if not candidates:
        raise FileNotFoundError(f"no instances_*.json under {ann_dir}")
    if len(candidates) > 1:
        names = ", ".join(
            os.path.basename(c)[len("instances_"):-len(".json")]
            for c in candidates)
        raise ValueError(
            f"{ann_dir} holds several splits ({names}) — set the dataset "
            "config's 'dataset_name' to choose one")
    return candidates[0]


def csv_source_files(image_dir: str, label_file: str,
                     classes_file: str) -> List[str]:
    """Annotation sources of a CSV dataset, including the images (their
    dimensions are read at parse time, so a changed image invalidates the
    parsed records)."""
    names = set()
    with open(label_file, newline="") as f:
        for row in csv_mod.DictReader(f):
            names.add(row["image_file"])
    return [label_file, classes_file] + [
        os.path.join(image_dir, n) for n in sorted(names)
    ]


class CocoDataset(_ListDataset):
    """COCO detection annotations (instances_*.json)."""

    def __init__(
        self,
        dataset_dir: str,
        annotation_file: Optional[str] = None,
        image_dir: Optional[str] = None,
        classes_whitelist: Optional[Sequence[str]] = None,
        dataset_name: str = "",
    ):
        annotation_file = coco_annotation_file(dataset_dir, annotation_file,
                                               dataset_name)
        with open(annotation_file) as f:
            coco = json.load(f)

        cats = sorted(coco["categories"], key=lambda c: c["id"])
        whitelist: Optional[Set[str]] = set(classes_whitelist) if classes_whitelist else None
        names = [c["name"] for c in cats if whitelist is None or c["name"] in whitelist]
        cat_to_index: Dict[int, int] = {}
        for c in cats:
            if whitelist is None or c["name"] in whitelist:
                cat_to_index[c["id"]] = names.index(c["name"])

        if image_dir is None:
            split = os.path.splitext(os.path.basename(annotation_file))[0].replace(
                "instances_", ""
            )
            guess = os.path.join(dataset_dir, split)
            image_dir = guess if os.path.isdir(guess) else dataset_dir

        images = {img["id"]: img for img in coco["images"]}
        boxes_by_image: Dict[int, List] = {img_id: [] for img_id in images}
        for ann in coco["annotations"]:
            if ann.get("iscrowd"):
                continue
            if ann["category_id"] not in cat_to_index:
                continue
            boxes_by_image.setdefault(ann["image_id"], []).append(ann)

        records = []
        for img_id, img in images.items():
            anns = boxes_by_image.get(img_id, [])
            boxes, classes = [], []
            for ann in anns:
                # coco bbox = [x_min, y_min, w, h] pixels → cycxhw
                x, y, w, h = ann["bbox"]
                boxes.append((y + h / 2, x + w / 2, h, w))
                classes.append(cat_to_index[ann["category_id"]])
            records.append(
                FileRecord(
                    path=os.path.join(image_dir, img["file_name"]),
                    height=img["height"],
                    width=img["width"],
                    boxes_pixel=np.asarray(boxes, np.float64).reshape(-1, 4),
                    classes=np.asarray(classes, np.int32),
                )
            )
        super().__init__(records, names)


def voc_source_files(dataset_dir: str) -> List[str]:
    ann_dir = os.path.join(dataset_dir, "Annotations")
    return sorted(
        os.path.join(ann_dir, n) for n in os.listdir(ann_dir) if n.endswith(".xml")
    )


def iii_source_files(dataset_dir: str, classes_file: str) -> List[str]:
    import glob as glob_mod

    return [classes_file] + sorted(
        glob_mod.glob(os.path.join(dataset_dir, "**", "*.xml"), recursive=True)
    )


class VocDataset(_ListDataset):
    """PASCAL VOC layout: Annotations/*.xml + JPEGImages/."""

    def __init__(self, dataset_dir: str, classes: Optional[List[str]] = None):
        img_dir = os.path.join(dataset_dir, "JPEGImages")
        xmls = voc_source_files(dataset_dir)
        discovered: List[str] = list(classes) if classes else []
        parsed = []
        for xml_path in xmls:
            root = ET.parse(xml_path).getroot()
            filename = root.findtext("filename")
            size = root.find("size")
            # int(float(...)): float-valued dims occur in VOC-style XMLs
            # in the wild (same guard as IiiDataset)
            w = int(float(size.findtext("width")))
            h = int(float(size.findtext("height")))
            objs = []
            for obj in root.iter("object"):
                name = obj.findtext("name")
                if classes is None and name not in discovered:
                    discovered.append(name)
                if name not in discovered:
                    continue
                bb = obj.find("bndbox")
                xmin, ymin = float(bb.findtext("xmin")), float(bb.findtext("ymin"))
                xmax, ymax = float(bb.findtext("xmax")), float(bb.findtext("ymax"))
                objs.append((name, ymin, xmin, ymax, xmax))
            parsed.append((filename, h, w, objs))

        if classes is None:
            discovered.sort()
        records = []
        for filename, h, w, objs in parsed:
            boxes, cls = [], []
            for name, ymin, xmin, ymax, xmax in objs:
                boxes.append(((ymin + ymax) / 2, (xmin + xmax) / 2, ymax - ymin, xmax - xmin))
                cls.append(discovered.index(name))
            records.append(
                FileRecord(
                    path=os.path.join(img_dir, filename),
                    height=h,
                    width=w,
                    boxes_pixel=np.asarray(boxes, np.float64).reshape(-1, 4),
                    classes=np.asarray(cls, np.int32),
                )
            )
        super().__init__(records, discovered)


class CsvDataset(_ListDataset):
    """``image_file,class_name,cy,cx,h,w`` pixel-unit labels (csv.rs parity)."""

    def __init__(self, image_dir: str, label_file: str, classes_file: str,
                 input_channels: int = 3):
        classes = load_classes_file(classes_file)
        by_image: Dict[str, List] = {}
        with open(label_file, newline="") as f:
            for row in csv_mod.DictReader(f):
                name = row["image_file"]
                cls = row["class_name"]
                if cls not in classes:
                    raise ValueError(f"unknown class {cls!r} in {label_file}")
                by_image.setdefault(name, []).append(
                    (
                        float(row["cy"]), float(row["cx"]),
                        float(row["h"]), float(row["w"]),
                        classes.index(cls),
                    )
                )
        records = []
        for name in sorted(by_image):
            path = os.path.join(image_dir, name)
            with Image.open(path) as im:
                width, height = im.size
            rows = by_image[name]
            records.append(
                FileRecord(
                    path=path,
                    height=height,
                    width=width,
                    boxes_pixel=np.asarray([r[:4] for r in rows], np.float64),
                    classes=np.asarray([r[4] for r in rows], np.int32),
                )
            )
        self._input_channels = input_channels
        super().__init__(records, classes)

    @property
    def input_channels(self) -> int:
        return self._input_channels


class SanitizedDataset(_ListDataset):
    """Clamp out-of-bound boxes (within tolerance) and drop tiny ones
    (sanitized.rs:21-148).  ``out_of_bound_tolerance`` is in PIXELS
    (sanitized.rs:45-46 adds it to the pixel extent); ``min_bbox_size`` is
    an image-RATIO in [0, 1] (sanitized.rs:22,80-81 divides by the image
    size) — a box is dropped when h/img_h ≤ min or w/img_w ≤ min."""

    def __init__(self, inner: _ListDataset, out_of_bound_tolerance: float = 0.0,
                 min_bbox_size: float = 0.0, bbox_scaling: float = 1.0):
        if not 0.0 <= min_bbox_size <= 1.0:
            raise ValueError(
                f"min_bbox_size must be in [0, 1] (image ratio), got "
                f"{min_bbox_size}")
        if not bbox_scaling > 0.0:
            raise ValueError(
                f"bbox_scaling must be positive (cycxhw.rs try_scale), got "
                f"{bbox_scaling}")
        records = []
        for rec in inner.records():
            boxes = rec.boxes_pixel
            if len(boxes):
                cy, cx, h, w = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
                t, b = cy - h / 2, cy + h / 2
                l, r = cx - w / 2, cx + w / 2
                tol = out_of_bound_tolerance
                if np.any(t < -tol) or np.any(l < -tol) or \
                   np.any(b > rec.height + tol) or np.any(r > rec.width + tol):
                    raise ValueError(
                        f"{rec.path}: bbox exceeds image bounds beyond tolerance {tol}"
                    )
                t, b = np.clip(t, 0, rec.height), np.clip(b, 0, rec.height)
                l, r = np.clip(l, 0, rec.width), np.clip(r, 0, rec.width)
                nh, nw = b - t, r - l
                keep = ((nh / rec.height > min_bbox_size)
                        & (nw / rec.width > min_bbox_size))
                boxes = np.stack([(t + b) / 2, (l + r) / 2, nh, nw], -1)[keep]
                classes = rec.classes[keep]
                if bbox_scaling != 1.0:
                    # scale the surviving extents about their centers AFTER
                    # sanitizing — the reference loads records from the
                    # already-sanitized dataset and scales on the way into
                    # the stream (training_stream.rs:320-329; rect.scale),
                    # with no re-clamp, so scaled boxes may exceed bounds
                    # just as there.
                    boxes = boxes.copy()
                    boxes[:, 2:] *= bbox_scaling
            else:
                classes = rec.classes
            records.append(
                FileRecord(rec.path, rec.height, rec.width, boxes, classes)
            )
        super().__init__(records, inner.classes)
        # forward the wrapped dataset's channel count (CsvDataset can carry
        # a non-RGB override) instead of inheriting the hard-coded 3
        self._input_channels = getattr(inner, "input_channels", 3)

    @property
    def input_channels(self) -> int:
        return self._input_channels


class IiiDataset(_ListDataset):
    """III Formosa dataset: VOC-style XML annotations scattered under nested
    directories, image ``{stem}.jpg`` next to each XML (iii.rs:35-217).
    ``blacklist_files`` are dataset-dir-relative XML paths to skip."""

    def __init__(
        self,
        dataset_dir: str,
        classes_file: str,
        classes_whitelist: Optional[Sequence[str]] = None,
        blacklist_files: Optional[Sequence[str]] = None,
    ):
        classes = load_classes_file(classes_file)
        whitelist = set(classes_whitelist) if classes_whitelist else None
        blacklist = set(blacklist_files or ())

        records = []
        # discovery shared with the records-cache signature so the two
        # can't drift ([0] is the classes file)
        for xml_path in iii_source_files(dataset_dir, classes_file)[1:]:
            rel = os.path.relpath(xml_path, dataset_dir)
            if rel in blacklist:
                continue
            root = ET.parse(xml_path).getroot()
            size = root.find("size")
            w = int(float(size.findtext("width")))
            h = int(float(size.findtext("height")))
            boxes, cls = [], []
            for obj in root.iter("object"):
                name = obj.findtext("name")
                if name not in classes:
                    continue
                if whitelist is not None and name not in whitelist:
                    continue
                bb = obj.find("bndbox")
                xmin, ymin = float(bb.findtext("xmin")), float(bb.findtext("ymin"))
                xmax, ymax = float(bb.findtext("xmax")), float(bb.findtext("ymax"))
                boxes.append(
                    ((ymin + ymax) / 2, (xmin + xmax) / 2, ymax - ymin, xmax - xmin)
                )
                cls.append(classes.index(name))
            stem = os.path.splitext(os.path.basename(xml_path))[0]
            image_file = os.path.join(os.path.dirname(xml_path), stem + ".jpg")
            records.append(
                FileRecord(
                    path=image_file, height=h, width=w,
                    boxes_pixel=np.asarray(boxes, np.float64).reshape(-1, 4),
                    classes=np.asarray(cls, np.int32),
                )
            )
        super().__init__(records, classes)
