"""The port's dataset loaders and image loaders (yolodl_torch/data/) against
the reference's (yolodl_tpu/data/) on small synthetic datasets: the same
records (paths, sizes, pixel boxes, classes) and class lists, and the same
decoded, letterboxed images and ratio boxes, exactly."""

import dataclasses
import json
import os

import numpy as np
import pytest
from PIL import Image

from yolodl_tpu.config.app_config import DatasetConfig as JDatasetConfig
from yolodl_tpu.data import cache as j_cache
from yolodl_tpu.data import datasets as j_ds
from yolodl_torch.config.app_config import DatasetConfig as TDatasetConfig
from yolodl_torch.data import cache as t_cache
from yolodl_torch.data import datasets as t_ds

CLASSES = ["cat", "dog", "bird"]
SIZES = [(48, 64), (72, 128), (64, 64)]  # three original sizes, h x w


def write_images(root, rng, ext="png"):
    names = []
    for i, (h, w) in enumerate(SIZES):
        name = f"im{i}.{ext}"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            os.path.join(root, name))
        names.append((name, h, w))
    return names


def random_boxes(rng, h, w, n):
    """n (ymin, xmin, ymax, xmax) pixel boxes, some past the border by 2 px."""
    out = []
    for _ in range(n):
        bh, bw = rng.uniform(2, h / 2), rng.uniform(2, w / 2)
        y0, x0 = rng.uniform(-2, h - bh + 2), rng.uniform(-2, w - bw + 2)
        out.append((y0, x0, y0 + bh, x0 + bw))
    return out


def voc_xml(filename, h, w, objects):
    objs = "".join(
        f"<object><name>{name}</name><bndbox><xmin>{x0}</xmin><ymin>{y0}</ymin>"
        f"<xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox></object>"
        for name, (y0, x0, y1, x1) in objects)
    return (f"<annotation><filename>{filename}</filename><size><width>{w}</width>"
            f"<height>{h}</height><depth>3</depth></size>{objs}</annotation>")


@pytest.fixture()
def csv_root(tmp_path, rng):
    root = tmp_path / "csv"
    root.mkdir()
    (root / "classes.txt").write_text("\n".join(CLASSES) + "\n")
    lines = ["image_file,class_name,cy,cx,h,w"]
    for name, h, w in write_images(str(root), rng):
        for y0, x0, y1, x1 in random_boxes(rng, h, w, 3):
            lines.append(f"{name},{CLASSES[rng.integers(3)]},{(y0 + y1) / 2},"
                         f"{(x0 + x1) / 2},{y1 - y0},{x1 - x0}")
    (root / "label.csv").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture()
def coco_root(tmp_path, rng):
    root = tmp_path / "coco"
    (root / "val2017").mkdir(parents=True)
    (root / "annotations").mkdir()
    images, anns = [], []
    for img_id, (name, h, w) in enumerate(write_images(str(root / "val2017"), rng)):
        images.append({"id": img_id + 10, "file_name": name, "height": h, "width": w})
        for y0, x0, y1, x1 in random_boxes(rng, h, w, 3):
            anns.append({"id": len(anns), "image_id": img_id + 10,
                         "category_id": [1, 3, 7][rng.integers(3)],
                         "bbox": [x0, y0, x1 - x0, y1 - y0], "iscrowd": int(rng.random() < 0.2)})
    cats = [{"id": 7, "name": "bird"}, {"id": 1, "name": "cat"}, {"id": 3, "name": "dog"}]
    (root / "annotations" / "instances_val2017.json").write_text(
        json.dumps({"images": images, "annotations": anns, "categories": cats}))
    return root


@pytest.fixture()
def voc_root(tmp_path, rng):
    root = tmp_path / "voc"
    (root / "JPEGImages").mkdir(parents=True)
    (root / "Annotations").mkdir()
    for name, h, w in write_images(str(root / "JPEGImages"), rng, "jpg"):
        objs = [(CLASSES[rng.integers(3)], b) for b in random_boxes(rng, h, w, 2)]
        (root / "Annotations" / f"{name[:-4]}.xml").write_text(voc_xml(name, h, w, objs))
    return root


@pytest.fixture()
def iii_root(tmp_path, rng):
    root = tmp_path / "iii"
    for sub in ("a", "a/b", "c"):
        (root / sub).mkdir(parents=True, exist_ok=True)
    (tmp_path / "iii_classes.txt").write_text("\n".join(CLASSES) + "\n")
    for i, (sub, (h, w)) in enumerate(zip(("a", "a/b", "c"), SIZES)):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
            root / sub / f"f{i}.jpg")
        objs = [(name, b) for name, b in zip(["cat", "zebra", "bird"],
                                             random_boxes(rng, h, w, 3))]
        (root / sub / f"f{i}.xml").write_text(voc_xml(f"f{i}.jpg", h, w, objs))
    return root


def assert_same_records(port, ref):
    assert list(port.classes) == list(ref.classes)
    assert port.input_channels == ref.input_channels
    assert len(port.records()) == len(ref.records())
    for a, b in zip(port.records(), ref.records()):
        assert (a.path, a.height, a.width) == (b.path, b.height, b.width)
        assert a.boxes_pixel.dtype == b.boxes_pixel.dtype
        np.testing.assert_array_equal(a.boxes_pixel, b.boxes_pixel)
        np.testing.assert_array_equal(a.classes, b.classes)


def build(kind, root, tmp_path, pkg):
    if kind == "csv":
        return pkg.CsvDataset(str(root), str(root / "label.csv"), str(root / "classes.txt"))
    if kind == "coco":
        return pkg.CocoDataset(str(root), classes_whitelist=["dog", "bird"])
    if kind == "voc":
        return pkg.VocDataset(str(root))
    return pkg.IiiDataset(str(root), str(tmp_path / "iii_classes.txt"),
                          classes_whitelist=["cat", "bird"], blacklist_files=["c/f2.xml"])


@pytest.mark.parametrize("kind", ["csv", "coco", "voc", "iii"])
def test_dataset_records(kind, request, tmp_path):
    root = request.getfixturevalue(f"{kind}_root")
    ref = build(kind, root, tmp_path, j_ds)
    port = build(kind, root, tmp_path, t_ds)
    assert_same_records(port, ref)
    assert len(ref.records()) >= 2
    for tol, min_size, scaling in ((2.5, 0.0, 1.0), (3.0, 0.1, 1.3)):
        assert_same_records(
            t_ds.SanitizedDataset(port, out_of_bound_tolerance=tol,
                                  min_bbox_size=min_size, bbox_scaling=scaling),
            j_ds.SanitizedDataset(ref, out_of_bound_tolerance=tol,
                                  min_bbox_size=min_size, bbox_scaling=scaling))


def test_sanitizer_errors(csv_root):
    # im0 is 48 x 64: this box reaches 5 px past its top edge
    (csv_root / "over.csv").write_text("image_file,class_name,cy,cx,h,w\n"
                                       "im0.png,cat,5,20,20,10\n")
    for pkg in (j_ds, t_ds):
        ds = pkg.CsvDataset(str(csv_root), str(csv_root / "over.csv"),
                            str(csv_root / "classes.txt"))
        with pytest.raises(ValueError, match="beyond tolerance 4.0"):
            pkg.SanitizedDataset(ds, out_of_bound_tolerance=4.0)
        assert len(pkg.SanitizedDataset(ds, out_of_bound_tolerance=5.0).records()) == 1
        with pytest.raises(ValueError, match="min_bbox_size"):
            pkg.SanitizedDataset(ds, min_bbox_size=1.5)


def test_classes_file_and_unknown_class(csv_root, tmp_path):
    (tmp_path / "dup.txt").write_text("a\nb\na\n")
    (tmp_path / "ok.txt").write_text("a\n\n b \n")
    (csv_root / "zebra.csv").write_text("image_file,class_name,cy,cx,h,w\n"
                                        "im0.png,zebra,20,20,10,10\n")
    for pkg in (j_ds, t_ds):
        with pytest.raises(ValueError, match="duplicate class names"):
            pkg.load_classes_file(str(tmp_path / "dup.txt"))
        assert pkg.load_classes_file(str(tmp_path / "ok.txt")) == ["a", "b"]
        with pytest.raises(ValueError, match="unknown class 'zebra'"):
            pkg.CsvDataset(str(csv_root), str(csv_root / "zebra.csv"),
                           str(csv_root / "classes.txt"))


@pytest.mark.parametrize("kind", ["csv", "coco", "voc", "iii"])
def test_records_cache_through_dataset_config(kind, request, tmp_path):
    """DatasetConfig.open with a records cache: a miss parses and writes the
    cache, a hit reads it back; both packages give the same records, and
    each reads the cache file the other wrote."""
    root = request.getfixturevalue(f"{kind}_root")
    raw = {"kind": {"type": kind.capitalize(), "image_size": 32,
                    "dataset_dir": str(root), "classes_file": str(tmp_path / "iii_classes.txt"),
                    "image_dir": str(root), "label_file": str(root / "label.csv"),
                    "dataset_name": "val2017" if kind == "coco" else ""}}
    if kind == "csv":
        raw["kind"]["classes_file"] = str(root / "classes.txt")
    jcfg, tcfg = JDatasetConfig.parse(raw), TDatasetConfig.parse(raw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    ref = jcfg.open(str(tmp_path), records_cache_dir=str(tmp_path / "cache_j"))
    port_miss = tcfg.open(str(tmp_path), records_cache_dir=str(tmp_path / "cache_t"))
    port_hit = tcfg.open(str(tmp_path), records_cache_dir=str(tmp_path / "cache_t"))
    assert type(port_hit).__name__ == "PrebuiltDataset"
    from_ref_cache = tcfg.open(str(tmp_path), records_cache_dir=str(tmp_path / "cache_j"))
    assert type(from_ref_cache).__name__ == "PrebuiltDataset"
    for port in (port_miss, port_hit, from_ref_cache):
        assert_same_records(port, ref)
    assert sorted(os.listdir(tmp_path / "cache_j")) == sorted(os.listdir(tmp_path / "cache_t"))


@pytest.fixture()
def csv_records(csv_root):
    ds = j_ds.CsvDataset(str(csv_root), str(csv_root / "label.csv"), str(csv_root / "classes.txt"))
    return j_ds.SanitizedDataset(ds, out_of_bound_tolerance=2.5).records()


def assert_same_data(a, b):
    assert a.image.dtype == b.image.dtype == np.float32
    np.testing.assert_array_equal(a.image, b.image)
    np.testing.assert_array_equal(a.boxes, b.boxes)
    np.testing.assert_array_equal(a.classes, b.classes)


@pytest.mark.parametrize("index", range(len(SIZES)))
def test_on_demand_loader(index, csv_records, monkeypatch):
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")
    rec = csv_records[index]
    ref = j_cache.make_decode_loader((40, 40)).load(rec)
    port = t_cache.make_decode_loader((40, 40)).load(rec)
    assert type(t_cache.make_decode_loader((40, 40))) is t_cache.OnDemandLoader
    assert_same_data(port, ref)
    assert len(port.boxes) == len(rec.boxes_pixel)
    np.testing.assert_array_equal(t_cache.decode_image(rec.path), j_cache.decode_image(rec.path))


@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_file_and_memory_cache(dtype, csv_records, tmp_path, monkeypatch):
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")
    jc = j_cache.FileCache(str(tmp_path / "j"), (40, 40), dtype=dtype)
    tc = t_cache.FileCache(str(tmp_path / "t"), (40, 40), dtype=dtype)
    jm, tm = j_cache.MemoryCache((40, 40)), t_cache.MemoryCache((40, 40))
    for rec in csv_records:
        miss_j, miss_t = jc.load(rec), tc.load(rec)
        assert_same_data(miss_t, miss_j)
        assert_same_data(tc.load(rec), jc.load(rec))  # hits, read back from disk
        assert_same_data(tm.load(rec), jm.load(rec))
        assert_same_data(tm.load(rec), jm.load(rec))
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))
