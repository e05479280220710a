"""The port's decode library (``csrc/host_decode.cpp`` through
``data/native_loader.py`` ``NativeLoader``) against the reference's
``native/loader.cpp``, built from the checkout into a temp dir, bit for
bit; the reference's own ``TestNativeLoader`` cases (tests/test_data.py
:547-680) on the port; the per-record PIL route; threads."""

import os
import threading

import numpy as np
import pytest
from PIL import Image

from _torch_parity import reference_native  # noqa: F401
from yolodl_torch.data import native_loader as t_native
from yolodl_torch.data.cache import OnDemandLoader
from yolodl_torch.data.letterbox import letterbox_geometry
from yolodl_torch.data.records import FileRecord
from yolodl_tpu.data.records import FileRecord as JFileRecord

BOXES = np.asarray([[12.0, 20.0, 10.0, 16.0], [30.0, 8.0, 6.0, 9.0]])
CLASSES = np.asarray([1, 2], np.int32)


def write_image(tmp_path, kind, seed=0):
    """(path, height, width) of a seeded image file of one PNG/JPEG flavour."""
    rng = np.random.default_rng(seed)
    h, w = (900, 1200) if kind.startswith("jpeg_big") else (40, 60)
    if kind == "jpeg_big":  # smooth, as tests/test_data.py's scaled-decode case
        yy, xx = np.mgrid[0:h, 0:w]
        rgb = np.stack([xx * 255 // w, yy * 255 // h, (xx + yy) * 255 // (h + w)], -1)
        im = Image.fromarray(rgb.astype(np.uint8))
    else:
        rgb = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
        im = {"png_rgb": lambda: Image.fromarray(rgb),
              "png_grey": lambda: Image.fromarray(rgb[..., 0]),
              "png_palette": lambda: Image.fromarray(rgb).quantize(37),
              "png_rgba": lambda: Image.fromarray(
                  np.concatenate([rgb, rgb[..., :1]], -1), "RGBA"),
              "png_16bit": lambda: Image.fromarray(rgb[..., 0].astype(np.uint16) * 257),
              "jpeg": lambda: Image.fromarray(rgb),
              "jpeg_grey": lambda: Image.fromarray(rgb[..., 1]),
              "bmp": lambda: Image.fromarray(rgb)}[kind]()
    suffix = {"png": ".png", "jpe": ".jpg", "bmp": ".bmp"}[kind[:3]]
    path = tmp_path / f"{kind}{suffix}"
    im.save(path, **({"quality": 95} if suffix == ".jpg" else {}))
    return str(path), h, w


def records(path, h, w, boxes=BOXES, classes=CLASSES):
    return (FileRecord(path, h, w, boxes.copy(), classes.copy()),
            JFileRecord(path, h, w, boxes.copy(), classes.copy()))


def assert_records_equal(a, b):
    for f in ("image", "boxes", "classes"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)


KINDS = ("png_rgb", "png_grey", "png_palette", "png_rgba", "png_16bit", "jpeg", "jpeg_grey",
         "jpeg_big")


@pytest.mark.parametrize("scaled", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_load_bit_identical_to_reference(tmp_path, reference_native, kind, scaled):
    path, h, w = write_image(tmp_path, kind)
    boxes = BOXES * 20 if kind == "jpeg_big" else BOXES
    t_rec, j_rec = records(path, h, w, boxes)
    for hw in ((32, 32), (48, 64), (96, 96)):
        out = t_native.NativeLoader(hw, scaled_decode=scaled).load(t_rec)
        assert out.image.shape == (3, *hw)
        assert_records_equal(out, reference_native.NativeLoader(hw, scaled_decode=scaled)
                             .load(j_rec))


def test_unread_format_takes_pil_per_record(tmp_path, reference_native):
    """A BMP is neither JPEG nor PNG: ldr_load fails and that record alone
    goes through PIL, as the reference's does."""
    path, h, w = write_image(tmp_path, "bmp")
    t_rec, j_rec = records(path, h, w)
    out = t_native.NativeLoader((32, 32)).load(t_rec)
    assert_records_equal(out, OnDemandLoader((32, 32)).load(t_rec))
    assert_records_equal(out, reference_native.NativeLoader((32, 32)).load(j_rec))


def test_boxes_without_dimensions_raise(tmp_path, reference_native):
    path, _, _ = write_image(tmp_path, "png_rgb")
    t_rec, j_rec = records(path, 0, 0)
    with pytest.raises(ValueError, match="no image dimensions"):
        t_native.NativeLoader((32, 32)).load(t_rec)
    with pytest.raises(ValueError, match="no image dimensions"):
        reference_native.NativeLoader((32, 32)).load(j_rec)
    # box-less records may carry 0x0 dims (classification)
    t_rec, j_rec = records(path, 0, 0, np.zeros((0, 4)), np.zeros((0,), np.int32))
    out = t_native.NativeLoader((32, 32)).load(t_rec)
    assert out.boxes.shape == (0, 4)
    assert_records_equal(out, reference_native.NativeLoader((32, 32)).load(j_rec))


def test_truncated_jpeg(tmp_path, reference_native):
    """libjpeg's fatal error fails the one decode (rc != 0 → PIL), as the
    reference's does, and the loader goes on working."""
    good, h, w = write_image(tmp_path, "jpeg")
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(open(good, "rb").read()[:120])
    empty = (np.zeros((0, 4)), np.zeros((0,), np.int32))
    outcomes = []
    for loader, rec in zip((t_native.NativeLoader((32, 32)),
                            reference_native.NativeLoader((32, 32))),
                           records(str(bad), h, w, *empty)):
        try:
            outcomes.append(loader.load(rec).image)
        except Exception as e:  # PIL may refuse the stub: raising is fine, dying is not
            outcomes.append(type(e))
    if isinstance(outcomes[0], np.ndarray):
        np.testing.assert_array_equal(*outcomes)
    else:
        assert outcomes[0] is outcomes[1]
    ok = t_native.NativeLoader((32, 32)).load(records(good, h, w, *empty)[0])
    assert ok.image.shape == (3, 32, 32)


def test_threads_give_the_serial_outputs(tmp_path):
    """Four threads calling ldr_load at once (the call releases the GIL)
    give what one thread gives."""
    recs = [records(*write_image(tmp_path, kind, seed=3))[0] for kind in KINDS]
    loader = t_native.NativeLoader((64, 64))
    serial = [loader.load(r) for r in recs]
    results = [None] * len(recs)

    def worker(k):
        for _ in range(4):
            for i in range(k, len(recs), 4):
                results[i] = loader.load(recs[i])

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(results, serial):
        assert_records_equal(a, b)


# -- the reference's own TestNativeLoader (tests/test_data.py:547-680), on
# the port


def test_matches_pil_path(tmp_path):
    # a smooth gradient: PIL's antialiased downscale and the 2-tap bilinear
    # agree closely on smooth content (they differ on noise)
    grad = np.zeros((40, 60, 3), np.uint8)
    grad[..., 0] = np.linspace(0, 255, 60, dtype=np.uint8)[None, :]
    grad[..., 1] = np.linspace(0, 255, 40, dtype=np.uint8)[:, None]
    path = tmp_path / "grad.png"
    Image.fromarray(grad).save(path)
    rec = FileRecord(str(path), 40, 60, BOXES, CLASSES)
    a = t_native.NativeLoader((32, 32)).load(rec)
    b = OnDemandLoader((32, 32)).load(rec)
    assert a.image.shape == b.image.shape == (3, 32, 32)
    assert np.abs(a.image - b.image).mean() < 0.02
    np.testing.assert_allclose(a.boxes, b.boxes, atol=1e-5)


def test_jpeg_decode(tmp_path):
    path, h, w = write_image(tmp_path, "jpeg")
    rec = FileRecord(path, h, w, np.zeros((0, 4)), np.zeros((0,), np.int32))
    out = t_native.NativeLoader((48, 48)).load(rec)
    assert out.image.shape == (3, 48, 48)
    assert np.abs(out.image - OnDemandLoader((48, 48)).load(rec).image).mean() < 0.03


def test_scaled_jpeg_decode_parity(tmp_path):
    """DCT-scaled decode of a large JPEG keeps the letterbox geometry and
    the box transforms exact against the full-resolution decode, and the
    pixels close."""
    path, h, w = write_image(tmp_path, "jpeg_big")
    rec = FileRecord(path, h, w, np.asarray([[450.0, 600.0, 300.0, 400.0]]),
                     np.zeros((1,), np.int32))
    scaled = t_native.NativeLoader((96, 96), scaled_decode=True).load(rec)
    full = t_native.NativeLoader((96, 96), scaled_decode=False).load(rec)
    assert scaled.image.shape == full.image.shape == (3, 96, 96)
    pad_s = np.abs(scaled.image - 0.5).max(axis=(0, 2)) < 1e-3
    pad_f = np.abs(full.image - 0.5).max(axis=(0, 2)) < 1e-3
    np.testing.assert_array_equal(pad_s, pad_f)
    np.testing.assert_allclose(scaled.boxes, full.boxes)
    assert np.abs(scaled.image - full.image).mean() < 0.02
    assert not np.array_equal(scaled.image, full.image)  # the scaled decode ran


def test_scaled_decode_noop_when_image_small(tmp_path):
    path, h, w = write_image(tmp_path, "jpeg")
    rec = FileRecord(path, h, w, np.zeros((0, 4)), np.zeros((0,), np.int32))
    a = t_native.NativeLoader((48, 48), scaled_decode=True).load(rec)
    b = t_native.NativeLoader((48, 48), scaled_decode=False).load(rec)
    np.testing.assert_array_equal(a.image, b.image)


@pytest.mark.parametrize("package", ["port", "reference"])
def test_halfway_rounding_matches_python(tmp_path, request, package):
    """Content placement on an exact-half resize (25·16/32 = 12.5) follows
    letterbox_geometry's round-half-even (width 12, not 13)."""
    assert letterbox_geometry((32, 25), (16, 16)) == (16, 12, 0, 2)
    native = t_native if package == "port" else request.getfixturevalue("reference_native")
    path = tmp_path / "white.png"
    Image.fromarray(np.full((32, 25, 3), 255, np.uint8)).save(path)
    empty = (np.zeros((0, 4)), np.zeros((0,), np.int32))
    rec = (FileRecord if package == "port" else JFileRecord)(str(path), 32, 25, *empty)
    a = native.NativeLoader((16, 16)).load(rec).image
    b = OnDemandLoader((16, 16)).load(FileRecord(str(path), 32, 25, *empty)).image
    cols_a = (np.abs(a - 0.5) > 1e-3).any(axis=(0, 1))
    cols_b = (np.abs(b - 0.5) > 1e-3).any(axis=(0, 1))
    np.testing.assert_array_equal(cols_a, cols_b)
    assert cols_a.sum() == 12


@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_caches_on_the_native_route(tmp_path, monkeypatch, reference_native, dtype):
    """Both packages' make_decode_loader, FileCache and MemoryCache on
    their default route, which is native here: the same records bit for
    bit, misses and hits, and the same cache files."""
    from yolodl_tpu.data import cache as j_cache
    from yolodl_torch.data import cache as t_cache

    monkeypatch.delenv("YDL_NO_NATIVE_DECODE", raising=False)
    recs = [records(*write_image(tmp_path, kind, seed=i)) for i, kind in enumerate(KINDS)]
    assert type(t_cache.make_decode_loader((40, 40))) is t_native.NativeLoader
    assert type(j_cache.make_decode_loader((40, 40))) is reference_native.NativeLoader
    jc = j_cache.FileCache(str(tmp_path / "j"), (40, 40), dtype=dtype)
    tc = t_cache.FileCache(str(tmp_path / "t"), (40, 40), dtype=dtype)
    jm, tm = j_cache.MemoryCache((40, 40)), t_cache.MemoryCache((40, 40))
    for t_rec, j_rec in recs:
        assert_records_equal(tc.load(t_rec), jc.load(j_rec))  # misses
        assert_records_equal(tc.load(t_rec), jc.load(j_rec))  # hits, read back
        assert_records_equal(tm.load(t_rec), jm.load(j_rec))
    assert sorted(os.listdir(tmp_path / "j")) == sorted(os.listdir(tmp_path / "t"))
