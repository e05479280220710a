"""``TrainingStream`` with the smoke's augment recipe (mosaic 0.5, colour
jitter, a 10° random affine; chip_smoke.py ``augment_recipe``) at 64²,
the port against the reference on each route, bit for bit: both native
(the reference's ``native/loader.cpp`` built into a temp dir), and both
on their plain numpy/scipy versions."""

import numpy as np
import pytest

from _torch_parity import plain_route, reference_native  # noqa: F401
from yolodl_tpu.data import affine as j_affine
from yolodl_tpu.data import color as j_color
from yolodl_tpu.data import mosaic as j_mosaic
from yolodl_tpu.data import pipeline as j_pipe
from yolodl_tpu.data import records as j_records
from yolodl_torch.data import affine as t_affine
from yolodl_torch.data import color as t_color
from yolodl_torch.data import mosaic as t_mosaic
from yolodl_torch.data import native_loader as t_native
from yolodl_torch.data import pipeline as t_pipe
from yolodl_torch.data import records as t_records

SIZE, RECORDS, BATCH = 64, 24, 8


class Loader:
    """Index → a seeded record of one package: a smooth colour field with
    noise on the u8/255 grid, 1-7 boxes of 3 classes."""

    def __init__(self, records_module):
        self.record = records_module.DataRecord

    def load(self, i):
        rng = np.random.default_rng(3000 + int(i))
        low = rng.uniform(0, 255, (3, 4, 4))
        field = np.kron(low, np.ones((SIZE // 4, SIZE // 4)))
        pixels = np.clip(np.rint(field + rng.integers(-12, 13, field.shape)), 0, 255)
        n = int(rng.integers(1, 8))
        cy, cx = rng.uniform(0.2, 0.8, (2, n))
        bh, bw = rng.uniform(0.05, 0.3, (2, n))
        return self.record((pixels / 255.0).astype(np.float32),
                           np.stack([cy, cx, bh, bw], -1).astype(np.float32),
                           rng.integers(0, 3, n).astype(np.int32))


def recipe(color, affine, mosaic, pipe, workers):
    return pipe.TrainingStreamConfig(
        batch_size=BATCH, max_gt=64, seed=0, workers=workers,
        mosaic_prob=0.5, mosaic=mosaic.MosaicMixer(mosaic_margin=0.25),
        color_jitter=color.ColorJitter(hue_shift=0.1, saturation_shift=0.2, value_shift=0.2),
        random_affine=affine.RandomAffine(
            rotate_prob=0.5, rotate_degrees=10.0, translation_prob=0.5, translation=0.1,
            scale_prob=0.5, scale=(0.8, 1.2), horizontal_flip_prob=0.5))


def batches(package, records_module, workers, n=4):
    pipe = package[3]
    stream = iter(pipe.TrainingStream(list(range(RECORDS)), Loader(records_module),
                                      recipe(*package, workers)))
    try:
        return [next(stream) for _ in range(n)]
    finally:
        stream.close()


T = (t_color, t_affine, t_mosaic, t_pipe)
J = (j_color, j_affine, j_mosaic, j_pipe)


def assert_identical(port, ref):
    for a, b in zip(port, ref):
        for f in ("images", "boxes", "classes", "mask"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("workers", [1, 4])
def test_native_stream_identical_to_reference_native(reference_native, workers):
    port, ref = batches(T, t_records, workers), batches(J, j_records, workers)
    assert t_native._aug_lib_cache and reference_native._aug_lib_cache  # both ran natively
    assert_identical(port, ref)


@pytest.mark.parametrize("workers", [1, 4])
def test_plain_stream_identical_to_reference_numpy(plain_route, workers):
    assert_identical(batches(T, t_records, workers), batches(J, j_records, workers))


def test_routes_differ_only_by_rounding(monkeypatch):
    """The native stream against the plain one: the same draws, labels
    identical, pixels within the warp's and the jitter's tolerances but at
    border ties (a few values here at most)."""
    native = batches(T, t_records, 1)
    monkeypatch.setattr(t_native, "_aug_lib_cache", False)
    plain = batches(T, t_records, 1)
    for a, b in zip(native, plain):
        for f in ("boxes", "classes", "mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        diff = np.abs(a.images - b.images)
        assert np.mean(diff > 1e-4) < 1e-3
        assert np.median(diff) < 1e-6
