"""The deferred stream of the port's device augmentation
(``TrainingStream`` with ``defer_images``, then
``device_augment.apply_device_augmentation`` on the CPU) against the JAX
reference's deferred stream and against the port's own host pipeline.

- packs, boxes, classes and mask identical to the reference's deferred
  stream, batch by batch, also when it resumes at ``start_records``, which
  also replays the uninterrupted stream's batches;
- the augmented images against the port's CPU pipeline on the same seeds,
  with the bounds of ``tests/test_device_augment.py``'s stream cases
  (labels identical there too); the host pipeline jitters and warps on
  its plain numpy/scipy route there, whose formulas the program
  reproduces;
- ``apply_device_augmentation`` (CPU) against the reference's (its jitted
  program) on a rotating (two-pass warp) and a rotation-free recipe:
  labels identical, images within mean |Δ| ≤ 1e-5 and at most 0.2 % of
  pixels with |Δ| > 1e-3.
"""

import numpy as np
import pytest
import torch

from _torch_parity import plain_route  # noqa: F401
from yolodl_tpu.data import device_augment as j_da
from yolodl_tpu.data import pipeline as j_pipe
from yolodl_tpu.data.affine import RandomAffine as JRandomAffine
from yolodl_tpu.data.color import ColorJitter as JColorJitter
from yolodl_tpu.data.mosaic import MosaicMixer as JMosaicMixer
from yolodl_tpu.data.records import DataRecord as JDataRecord
from yolodl_torch.data import device_augment as t_da
from yolodl_torch.data import pipeline as t_pipe
from yolodl_torch.data.affine import RandomAffine
from yolodl_torch.data.color import ColorJitter
from yolodl_torch.data.mosaic import MosaicMixer
from yolodl_torch.data.records import DataRecord
from yolodl_torch.utils import timing as t_timing

torch.set_num_threads(2)


class SyntheticLoader:
    """Index → a seeded record of the given package (the reference test's
    loader: a random image, 1-3 boxes of 3 classes; no file IO)."""

    def __init__(self, record_type, h, w):
        self.record_type, self.h, self.w = record_type, h, w

    def load(self, i):
        rng = np.random.default_rng(1000 + int(i))
        img = rng.random((3, self.h, self.w)).astype(np.float32)
        n = int(rng.integers(1, 4))
        boxes = np.stack([rng.uniform(0.25, 0.75, n), rng.uniform(0.25, 0.75, n),
                          rng.uniform(0.1, 0.3, n), rng.uniform(0.1, 0.3, n)], -1)
        return self.record_type(img, boxes.astype(np.float32),
                                rng.integers(0, 3, n).astype(np.int32))


def recipe(package, name):
    """The reference test's stream recipes, built from ``package``'s
    augmentation classes (port or reference)."""
    color, affine, mosaic = package
    jitter = color(hue_shift=0.1, saturation_shift=0.2, value_shift=0.2)
    rotating = affine(rotate_prob=0.5, rotate_degrees=15.0, translation_prob=0.5,
                      translation=0.1, horizontal_flip_prob=0.5)
    return {
        "mix_only": dict(mosaic_prob=0.4, mixup_prob=0.3, cutmix_prob=0.3,
                         mosaic=mosaic(mosaic_margin=0.25)),
        "full": dict(mosaic_prob=0.5, mosaic=mosaic(mosaic_margin=0.25),
                     color_jitter=jitter, color_jitter_prob=0.7,
                     random_affine=rotating, affine_prob=0.8),
        "rotation": dict(color_jitter=jitter, color_jitter_prob=0.7,
                         random_affine=rotating, affine_prob=0.8),
        "u8": dict(mosaic_prob=0.5, mosaic=mosaic(mosaic_margin=0.25), color_jitter=jitter),
        "none": {},
        "separable": dict(mixup_prob=0.5, random_affine=affine(
            scale_prob=1.0, scale=(0.8, 1.2), translation_prob=1.0, translation=0.1,
            horizontal_flip_prob=0.5)),
    }[name]


PORT = (ColorJitter, RandomAffine, MosaicMixer)
REF = (JColorJitter, JRandomAffine, JMosaicMixer)


def stream(pipe, record_type, package, name, defer, h=32, w=48, **kw):
    kw.setdefault("pack_uint8", False)
    cfg = pipe.TrainingStreamConfig(batch_size=4, max_gt=16, seed=3, workers=1,
                                    defer_images=defer, **recipe(package, name), **kw)
    return pipe.TrainingStream(list(range(12)), SyntheticLoader(record_type, h, w), cfg), cfg


def take(iterator, n):
    return [next(iterator) for _ in range(n)]


@pytest.mark.parametrize("name", ["mix_only", "full", "u8", "separable"])
def test_deferred_stream_identical_to_reference(name, monkeypatch):
    """Four batches (past the 12-record epoch): packs, boxes, classes and
    mask identical to the reference's deferred stream; the slots' timing
    spans carry the reference's names."""
    monkeypatch.setattr(t_timing, "_ENABLED", True)
    kw = {"pack_uint8": True} if name == "u8" else {}
    port, _ = stream(t_pipe, DataRecord, PORT, name, True, **kw)
    ref, _ = stream(j_pipe, JDataRecord, REF, name, True, **kw)
    for a, b in zip(take(iter(port), 4), take(iter(ref), 4)):
        assert a.images is None and b.images is None
        assert a.deferred.keys() == b.deferred.keys()
        for k in b.deferred:
            assert a.deferred[k].dtype == b.deferred[k].dtype, k
            np.testing.assert_array_equal(a.deferred[k], b.deferred[k], err_msg=k)
        for f in ("boxes", "classes", "mask"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert ("affine_boxes" in a.timing.events) == (name in ("full", "separable"))
        assert "mix_boxes" in a.timing.events and "color_jitter" not in a.timing.events


@pytest.mark.parametrize("start", [4, 13])
def test_deferred_stream_resumes_at_start_records(start):
    """A deferred stream resumed at ``start_records`` gives the
    uninterrupted stream's later batches, and the reference's."""
    port, _ = stream(t_pipe, DataRecord, PORT, "full", True, start_records=start)
    ref, _ = stream(j_pipe, JDataRecord, REF, "full", True, start_records=start)
    resumed, ref_resumed = take(iter(port), 2), take(iter(ref), 2)
    whole, _ = stream(t_pipe, DataRecord, PORT, "full", True)
    later = take(iter(whole), start // 4 + 2)[start // 4:]
    for a, b, c in zip(resumed, later, ref_resumed):
        for k in a.deferred:
            np.testing.assert_array_equal(a.deferred[k], c.deferred[k], err_msg=k)
            if start % 4 == 0:
                np.testing.assert_array_equal(a.deferred[k], b.deferred[k], err_msg=k)
        np.testing.assert_array_equal(a.boxes, c.boxes)


def device_vs_host(name, batches=2, **kw):
    """The port's deferred stream through apply_device_augmentation (CPU)
    beside the port's host stream of the same recipe."""
    dev, cfg = stream(t_pipe, DataRecord, PORT, name, True, **kw)
    kw.pop("pack_uint8", None)
    host, _ = stream(t_pipe, DataRecord, PORT, name, False, **kw)
    dev_it = t_da.apply_device_augmentation(iter(dev), cfg, device="cpu")
    out = []
    try:
        for host_rec, (dev_rec, arrays) in zip(take(iter(host), batches), take(dev_it, batches)):
            assert dev_rec.deferred is None and dev_rec.images is arrays[0]
            assert arrays[0].dtype == torch.float32 and arrays[0].device.type == "cpu"
            for f, t in zip(("boxes", "classes", "mask"), arrays[1:]):
                np.testing.assert_array_equal(getattr(host_rec, f), t.numpy(), err_msg=f)
                np.testing.assert_array_equal(getattr(host_rec, f), getattr(dev_rec, f))
            out.append((host_rec, arrays[0].numpy()))
    finally:
        dev_it.close()
    return out


@pytest.mark.usefixtures("plain_route")
class TestStreamAgainstHostPipeline:
    def test_mix_only_exact(self):
        for host_rec, images in device_vs_host("mix_only"):
            np.testing.assert_allclose(images, host_rec.images, atol=2e-6)

    def test_full_pipeline_parity(self, monkeypatch):
        monkeypatch.setenv("YDL_AUG_GENERAL_WARP", "1")  # the bilinear bounds
        for host_rec, images in device_vs_host("full"):
            diff = np.abs(images - host_rec.images)
            assert np.mean(diff) < 2e-4
            assert np.mean(diff > 1e-2) < 0.005

    def test_rotation_twopass_pipeline(self):
        for host_rec, images in device_vs_host("rotation"):
            diff = np.abs(images - host_rec.images)
            assert np.mean(diff) < 0.02
            assert np.mean(diff > 0.25) < 0.02

    def test_u8_pack_quantization(self):
        for host_rec, images in device_vs_host("u8", batches=1, pack_uint8=True):
            diff = np.abs(images - host_rec.images)
            assert np.mean(diff) < 1.5 / 255
            assert np.mean(diff > 4 / 255) < 0.01

    def test_no_augments_passthrough(self):
        for host_rec, images in device_vs_host("none", batches=1):
            np.testing.assert_array_equal(images, host_rec.images)

    def test_separable_config_parity(self):
        for host_rec, images in device_vs_host("separable"):
            diff = np.abs(images - host_rec.images)
            assert np.mean(diff) < 2e-4
            assert np.mean(diff > 1e-2) < 0.005


@pytest.mark.parametrize("name", ["full", "separable"])
def test_device_augmented_stream_matches_reference(name):
    """Two batches of each package's deferred stream through its own
    ``apply_device_augmentation``, u8 packs as in production."""
    port, port_cfg = stream(t_pipe, DataRecord, PORT, name, True, pack_uint8=True)
    ref, ref_cfg = stream(j_pipe, JDataRecord, REF, name, True, pack_uint8=True)
    port_it = t_da.apply_device_augmentation(iter(port), port_cfg, device="cpu")
    ref_it = j_da.apply_device_augmentation(iter(ref), ref_cfg)
    try:
        for _ in range(2):
            (_, out), (_, expected) = next(port_it), next(ref_it)
            for a, b in zip(out[1:], expected[1:]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            diff = np.abs(out[0].numpy() - np.asarray(expected[0]))
            assert np.mean(diff) <= 1e-5, np.mean(diff)
            assert np.mean(diff > 1e-3) <= 0.002, np.mean(diff > 1e-3)
    finally:
        port_it.close()
        ref_it.close()


def test_device_rule():
    """No card: the default device raises, as every entry point does."""
    from yolodl_torch._device import NoCudaDeviceError

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    dev, cfg = stream(t_pipe, DataRecord, PORT, "none", True)
    with pytest.raises(NoCudaDeviceError):
        next(t_da.apply_device_augmentation(iter(dev), cfg))
