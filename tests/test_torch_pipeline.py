"""The port's training data path against the JAX reference:
``data/pipeline.py`` (TrainingStream, pad_targets, lookahead_map,
device_prefetch), ``data/mosaic.py`` (mosaic, MixUp, CutMix) and
``utils/timing.py``.

Every mixer and the stream draw from numpy generators keyed as the
reference keys them, so the comparisons are exact: the same records and
the same seeds give bit-identical batches (images, boxes, classes, mask),
with mosaic, MixUp, CutMix, colour jitter and the random affine all on,
also when a stream resumes at ``start_records``.
"""

import threading
import time

import numpy as np
import pytest
import torch

from yolodl_tpu.data import affine as j_affine
from yolodl_tpu.data import color as j_color
from yolodl_tpu.data import mosaic as j_mosaic
from yolodl_tpu.data import pipeline as j_pipe
from yolodl_tpu.data import records as j_records
from yolodl_tpu.utils import timing as j_timing
from yolodl_torch.data import affine as t_affine
from yolodl_torch.data import color as t_color
from yolodl_torch.data import mosaic as t_mosaic
from yolodl_torch.data import pipeline as t_pipe
from yolodl_torch.data import records as t_records
from yolodl_torch.utils import timing as t_timing

torch.set_num_threads(2)

N_RECORDS, SIZE = 11, 24


class SyntheticLoader:
    """FileRecord → DataRecord of the given package: a seeded image and
    1-4 boxes per record index, fresh arrays on every load (the stream
    scales boxes in place)."""

    def __init__(self, records_module):
        self.record = records_module.DataRecord
        rng = np.random.default_rng(0)
        self.items = []
        for _ in range(N_RECORDS):
            n = int(rng.integers(1, 5))
            boxes = np.concatenate([rng.uniform(0.25, 0.75, (n, 2)),
                                    rng.uniform(0.1, 0.4, (n, 2))], 1).astype(np.float32)
            self.items.append((rng.uniform(0, 1, (3, SIZE, SIZE)).astype(np.float32),
                               boxes, rng.integers(0, 3, n).astype(np.int32)))

    def load(self, record):
        image, boxes, classes = self.items[int(record.path)]
        return self.record(image.copy(), boxes.copy(), classes.copy())


def file_records(records_module):
    return [records_module.FileRecord(str(i), SIZE, SIZE, np.zeros((0, 4)), np.zeros(0))
            for i in range(N_RECORDS)]


def stream_config(package, **kw):
    color, affine, mosaic, pipe = package
    defaults = dict(
        batch_size=3, max_gt=8, mosaic_prob=0.4, mixup_prob=0.2, cutmix_prob=0.2,
        mosaic=mosaic.MosaicMixer(mosaic_margin=0.3),
        color_jitter=color.ColorJitter(hue_shift=0.05, saturation_shift=0.2,
                                       value_shift=0.2),
        color_jitter_prob=0.7,
        random_affine=affine.RandomAffine(
            rotate_prob=0.5, rotate_degrees=10, translation_prob=0.5, translation=0.1,
            scale_prob=0.5, scale=(0.8, 1.2), horizontal_flip_prob=0.5,
            min_bbox_size=0.02, min_bbox_cropping_ratio=0.3),
        affine_prob=0.8, bbox_scaling=1.1, seed=5, workers=3)
    return pipe.TrainingStreamConfig(**{**defaults, **kw})


J = (j_color, j_affine, j_mosaic, j_pipe)
T = (t_color, t_affine, t_mosaic, t_pipe)


def batches(package, records_module, n, **kw):
    pipe = package[3]
    stream = pipe.TrainingStream(file_records(records_module), SyntheticLoader(records_module),
                                 stream_config(package, **kw))
    out = []
    for rec in stream:
        out.append(rec)
        if len(out) == n:
            break
    return out


def assert_batches_identical(t_batches, j_batches):
    assert len(t_batches) == len(j_batches)
    for t, j in zip(t_batches, j_batches):
        assert (t.epoch, t.step) == (j.epoch, j.step)
        for f in ("images", "boxes", "classes", "mask"):
            a, b = getattr(t, f), getattr(j, f)
            assert a.dtype == b.dtype and a.shape == b.shape, f
            np.testing.assert_array_equal(a, b, err_msg=f)


def test_stream_batches_bit_identical_to_reference():
    """Nine batches (past two epochs of 11 records) with every mix kind."""
    t_b = batches(T, t_records, 9)
    assert_batches_identical(t_b, batches(J, j_records, 9))
    assert any(b.mask.sum() > 3 for b in t_b)  # some mosaic/mixup merged boxes


@pytest.mark.parametrize("start", [0, 5, 14, 33])
def test_stream_resume_replays_the_reference_order(start):
    """A stream that resumes at ``start_records`` (a FromRecent restore sets
    step × batch) gives the reference's batches, and those of an
    uninterrupted stream from that record on."""
    t_b = batches(T, t_records, 3, start_records=start)
    assert_batches_identical(t_b, batches(J, j_records, 3, start_records=start))
    if start % 3 == 0:
        full = batches(T, t_records, start // 3 + 3)
        for a, b in zip(t_b, full[start // 3:]):
            for f in ("images", "boxes", "classes", "mask"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_unordered_stream_yields_every_record():
    """Unordered, records come as workers finish them, but within the
    producers' window (18 records here) every one of the first epoch is
    yielded within 33 records, and nothing else is."""
    b = batches(T, t_records, 11, ordered=False, mosaic_prob=0.0, mixup_prob=0.0,
                cutmix_prob=0.0, random_affine=None, color_jitter=None, bbox_scaling=1.0)
    images = np.concatenate([x.images for x in b])
    loader = SyntheticLoader(t_records)
    assert {img.tobytes() for img in images} == {it[0].tobytes() for it in loader.items}


@pytest.mark.parametrize("kind", ["mosaic", "mixup", "cutmix"])
def test_mixers_match_reference(kind):
    loader_t, loader_j = SyntheticLoader(t_records), SyntheticLoader(j_records)
    recs = file_records(t_records)
    need = 4 if kind == "mosaic" else 2
    t_in = [loader_t.load(r) for r in recs[:need]]
    j_in = [loader_j.load(r) for r in recs[:need]]
    if kind == "mosaic":
        t_out = t_mosaic.MosaicMixer(0.2, 0.01, 0.3)(t_in, np.random.default_rng(1))
        j_out = j_mosaic.MosaicMixer(0.2, 0.01, 0.3)(j_in, np.random.default_rng(1))
    else:
        name = {"mixup": "MixUpMixer", "cutmix": "CutMixMixer"}[kind]
        t_out = getattr(t_mosaic, name)()(*t_in, np.random.default_rng(1))
        j_out = getattr(j_mosaic, name)()(*j_in, np.random.default_rng(1))
    for f in ("image", "boxes", "classes"):
        np.testing.assert_array_equal(getattr(t_out, f), getattr(j_out, f))
    with pytest.raises(ValueError):
        t_mosaic.MosaicMixer(mosaic_margin=0.6)


def test_pad_targets_matches_reference():
    loader = SyntheticLoader(t_records)
    recs = [loader.load(r) for r in file_records(t_records)[:4]]
    out = t_pipe.pad_targets(recs, 3)
    ref = j_pipe.pad_targets(recs, 3)
    for a, b in zip(out, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_stream_rejections():
    with pytest.raises(ValueError, match="sum to <= 1"):
        stream_config(T, mosaic_prob=0.9)
    with pytest.raises(ValueError, match="empty dataset"):
        t_pipe.TrainingStream([], SyntheticLoader(t_records), stream_config(T))


def test_worker_error_reaches_the_consumer():
    class Broken(SyntheticLoader):
        def load(self, record):
            raise OSError("unreadable")

    stream = t_pipe.TrainingStream(file_records(t_records), Broken(t_records),
                                   stream_config(T))
    with pytest.raises(OSError, match="unreadable"):
        next(iter(stream))


def test_lookahead_map_and_device_prefetch_on_cpu():
    assert list(t_pipe.lookahead_map(iter(range(7)), lambda x: x * x, depth=2)) == \
        [x * x for x in range(7)]

    def failing():
        yield 1
        raise RuntimeError("source failed")

    with pytest.raises(RuntimeError, match="source failed"):
        list(t_pipe.lookahead_map(failing(), lambda x: x))
    recs = batches(T, t_records, 2)
    out = list(t_pipe.device_prefetch(iter(recs), "cpu"))
    assert [r for r, _ in out] == recs
    for rec, arrays in out:
        assert all(isinstance(a, torch.Tensor) and a.device.type == "cpu" for a in arrays)
        for a, f in zip(arrays, ("images", "boxes", "classes", "mask")):
            np.testing.assert_array_equal(a.numpy(), getattr(rec, f))


def test_lookahead_stops_its_worker_when_the_consumer_leaves():
    produced = []

    def source():
        for i in range(1000):
            produced.append(i)
            yield i

    gen = t_pipe.lookahead_map(source(), lambda x: x, depth=2)
    assert next(gen) == 0
    gen.close()
    time.sleep(1.2)  # the worker's put times out every 0.5 s and sees stop
    n = len(produced)
    time.sleep(0.6)
    assert len(produced) == n < 10


def test_timing_and_rate_counter_match_reference(monkeypatch):
    for mod in (t_timing, j_timing):
        monkeypatch.setattr(mod, "_ENABLED", True)
        monkeypatch.setattr(mod, "_WHITELIST", set())
    t, j = t_timing.Timing("x"), j_timing.Timing("x")
    for tm in (t, j):
        tm.events = {"load": 0.5, "mosaic": 0.25}
        other = type(tm)("y")
        other.events = {"load": 0.75, "affine": 0.1}
        tm.merge(other)
    assert t.events == j.events == {"load": 0.75, "mosaic": 0.25, "affine": 0.1}
    assert t.report() == j.report()
    with t.timed("sleep"):
        time.sleep(0.01)
    assert t.events["sleep"] >= 0.01
    monkeypatch.setattr(t_timing, "_WHITELIST", {"batch"})
    assert t_timing.profiling_enabled("batch") and not t_timing.profiling_enabled("x")
    rate = t_timing.RateCounter(window_secs=10.0)
    assert rate.rate() == 0.0
    for _ in range(3):
        rate.add(4)
        time.sleep(0.02)
    assert 4 / 0.05 < rate.rate() < 8 / 0.04


def test_stream_is_safe_under_thread_switching():
    """Six workers over 11 records with a short switch interval: every
    ordered batch still equals the reference's."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t_b = batches(T, t_records, 6, workers=6)
    finally:
        sys.setswitchinterval(old)
    assert_batches_identical(t_b, batches(J, j_records, 6))
    assert threading.active_count() < 40
