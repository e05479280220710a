"""The port's training-side I/O against the reference and the libraries it
stands in for: CRC-32C (``data/tfrecord_cache.py``, held to
``google_crc32c``, which the card's machine lacks), the TFRecord cache
(files readable by either package) and ``LoggingWorker``
(``train/logging.py``), whose event files are read back with
tensorboard's own reader and hold the reference's tags and values.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import google_crc32c
from yolodl_tpu.data import tfrecord_cache as j_tfr
from yolodl_tpu.data.records import FileRecord as JFileRecord
from yolodl_tpu.train import logging as j_log
from yolodl_torch.data import tfrecord_cache as t_tfr
from yolodl_torch.data.records import FileRecord as TFileRecord
from yolodl_torch.train import logging as t_log

torch.set_num_threads(2)


@pytest.mark.parametrize("n", [0, 1, 3, 4, 5, 8, 15, 16, 17, 255, 4096, 4099, 196_608,
                               786_435])
def test_crc32c_matches_google_crc32c(n):
    data = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert t_tfr.crc32c(data) == int.from_bytes(google_crc32c.Checksum(data).digest(), "big")
    assert t_tfr._masked_crc(data) == j_tfr._masked_crc(data)


def test_crc32c_known_values():
    # RFC 3720 B.4 test vectors
    assert t_tfr.crc32c(bytes(32)) == 0x8A9136AA
    assert t_tfr.crc32c(b"\xff" * 32) == 0x62A8AB43
    assert t_tfr.crc32c(bytes(range(32))) == 0x46DD794E
    assert t_tfr.crc32c(b"123456789") == 0xE3069283


def test_tfrecord_framing_reads_both_ways(tmp_path):
    payloads = [b"", b"x", os.urandom(1000), os.urandom(70_000)]
    for writer, reader in ((t_tfr, j_tfr), (j_tfr, t_tfr)):
        path = tmp_path / f"{writer.__name__}.tfrecord"
        with open(path, "wb") as f:
            offsets = [writer.write_tfrecord(f, p)[0] for p in payloads]
        with open(path, "rb") as f:
            assert [reader.read_tfrecord(f, o) for o in offsets] == payloads
    with open(path, "r+b") as f:  # a flipped payload byte fails the CRC
        f.seek(offsets[2] + 12 + 10)
        byte = f.read(1)
        f.seek(offsets[2] + 12 + 10)
        f.write(bytes([byte[0] ^ 1]))
    with open(path, "rb") as f, pytest.raises(ValueError, match="data CRC"):
        t_tfr.read_tfrecord(f, offsets[2])


def test_tfrecord_cache_is_shared_with_the_reference(tmp_path):
    """The port fills the cache; the reference reads the port's shard and
    index, and both give the same images and boxes."""
    rng = np.random.default_rng(3)
    records = []
    for i, (h, w) in enumerate([(40, 60), (50, 50), (30, 70)]):
        path = tmp_path / f"im{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(path)
        records.append((str(path), h, w, np.array([[h / 2, w / 2, h / 3, w / 4]]),
                        np.array([i % 2])))
    cache = str(tmp_path / "cache")
    port = t_tfr.TfrecordCache(cache, (32, 32))
    first = [port.load(TFileRecord(*r)) for r in records]   # decode + append
    again = [t_tfr.TfrecordCache(cache, (32, 32)).load(TFileRecord(*r)) for r in records]
    ref = [j_tfr.TfrecordCache(cache, (32, 32)).load(JFileRecord(*r)) for r in records]
    for a, b, c in zip(first, again, ref):
        np.testing.assert_allclose(b.image, a.image, atol=0.5 / 255 + 1e-7)  # u8 payload
        np.testing.assert_array_equal(c.image, b.image)
        np.testing.assert_array_equal(c.boxes, b.boxes)
        np.testing.assert_array_equal(c.classes, b.classes)


def read_events(log_dir):
    """{tag: [(step, value)]} for scalars and {tag: [(step, h, w)]} for
    images, read with tensorboard's own event reader."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(log_dir, size_guidance={"scalars": 0, "images": 0})
    acc.Reload()
    tags = acc.Tags()
    scalars = {t: [(e.step, e.value) for e in acc.Scalars(t)] for t in tags["scalars"]}
    images = {t: [(e.step, e.height, e.width) for e in acc.Images(t)] for t in tags["images"]}
    return scalars, images


def log_everything(module, log_dir):
    from yolodl_tpu.ops.detect import DetectionInfo

    worker = module.LoggingWorker(log_dir).start()
    worker.log_training_output(
        3, 0.01, {"total_loss": 1.5, "iou_loss": 0.5, "classification_loss": 0.25,
                  "objectness_loss": 0.75, "debug/cy_mean": 0.4},
        benchmark={"obj_accuracy": 0.9, "class_accuracy": 0.5})
    worker.log_scalars(4, {"val/mAP@0.5": 0.125})
    params = {"layer0": {"w": np.full((3, 3, 3, 4), -2.0, np.float32),
                         "bn": {"scale": np.ones(4, np.float32)}}}
    worker.log_weights_and_grads(5, params, params)
    image = np.random.default_rng(0).uniform(0, 1, (3, 16, 16)).astype(np.float32)
    worker.log_image(6, "pipeline/load", image)
    info = DetectionInfo(feature_h=4, feature_w=4, anchors=((0.1, 0.1), (0.2, 0.2)),
                         flat_begin=0, flat_end=32)
    worker.log_objectness_heatmap(7, image, np.linspace(0, 1, 32, dtype=np.float32), [info])
    worker.close()
    assert worker.dropped == 0
    return read_events(log_dir)


def test_logging_worker_events_match_the_reference(tmp_path):
    scalars, images = log_everything(t_log, str(tmp_path / "port"))
    ref_scalars, ref_images = log_everything(j_log, str(tmp_path / "ref"))
    assert scalars.keys() == ref_scalars.keys()
    for tag in scalars:
        np.testing.assert_allclose(scalars[tag], ref_scalars[tag], rtol=1e-7, err_msg=tag)
    assert images == ref_images
    assert scalars["loss/total_loss"] == [(3, 1.5)]
    assert scalars["weights_max/layer0/w"] == [(5, 2.0)]
    assert scalars["grads_max/layer0/bn/scale"] == [(5, 1.0)]
    assert images["objectness/heatmap"] == [(7, 16, 16)]


def test_logging_worker_drops_when_full_and_weights_take_tensors(tmp_path):
    worker = t_log.LoggingWorker(str(tmp_path), queue_size=2)  # not started: no drain
    for step in range(5):
        worker.log_scalars(step, {"a": 1.0})
    assert worker.dropped == 3
    worker.start()
    worker.log_weights_and_grads(1, {"n": {"w": torch.tensor([-3.0, 1.0])}})
    worker.close()
    scalars, _ = read_events(str(tmp_path))
    assert scalars["weights_max/n/w"] == [(1, 3.0)]
    assert [s for s, _ in scalars["a"]] == [0, 1]
