"""Multi-device inference (ROADMAP A14a) on the CPU: ``DetectionService``,
``DatasetEvaluator`` and the detect, eval and serve CLIs with 2 and 4
model replicas (``device="cpu"`` / ``--device cpu``) against the same with
one, and the service against the reference's ``devices=8`` service over
the 8 virtual CPU devices of tests/conftest.py.

Each replica takes an equal part of a batch, so the rows are the same rows
a one-replica batch holds and, on the CPU, each image's forward the same
arithmetic: detections must be identical (the services' rounded dicts,
the evaluator's reports, the CLIs' JSON).  Against the reference (f32
forwards on both sides, as in test_torch_serve.py): the same detections in
the same order, classes equal, scores within 1e-4 and boxes within
0.01 px.  NMS runs once per replica per batch: the CPU wrappers of B1
(``yolodl_torch.loss.nms``) are counted here; on a card each call is one
launch of each kernel (chip_smoke.py phase ``dp``).
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import REPO, reference_and_port, write_csv_dataset
from test_torch_cli import CFG, write_config
from yolodl_tpu.serve import DetectionService as JDetectionService
from yolodl_torch.bridge import params_to_jax
from yolodl_torch.cli import detect_main, eval_main
from yolodl_torch.config import darknet_cfg as dk
from yolodl_torch.data.cache import make_decode_loader
from yolodl_torch.data.datasets import CsvDataset, SanitizedDataset
from yolodl_torch.loss import nms as t_nms
from yolodl_torch.models import zoo
from yolodl_torch.models.weights import save_darknet_weights
from yolodl_torch.serve import DetectionService
from yolodl_torch.train.evaluation import DatasetEvaluator

torch.set_num_threads(2)

KW = dict(image_size=64, batch_size=8, window_ms=300.0, nms_iou_thresh=0.45,
          nms_conf_thresh=0.3, nms_kind="diou", nms_beta=0.6)


class F32Service(DetectionService):
    """The f32 forward of each replica (test_torch_serve.py's comparison)."""

    def forward(self, images_u8, replica=0):
        return self._replicas.models[replica](images_u8.to(torch.float32) / 255.0,
                                              data_format="NHWC")


def frames(n=8, seed=11):
    rng = np.random.default_rng(seed)
    sizes = [(64, 64), (48, 80), (100, 40), (30, 30)]
    return [rng.integers(0, 256, sizes[i % 4] + (3,), dtype=np.uint8) for i in range(n)]


def serve_all(svc, images):
    """Every frame from its own thread at once, so that one batch fills."""
    out = [None] * len(images)

    def one(i):
        out[i] = svc.submit_u8(images[i])

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


@pytest.fixture
def counted(monkeypatch):
    """Calls of the conflict and resolution steps of NMS."""
    calls = {"conflict": 0, "keep": 0}
    real_bits, real_keep = t_nms.nms_conflict_bits, t_nms.nms_keep_from_bits

    def bits(*a, **k):
        calls["conflict"] += 1
        return real_bits(*a, **k)

    def keep(*a, **k):
        calls["keep"] += 1
        return real_keep(*a, **k)

    monkeypatch.setattr(t_nms, "nms_conflict_bits", bits)
    monkeypatch.setattr(t_nms, "nms_keep_from_bits", keep)
    return calls


@pytest.fixture(scope="module")
def models():
    return reference_and_port("yolov4-tiny", seed=2)


def test_service_replicas_match_one_replica_and_reference(models, counted):
    jm, params, state, tm = models
    images = frames()
    results = {}
    for n in (1, 2, 4):
        svc = F32Service(tm, device="cpu", devices=n, **KW)
        assert svc.devices == [torch.device("cpu")] * n
        svc.start()
        counted.update(conflict=0, keep=0)
        try:
            results[n] = serve_all(svc, images)
            stats = svc.stats.snapshot(svc.batch_size)
        finally:
            svc.shutdown()
        assert stats["errors"] == 0 and stats["images_done"] == len(images)
        # one NMS a replica a batch
        assert counted == {"conflict": n * stats["batches"], "keep": n * stats["batches"]}
    assert results[2] == results[1] and results[4] == results[1]
    assert sum(len(r) for r in results[1]) > 8

    @jax.jit
    def forward_f32(p, s, images_u8):
        x = images_u8.astype(jnp.float32) / 255.0
        return jm.apply(p, s, x, train=False, data_format="NHWC")[0]

    ref = JDetectionService(jm, jax.tree_util.tree_map(jnp.asarray, params),
                            jax.tree_util.tree_map(jnp.asarray, state), devices=8, **KW)
    ref._forward = forward_f32  # the f32 forward, over its mesh
    ref.start()
    try:
        expected = serve_all(ref, images)
    finally:
        ref.shutdown()
    for got, want in zip(results[2], expected):
        assert [d["class"] for d in got] == [d["class"] for d in want]
        for a, b in zip(got, want):
            assert abs(a["score"] - b["score"]) <= 1e-4
            np.testing.assert_allclose(a["bbox"], b["bbox"], atol=0.01)


def test_service_rejections(models, tmp_path):
    from yolodl_torch.models.export import export_inference

    tm = models[3]
    with pytest.raises(ValueError, match="batch_size 8 not divisible by devices 3"):
        DetectionService(tm, device="cpu", devices=3, **KW)
    serving = export_inference(tm, str(tmp_path / "art"), batch_size=4, image_size=64,
                               serving=True)
    art = DetectionService.from_artifact(serving, device="cpu")
    with pytest.raises(ValueError, match="artifact serving is single-device"):
        DetectionService(None, device="cpu", devices=2, image_size=64, batch_size=4,
                         forward_fn=art._forward_fn)
    # an explicit list names each replica's device
    svc = DetectionService(tm, devices=["cpu", "cpu"], **KW)
    assert svc.devices == [torch.device("cpu")] * 2 and svc.device == torch.device("cpu")


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_torch_cli.py's darknet cfg and .weights, 6 CSV images."""
    root = str(tmp_path_factory.mktemp("multi_device"))
    cfg = os.path.join(root, "tiny2.cfg")
    with open(cfg, "w") as f:
        f.write(CFG)
    model = zoo.load_darknet_model(cfg, device="cpu", seed=1)
    weights = os.path.join(root, "tiny2.weights")
    save_darknet_weights(dk.Darknet.load(cfg), *params_to_jax(model.state_dict()), weights)
    write_csv_dataset(root, 6, seed=5)
    return root, write_config(root), weights, model


def test_evaluator_replicas_match_one_replica(workspace, counted):
    root, _, _, model = workspace
    ds = SanitizedDataset(CsvDataset(os.path.join(root, "images"),
                                     os.path.join(root, "label.csv"),
                                     os.path.join(root, "classes.txt")))
    reports = {}
    for n in (1, 2, 4):
        counted.update(conflict=0, keep=0)
        ev = DatasetEvaluator(model, ds.records(), make_decode_loader((64, 64)),
                              num_classes=80, batch_size=4, confidence_threshold=0.05,
                              nms_kind="diou", devices=n)
        reports[n] = ev()
        assert counted["conflict"] == counted["keep"] == 2 * n  # 2 batches of 4
    assert reports[1]["detections"] > 0
    assert reports[2] == reports[1] and reports[4] == reports[1]


def test_detect_and_eval_main_devices_match_one_device(workspace, counted, capsys):
    root, config, weights, _ = workspace
    out = {}
    for n in ("1", "2", "cpu,cpu"):
        path = os.path.join(root, f"dets{n.replace(',', '_')}.json")
        counted.update(conflict=0, keep=0)
        detect_main.main(["--config-file", config, "--weights", weights, "--device", "cpu",
                          "--devices", n, "--save-json", path])
        replicas = 1 if n == "1" else 2
        assert counted == {"conflict": 2 * replicas, "keep": 2 * replicas}  # 2 batches of 4
        with open(path) as f:
            out[n] = json.load(f)
        capsys.readouterr()
        report = eval_main.main(["--config-file", config, "--weights", weights,
                                 "--device", "cpu", "--devices", n, "--conf-thresh", "0.05"])
        out[n + "/eval"] = report
    assert out["1"] and out["2"] == out["1"] and out["cpu,cpu"] == out["1"]
    assert out["2/eval"] == out["1/eval"] == out["cpu,cpu/eval"]
    with pytest.raises(ValueError, match="minibatch_size 4 not divisible by devices 3"):
        detect_main.main(["--config-file", config, "--weights", weights, "--device", "cpu",
                          "--devices", "3"])


def test_serve_main_devices_2_matches_devices_1(workspace):
    """Two serve_main processes, --devices 1 and 2, answer the same POSTs
    alike, then exit 0 on SIGINT; --artifact with --devices 2 is refused."""
    root, config, weights, _ = workspace
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = {n: subprocess.Popen(
        [sys.executable, "-m", "yolodl_torch.cli.serve_main", "--config-file", config,
         "--weights", weights, "--device", "cpu", "--devices", n, "--port", "0",
         "--batch-size", "4", "--window-ms", "200"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
        for n in ("1", "2")}
    refused = subprocess.run(
        [sys.executable, "-m", "yolodl_torch.cli.serve_main", "--config-file", config,
         "--device", "cpu", "--devices", "2", "--artifact", root],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    try:
        answers = {}
        for n, p in procs.items():
            for line in p.stdout:
                if "serving on http://" in line:
                    url = line.split("serving on ")[1].split()[0]
                    break
            else:
                raise AssertionError(p.stderr.read())
            answers[n] = []
            for i in range(4):
                with open(os.path.join(root, "images", f"im{i:02d}.png"), "rb") as f:
                    req = urllib.request.Request(url + "/detect", data=f.read(), method="POST")
                with urllib.request.urlopen(req, timeout=60) as r:
                    answers[n].append(json.loads(r.read())["detections"])
        for p in procs.values():
            p.send_signal(signal.SIGINT)
        assert all(p.wait(timeout=60) == 0 for p in procs.values())
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    assert answers["2"] == answers["1"] and any(answers["1"])
    assert refused.returncode != 0 and "--devices > 1 needs live-model serving" in refused.stderr
