"""Serving from an exported artifact in yolodl_torch on the CPU:
``DetectionService.from_artifact`` answers as the live service does on the
same frames (identical detections), and ``serve_main --artifact --port 0``
as a user starts it answers the same over HTTP, reports the artifact's
batch, and exits 0 on SIGINT."""

import contextlib
import io
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest
import torch

from _torch_parity import REPO, write_csv_dataset
from test_torch_cli import CFG, write_config
from yolodl_torch.cli import tool_main
from yolodl_torch.models import zoo
from yolodl_torch.serve import DetectionService

torch.set_num_threads(2)

NMS = dict(nms_iou_thresh=0.45, nms_conf_thresh=0.2, nms_kind="diou", nms_beta=0.6)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """(root, config, serving artifact, live model, images)."""
    root = str(tmp_path_factory.mktemp("serve_artifact"))
    cfg = os.path.join(root, "tiny2.cfg")
    with open(cfg, "w") as f:
        f.write(CFG)
    images = write_csv_dataset(root, 4, seed=7)
    art = os.path.join(root, "serving")
    with contextlib.redirect_stdout(io.StringIO()):
        tool_main.main(["export", cfg, art, "--size", "64", "--batch", "2", "--serving",
                        "--device", "cpu"])
    # tool_main's model without --weights: the seeded init (seed 0)
    model = zoo.load_darknet_model(cfg, device="cpu")
    return root, write_config(root), art, model, images


def test_from_artifact_answers_as_the_live_service(workspace):
    _, _, art, model, images = workspace
    svc = DetectionService.from_artifact(art, window_ms=20.0, device="cpu", **NMS)
    assert svc.batch_size == 2 and svc.image_size == 64 and svc.model is None
    live = DetectionService(model, image_size=64, batch_size=2, window_ms=20.0,
                            device="cpu", **NMS)
    answers = {}
    for name, s in (("artifact", svc), ("live", live)):
        s.warmup()
        s.start()
        try:
            answers[name] = []
            for path, _, _ in images:
                with open(path, "rb") as f:
                    answers[name].append(s.submit_bytes(f.read()))
        finally:
            s.shutdown()
    assert answers["artifact"] == answers["live"]
    assert sum(len(a) for a in answers["live"]) > 0


def test_serve_main_serves_artifact_and_stops_on_sigint(workspace):
    root, config, art, _, images = workspace
    svc = DetectionService.from_artifact(art, window_ms=2.0, device="cpu", **NMS)
    svc.start()
    try:
        expected = []
        for path, _, _ in images[:2]:
            with open(path, "rb") as f:
                expected.append(svc.submit_bytes(f.read()))
    finally:
        svc.shutdown()
    proc = subprocess.Popen(
        [sys.executable, "-m", "yolodl_torch.cli.serve_main", "--config-file", config,
         "--artifact", art, "--device", "cpu", "--port", "0", "--window-ms", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        printed = []
        while not printed or "serving on http://" not in printed[-1]:
            printed.append(lines.get(timeout=120))
        assert printed[0].strip() == "artifact batch 2 overrides --batch-size 8"
        base = printed[-1].split("serving on ")[1].split()[0]
        for (path, _, _), want in zip(images[:2], expected):
            with open(path, "rb") as f:
                req = urllib.request.Request(base + "/detect", data=f.read(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                body = json.load(r)
            got = [{k: v for k, v in d.items() if k != "class_name"} for d in body["detections"]]
            assert got == want
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            assert json.load(r)["errors"] == 0
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert np.isfinite([d["score"] for a in expected for d in a]).all()
