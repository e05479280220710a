"""The port's inference CLIs as a user starts them, in subprocesses:
errors end with exit code 1 and one ``error:`` line that says what to do
(or which ROADMAP item has not been ported; a missing or misused
``--artifact`` says so), and ``serve_main --device cpu
--port 0`` answers HTTP requests, then exits 0 on SIGINT."""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import urllib.request

import pytest
import torch

from _torch_parity import REPO, write_csv_dataset
from test_torch_cli import CFG, write_config
from yolodl_torch.bridge import params_to_jax
from yolodl_torch.config import darknet_cfg as dk
from yolodl_torch.models import zoo
from yolodl_torch.models.weights import save_darknet_weights

NEWSLAB = os.path.join(REPO, "cfg", "model", "yolov4-csp-custom-64x64-2021-08-21.json5")


def env():
    out = dict(os.environ)
    out["PYTHONPATH"] = REPO
    return out


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cli_proc"))
    with open(os.path.join(root, "tiny2.cfg"), "w") as f:
        f.write(CFG)
    model = zoo.load_darknet_model(os.path.join(root, "tiny2.cfg"), device="cpu", seed=1)
    save_darknet_weights(dk.Darknet.load(os.path.join(root, "tiny2.cfg")),
                         *params_to_jax(model.state_dict()), os.path.join(root, "tiny2.weights"))
    images = write_csv_dataset(root, 4, seed=5)
    config = write_config(root)
    with open(os.path.join(root, "bad.json5"), "w") as f:
        f.write('{version: "0.1.0",\n  model: {cfg_file: "tiny2.cfg",, },\n}\n')
    with open(config) as f:
        text = f.read()
    with open(os.path.join(root, "newslab.json5"), "w") as f:
        f.write(text.replace("kind: 'Darknet',", "kind: 'NewslabV1',")
                    .replace("cfg_file: 'tiny2.cfg'", f"cfg_file: '{NEWSLAB}'"))
    return root, config, os.path.join(root, "tiny2.weights"), images


# (CLI, arguments after the config file, what the error line must say)
ERRORS = {
    "bad_config": ("detect_main", "bad.json5", [], "bad.json5:2:33: unexpected ','"),
    "no_device": ("eval_main", "detect.json5", None, "no CUDA device is available"),
    "artifact": ("serve_main", "detect.json5", ["--artifact", "x"],
                 "x: no exported artifact directory"),
    "artifact_weights": ("serve_main", "detect.json5", ["--artifact", "x", "--weights", "w"],
                         "--artifact bakes the weights in"),
    "artifact_precision": ("detect_main", "detect.json5",
                           ["--artifact", "x", "--precision", "bfloat16"],
                           "--precision does not apply to --artifact runs"),
    # several devices are ported (ROADMAP A14a); the batch must split evenly
    "devices": ("detect_main", "detect.json5", ["--devices", "3"],
                "minibatch_size 4 not divisible by devices 3"),
}


@pytest.fixture(scope="module")
def error_runs(workspace):
    """Every ERRORS case, started together, awaited together."""
    root = workspace[0]
    procs = {}
    for name, (cli, config, extra, _) in ERRORS.items():
        args = ["--device", "cpu"] + extra if extra is not None else []
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", f"yolodl_torch.cli.{cli}",
             "--config-file", os.path.join(root, config), *args],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env(), cwd=REPO)
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=120)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


@pytest.mark.parametrize("name", ERRORS)
def test_error_exits_1_with_one_error_line(name, error_runs):
    if name == "no_device" and torch.cuda.is_available():
        pytest.skip("this machine has a card: --device defaults to it")
    rc, _, stderr = error_runs[name]
    assert rc == 1, stderr
    lines = [ln for ln in stderr.splitlines() if ln.startswith("error:")]
    assert len(lines) == 1, stderr
    assert ERRORS[name][3] in lines[0], stderr
    assert "Traceback" not in stderr


def test_newslab_config_evaluates(workspace):
    """cfg/train.json5's NEWSLAB model, whose node kinds once ended eval_main
    with an error line naming ROADMAP A2, now evaluates: exit 0 and the
    report line."""
    root = workspace[0]
    res = subprocess.run(
        [sys.executable, "-m", "yolodl_torch.cli.eval_main", "--config-file",
         os.path.join(root, "newslab.json5"), "--device", "cpu"],
        capture_output=True, text=True, env=env(), cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["images"] == 4 and report["ground_truths"] == 4


def test_serve_main_answers_and_stops_on_sigint(workspace):
    root, config, weights, images = workspace
    proc = subprocess.Popen(
        [sys.executable, "-m", "yolodl_torch.cli.serve_main", "--config-file", config,
         "--weights", weights, "--device", "cpu", "--port", "0", "--batch-size", "2",
         "--window-ms", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env(), cwd=REPO)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    try:
        while True:
            line = lines.get(timeout=120)
            if "serving on http://" in line:
                break
        base = line.split("serving on ")[1].split()[0]
        assert base.startswith("http://127.0.0.1:") and not base.endswith(":0")
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert json.load(r) == {"ok": True}
        path, h, w = images[1]
        with open(path, "rb") as f:
            req = urllib.request.Request(base + "/detect", data=f.read(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.load(r)
        assert isinstance(body["detections"], list) and body["detections"]
        for d in body["detections"]:
            x, y, bw, bh = d["bbox"]
            assert 0 <= x <= w and 0 <= y <= h and bw >= 0 and bh >= 0
            assert d["score"] >= 0.2 and 0 <= d["class"] < 80 and d["class_name"]
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.load(r)
        assert stats["errors"] == 0 and stats["images_done"] == 1
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0, proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
