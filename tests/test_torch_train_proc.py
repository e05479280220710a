"""``yolodl_torch.cli.train_main`` as a user runs it, on the CPU: SIGINT
mid-run leaves a checkpoint with optimizer state and exits 0 with the
reference's message; a ``FromRecent`` run then restores it, resumes the
data stream at step × batch records, and trains first on the batch an
uninterrupted run trains on at that step (exactly equal); a config that
needs an unported part fails with one ``error:`` line naming its ROADMAP
item (``cli/_guard.py``); a run with ``loss.impl Darknet`` exits 0.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import torch

from _torch_parity import REPO as REPO_ROOT
from _torch_parity import run_main as run
from _torch_parity import write_darknet_train_workspace
from _torch_parity import write_train_workspace as write_workspace
from yolodl_torch import train as t_train_pkg
from yolodl_torch.cli import train_main as t_train

torch.set_num_threads(2)


def env():
    return {**os.environ, "PYTHONPATH": REPO_ROOT}


def first_batches(monkeypatch, config, *args):
    """Run the port's CLI in this process; returns the images of every
    batch its train step was given, in order."""
    seen = []
    real = t_train_pkg.make_train_step

    def recording(*a, **k):
        step = real(*a, **k)

        def wrapped(ts, images, *rest):
            seen.append(images.clone())
            return step(ts, images, *rest)
        return wrapped

    monkeypatch.setattr(t_train_pkg, "make_train_step", recording)
    run(t_train, config, *args, "--device", "cpu")
    monkeypatch.setattr(t_train_pkg, "make_train_step", real)
    return seen


def test_sigint_checkpoint_and_from_recent_resume(tmp_path, monkeypatch, capsys):
    config = write_workspace(tmp_path / "w", save_checkpoint_steps=1)
    proc = subprocess.Popen(
        [sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file", config,
         "--device", "cpu"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO_ROOT, env=env())
    try:
        deadline = time.monotonic() + 120
        while not glob.glob(str(tmp_path / "w" / "logs" / "*" / "checkpoints" / "*.ckpt")):
            assert proc.poll() is None, proc.communicate()
            assert time.monotonic() < deadline, "no checkpoint within 120 s"
            time.sleep(0.05)
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    line = [x for x in out.splitlines() if x.startswith("received signal")]
    assert line and line[0].endswith("exiting"), out
    step = int(line[0].split("at step ")[1].split(",")[0])
    newest = sorted(glob.glob(str(tmp_path / "w" / "logs" / "*" / "checkpoints" / "*.ckpt")))[-1]
    assert f"_{step:06d}_" in os.path.basename(newest)
    with np.load(newest) as f:
        meta = json.loads(bytes(f["__meta__"].tobytes()).decode())
        assert meta["has_opt"] and meta["step"] == step
        assert any(k.startswith("opt/0/0/.mu/") for k in f.files)

    raw = json.loads(open(config).read())
    raw["training"]["load_checkpoint"] = {"type": "FromRecent"}
    with open(config, "w") as f:
        json.dump(raw, f)
    resumed = first_batches(monkeypatch, config, "--max-steps", str(step + 1))
    out = capsys.readouterr().out
    assert f"restored checkpoint at step {step}" in out
    assert f"data stream resumed at record {step * 2}" in out
    assert len(resumed) == 1

    fresh = write_workspace(tmp_path / "fresh")
    uninterrupted = first_batches(monkeypatch, fresh, "--max-steps", str(step + 1))
    assert torch.equal(resumed[0], uninterrupted[step])


def test_unported_part_fails_with_one_error_line(tmp_path):
    """Every part of the training CLI is ported since A14c; what stays is
    that a failed rank fails the run with one error line.  Under
    pipeline_parallel 2 only stage 0 decodes images: with each file cut
    to its first half (the header, which every rank's dataset reads,
    stays whole) rank 0 fails while rank 1 waits for its first boundary
    tensors, and the run exits with rank 0's error, rank 1 stopped."""
    config = write_workspace(tmp_path)
    raw = json.loads(open(config).read())
    raw["training"]["device_config"] = {"type": "MultiDevice",
                                        "devices": ["cuda:0", "cuda:1"]}
    raw["training"]["pipeline_parallel"] = 2
    with open(config, "w") as f:
        json.dump(raw, f)
    for image in (tmp_path / "images").iterdir():
        image.write_bytes(image.read_bytes()[:image.stat().st_size // 2])
    res = subprocess.run(
        [sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file", config,
         "--device", "cpu"], capture_output=True, text=True, cwd=REPO_ROOT, env=env(),
        timeout=120)
    assert res.returncode == 1
    errors = [x for x in res.stderr.splitlines() if x.startswith("error:")]
    assert len(errors) == 1 and errors[0].startswith("error: rank 0 "), res.stderr


def test_darknet_loss_run_exits_zero(tmp_path):
    """``python -m yolodl_torch.cli.train_main`` with ``loss.impl Darknet``
    on a darknet cfg: exit 0, the loss impl line, a checkpoint, and the
    darknet telemetry among the logged scalars."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    config = write_darknet_train_workspace(tmp_path)
    res = subprocess.run(
        [sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file", config,
         "--device", "cpu", "--max-steps", "2"], capture_output=True, text=True,
        cwd=REPO_ROOT, env=env(), timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "loss impl: darknet-exact (1 heads;" in res.stdout
    (run_dir,) = glob.glob(str(tmp_path / "logs" / "*"))
    assert glob.glob(os.path.join(run_dir, "checkpoints", "*.ckpt"))
    acc = EventAccumulator(run_dir, size_guidance={"scalars": 0})
    acc.Reload()
    assert {"benchmark/num_matched", "benchmark/avg_iou", "benchmark/avg_obj",
            "benchmark/avg_cat", "benchmark/recall50", "benchmark/recall75",
            "benchmark/no_obj"} <= set(acc.Tags()["scalars"])
