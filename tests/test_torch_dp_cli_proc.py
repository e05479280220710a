"""``python -m yolodl_torch.cli.train_main`` data-parallel, as a user starts
it (``--device cpu``, gloo): a MultiDevice run of 2 ranks stopped by SIGINT
to the parent (every rank stops at one step, rank 0 writes the
checkpoint, exit 0, no rank left running) and resumed by ``FromRecent``
(each rank's stream resumes at step × local batch).  MultiProcess and a
failing rank: test_torch_dp_cli_mp.py.
"""

import glob
import json
import os
import re
import signal
import subprocess
import sys
import time

from _torch_parity import REPO
from _torch_parity import write_train_workspace as write_workspace

MULTI = {"type": "MultiDevice", "devices": ["cuda:0", "cuda:1"]}


def env():
    return {**os.environ, "PYTHONPATH": REPO}


def train(config, *args):
    return subprocess.Popen(
        [sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file", config,
         "--device", "cpu", *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env(), cwd=REPO)


def children(pid):
    """PIDs whose parent is ``pid``."""
    out = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                with open(f"/proc/{entry}/stat") as f:
                    fields = f.read().rsplit(")", 1)[1].split()
            except OSError:
                continue
            if int(fields[1]) == pid:
                out.append(int(entry))
    return out


def alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def checkpoints(root):
    return sorted(glob.glob(str(root / "logs" / "*" / "checkpoints" / "*.ckpt")))


def test_sigint_stops_every_rank_and_from_recent_resumes(tmp_path):
    config = write_workspace(tmp_path, batch_size=4, device_config=MULTI,
                             save_checkpoint_steps=1)
    proc = train(config, "--max-steps", "100000")
    try:
        deadline = time.time() + 180
        while not checkpoints(tmp_path):
            assert proc.poll() is None and time.time() < deadline, proc.communicate()
            time.sleep(0.2)
        ranks = children(proc.pid)
        assert len(ranks) == 2
        proc.send_signal(signal.SIGINT)
        out, err = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err
    assert not any(alive(pid) for pid in ranks)
    said = re.findall(r"signal(?: \d+)? — (checkpoint saved|stopping) at step (\d+)", out)
    steps = {int(n) for _, n in said}
    # both ranks, one step, rank 0 the one that saves
    assert sorted(w for w, _ in said) == ["checkpoint saved", "stopping"], out
    assert len(steps) == 1, out
    (step,) = steps
    assert not any(d.endswith("-r1") for d in
                   {os.path.dirname(os.path.dirname(c)) for c in checkpoints(tmp_path)})
    assert os.path.basename(checkpoints(tmp_path)[-1]).split("_")[1] == f"{step:06d}"

    raw = json.loads(open(config).read())
    raw["training"]["load_checkpoint"] = {"type": "FromRecent"}
    with open(config, "w") as f:
        json.dump(raw, f)
    resumed = train(config, "--max-steps", str(step + 1))
    out, err = resumed.communicate(timeout=180)
    assert resumed.returncode == 0, err
    assert out.count(f"restored checkpoint at step {step}") == 2
    assert out.count(f"data stream resumed at record {step * 2}") == 2  # local batch 2
