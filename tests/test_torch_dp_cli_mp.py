"""``python -m yolodl_torch.cli.train_main`` data-parallel over processes
a user starts (``--device cpu``, gloo): MultiProcess joined from
torchrun's variables (``env://``) and from the config's ``coordinator``
with ``--process-id``, two steps each, rank 0's checkpoint and the other
rank's ``-r1`` dir; without a process id the coordinator case is refused.
MultiDevice failures: a rank that fails ends the run with exit code 1, one
``error:`` line naming the rank, and the other rank stopped; a device
entry that is not a device fails before any rank starts.
"""

import glob
import subprocess
import sys

import pytest

from _torch_parity import REPO, start_ranks
from _torch_parity import write_train_workspace as write_workspace
from test_torch_dp_cli_proc import MULTI, checkpoints, children, env, train


@pytest.fixture
def multiprocess_configs(tmp_path):
    from yolodl_torch.parallel.mesh import free_port

    env_cfg = write_workspace(tmp_path / "env", batch_size=4,
                              device_config={"type": "MultiProcess"})
    tcp_cfg = write_workspace(tmp_path / "tcp", batch_size=4, device_config={
        "type": "MultiProcess", "coordinator": f"127.0.0.1:{free_port()}",
        "num_processes": 2})
    return env_cfg, tcp_cfg


def test_multiprocess_joins_from_env_and_from_a_coordinator(tmp_path, multiprocess_configs):
    env_cfg, tcp_cfg = multiprocess_configs
    args = ["-m", "yolodl_torch.cli.train_main", "--device", "cpu", "--max-steps", "2"]
    by_env = start_ranks([*args, "--config-file", env_cfg], 2)
    by_tcp = [subprocess.Popen([sys.executable, *args, "--config-file", tcp_cfg,
                                "--process-id", str(r)],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                               env=env(), cwd=REPO) for r in range(2)]
    outs = {}
    try:
        for name, procs in (("env", by_env), ("tcp", by_tcp)):
            for r, p in enumerate(procs):
                out, err = p.communicate(timeout=180)
                assert p.returncode == 0, (name, r, err)
                outs[name, r] = out or ""
    finally:
        for p in by_env + by_tcp:
            if p.poll() is None:
                p.kill()
    assert "multi-process: rank 1/2, 1 local / 2 global devices" in outs["tcp", 1]
    assert "dp: 2 ranks, backend gloo (ranks run on the CPU)" in outs["tcp", 0]
    for name in ("env", "tcp"):
        ckpts = checkpoints(tmp_path / name)
        assert len(ckpts) == 1 and "_000002_" in ckpts[0], ckpts
        dirs = glob.glob(str(tmp_path / name / "logs" / "*"))
        assert sorted(d.endswith("-r1") for d in dirs) == [False, True]


def test_multiprocess_needs_a_process_id_with_a_coordinator(tmp_path, multiprocess_configs):
    _, tcp_cfg = multiprocess_configs
    res = subprocess.run(
        [sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file", tcp_cfg,
         "--device", "cpu"], capture_output=True, text=True, env=env(), cwd=REPO, timeout=120)
    assert res.returncode == 1
    assert "needs --process-id (or YDL_PROCESS_ID)" in res.stderr


def test_a_failed_rank_ends_the_run_with_one_error_line(tmp_path):
    """One labelled image for two ranks: both join, rank 1 finds no
    records and fails while rank 0 waits in its first collective; the
    parent stops rank 0 and prints rank 1's error, once."""
    config = write_workspace(tmp_path, batch_size=4, device_config=MULTI)
    label = tmp_path / "label.csv"
    label.write_text("\n".join(label.read_text().splitlines()[:2]) + "\n")
    proc = train(config, "--max-steps", "2")
    out, err = proc.communicate(timeout=120)
    assert proc.returncode == 1
    errors = [ln for ln in err.splitlines() if ln.startswith("error:")]
    assert errors == ["error: rank 1: rank 1 of 2 gets no records: the dataset holds 1"], err
    assert not children(proc.pid)


def test_a_bad_device_entry_fails_before_any_rank_starts(tmp_path):
    config = write_workspace(tmp_path, batch_size=4, device_config={
        "type": "MultiDevice", "devices": ["cuda:0", "bogus"]})
    res = subprocess.run(
        [sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file", config,
         "--device", "cpu"], capture_output=True, text=True, env=env(), cwd=REPO, timeout=120)
    assert res.returncode == 1 and "dp: starting" not in res.stdout
    errors = [ln for ln in res.stderr.splitlines() if ln.startswith("error:")]
    assert errors == ["error: device entry 'bogus': expected cuda:N, cuda(N), N or cpu"]
