"""``yolodl_torch.cli.train_main`` with ``device_config`` MultiDevice of 2
and ``--device cpu``: two ranks over gloo, started by the CLI itself.

A checkpoint of one step with optimizer state (the port's library,
tests/_torch_parity.py ``write_first_checkpoint``; both packages read it,
test_torch_train_cli.py) starts both sides: the port's MultiDevice run
(``FromFile``) takes three steps of a global batch
of 4, each rank streaming ``records[rank::2]`` with ``seed=rank`` and 2
rows.  Meanwhile this process runs the reference's DP step
(``yolodl_tpu.parallel.make_dp_train_step`` on a 2-device mesh) from the
same checkpoint on the global batches the reference's ``TrainingStream``
gives over those records with those seeds.

Checked: the three logged losses within rel 1e-4 (test_torch_train_cli.py's
limit), so the ranks' batches are those; the streams themselves bit for
bit; checkpoints from rank 0 only, in its run dir, and the other rank's
dir suffixed ``-r1`` with its own TensorBoard events and no checkpoint;
the backend line.  SIGINT, resume, MultiProcess and a failing rank:
test_torch_dp_cli_proc.py.
"""

import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (REPO, first_batches, logged, rank_streams, reference_native,  # noqa: F401
                           reference_native_route, write_first_checkpoint)
from _torch_parity import write_train_workspace as write_workspace
from yolodl_tpu.cli import train_main as j_train

torch.set_num_threads(2)

MULTI = {"type": "MultiDevice", "devices": ["cuda:0", "cuda:1"]}


def reference_dp_losses(config_path, ckpt, global_batches):
    """The reference's DP step, as its train_main builds it, from ``ckpt``
    over ``global_batches`` → the total losses."""
    from yolodl_tpu.config.app_config import TrainAppConfig, compute_dtype_of
    from yolodl_tpu.graph import Graph
    from yolodl_tpu.models import YoloModel
    from yolodl_tpu.parallel import make_dp_train_step, make_mesh, shard_batch
    from yolodl_tpu.parallel.dp import replicate_state
    from yolodl_tpu.train import TrainConfig, load_checkpoint, train_init

    config = TrainAppConfig.load(config_path)
    graph = Graph.load_newslab_v1_json(
        os.path.join(os.path.dirname(config_path), config.model_file))
    config = j_train._resolve_auto_loss_options(config, graph)
    model = YoloModel(graph)
    train_cfg = TrainConfig(
        lr=config.lr, optimizer=config.optimizer, momentum=config.momentum,
        weight_decay=config.weight_decay, loss=config.loss,
        use_ema=config.use_ema, ema_decay=config.ema_decay,
        compute_dtype=compute_dtype_of(config.precision))
    ts, opt = train_init(model, train_cfg, seed=0)
    params, state, opt_state, meta = load_checkpoint(ckpt, ts.params, ts.state, ts.opt_state)
    ts = ts.__class__(params, state, opt_state, jnp.asarray(meta["step"], jnp.int32), None)
    mesh = make_mesh(2)
    ts = replicate_state(mesh, ts)
    step = make_dp_train_step(model, opt, train_cfg, mesh)
    losses = []
    for batch in global_batches:
        ts, m = step(ts, *shard_batch(mesh, tuple(map(jnp.asarray, batch))))
        losses.append(float(m["total_loss"]))
    return losses


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_cli")
    env = {**os.environ, "PYTHONPATH": REPO, "YDL_NO_NATIVE_DECODE": "1"}
    os.environ["YDL_NO_NATIVE_DECODE"] = "1"  # both decode with PIL
    try:
        ckpt = write_first_checkpoint(write_workspace(tmp / "first", batch_size=4),
                                      str(tmp / "first" / "checkpoints"))
        config = write_workspace(tmp / "port", batch_size=4, device_config=MULTI,
                                 save_checkpoint_steps=1,
                                 load_checkpoint={"type": "FromFile", "file": ckpt})
        proc = subprocess.Popen(
            [sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file", config,
             "--max-steps", "4", "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)
        with reference_native_route():  # the port's ranks jitter natively too
            per_rank = first_batches(rank_streams("ref", config), 3)
        global_batches = [tuple(np.concatenate([getattr(per_rank[r][i], f) for r in range(2)])
                                for f in ("images", "boxes", "classes", "mask"))
                          for i in range(3)]
        ref_losses = reference_dp_losses(config, ckpt, global_batches)
        out, err = proc.communicate(timeout=300)
    finally:
        del os.environ["YDL_NO_NATIVE_DECODE"]
    assert proc.returncode == 0, err
    return tmp, config, ref_losses, out, err


def test_multidevice_train_main_matches_the_reference_dp_step(dp_run):
    tmp, _, ref_losses, out, _ = dp_run
    assert "dp: starting 2 ranks" in out
    assert "dp: 2 ranks, backend gloo (ranks run on the CPU)" in out
    assert out.count("restored checkpoint at step 1") == 2  # each rank
    (chief,) = [d for d in glob.glob(str(tmp / "port" / "logs" / "*")) if not d.endswith("-r1")]
    port = logged(chief)
    assert [s for s, _ in port] == [2, 3, 4]
    np.testing.assert_allclose([v for _, v in port], ref_losses, rtol=1e-4)


def test_checkpoints_come_from_rank_0_only(dp_run):
    tmp = dp_run[0]
    dirs = sorted(glob.glob(str(tmp / "port" / "logs" / "*")))
    assert len(dirs) == 2
    chief, other = (d for d in dirs if not d.endswith("-r1")), (d for d in dirs
                                                                if d.endswith("-r1"))
    chief, other = next(chief), next(other)
    assert len(glob.glob(os.path.join(chief, "checkpoints", "*.ckpt"))) == 3  # steps 2-4
    assert not os.path.exists(os.path.join(other, "checkpoints"))
    assert os.path.exists(os.path.join(other, "train.json5"))
    assert [s for s, _ in logged(other)] == [2, 3, 4]
    # the losses are reduced over the ranks, so both logs agree
    assert logged(other) == logged(chief)


def test_rank_streams_match_the_reference_streams(dp_run, monkeypatch, reference_native):
    """records[r::2] with seed r, the port's stream against the
    reference's, bit for bit, for both ranks, both jittering natively."""
    monkeypatch.setenv("YDL_NO_NATIVE_DECODE", "1")
    config = dp_run[1]
    ref = first_batches(rank_streams("ref", config), 3)
    port = first_batches(rank_streams("port", config), 3)
    for r in range(2):
        for a, b in zip(port[r], ref[r]):
            for f in ("images", "boxes", "classes", "mask"):
                np.testing.assert_array_equal(np.asarray(getattr(a, f)), getattr(b, f),
                                              err_msg=f"rank {r} {f}")
    assert not np.array_equal(port[0][0].images, port[1][0].images)
