"""``yolodl_torch.cli.train_main`` with ``device_config`` MultiDevice of 2,
``--device cpu`` (two ranks over gloo), and ``tensor_parallel 2`` or
``zero_optimizer``.

- **Tensor parallel (1×2).**  Both ranks stream the same records (data
  index 0 of 1: all of them, ``seed=0``, the whole batch of 4), so the run
  takes the steps the reference takes on one stream.  From one checkpoint
  of the port's library (tests/_torch_parity.py ``write_first_checkpoint``,
  the standard layout) it trains 3 steps with an evaluation at step 3; this
  process runs the reference's ``make_tp_train_step`` on
  ``make_tp_mesh(1, 2)`` from the same checkpoint over the reference
  stream's batches.  The logged losses agree within rel 1e-4
  (test_torch_train_cli.py's limit), and the port's last checkpoint loads
  into the reference's templates with parameters and BN state within
  3e-4 · max|ref| of the reference's state (test_torch_dp.py's multi-step
  limit).
- **ZeRO-1.**  A checkpoint the reference's ZeRO step wrote (its flat
  ``opt/`` vectors) resumes in the port's ZeRO run at the same world size;
  its 3 logged losses agree within rel 1e-4 with the reference's ZeRO step
  continuing from that checkpoint over the ranks' global batches (each
  rank streaming ``records[r::2]`` with ``seed=r``), and the port's last
  checkpoint loads back into the reference's ZeRO templates.
- Both: checkpoints from rank 0 only; the mesh and reduce-scatter lines.
- The model-group batch check raises on both ranks when they hold
  different batches.
"""

import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import (REPO, assert_trees_close, first_batches, flat_leaves, logged,
                           random_targets, rank_streams, start_ranks, write_first_checkpoint)
from _torch_parity import write_train_workspace as write_workspace
from yolodl_tpu.cli import train_main as j_train

MULTI = {"type": "MultiDevice", "devices": ["cuda:0", "cuda:1"]}


def reference_setup(config_path):
    """The reference's model and TrainConfig as its train_main builds them."""
    from yolodl_tpu.config.app_config import TrainAppConfig, compute_dtype_of
    from yolodl_tpu.graph import Graph
    from yolodl_tpu.models import YoloModel
    from yolodl_tpu.train import TrainConfig

    config = TrainAppConfig.load(config_path)
    graph = Graph.load_newslab_v1_json(
        os.path.join(os.path.dirname(config_path), config.model_file))
    config = j_train._resolve_auto_loss_options(config, graph)
    train_cfg = TrainConfig(
        lr=config.lr, optimizer=config.optimizer, momentum=config.momentum,
        weight_decay=config.weight_decay, loss=config.loss,
        use_ema=config.use_ema, ema_decay=config.ema_decay,
        compute_dtype=compute_dtype_of(config.precision))
    return YoloModel(graph), train_cfg


def reference_run(kind, config_path, ckpt, global_batches):
    """The reference's ``kind`` step ("tp" on make_tp_mesh(1, 2), "zero" on
    make_mesh(2)) from ``ckpt`` over ``global_batches`` → (losses, final
    TrainState)."""
    from yolodl_tpu import parallel as jp
    from yolodl_tpu.train import load_checkpoint, train_init

    model, train_cfg = reference_setup(config_path)
    if kind == "zero":
        mesh = jp.make_mesh(2)
        ts, opt = jp.zero_init(model, train_cfg, mesh, seed=0)
    else:
        mesh = jp.make_tp_mesh(1, 2)
        ts, opt = train_init(model, train_cfg, seed=0)
    params, state, opt_state, meta = load_checkpoint(ckpt, ts.params, ts.state, ts.opt_state)
    ts = ts.__class__(params, state, opt_state, jnp.asarray(meta["step"], jnp.int32), None)
    if kind == "zero":
        ts = jp.place_zero_state(mesh, ts)
        step, place = jp.make_zero_train_step(model, opt, train_cfg, mesh), jp.shard_batch
    else:
        ts = jp.place_tp_state(mesh, ts)
        step, place = jp.make_tp_train_step(model, opt, train_cfg, mesh), jp.shard_batch_tp
    losses = []
    for batch in global_batches:
        ts, m = step(ts, *place(mesh, tuple(map(jnp.asarray, batch))))
        losses.append(float(m["total_loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, ts)


def reference_zero_checkpoint(config_path, ckpt, out_dir):
    """One reference ZeRO step on 2 devices from ``ckpt``'s parameters with
    a fresh flat optimizer, saved by the reference → its path."""
    from yolodl_tpu import parallel as jp
    from yolodl_tpu.train import load_checkpoint, save_checkpoint

    model, train_cfg = reference_setup(config_path)
    mesh = jp.make_mesh(2)
    ts, opt = jp.zero_init(model, train_cfg, mesh, seed=0)
    params, state, _, _ = load_checkpoint(ckpt, ts.params, ts.state)
    ts = jp.place_zero_state(mesh, ts.__class__(params, state, ts.opt_state, ts.step, None))
    rng = np.random.default_rng(3)
    batch = (rng.uniform(0, 1, (4, 3, 32, 32)).astype(np.float32),
             *random_targets(4, 4, 3, num_classes=1))
    ts, m = jp.make_zero_train_step(model, opt, train_cfg, mesh)(
        ts, *jp.shard_batch(mesh, tuple(map(jnp.asarray, batch))))
    return save_checkpoint(out_dir, int(ts.step), float(m["total_loss"]),
                           jax.device_get(ts.params), jax.device_get(ts.state),
                           jax.device_get(ts.opt_state))


def start(config, env):
    return subprocess.Popen(
        [sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file", config,
         "--max-steps", "4", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)


def global_batches(config, world, n=3):
    per_rank = first_batches(rank_streams("ref", config, world), n)
    return [tuple(np.concatenate([getattr(per_rank[r][i], f) for r in range(world)])
                  for f in ("images", "boxes", "classes", "mask"))
            for i in range(n)]


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("tp_cli")
    env = {**os.environ, "PYTHONPATH": REPO, "YDL_NO_NATIVE_DECODE": "1"}
    os.environ["YDL_NO_NATIVE_DECODE"] = "1"  # both decode with PIL
    try:
        first = write_workspace(tmp / "first", batch_size=4)
        ckpt = write_first_checkpoint(first, str(tmp / "first" / "checkpoints"))
        zero_ckpt = reference_zero_checkpoint(first, ckpt, str(tmp / "zero_ckpt"))
        common = dict(batch_size=4, device_config=MULTI, save_checkpoint_steps=1)
        tp_config = write_workspace(tmp / "tp", tensor_parallel=2,
                                    load_checkpoint={"type": "FromFile", "file": ckpt},
                                    **common)
        zero_config = write_workspace(tmp / "zero", zero_optimizer=True,
                                      load_checkpoint={"type": "FromFile", "file": zero_ckpt},
                                      **common)
        raw = open(tp_config).read()
        with open(tp_config, "w") as f:  # an evaluation at step 3
            f.write(raw[:-1] + ', "evaluation": {"interval": 3, "batch_size": 2}}')
        procs = {"tp": start(tp_config, env), "zero": start(zero_config, env)}
        refs = {"tp": reference_run("tp", tp_config, ckpt, global_batches(tp_config, 1)),
                "zero": reference_run("zero", zero_config, zero_ckpt,
                                      global_batches(zero_config, 2))}
        outs = {name: p.communicate(timeout=300) for name, p in procs.items()}
    finally:
        del os.environ["YDL_NO_NATIVE_DECODE"]
    for name, p in procs.items():
        assert p.returncode == 0, outs[name][1]
    return tmp, refs, {name: out for name, (out, _) in outs.items()}


def chief_dir(tmp, name):
    (chief,) = [d for d in glob.glob(str(tmp / name / "logs" / "*")) if not d.endswith("-r1")]
    return chief


@pytest.mark.parametrize("name", ["tp", "zero"])
def test_train_main_matches_the_reference_step(cli_runs, name):
    tmp, refs, outs = cli_runs
    out = outs[name]
    assert "dp: 2 ranks, backend gloo (ranks run on the CPU)" in out
    if name == "tp":
        assert "mesh: data=1 x model=2 (tensor parallel)" in out
        assert "step 3  val mAP@0.5" in out
    else:
        assert "zero: optimizer state over 2 ranks, reduce-scatter by " in out
    assert out.count("restored checkpoint at step 1") == 2  # each rank
    port = logged(chief_dir(tmp, name))
    assert [s for s, _ in port] == [2, 3, 4]
    np.testing.assert_allclose([v for _, v in port], refs[name][0], rtol=1e-4)


@pytest.mark.parametrize("name", ["tp", "zero"])
def test_checkpoints_come_from_rank_0_and_load_into_the_reference(cli_runs, name):
    """Rank 0 writes a checkpoint each step; the last loads with the
    reference's templates (the standard layout under TP, the flat ZeRO
    layout under ZeRO) and holds the reference's state after the steps."""
    from yolodl_tpu import parallel as jp
    from yolodl_tpu.train import load_checkpoint, train_init

    tmp, refs, _ = cli_runs
    chief = chief_dir(tmp, name)
    ckpts = sorted(glob.glob(os.path.join(chief, "checkpoints", "*.ckpt")))
    assert len(ckpts) == 3
    assert not glob.glob(str(tmp / name / "logs" / "*-r1" / "checkpoints"))
    model, train_cfg = reference_setup(os.path.join(tmp, name, "train.json5"))
    ts, _ = (jp.zero_init(model, train_cfg, jp.make_mesh(2), seed=0) if name == "zero"
             else train_init(model, train_cfg, seed=0))
    params, state, opt_state, meta = load_checkpoint(ckpts[-1], ts.params, ts.state,
                                                     ts.opt_state)
    assert meta["step"] == 4 and opt_state is not None
    final = refs[name][1]
    assert_trees_close(flat_leaves(params), flat_leaves(final.params), 3e-4, rel=True)
    assert_trees_close(flat_leaves(state), flat_leaves(final.state), 3e-4, rel=True)


CHECK_SCRIPT = r"""
import sys, torch
from yolodl_torch.parallel import init_process_group, make_tp_mesh
from yolodl_torch.parallel.mesh import destroy_process_group
from yolodl_torch.parallel.tp import check_model_group_batch
world = init_process_group("cpu")
mesh = make_tp_mesh(1, 2)
same = (torch.zeros(2, 3), torch.ones(2, 1, dtype=torch.bool))
check_model_group_batch(mesh, same)
print("equal batches pass", file=sys.stderr)
try:
    check_model_group_batch(mesh, (torch.full((2, 3), float(world.rank)), same[1]))
except RuntimeError as e:
    print("raised:", e, file=sys.stderr)
destroy_process_group()
"""


def test_model_group_batch_check_raises_on_a_mismatch():
    """The ranks of a model group must hold one batch: equal batches pass,
    different ones raise on both ranks."""
    procs = start_ranks(["-c", CHECK_SCRIPT], 2)
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        assert "equal batches pass" in err
        assert "raised: tensor parallel: the 2 ranks of data index 0 hold different batches" in err
