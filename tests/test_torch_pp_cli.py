"""``yolodl_torch.cli.train_main`` with ``training.pipeline_parallel 2`` on
``device_config`` MultiDevice of 2, ``--device cpu``: two ranks over gloo,
one stage each (dp 1).

With dp 1 stage 0 streams every record (``seed=0``, the whole batch of 4),
so the run takes the steps the reference takes on its one stream.  The
run resumes ``FromRecent`` from one checkpoint of the port's library at
step 1 (tests/_torch_parity.py ``write_first_checkpoint``, the standard
layout, in an earlier run dir of the logging dir): it skips the 4 records
step 1 took and trains steps 2-4 of 2 micro-batches each, a checkpoint a
step and an evaluation at step 4.  This process runs the reference's
``make_train_step(accum=2)`` from the same checkpoint over the reference
stream's batches 2-4.  Limits as test_torch_tp_cli.py's: the logged
losses within rel 1e-4 (so each step trained on the exact batch), the
last checkpoint's tensors within 3e-4 · max|ref| of the reference's
state.
"""

import glob
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import REPO, assert_trees_close, flat_leaves, logged, write_first_checkpoint
from _torch_parity import write_train_workspace as write_workspace
from test_torch_tp_cli import global_batches, reference_setup

MULTI = {"type": "MultiDevice", "devices": ["cuda:0", "cuda:1"]}


def train_main(config, max_steps, env):
    return subprocess.Popen(
        [sys.executable, "-m", "yolodl_torch.cli.train_main", "--config-file", config,
         "--max-steps", str(max_steps), "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env, cwd=REPO)


def reference_steps(config_path, ckpt, batches):
    """The reference's accumulation step from ``ckpt`` over ``batches`` →
    (losses, final TrainState)."""
    from yolodl_tpu.train import load_checkpoint, make_train_step, train_init

    model, train_cfg = reference_setup(config_path)
    ts, opt = train_init(model, train_cfg, seed=0)
    params, state, opt_state, meta = load_checkpoint(ckpt, ts.params, ts.state, ts.opt_state)
    ts = ts.__class__(params, state, opt_state, jnp.asarray(meta["step"], jnp.int32), None)
    step = make_train_step(model, opt, train_cfg, accum=2)
    losses = []
    for batch in batches:
        ts, m = step(ts, *map(jnp.asarray, batch))
        losses.append(float(m["total_loss"]))
    return losses, jax.tree_util.tree_map(np.asarray, ts)


@pytest.fixture(scope="module")
def pp_run(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("pp_cli")
    env = {**os.environ, "PYTHONPATH": REPO, "YDL_NO_NATIVE_DECODE": "1"}
    os.environ["YDL_NO_NATIVE_DECODE"] = "1"  # both decode with PIL
    try:
        config = write_workspace(tmp, batch_size=4, accumulation_steps=2, pipeline_parallel=2,
                                 device_config=MULTI, save_checkpoint_steps=1,
                                 load_checkpoint={"type": "FromRecent"})
        ckpt = write_first_checkpoint(config, str(tmp / "logs" / "earlier" / "checkpoints"))
        raw = json.loads(open(config).read())
        raw["evaluation"] = {"interval": 4, "batch_size": 2}
        with open(config, "w") as f:
            json.dump(raw, f)
        proc = train_main(config, 4, env)
        ref = reference_steps(config, ckpt, global_batches(config, 1, n=4)[1:])
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
    finally:
        del os.environ["YDL_NO_NATIVE_DECODE"]
    (chief,) = [d for d in glob.glob(str(tmp / "logs" / "*"))
                if not d.endswith(("-r1", "earlier"))]
    return dict(tmp=tmp, config=config, out=out, chief=chief, ref=ref,
                ckpts=sorted(glob.glob(os.path.join(chief, "checkpoints", "*.ckpt"))))


def test_train_main_matches_the_reference_accumulation_step(pp_run):
    out = pp_run["out"]
    assert "dp: 2 ranks, backend gloo (ranks run on the CPU)" in out
    assert "pipeline: 2 stages (2 nodes, 4 nodes) x dp=1, 2 microbatches/step" in out
    assert "pipeline: boundary tensors over gloo, staged through host memory" in out
    assert "warning: in-training evaluation/inference merges the full model" in out
    assert "step 4  val mAP@0.5" in out
    assert out.count("restored checkpoint at step 1") == 2  # each rank
    assert "data stream resumed at record 4" in out
    port = logged(pp_run["chief"])
    assert [s for s, _ in port] == [2, 3, 4]
    np.testing.assert_allclose([v for _, v in port], pp_run["ref"][0], rtol=1e-4)


def test_checkpoint_loads_into_a_plain_port_model_and_the_reference(pp_run):
    """Rank 0 writes a checkpoint each step in the standard layout; the last
    loads with the reference's templates and holds its state after the
    steps, and loads into a single-device port model and optimizer."""
    from yolodl_torch.bridge import params_from_jax, params_to_jax
    from yolodl_torch.graph import Graph
    from yolodl_torch.models import YoloModel
    from yolodl_torch.train import TrainConfig, train_init
    from yolodl_torch.train.checkpoint import load_checkpoint as t_load_checkpoint
    from yolodl_torch.train.loop import load_optimizer_state_tree, optimizer_state_tree
    from yolodl_tpu.train import load_checkpoint, train_init as j_train_init

    ckpts = pp_run["ckpts"]
    assert len(ckpts) == 3
    assert not glob.glob(str(pp_run["tmp"] / "logs" / "*-r1" / "checkpoints"))
    model, train_cfg = reference_setup(pp_run["config"])
    ts, _ = j_train_init(model, train_cfg, seed=0)
    params, state, opt_state, meta = load_checkpoint(ckpts[-1], ts.params, ts.state,
                                                     ts.opt_state)
    assert meta["step"] == 4 and opt_state is not None
    final = pp_run["ref"][1]
    assert_trees_close(flat_leaves(params), flat_leaves(final.params), 3e-4, rel=True)
    assert_trees_close(flat_leaves(state), flat_leaves(final.state), 3e-4, rel=True)

    net = YoloModel(Graph.load_newslab_v1_json(str(pp_run["tmp"] / "model.json5")),
                    device="cpu")
    t_cfg = TrainConfig(optimizer="adam", momentum=0.9, weight_decay=5e-4)  # the workspace's
    t_ts, _ = train_init(net, t_cfg)
    params_t, state_t = params_to_jax(net.state_dict())
    t_params, t_state, t_opt, t_meta = t_load_checkpoint(
        ckpts[-1], params_t, state_t, optimizer_state_tree(t_ts, t_cfg))
    params_from_jax(t_params, t_state, model=net)
    load_optimizer_state_tree(t_ts, t_cfg, t_opt)
    assert t_meta["step"] == 4
    assert_trees_close(flat_leaves(params_to_jax(net.state_dict())[0]), flat_leaves(params), 0)
    with torch.no_grad():
        assert bool(torch.isfinite(net(torch.zeros((1, 3, 32, 32))).cycxhw).all())
