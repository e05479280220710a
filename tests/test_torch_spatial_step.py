"""``yolodl_torch.parallel.spatial_model.make_spatial_train_step`` on a
2 × 2 (data × space) mesh against the reference's
``make_spatial_train_step`` on ``make_data_space_mesh(2, 2)`` (the virtual
CPU devices of tests/conftest.py) and against the port's single-process
``make_train_step`` on the same global batch.

The model is tests/test_pipeline.py's yolov4-tiny at 64² with 3 classes
(``pp_tiny``: the reference's seeded weights through the bridge); the batch
is the reference test's (tests/test_spatial_model.py:101-110): 2 seeded
images duplicated over the data axis, so that each data replica's tail
BN statistics are the whole batch's, one box an image.  One SGD step
(momentum 0.937, lr 1e-2), four ranks joined over gloo
(``SPATIAL_RANK_SCRIPT``).  Limits are the reference test's (:125-135):
the loss within 1e-4, every parameter and BN statistic within 2e-4;
``num_matched`` equal; every rank ends with the same state.  The frozen
case is tests/test_spatial_model.py:138-201: ``layer0`` and ``layer1`` in
``stop_gradient_paths`` (weight decay 0) keep their kernels bit for bit
while the rest of the network moves, and the step still matches the
reference's and the single process's.  The float64 checks of every
gradient are in test_torch_spatial_f64.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, flat_leaves, port_single, pp_tiny, spatial_batch,
                           start_spatial_ranks, state_trees, train_configs, wait_ranks)
from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.parallel.dp import replicate_state as j_replicate
from yolodl_tpu.parallel.spatial_model import make_data_space_mesh as j_mesh
from yolodl_tpu.parallel.spatial_model import make_spatial_train_step as j_step
from yolodl_tpu.parallel.spatial_model import shard_batch_2d as j_shard
from yolodl_tpu.train import loop as j_loop
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.models import YoloModel

torch.set_num_threads(2)

SGD = dict(optimizer="sgd", lr=1e-2)
FROZEN = ("layer0", "layer1")


def reference_step(jm, params, state, j_cfg, batch):
    """One reference spatial step on a 2 × 2 mesh → (flat params, flat
    state, metrics)."""
    opt = j_loop.make_optimizer(j_cfg)
    p, s = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, state))
    ts = j_loop.TrainState(p, s, opt.init(p), jnp.zeros((), jnp.int32), None)
    mesh = j_mesh(2, 2)
    ts, metrics = j_step(jm, opt, j_cfg, mesh)(j_replicate(mesh, ts),
                                               *j_shard(mesh, tuple(map(jnp.asarray, batch))))
    return flat_leaves(ts.params), flat_leaves(ts.state), metrics


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("spatial_step")
    path, jm, params, state, tm, init = pp_tiny(tmp, 64)
    batch = spatial_batch()
    config = dict(SGD)
    procs, out = start_spatial_ranks(tmp, {
        "step": {"mode": "step", "mesh": [2, 2], "model": path, "init": init, "config": config},
        "frozen": {"mode": "step", "mesh": [2, 2], "model": path, "init": init,
                   "config": {**config, "weight_decay": 0.0}, "frozen": list(FROZEN)}},
        {f"{k}0": v for k, v in zip(("images", "boxes", "classes", "mask"), batch)}, 4)
    j_cfg, t_cfg = train_configs(**SGD)
    refs = {"step": reference_step(jm, params, state, j_cfg, batch)}
    graph = j_load(path)
    graph.stop_gradient_paths = frozenset(FROZEN)
    fm = JYoloModel(graph, spd_stem="off")
    assert fm._sg_keys
    refs["frozen"] = reference_step(fm, params, state, j_cfg, batch)
    singles = {"step": port_single(tm, t_cfg, [batch])}
    t_graph = load_darknet_graph(path)
    t_graph.stop_gradient_paths = frozenset(FROZEN)
    ftm = YoloModel(t_graph, device="cpu")
    ftm.load_state_dict(init)
    singles["frozen"] = port_single(ftm, t_cfg, [batch])
    wait_ranks(procs)
    ranks = [dict(np.load(f"{out}.r{r}.npz")) for r in range(4)]
    return refs, singles, ranks, init


@pytest.mark.parametrize("case", ["step", "frozen"])
def test_spatial_step_matches_reference_and_single_process(runs, case):
    refs, singles, ranks, _ = runs
    j_params, j_state, j_metrics = refs[case]
    _, final, losses = singles[case]
    rank = ranks[0]
    loss = float(rank[f"{case}/metrics/total_loss"])
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, float(j_metrics["total_loss"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(loss, losses[0], rtol=0, atol=1e-4)
    assert int(rank[f"{case}/metrics/num_matched"]) == int(j_metrics["num_matched"]) > 0
    prefix = f"{case}/state/"
    params, state = state_trees({k[len(prefix):]: torch.from_numpy(v)
                                 for k, v in rank.items() if k.startswith(prefix)})
    assert_trees_close(params, j_params, 2e-4)
    assert_trees_close(state, j_state, 2e-4)
    s_params, s_state = state_trees(final)
    assert_trees_close(params, s_params, 2e-4)
    assert_trees_close(state, s_state, 2e-4)
    digests = {str(r[f"{case}/digest/{i}"]) for i, r in enumerate(ranks)}
    assert len(digests) == 1


def test_frozen_prefix_layers_keep_their_weights(runs):
    """tests/test_spatial_model.py:185-194: SGD with weight decay 0 and a
    zero gradient leaves the frozen kernels bit for bit; others move."""
    _, _, ranks, init = runs
    rank = ranks[0]
    for name in FROZEN:
        key = f"layers.{name}.w"
        np.testing.assert_array_equal(rank[f"frozen/state/{key}"], init[key].numpy(),
                                      err_msg=name)
        assert not rank[f"frozen/grad/{key}"].any()  # no gradient reached it
    moved = [k for k in init if k.endswith(".w") and k.split(".")[1] not in FROZEN
             and not np.array_equal(rank[f"frozen/state/{k}"], init[k].numpy())]
    assert len(moved) > 10
