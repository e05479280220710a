"""``yolodl_torch.parallel`` ZeRO-1 over 2 ranks against
``yolodl_tpu.parallel.make_zero_train_step`` on ``make_mesh(2)`` (the
virtual CPU devices of tests/conftest.py), and against the port's own
data-parallel step.

The ranks are processes joined over gloo (``TP_RANK_SCRIPT`` of
tests/_torch_parity.py); each takes its 4 rows of the same seeded global
batches of 8 from the same weights carried through the bridge.  The model
is the reference test's ``tiny_model(bn=False)`` (tests/test_train.py:374:
ZeRO-1 is held to plain DP there).

Limits: three Adam steps, the loss within rtol 1e-5 and the parameters
within atol 1e-6 of the DP step's (tests/test_train.py:405-411), and of
the reference's ZeRO step's; each rank's flat moments are ``per_shard``
long.  ZeRO × darknet loss (tests/test_train.py:760-780): the BN-free
darknet cfg, one SGD step over 2 ranks against the single-device step,
weights within atol 2e-6.
"""

import ast
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (DARKNET_CFG, assert_trees_close, darknet_batch, fake_batches,
                           flat_leaves, model_pair, port_single, reference_parallel, start_ranks,
                           start_tp_ranks, state_trees, train_configs, wait_ranks)
from yolodl_tpu.config import darknet_cfg as jdk
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_torch.bridge import params_from_jax
from yolodl_torch.config import darknet_cfg as tdk
from yolodl_torch.graph import Graph
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.loss.darknet_loss import head_params_from_darknet
from yolodl_torch.models import YoloModel
from yolodl_torch.parallel import zero_init
from yolodl_torch.parallel.zero import flat_geometry

torch.set_num_threads(2)

TINY = {"main_group": "m", "groups": {"m": [
    {"name": "input", "kind": "Input", "shape": ["_", 3, 32, 32]},
    {"kind": "ConvBn2D", "c": 8, "k": 3, "s": 2, "bn": {"enabled": False}},
    {"kind": "ConvBn2D", "c": 16, "k": 3, "s": 2, "bn": {"enabled": False}},
    {"name": "head", "kind": "ConvBn2D", "c": 7, "k": 1, "act": "linear",
     "bn": {"enabled": False}},
    {"name": "det", "kind": "Detect2D", "classes": 2, "anchors": [[0.3, 0.3]]},
    {"name": "output", "kind": "MergeDetect2D", "from": ["det"]},
]}}
ADAM = dict(optimizer="adam", lr=1e-3)
SGD = dict(optimizer="sgd", momentum=0.9, lr=1e-3)
LOGGED = dict(ADAM, clip_grad_value=0.01, log_weights_and_grads=True)
@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    """The ranks run ZeRO-1 and DP on the tiny model and ZeRO-1 with the
    darknet loss, while this process runs the reference's ZeRO step and
    the single-device darknet-loss step."""
    tmp = tmp_path_factory.mktemp("zero")
    batches = fake_batches(3)
    jm, params, state, _, init = model_pair(TINY, tmp / "tiny.json5")
    cfg_path = tmp / "darknet.cfg"
    cfg_path.write_text(DARKNET_CFG)
    d = jdk.Darknet.from_str(DARKNET_CFG)
    jd = JYoloModel(j_graph(d))
    d_params, d_state = jax.tree_util.tree_map(np.asarray, jd.init(jax.random.PRNGKey(0)))
    dm = YoloModel(load_darknet_graph(str(cfg_path)), device="cpu")
    params_from_jax(d_params, d_state, model=dm)
    d_init = {k: v.clone() for k, v in dm.state_dict().items()}
    tiny = {"model": str(tmp / "tiny.json5"), "init": init, "config": ADAM, "steps": 3}
    procs, out = start_tp_ranks(tmp, {
        "zero": {**tiny, "mode": "zero"}, "dp": {**tiny, "mode": "dp"},
        "logged": {**tiny, "mode": "zero", "config": LOGGED},
        "darknet": {"model": str(cfg_path), "init": d_init, "config": SGD, "steps": 1,
                    "mode": "zero", "darknet": True, "batches": [darknet_batch()]}},
        batches, 2)
    ref = reference_parallel("zero", jm, params, state, train_configs(**ADAM)[0], batches, (2,))
    logged = reference_parallel("zero", jm, params, state, train_configs(**LOGGED)[0],
                                batches, (2,))
    _, t_cfg = train_configs(**SGD)
    spec = (dm.graph.detect_head_input_keys(),
            tuple(head_params_from_darknet(layer, 64, 64)
                  for layer in tdk.Darknet.from_str(DARKNET_CFG).layers
                  if isinstance(layer, tdk.Yolo)))
    single = port_single(dm, dataclasses.replace(t_cfg, darknet_loss=spec), [darknet_batch()])
    wait_ranks(procs)
    ranks = [dict(np.load(f"{out}.r{r}.npz")) for r in range(2)]
    return dict(ref=ref, logged=logged, single=single, ranks=ranks, init=init)


def rank_trees(rank, name):
    return state_trees({k[len(f"{name}/state/"):]: torch.from_numpy(v)
                        for k, v in rank.items() if k.startswith(f"{name}/state/")})


def test_zero_step_matches_the_reference_zero_step(runs):
    """Three Adam steps: losses rtol 1e-5, parameters atol 1e-6 against the
    reference's make_zero_train_step on 2 devices; both ranks identical."""
    r0, r1 = runs["ranks"]
    _, j_ts, j_metrics = runs["ref"]
    for i, ref in enumerate(j_metrics):
        np.testing.assert_allclose(r0[f"zero/step{i}/total_loss"], ref["total_loss"], rtol=1e-5)
        assert int(r0[f"zero/step{i}/num_matched"]) == int(ref["num_matched"]) > 0
    params, _ = rank_trees(r0, "zero")
    assert_trees_close(params, flat_leaves(j_ts.params), 1e-6)
    assert str(r0["zero/digest"]) == str(r1["zero/digest"])
    assert int(r0["zero/step"]) == 3


def test_zero_clip_value_and_maxima_match_the_reference(runs):
    """``clip_grad_value`` on the slice and ``log_weights_and_grads``: the
    ``grads_max/*`` scalars read the averaged gradients (zero.py:150-156);
    every metric within rtol 1e-5 of the reference's ZeRO step, the
    parameters within atol 1e-6."""
    r0 = runs["ranks"][0]
    _, j_ts, j_metrics = runs["logged"]
    for i, ref in enumerate(j_metrics):
        got = {k.split("/", 2)[2]: v for k, v in r0.items() if k.startswith(f"logged/step{i}/")}
        assert set(got) == set(ref), set(got) ^ set(ref)
        assert any(k.startswith("grads_max/") for k in got)
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    params, _ = rank_trees(r0, "logged")
    assert_trees_close(params, flat_leaves(j_ts.params), 1e-6)


def test_zero_step_matches_the_dp_step(runs):
    """tests/test_train.py:374-411: ZeRO-1 tracks plain DP on the same rows,
    loss rtol 1e-5, parameters atol 1e-6."""
    r0 = runs["ranks"][0]
    for i in range(3):
        np.testing.assert_allclose(r0[f"zero/step{i}/total_loss"], r0[f"dp/step{i}/total_loss"],
                                   rtol=1e-5)
    z_params, _ = rank_trees(r0, "zero")
    d_params, _ = rank_trees(r0, "dp")
    assert_trees_close(z_params, d_params, 1e-6)


def test_each_rank_holds_per_shard_moments(runs, tmp_path):
    """Adam's two moments on each rank are one flat slice of ``per_shard``
    elements, half the padded parameter count."""
    model = YoloModel(Graph.load_newslab_v1_json(_write(tmp_path, TINY)), device="cpu")
    padded, per_shard = flat_geometry(list(model.parameters()), 2)
    assert padded == 2 * per_shard >= sum(p.numel() for p in model.parameters())
    for rank in runs["ranks"]:
        assert list(rank["zero/opt_slices"]) == [per_shard, per_shard]


def _write(tmp_path, spec):
    path = tmp_path / "m.json5"
    path.write_text(json.dumps(spec))
    return str(path)


def test_zero_init_rejects_the_global_norm_clip(tmp_path):
    """tests/test_train.py zero1_rejects_global_norm_clip: the reference's
    ValueError, before anything touches a group."""
    model = YoloModel(Graph.load_newslab_v1_json(_write(tmp_path, TINY)), device="cpu")
    _, t_cfg = train_configs(lr=1e-3, clip_grad_norm=1.0)
    with pytest.raises(ValueError, match="global gradient norm"):
        zero_init(model, t_cfg, mesh=None)


def test_zero_with_the_darknet_loss_matches_the_single_device_step(runs):
    """ZeRO-1 × darknet loss (tests/test_train.py:760-780): 2 ranks of one
    image each, one SGD step, against the single-device step over both
    images: weights within atol 2e-6."""
    r0 = runs["ranks"][0]
    _, final, _ = runs["single"]
    params, _ = rank_trees(r0, "darknet")
    s_params, _ = state_trees(final)
    assert_trees_close(params, s_params, 2e-6)
    assert int(r0["darknet/step"]) == 1


ROUTE_SCRIPT = r"""
import sys, torch
from yolodl_torch.parallel import init_process_group, mesh as m
world = init_process_group("cpu")
flat = torch.arange(10, dtype=torch.float32) * (world.rank + 1)
routes = {}
for since in ((0, 0), (99, 0)):  # a torch with, then one without, gloo's reduce_scatter_tensor
    m._GLOO_REDUCE_SCATTER_SINCE = since
    routes[m.reduce_scatter_route("gloo")] = world.reduce_scatter(flat).tolist()
print(routes, file=sys.stderr)
m.destroy_process_group()
"""


def test_both_reduce_scatter_routes_give_this_ranks_part_of_the_sum():
    """The backend rule's two routes (``reduce_scatter_tensor``, and an
    all-reduce then this rank's slice) give each rank the same part of the
    sum over the ranks."""
    procs = start_ranks(["-c", ROUTE_SCRIPT], 2)
    for r, p in enumerate(procs):
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        routes = ast.literal_eval(err.strip().splitlines()[-1])
        want = [3.0 * x for x in range(5 * r, 5 * r + 5)]
        assert routes == {"reduce_scatter_tensor": want, "all_reduce + slice": want}
