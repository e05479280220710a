"""TP × ZeRO-1 and TP × the darknet loss in ``yolodl_torch.parallel``, on a
2×2 data × model mesh of 4 ranks over gloo (``TP_RANK_SCRIPT`` of
tests/_torch_parity.py).

- TP × ZeRO-1 against TP (``__graft_entry__.py:205-236``: the same
  numbers, since the optimizer update is elementwise) and against the
  reference's ``make_tp_zero_train_step`` on ``make_tp_mesh(2, 2)``; the
  model is the reference test's ``tiny_model(bn=True)``, two Adam steps,
  and a third case adds ``clip_grad_norm`` and ``log_weights_and_grads``
  (the global norm and the maxima cross both mesh axes and the flat
  slices).  Limits: tests/test_tp.py's, loss rtol 2e-4, parameters and BN
  state atol 5e-5; the TP × ZeRO-1 loss within 1e-4 of TP's as in the
  graft entry; the maxima within rtol 1e-5.
- TP × darknet loss (tests/test_train.py:782): the BN-free darknet cfg of
  tests/test_train.py (``_torch_parity.DARKNET_CFG``), one SGD step, one
  image a data rank; both the cost and the weights match the single-device step (cost rtol 1e-5, weights
  atol 2e-6), unlike the data-parallel step's per-rank cost.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (DARKNET_CFG, TINY_BN, assert_trees_close, darknet_batch, fake_batches,
                           flat_leaves, model_pair, port_single, reference_parallel,
                           start_tp_ranks, state_trees, train_configs, wait_ranks)
from yolodl_tpu.config import darknet_cfg as jdk
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_torch.bridge import params_from_jax
from yolodl_torch.config import darknet_cfg as tdk
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.loss.darknet_loss import head_params_from_darknet
from yolodl_torch.models import YoloModel

torch.set_num_threads(2)

ADAM = dict(optimizer="adam", lr=1e-3)
SGD = dict(optimizer="sgd", momentum=0.9, lr=1e-3)
CLIPPED = dict(ADAM, clip_grad_norm=0.05, log_weights_and_grads=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    tmp = tmp_path_factory.mktemp("tp_zero")
    batches = fake_batches(2)
    jm, params, state, _, init = model_pair(TINY_BN, tmp / "tiny.json5")
    cfg_path = tmp / "darknet.cfg"
    cfg_path.write_text(DARKNET_CFG)
    jd = JYoloModel(j_graph(jdk.Darknet.from_str(DARKNET_CFG)))
    d_params, d_state = jax.tree_util.tree_map(np.asarray, jd.init(jax.random.PRNGKey(0)))
    dm = YoloModel(load_darknet_graph(str(cfg_path)), device="cpu")
    params_from_jax(d_params, d_state, model=dm)
    tiny = {"model": str(tmp / "tiny.json5"), "init": init, "mesh": [2, 2], "steps": 2}
    procs, out = start_tp_ranks(tmp, {
        "tp": {**tiny, "mode": "tp", "config": ADAM},
        "tp_zero": {**tiny, "mode": "tp_zero", "config": ADAM},
        "clipped": {**tiny, "mode": "tp_zero", "config": CLIPPED},
        "darknet": {"model": str(cfg_path), "init": dict(dm.state_dict()), "config": SGD,
                    "steps": 1, "mode": "tp", "mesh": [2, 2], "darknet": True,
                    "batches": [darknet_batch()]}}, batches, 4)
    refs = {name: reference_parallel("tp_zero", jm, params, state, train_configs(**kw)[0],
                                     batches, (2, 2))
            for name, kw in (("tp_zero", ADAM), ("clipped", CLIPPED))}
    _, t_cfg = train_configs(**SGD)
    spec = (dm.graph.detect_head_input_keys(),
            tuple(head_params_from_darknet(layer, 64, 64)
                  for layer in tdk.Darknet.from_str(DARKNET_CFG).layers
                  if isinstance(layer, tdk.Yolo)))
    single = port_single(dm, dataclasses.replace(t_cfg, darknet_loss=spec), [darknet_batch()])
    wait_ranks(procs)
    return dict(refs=refs, single=single, rank=dict(np.load(f"{out}.r0.npz")),
                slices=[list(np.load(f"{out}.r{r}.npz")["tp_zero/opt_slices"])
                        for r in range(4)])


def trees(rank, name, which="state"):
    prefix = f"{name}/{which}/"
    return state_trees({k[len(prefix):]: torch.from_numpy(v)
                        for k, v in rank.items() if k.startswith(prefix)})


def test_tp_zero_equals_tp(runs):
    """The flat slice of the TP shard a rank updates gives TP's numbers."""
    rank = runs["rank"]
    for i in range(2):
        assert abs(float(rank[f"tp_zero/step{i}/total_loss"])
                   - float(rank[f"tp/step{i}/total_loss"])) < 1e-4
    for which in ("first", "state"):
        for mine, tp in zip(trees(rank, "tp_zero", which), trees(rank, "tp", which)):
            assert_trees_close(mine, tp, 5e-5)
    # each rank's optimizer holds its quarter: two moments of one slice
    assert all(len(s) == 2 and s[0] == s[1] for s in runs["slices"])


@pytest.mark.parametrize("name", ["tp_zero", "clipped"])
def test_tp_zero_matches_the_reference_tp_zero_step(runs, name):
    """Against yolodl_tpu's make_tp_zero_train_step on make_tp_mesh(2, 2);
    with clipping, the global norm and every maximum too."""
    rank = runs["rank"]
    j_first, j_ts, j_metrics = runs["refs"][name]
    for i, ref in enumerate(j_metrics):
        got = {k.split("/", 2)[2]: v for k, v in rank.items() if k.startswith(f"{name}/step{i}/")}
        assert set(got) == set(ref), set(got) ^ set(ref)
        np.testing.assert_allclose(got["total_loss"], ref["total_loss"], rtol=2e-4)
        for k, v in ref.items():
            if k.startswith(("weights_max/", "grads_max/")):
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
    for which, j in (("first", j_first), ("state", j_ts)):
        params, state = trees(rank, name, which)
        assert_trees_close(params, flat_leaves(j.params), 5e-5)
        assert_trees_close(state, flat_leaves(j.state), 5e-5)


def test_tp_with_the_darknet_loss_matches_the_single_device_step(runs):
    """tests/test_train.py:782: the loss runs on the gathered heads over the
    global batch, so the reported cost and the weights are the
    single-device step's (its 24-channel head is cut too)."""
    rank = runs["rank"]
    _, final, losses = runs["single"]
    np.testing.assert_allclose(float(rank["darknet/step0/total_loss"]), losses[0], rtol=1e-5)
    params, _ = trees(rank, "darknet")
    s_params, _ = state_trees(final)
    assert_trees_close(params, s_params, 2e-6)
