"""``yolodl_torch.parallel`` tensor parallelism against
``yolodl_tpu.parallel.make_tp_train_step`` on ``make_tp_mesh`` of the same
shape (the 8 virtual CPU devices of tests/conftest.py), and against the
port's own single-process step over the global batch.

The port's ranks are processes joined over gloo (``TP_RANK_SCRIPT`` of
tests/_torch_parity.py); each takes its rows of the same seeded global
batches (8 images) from the same weights carried through the bridge.  The
model is the reference test's ``tiny_model(bn=True)`` (tests/test_train.py:29:
two 3×3 ConvBn2D of 8 and 16 channels, cut over the model axis, and a
7-channel head, replicated); a second case runs the 16² graph of every
NEWSLAB kind (DarkCsp2D and SppCsp2D sub-convs, DeconvBn2D, a Conv2D head
of 14 channels) at 1×2.

Limits are tests/test_tp.py's (:41-73): the loss within rtol 2e-4,
parameters and BN state within atol 5e-5, after two Adam steps; the BN
state included, since the TP step normalizes over the global batch.
``accum=2`` on 2×2 pins the interleaved rows of ``shard_batch_tp``: a
micro-batch is a part of the global batch, and with BN its statistics
depend on which rows it holds.  ``make_tp_infer`` against the unsharded
forward: atol 2e-5 (:102-120).
"""

import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (REPO, TINY_BN, assert_trees_close, fake_batches, flat_leaves, model_pair,
                           port_single, reference_parallel, small_newslab_spec, start_ranks,
                           start_tp_ranks, state_trees, train_configs, wait_ranks)
from yolodl_tpu.parallel.tp import _leaf_spec
from yolodl_torch.bridge import params_to_jax
from yolodl_torch.graph import Graph
from yolodl_torch.models import YoloModel
from yolodl_torch.parallel.tp import leaf_spec, tp_shardings

torch.set_num_threads(2)

ADAM = dict(optimizer="adam", lr=1e-3)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    """Two rank groups at once (1×2 and 2×2) while this process runs the
    reference's TP steps and the port's single-process steps."""
    tmp = tmp_path_factory.mktemp("tp")
    batches = fake_batches(2)
    jm, params, state, tm, init = model_pair(TINY_BN, tmp / "tiny.json5")
    _, _, _, nm, n_init = model_pair(small_newslab_spec(), tmp / "kinds.json5")
    k_batches = fake_batches(1, rows=4, size=16, seed=7)
    tiny = {"model": str(tmp / "tiny.json5"), "init": init, "config": ADAM}
    (tmp / "a").mkdir()
    (tmp / "b").mkdir()
    two, out2 = start_tp_ranks(tmp / "a", {
        "tiny": {**tiny, "mode": "tp", "mesh": [1, 2], "steps": 2},
        "kinds": {"model": str(tmp / "kinds.json5"), "init": n_init, "config": ADAM,
                  "mode": "tp", "mesh": [1, 2], "steps": 1, "batches": k_batches}},
        batches, 2)
    four, out4 = start_tp_ranks(tmp / "b", {
        "tiny": {**tiny, "mode": "tp", "mesh": [2, 2], "steps": 2},
        "accum": {**tiny, "mode": "tp", "mesh": [2, 2], "steps": 1, "accum": 2},
        "infer": {**tiny, "mode": "infer", "mesh": [2, 2]}}, batches, 4)
    j_cfg, t_cfg = train_configs(**ADAM)
    refs = {(1, 2): reference_parallel("tp", jm, params, state, j_cfg, batches, (1, 2)),
            (2, 2): reference_parallel("tp", jm, params, state, j_cfg, batches, (2, 2)),
            "accum": reference_parallel("tp", jm, params, state, j_cfg, batches[:1], (2, 2),
                                        accum=2)}
    singles = {}
    for name, accum, nb in (("tiny", 1, 2), ("accum", 2, 1)):
        tm.load_state_dict(init)
        singles[name] = port_single(tm, t_cfg, batches[:nb], accum=accum)
    pred, _ = jm.apply(params, state, jnp.asarray(batches[0][0]), train=False)
    tm.load_state_dict(init)
    with torch.no_grad():
        unsharded = tm(torch.from_numpy(batches[0][0]))
    wait_ranks(two)
    wait_ranks(four)
    ranks = {(1, 2): dict(np.load(f"{out2}.r0.npz")), (2, 2): dict(np.load(f"{out4}.r0.npz"))}
    digests = {shape: [str(np.load(f"{o}.r{r}.npz")["tiny/digest"]) for r in range(n)]
               for shape, o, n in (((1, 2), out2, 2), ((2, 2), out4, 4))}
    nm.load_state_dict(n_init)
    singles["kinds"] = port_single(nm, t_cfg, k_batches)
    return dict(refs=refs, singles=singles, ranks=ranks, digests=digests, pred=pred,
                unsharded=unsharded, kinds=nm)


@pytest.mark.parametrize("shape,sharded", [((16, 8, 3, 3), 0), ((7, 16, 1, 1), None),
                                           ((16,), 0), ((), None)])
def test_leaf_rule(shape, sharded):
    """tests/test_tp.py:26-37 in the port's layouts (OIHW, [O]): a conv
    kernel cut on O, an indivisible head replicated, a channel vector cut,
    a scalar replicated; the reference's rule agrees on the HWIO shape."""
    assert leaf_spec(shape, 4) == sharded
    hwio = shape[2:] + shape[1::-1] if len(shape) == 4 else shape
    assert (_leaf_spec(np.zeros(hwio), 4) != ()) == (sharded is not None)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_tp_step_matches_reference_and_single_process(runs, shape):
    """Two Adam steps with BN: loss, parameters and BN state against the
    reference's TP step on the same mesh shape and against the port's own
    single-process step over the global batch."""
    rank = runs["ranks"][shape]
    j_first, j_ts, j_metrics = runs["refs"][shape]
    first, final, losses = runs["singles"]["tiny"]
    for i, ref in enumerate(j_metrics):
        got = float(rank[f"tiny/step{i}/total_loss"])
        np.testing.assert_allclose(got, ref["total_loss"], rtol=2e-4, err_msg=f"step {i}")
        np.testing.assert_allclose(got, losses[i], rtol=2e-4, err_msg=f"step {i}")
        assert int(rank[f"tiny/step{i}/num_matched"]) == int(ref["num_matched"]) > 0
    for which, j, single in (("first", j_first, first), ("state", j_ts, final)):
        params, state = state_trees({k[len(f"tiny/{which}/"):]: torch.from_numpy(v)
                                     for k, v in rank.items() if k.startswith(f"tiny/{which}/")})
        assert_trees_close(params, flat_leaves(j.params), 5e-5)
        assert_trees_close(state, flat_leaves(j.state), 5e-5)
        s_params, s_state = state_trees(single)
        assert_trees_close(params, s_params, 5e-5)
        assert_trees_close(state, s_state, 5e-5)
    # every rank holds its shards of one state: a model group's ranks differ
    # in their shards, and the data ranks of one model index agree
    d = runs["digests"][shape]
    assert d[0] != d[1]
    if shape == (2, 2):
        assert d[0] == d[2] and d[1] == d[3]


def test_every_newslab_kind_under_tp_matches_the_single_process_step(runs):
    """The 16² graph of every NEWSLAB kind, one step at 1×2 (sub-convs of
    DarkCsp2D and SppCsp2D, a DeconvBn2D and a Conv2D head cut) against
    the port's single-process step on the same rows."""
    rank = runs["ranks"][(1, 2)]
    _, final, losses = runs["singles"]["kinds"]
    np.testing.assert_allclose(float(rank["kinds/step0/total_loss"]), losses[0], rtol=2e-4)
    params, state = state_trees({k[len("kinds/state/"):]: torch.from_numpy(v)
                                 for k, v in rank.items() if k.startswith("kinds/state/")})
    s_params, s_state = state_trees(final)
    assert_trees_close(params, s_params, 5e-5)
    assert_trees_close(state, s_state, 5e-5)
    cut = [k for k, v in tp_shardings(types.SimpleNamespace(n_model=2), runs["kinds"]).items()
           if v is not None]
    for node in ("csp", "spp", "up", "head"):
        assert any(k.startswith(f"layers.{node}") for k in cut), node


def test_accum_micro_batches_are_parts_of_the_global_batch(runs):
    """accum=2 on 2×2 with BN: each data rank's micro-batch i is its part of
    the global rows [4i, 4i+4), so the step is the single-device step with
    accum=2 (and the reference's)."""
    rank = runs["ranks"][(2, 2)]
    _, j_ts, j_metrics = runs["refs"]["accum"]
    _, final, losses = runs["singles"]["accum"]
    got = float(rank["accum/step0/total_loss"])
    np.testing.assert_allclose(got, j_metrics[0]["total_loss"], rtol=2e-4)
    np.testing.assert_allclose(got, losses[0], rtol=2e-4)
    params, state = state_trees({k[len("accum/state/"):]: torch.from_numpy(v)
                                 for k, v in rank.items() if k.startswith("accum/state/")})
    for mine, ref in ((params, flat_leaves(j_ts.params)), (state, flat_leaves(j_ts.state))):
        assert_trees_close(mine, ref, 5e-5)
    s_params, s_state = state_trees(final)
    assert_trees_close(params, s_params, 5e-5)
    assert_trees_close(state, s_state, 5e-5)


def test_tp_infer_matches_the_unsharded_forward(runs):
    """make_tp_infer on 2×2 (each data rank's rows, gathered here) against
    the port's unsharded forward and the reference's, atol 2e-5."""
    rank = runs["ranks"][(2, 2)]
    for field in ("cycxhw", "obj_logit", "class_logit"):
        got = rank[f"infer/infer/{field}"]
        np.testing.assert_allclose(got, getattr(runs["unsharded"], field).numpy(), atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(getattr(runs["pred"], field)), atol=2e-5)


def test_local_leaves_are_halved(runs):
    """At 1×2 the cut convs' kernels and BN leaves hold half their
    channels on a rank; the 7-channel head stays whole."""
    shapes = json.loads(str(runs["ranks"][(1, 2)]["tiny/local_shapes"]))
    assert shapes["layers.node1.w"] == [4, 3, 3, 3]
    assert shapes["layers.node2.w"] == [8, 8, 3, 3]
    for leaf in ("bn.scale", "bn.bias", "bn.mean", "bn.var"):
        assert shapes[f"layers.node1.{leaf}"] == [4] and shapes[f"layers.node2.{leaf}"] == [8]
    assert shapes["layers.head.w"] == [7, 16, 1, 1]


@pytest.mark.parametrize("kind,name", [("darknet", "yolov4-csp"),
                                       ("newslab", "yolov4-csp-custom-64x64-2021-08-21")])
def test_sharded_leaf_count_equals_the_reference(kind, name):
    """On the flagship and on cfg/train.json5's NEWSLAB model, the leaves
    the port cuts over a model axis of 2 are as many as the reference's
    ``_leaf_spec`` picks over the bridged (params, state) trees."""
    import os

    from yolodl_torch.graph.from_darknet import load_darknet_graph

    if kind == "darknet":
        graph = load_darknet_graph(os.path.join(REPO, "cfg", "darknet", f"{name}.cfg"))
    else:
        graph = Graph.load_newslab_v1_json(os.path.join(REPO, "cfg", "model", f"{name}.json5"))
    model = YoloModel(graph, device="cpu")
    plan = tp_shardings(types.SimpleNamespace(n_model=2), model)
    mine = sum(v is not None for v in plan.values())
    params, state = params_to_jax(model.state_dict())
    theirs = sum(_leaf_spec(v, 2) != () for tree in (params, state)
                 for v in flat_leaves(tree).values())
    assert mine == theirs > 100


# a grouped conv whose 4 groups divide over the model axis, then two
# [connected] layers (the first with BN): the layers a detection graph of
# the NEWSLAB configs does not hold
DENSE_CFG = """[net]
width=8
height=8
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=1
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=8
size=3
groups=4
stride=1
pad=1
activation=mish

[connected]
output=6
batch_normalize=1
activation=leaky

[connected]
output=5
activation=linear
"""

# On a 2×2 mesh: the graph cut by shard_model against the same graph whole,
# train mode on a global batch of 8 (the outputs' rows gathered over the
# data axis, a fixed linear loss), then eval mode.  Every rank prints the
# largest differences of the outputs, the gradients (summed over the data
# axis, gathered over the model axis), the BN statistics and the eval output.
DENSE_SCRIPT = r"""
import copy, sys, numpy as np, torch
torch.set_num_threads(1)
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.models.builder import GraphModel
from yolodl_torch.parallel import init_process_group, make_tp_mesh, shard_batch_tp
from yolodl_torch.parallel.mesh import destroy_process_group, gather_rows
from yolodl_torch.parallel.tp import shard_model, tp_shardings
world = init_process_group("cpu")
mesh = make_tp_mesh(2, 2)
whole = GraphModel(load_darknet_graph(sys.argv[1]), device="cpu")
part = copy.deepcopy(whole)
plan = tp_shardings(mesh, part)
cut = shard_model(mesh, part)
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.normal(size=(8, 3, 8, 8)).astype(np.float32))
w = torch.from_numpy(rng.normal(size=(8, 5)).astype(np.float32))
y = whole(x, train=True)
(y * w).sum().backward()
out = gather_rows(part(shard_batch_tp(mesh, (x,))[0], train=True), mesh.data)
(out * w).sum().backward()
err = {"out": float((out - y).abs().max())}
err = {}
ref = dict(whole.named_parameters())
for name, p in part.named_parameters():
    g = mesh.data.all_reduce_(p.grad.clone())
    if name in cut:
        g = mesh.model.all_gather(g)
    err["grad/" + name] = float((g - ref[name].grad).abs().max() / ref[name].grad.abs().max())
bufs = dict(whole.named_buffers())
for name, b in part.named_buffers():
    full = mesh.model.all_gather(b) if name in cut else b
    err["state/" + name] = float((full - bufs[name]).abs().max())
with torch.no_grad():
    e = gather_rows(part(shard_batch_tp(mesh, (x,))[0]), mesh.data)
    err["eval"] = float((e - whole(x)).abs().max())
print("cut", sorted(k for k, v in plan.items() if v is not None), file=sys.stderr)
print("errors", max(err.values()), max(err, key=err.get), file=sys.stderr)
destroy_process_group()
"""


def test_grouped_conv_and_linear_under_tp_match_the_whole_layers(tmp_path):
    """A grouped conv (each model rank holds 2 of its 4 groups) and a
    [connected] with BN, cut on a 2×2 mesh, against the same graph whole:
    gradients within 1e-5 of their largest, BN statistics (averaged over
    the data axis) and outputs within 1e-5."""
    path = tmp_path / "dense.cfg"
    path.write_text(DENSE_CFG)
    procs = start_ranks(["-c", DENSE_SCRIPT, str(path)], 4)
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        cut = [line for line in err.splitlines() if line.startswith("cut ")][0]
        for layer in ("layer0", "layer1", "layer2"):
            assert f"layers.{layer}.w" in cut, (layer, cut)
        assert "layers.layer3.w" not in cut  # 5 outputs stay whole
        worst = [line for line in err.splitlines() if line.startswith("errors ")][0].split()
        assert float(worst[1]) <= 1e-5, worst
