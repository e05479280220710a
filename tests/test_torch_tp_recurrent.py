"""Recurrent nodes under ``yolodl_torch.parallel`` tensor parallelism over
several data ranks, against the reference's single-device
``make_train_step``: the reference's TP step is that step compiled under
GSPMD (``yolodl_tpu/parallel/tp.py`` ``make_tp_train_step``, "exactly the
single-device step's"), so its time split ``x.reshape(T, N/T, …)`` runs
over the global rows of the micro-batch.

The model is ``_torch_parity.recurrent_cfg``: a 32² detector with a
[crnn] on 16×16 maps, and on a pooled branch an [lstm], an [rnn] and a 1×1
[crnn], ``time_steps=2``; with BN in the first [crnn] and the [rnn]
(``bn``), and a second model with BN in none of its recurrent nodes
(``nobn``).  The reference's seeded weights go through the bridge; the
global batch holds 16 seeded images (8 rows a time step), 32 with
``accum=2``.  The port's ranks are processes over gloo (``TP_RANK_SCRIPT``):
a 2×2 data × model mesh of 4 ranks for TP (accum 1 and 2), TP × ZeRO-1,
the BN-free model and ``make_tp_infer``; every recurrent sub-layer of
these models is cut over the model axis.  One SGD step (momentum 0.9, lr
1e-2).

Tolerances: the loss within rel 1e-4 of the reference's and 1e-5 of the
port's single process over the global batch; every parameter and BN
statistic within 1e-4 · max|ref| per tensor after the step, against both;
``make_tp_infer`` within test_torch_tp.py's atol 2e-5.  The BN-free case
is the one that a per-rank time split gets wrong without raising (the
hidden state then passes between other rows); with BN, that split used to
raise.  ``odd`` runs the BN-free model on a global batch of 6 rows: 3 a
data rank, which ``time_steps=2`` does not divide, while the global 6 it
does (the reference's ``_split_time`` checks the global rows).

``gather_rows_summed``'s backward in float64 (``F64_SCRIPT``, 4 more
ranks): the BN model cut by ``shard_model`` on 2×2 against the same model
whole, train mode on the global batch and a fixed linear loss of the raw
heads: the heads, every parameter's gradient (summed over the data axis,
gathered over the model axis), every BN statistic and the eval heads
within 1e-9 · max of the whole model's.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, flat_leaves, port_single, recurrent_batches,
                           recurrent_detector, start_ranks, start_tp_ranks, state_trees,
                           train_configs, train_reference, wait_ranks)

torch.set_num_threads(2)

SGD = dict(optimizer="sgd", momentum=0.9, lr=1e-2)
STEP_CASES = {"tp": dict(mode="tp"), "accum": dict(mode="tp", accum=2),
              "zero": dict(mode="tp_zero"), "nobn": dict(mode="tp"),
              "odd": dict(mode="tp", rows=6)}
BN = {"tp": True, "accum": True, "zero": True, "nobn": False, "odd": False}

# One rank of a 2×2 mesh: the BN model cut by shard_model against the same
# model whole, in float64 (see the module's doc); prints the largest
# relative difference and where.
F64_SCRIPT = r"""
import copy, sys, numpy as np, torch
torch.set_num_threads(1)
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.models.builder import GraphModel
from yolodl_torch.parallel import init_process_group, make_tp_mesh, shard_batch_tp
from yolodl_torch.parallel.mesh import destroy_process_group, gather_rows
from yolodl_torch.parallel.tp import shard_model
world = init_process_group("cpu")
mesh = make_tp_mesh(2, 2)
graph = load_darknet_graph(sys.argv[1])
heads = tuple(graph.detect_head_input_keys())
whole = GraphModel(graph, device="cpu").to(torch.float64)
part = copy.deepcopy(whole)
cut = shard_model(mesh, part)
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.uniform(0, 1, size=(16, 3, 32, 32)))

def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

y = whole(x, train=True, output_keys=heads)
ws = [torch.from_numpy(rng.normal(size=tuple(y[k].shape))) for k in heads]
sum((y[k] * w).sum() for k, w in zip(heads, ws)).backward()
out = part(shard_batch_tp(mesh, (x,))[0], train=True, output_keys=heads)
out = {k: gather_rows(v, mesh.data) for k, v in out.items()}
sum((out[k] * w).sum() for k, w in zip(heads, ws)).backward()
err = {f"head/{k}": rel(out[k], y[k]) for k in heads}
ref = dict(whole.named_parameters())
for name, p in part.named_parameters():
    g = mesh.data.all_reduce_(p.grad.clone())
    if name in cut:
        g = mesh.model.all_gather(g)
    err["grad/" + name] = rel(g, ref[name].grad)
bufs = dict(whole.named_buffers())
for name, b in part.named_buffers():
    err["state/" + name] = rel(mesh.model.all_gather(b) if name in cut else b, bufs[name])
with torch.no_grad():
    e = part(shard_batch_tp(mesh, (x,))[0], output_keys=heads)
    w = whole(x, output_keys=heads)
    for k in heads:
        err[f"eval/{k}"] = rel(gather_rows(e[k], mesh.data), w[k])
print("cut", len(cut), file=sys.stderr)
print("errors", max(err.values()), max(err, key=err.get), file=sys.stderr)
destroy_process_group()
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    """The 4 TP ranks and the 4 float64 ranks run while this process runs
    the reference's and the port's single-device steps."""
    tmp = tmp_path_factory.mktemp("tp_recurrent")
    models = {bn: recurrent_detector(tmp, bn) for bn in (True, False)}
    batches = {name: recurrent_batches(1, case.get("rows", 16 * case.get("accum", 1)), seed=i)
               for i, (name, case) in enumerate(STEP_CASES.items())}
    batches["zero"] = batches["tp"]  # TP x ZeRO-1 has TP's numbers
    (tmp / "tp").mkdir()
    cases = {}
    for name, case in STEP_CASES.items():
        path, *_, init = models[BN[name]]
        cases[name] = {"mode": case["mode"], "accum": case.get("accum", 1), "model": path,
                       "init": init, "config": SGD, "mesh": [2, 2], "steps": 1,
                       "batches": batches[name]}
    path, jm, params, state, tm, init = models[True]
    cases["infer"] = {"mode": "infer", "model": path, "init": init, "config": SGD,
                      "mesh": [2, 2], "batches": batches["tp"]}
    procs, out = start_tp_ranks(tmp / "tp", cases, batches["tp"], 4)
    f64 = start_ranks(["-c", F64_SCRIPT, path], 4)
    j_cfg, t_cfg = train_configs(**SGD)
    refs, singles = {}, {}
    for name, case in STEP_CASES.items():
        if name == "zero":
            continue
        _, jm_, params_, state_, tm_, init_ = models[BN[name]]
        accum = case.get("accum", 1)
        refs[name] = train_reference(jm_, params_, state_, j_cfg, batches[name], accum=accum)
        tm_.load_state_dict(init_)
        singles[name] = port_single(tm_, t_cfg, batches[name], accum=accum)
    refs["zero"], singles["zero"] = refs["tp"], singles["tp"]
    pred, _ = jm.apply(params, state, jnp.asarray(batches["tp"][0][0]), train=False)
    tm.load_state_dict(init)
    with torch.no_grad():
        unsharded = tm(torch.from_numpy(batches["tp"][0][0]))
    wait_ranks(procs)
    errs = wait_ranks(f64)
    ranks = [dict(np.load(f"{out}.r{r}.npz")) for r in range(4)]
    return dict(refs=refs, singles=singles, ranks=ranks, pred=pred, unsharded=unsharded,
                f64=errs)


def rank_trees(rank, name):
    prefix = f"{name}/state/"
    return state_trees({k[len(prefix):]: torch.from_numpy(v)
                        for k, v in rank.items() if k.startswith(prefix)})


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_tp_step_on_recurrent_nodes_matches_the_single_device_step(runs, name):
    """One step on the 2×2 mesh: the loss, the matches, every parameter
    and BN statistic against the reference's single-device step and the
    port's single process on the global batch."""
    rank = runs["ranks"][0]
    j_ts, j_losses = runs["refs"][name]
    _, final, losses = runs["singles"][name]
    got = float(rank[f"{name}/step0/total_loss"])
    np.testing.assert_allclose(got, j_losses[0], rtol=1e-4)
    np.testing.assert_allclose(got, losses[0], rtol=1e-5)
    assert int(rank[f"{name}/step0/num_matched"]) > 0
    params, state = rank_trees(rank, name)
    assert_trees_close(params, flat_leaves(j_ts.params), 1e-4, rel=True)
    assert_trees_close(state, flat_leaves(j_ts.state), 1e-4, rel=True)
    s_params, s_state = state_trees(final)
    assert_trees_close(params, s_params, 1e-4, rel=True)
    assert_trees_close(state, s_state, 1e-4, rel=True)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_data_ranks_hold_one_state(runs, name):
    """The data ranks of one model index end the step with the same
    shards, BN running statistics included; the two model indices hold
    different shards."""
    d = [str(r[f"{name}/digest"]) for r in runs["ranks"]]
    assert d[0] == d[2] and d[1] == d[3] and d[0] != d[1]


def test_every_recurrent_sub_layer_is_cut(runs):
    """Over a model axis of 2 each sub-layer of the four recurrent nodes
    holds half its output features on a rank (the reference's
    ``_leaf_spec`` cuts every one of them: 8 or 18 outputs)."""
    shapes = json.loads(str(runs["ranks"][0]["tp/local_shapes"]))
    subs = {k: v for k, v in shapes.items()
            if k.split(".")[1] in ("layer1", "layer7", "layer8", "layer9")}
    assert len({k.split(".")[2] for k in subs}) == 3 + 8  # rnn/crnn's three, lstm's eight
    for k, v in subs.items():
        assert v[0] in (4, 9), (k, v)


def test_tp_infer_on_recurrent_nodes_matches_the_unsharded_forward(runs):
    """make_tp_infer on 2×2 (each data rank's rows, gathered here) against
    the port's unsharded forward and the reference's, atol 2e-5."""
    rank = runs["ranks"][0]
    for field in ("cycxhw", "obj_logit", "class_logit"):
        got = rank[f"infer/infer/{field}"]
        np.testing.assert_allclose(got, getattr(runs["unsharded"], field).numpy(), atol=2e-5)
        np.testing.assert_allclose(got, np.asarray(getattr(runs["pred"], field)), atol=2e-5)


def test_gather_backward_in_float64(runs):
    """The row gather's reduce-scatter backward (and the cut sub-layers) in
    float64: every head, gradient, BN statistic and eval head of every rank
    within 1e-9 · max of the whole model's."""
    for err in runs["f64"]:
        lines = err.splitlines()
        assert int(next(line for line in lines if line.startswith("cut ")).split()[1]) > 0
        worst = next(line for line in lines if line.startswith("errors ")).split()
        assert float(worst[1]) <= 1e-9, worst
