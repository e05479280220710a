"""Recurrent nodes under ``yolodl_torch.parallel`` pipeline parallelism with
2 stages × dp 2, against the reference's single-device
``make_train_step(accum=2)`` and the port's single process; and under data
parallelism, against the reference's ``shard_map`` DP step.

The reference's pipeline runs each stage over a micro-batch sharded over
its data devices with global-array semantics
(``yolodl_tpu/parallel/pipeline.py:214-215``), so a recurrent node's time
split runs over the micro-batch's global rows; its numbers are the
single-device accumulation step's.  The model is
``_torch_parity.recurrent_cfg`` (``bn``: BN in the first [crnn] and the
[rnn]; ``nobn``: in none of the four recurrent nodes); ``plan_stages``
cuts it right after the first [crnn], so stage 0 ends in a recurrent node
(its gather runs in the forward wavefront and again in the recompute) and
stage 1 holds the other three.  Ranks over gloo (``PP_RANK_SCRIPT``): one
SGD step (momentum 0.9, lr 1e-2) of 2 micro-batches on a global batch of
32 seeded images, 16 a micro-batch (8 rows a time step), 8 a rank; a
``remat="blocks"`` case beside.

Tolerances: the loss within rel 1e-4 of the reference's and 1e-5 of the
port's single process; every parameter and BN statistic within
1e-4 · max|ref| per tensor after the step, against both; the data ranks of
a stage end the step bit-identical (BN running statistics included).

Data parallelism keeps the per-rank time split, as the reference's
``shard_map`` body does (``yolodl_tpu/parallel/dp.py:129``): 2 ranks of
``DP_RANK_SCRIPT`` on the ``bn`` model (8 images a rank) against
``yolodl_tpu.parallel.make_dp_train_step``, with test_torch_dp.py's
limits, and on the ``nobn`` model, whose DP loss differs from the single
process's over the global batch.  Neither the DP nor the spatial step
gives a recurrent node a parallel context.
"""

import types

import numpy as np
import pytest
import torch

from _torch_parity import (assert_dp_matches_reference, assert_ranks_identical, assert_trees_close,
                           flat_leaves, port_single, recurrent_batches, recurrent_detector,
                           reference_dp, start_dp_ranks, start_pp_ranks, state_trees,
                           train_configs, train_reference, wait_ranks)
from yolodl_torch.parallel import make_dp_train_step
from yolodl_torch.parallel.spatial_model import make_spatial_train_step
from yolodl_torch.parallel.tp import _RECURRENT
from yolodl_torch.train import loop

torch.set_num_threads(2)

SGD = dict(optimizer="sgd", momentum=0.9, lr=1e-2)
STEP_CASES = {"bn": dict(bn=True), "nobn": dict(bn=False),
              "remat": dict(bn=True, remat="blocks")}
DP_CASES = ("bn", "nobn")


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_recurrent")
    return tmp, {bn: recurrent_detector(tmp, bn) for bn in (True, False)}


@pytest.fixture(scope="module")
def runs(models, devices8):
    """The 4 pipeline ranks and the 2 DP ranks run while this process runs
    the references and the port's single-process steps."""
    tmp, by_bn = models
    batch = recurrent_batches(1, 32, seed=2)
    dp_batch = recurrent_batches(1, 16, seed=3)
    cases = {}
    for name, case in STEP_CASES.items():
        path, *_, init = by_bn[case["bn"]]
        cases[name] = {"model": path, "init": init, "config": SGD, "stages": 2, "dp": 2,
                       "accum": 2, "steps": 1, **({"remat": case["remat"]} if "remat" in case
                                                  else {})}
    (tmp / "pp").mkdir()
    (tmp / "dp").mkdir()
    pp, pp_out = start_pp_ranks(tmp / "pp", cases, batch, 4)
    dp, dp_out = start_dp_ranks(tmp / "dp", {
        name: {"model": by_bn[name == "bn"][0], "init": by_bn[name == "bn"][-1],
               "config": SGD, "steps": 1} for name in DP_CASES}, dp_batch)
    j_cfg, t_cfg = train_configs(**SGD)
    refs, singles, dp_refs, dp_singles = {}, {}, {}, {}
    for bn in (True, False):
        _, jm, params, state, tm, init = by_bn[bn]
        refs[bn] = train_reference(jm, params, state, j_cfg, batch, accum=2)
        tm.load_state_dict(init)
        singles[bn] = port_single(tm, t_cfg, batch, accum=2)
        name = "bn" if bn else "nobn"
        dp_refs[name] = reference_dp(jm, params, state, j_cfg, dp_batch)
        tm.load_state_dict(init)
        dp_singles[name] = port_single(tm, t_cfg, dp_batch)[2]
    wait_ranks(pp, timeout=300)
    wait_ranks(dp)
    return dict(refs=refs, singles=singles, dp_refs=dp_refs, dp_singles=dp_singles,
                pp=[dict(np.load(f"{pp_out}.r{r}.npz")) for r in range(4)],
                dp=[dict(np.load(f"{dp_out}.r{r}.npz")) for r in range(2)])


def merged(rank0, name):
    return tuple({k[len(p):]: v for k, v in rank0.items() if k.startswith(p)}
                 for p in (f"{name}/final/params/", f"{name}/final/state/"))


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_pipeline_step_on_recurrent_nodes_matches_the_single_device_step(runs, name):
    """One GPipe step of 2 stages × dp 2: the loss, the matches, every
    parameter and BN statistic against the reference's and the port's
    single-device accumulation steps on the global batch."""
    bn = STEP_CASES[name]["bn"]
    rank0 = runs["pp"][0]
    j_ts, j_losses = runs["refs"][bn]
    _, final, losses = runs["singles"][bn]
    got = float(rank0[f"{name}/step0/total_loss"])
    np.testing.assert_allclose(got, j_losses[0], rtol=1e-4)
    np.testing.assert_allclose(got, losses[0], rtol=1e-5)
    assert int(rank0[f"{name}/step0/num_matched"]) > 0
    params, state = merged(rank0, name)
    assert_trees_close(params, flat_leaves(j_ts.params), 1e-4, rel=True)
    assert_trees_close(state, flat_leaves(j_ts.state), 1e-4, rel=True)
    s_params, s_state = state_trees(final)
    assert_trees_close(params, s_params, 1e-4, rel=True)
    assert_trees_close(state, s_state, 1e-4, rel=True)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_data_ranks_of_a_stage_hold_one_state(runs, name):
    """Rank r holds stage r // 2 at data index r % 2: the two data ranks
    of each stage end the step with the same parameters and BN running
    statistics, and the stages hold different nodes."""
    d = [str(r[f"{name}/digest/{i}"]) for i, r in enumerate(runs["pp"])]
    assert d[0] == d[1] and d[2] == d[3] and d[0] != d[2]


@pytest.mark.parametrize("name", DP_CASES)
def test_dp_keeps_the_per_rank_time_split(runs, name):
    """DP on a recurrent detector equals the reference's shard_map DP step
    (each replica splits its own rows into time steps); without BN its
    loss is not the single process's over the global batch, whose split
    mixes the ranks' rows."""
    assert_ranks_identical(runs["dp"], name)
    assert_dp_matches_reference(runs["dp"][0], name, *runs["dp_refs"][name])
    if name == "nobn":
        got = float(runs["dp"][0]["nobn/step0/total_loss"])
        assert abs(got / runs["dp_singles"]["nobn"][0] - 1) > 1e-4


def test_dp_and_spatial_steps_give_recurrent_nodes_no_context(models):
    """Building the DP and the data × space steps leaves every recurrent
    node and sub-layer without a parallel context: their time loop runs
    on the rank's (or the data replica's) own rows."""
    _, by_bn = models
    tm = by_bn[True][4]
    _, t_cfg = train_configs(**SGD)
    ts, opt = loop.train_init(tm, t_cfg)
    make_dp_train_step(tm, opt, t_cfg, types.SimpleNamespace(world_size=2, rank=0))
    make_spatial_train_step(tm, opt, t_cfg, types.SimpleNamespace(n_space=2, n_data=2))
    nodes = [tm._node(k) for k in tm.graph.order
             if isinstance(tm.graph.nodes[k].config, _RECURRENT)]
    assert len(nodes) == 4
    assert all(m.shard is None and all(s.shard is None for s in m.values()) for m in nodes)
