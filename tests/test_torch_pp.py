"""``yolodl_torch.parallel`` GPipe training steps against the port's own
single-process accumulation step and the reference's
(``yolodl_tpu.train.loop.make_train_step(accum=2)``, and for 3 stages
``yolodl_tpu.parallel.pipeline.PipelineTrainStep`` on the 8 virtual CPU
devices of tests/conftest.py).  The forward, the split/merge round trip and
the step's config rejections are in test_torch_pp_model.py; 4 stages with a
pass-through tensor in test_torch_pp_csp.py.

The model is tests/test_pipeline.py's ``tiny_model``: yolov4-tiny at 96²
with 3 classes, the reference's seeded weights carried across by the
bridge.  The port's ranks are processes joined over gloo
(``PP_RANK_SCRIPT`` of tests/_torch_parity.py): 3 stages, 2 stages × dp 2,
and 2 stages under ``remat="blocks"``, each taking two SGD steps (momentum
0.9, lr 1e-3, as the reference test) of 2 micro-batches on two seeded
global batches of 4 images; stage 0 alone reads the images and targets,
the other stages get their shapes on the meta device.

Tolerances.  Against the port's single process the reference test's
(tests/test_pipeline.py:171-232): the loss within 1e-5, parameters within
3e-6, BN statistics within 1e-5.  2 stages × dp 2 needs more: 1e-4 on
parameters and BN statistics, since the synchronized BN averages each
half's E[x] and E[x²] in f32 and the one-pass variance's cancellation,
amplified by two steps, moves parameters by up to 8.2e-5 (the same step
in float64 agrees to 6e-8, and the tensor-parallel step over a data axis
of 2, ``make_tp_mesh(2, 1)``, differs from the single process by the same
8.2e-5; measured on this sandbox's CPU).  Against the reference
(another framework's f32 convolutions and BN) test_torch_train.py's SGD
limits: losses within rel 1e-4, every tensor within 3e-4 · max|ref|.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, flat_leaves, port_single, pp_batches, pp_tiny,
                           start_pp_ranks, state_trees, wait_ranks)
from yolodl_tpu.parallel.pipeline import PipelineModel as JPipelineModel
from yolodl_tpu.parallel.pipeline import PipelineTrainStep as JPipelineTrainStep
from yolodl_tpu.train import loop as j_loop
from yolodl_torch import parallel as par
from yolodl_torch.train import loop
from yolodl_torch.train.lr_schedule import LrScheduleConfig

torch.set_num_threads(2)

SGD = dict(optimizer="sgd", momentum=0.9, lr=1e-3)
STEP_CASES = {"three": dict(stages=3), "dp": dict(stages=2, dp=2),
              "remat": dict(stages=2, remat="blocks")}
PARAM_TOL = {"three": 3e-6, "dp": 1e-4, "remat": 3e-6}
STATE_TOL = {"three": 1e-5, "dp": 1e-4, "remat": 1e-5}


def reference_steps(jm, params, state, batches, pipeline_stages=None):
    """The reference's accumulation step (or its PipelineTrainStep over
    ``pipeline_stages``) → (losses, num_matched, flat params, flat state)."""
    config = j_loop.TrainConfig(optimizer="sgd", momentum=0.9)
    p, s = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, state))
    losses, matched = [], []
    if pipeline_stages:
        pp = JPipelineModel(jm, pipeline_stages)
        step = JPipelineTrainStep(pp, config, n_micro=2)
        ps, ss = pp.split_params(p), pp.split_state(s)
        opts = step.init_opt(ps)
        for b in batches:
            ps, ss, opts, m = step(ps, ss, opts, *b)
            losses.append(float(m["total_loss"]))
            matched.append(int(m["num_matched"]))
        p, s = pp.merge_params(ps), pp.merge_state(ss)
    else:
        opt = j_loop.make_optimizer(config)
        ts = j_loop.TrainState(p, s, opt.init(p), jnp.zeros((), jnp.int32), None)
        step = j_loop.make_train_step(jm, opt, config, accum=2)
        for b in batches:
            ts, m = step(ts, *map(jnp.asarray, b))
            losses.append(float(m["total_loss"]))
            matched.append(int(m["num_matched"]))
        p, s = ts.params, ts.state
    return losses, matched, flat_leaves(jax.device_get(p)), flat_leaves(jax.device_get(s))


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp")
    return (tmp, *pp_tiny(tmp))


@pytest.fixture(scope="module")
def runs(tiny, devices8):
    """Three rank groups at once (3, 4 and 2 ranks) while this process runs
    the references and the port's single-process steps."""
    tmp, path, jm, params, state, tm, init = tiny
    data = pp_batches()
    common = {"model": path, "init": init, "config": SGD, "accum": 2, "steps": 2}
    groups = {
        3: {"three": {**common, **STEP_CASES["three"]}},
        4: {"dp": {**common, **STEP_CASES["dp"]},
            "reject": {**common, "stages": 2, "dp": 2, "mode": "reject"}},
        2: {"remat": {**common, **STEP_CASES["remat"]}},
    }
    started = {}
    for n, cases in groups.items():
        (tmp / f"g{n}").mkdir()
        started[n] = start_pp_ranks(tmp / f"g{n}", cases, data, n)
    t_cfg = loop.TrainConfig(lr=LrScheduleConfig(kind="constant", lr=SGD["lr"]),
                             optimizer="sgd", momentum=0.9)
    tm.load_state_dict(init)
    single = port_single(tm, t_cfg, data, accum=2)
    tm.load_state_dict(init)
    with torch.no_grad():  # one train-mode forward per micro-batch of the first batch
        for m in range(2):
            tm(torch.from_numpy(data[0][0][2 * m:2 * m + 2]), train=True)
    forward_state = state_trees(tm.state_dict())[1]
    refs = {"accum": reference_steps(jm, params, state, data),
            "pipeline": reference_steps(jm, params, state, data, pipeline_stages=3)}
    ranks = {}
    for n, (procs, prefix) in started.items():
        wait_ranks(procs, timeout=300)
        ranks[n] = [dict(np.load(f"{prefix}.r{r}.npz")) for r in range(n)]
    return dict(ranks=ranks, single=single, refs=refs, forward_state=forward_state)


def case_ranks(runs, name):
    return next(r for r in runs["ranks"].values() if any(k.startswith(f"{name}/") for k in r[0]))


def merged(rank0, name, which):
    """Rank 0's merged (params, state) leaves of case ``name``."""
    return tuple({k[len(p):]: v for k, v in rank0.items() if k.startswith(p)}
                 for p in (f"{name}/{which}/params/", f"{name}/{which}/state/"))


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_gpipe_step_matches_accumulation_steps(runs, name):
    """Two GPipe steps: loss, num_matched, parameters and BN statistics
    after each against the port's make_train_step(accum=2) on the global
    batches, and after both against the reference's accumulation step."""
    rank0 = case_ranks(runs, name)[0]
    first, final, losses = runs["single"]
    r_losses, r_matched, r_params, r_state = runs["refs"]["accum"]
    for i in range(2):
        got = float(rank0[f"{name}/step{i}/total_loss"])
        assert abs(got - losses[i]) <= 1e-5, (i, got, losses[i])
        np.testing.assert_allclose(got, r_losses[i], rtol=1e-4)
        assert int(rank0[f"{name}/step{i}/num_matched"]) == r_matched[i] > 0
    for which, single in (("first", first), ("final", final)):
        params, state = merged(rank0, name, which)
        s_params, s_state = state_trees(single)
        assert_trees_close(params, s_params, PARAM_TOL[name])
        assert_trees_close(state, s_state, STATE_TOL[name])
    params, state = merged(rank0, name, "final")
    assert_trees_close(params, r_params, 3e-4, rel=True)
    assert_trees_close(state, r_state, 3e-4, rel=True)


def test_three_stages_match_the_reference_pipeline(runs):
    """The 3-stage run against the reference's own PipelineTrainStep over
    3 devices (test_torch_train.py's SGD limits)."""
    rank0 = case_ranks(runs, "three")[0]
    losses, matched, r_params, r_state = runs["refs"]["pipeline"]
    np.testing.assert_allclose([float(rank0[f"three/step{i}/total_loss"]) for i in range(2)],
                               losses, rtol=1e-4)
    assert [int(rank0[f"three/step{i}/num_matched"]) for i in range(2)] == matched
    params, state = merged(rank0, "three", "final")
    assert_trees_close(params, r_params, 3e-4, rel=True)
    assert_trees_close(state, r_state, 3e-4, rel=True)


def test_recompute_leaves_bn_statistics_as_one_forward(runs):
    """After one step each stage's BN statistics are those of one
    train-mode forward per micro-batch: the backward's recompute does not
    apply the momentum a second time."""
    for name in ("three", "remat"):
        _, state = merged(case_ranks(runs, name)[0], name, "first")
        assert_trees_close(state, runs["forward_state"], 1e-6)


@pytest.mark.parametrize("name,n_ranks", [("three", 3), ("dp", 4)])
def test_each_rank_holds_only_its_stage(tiny, runs, name, n_ranks):
    """Every rank's state_dict holds exactly its stage's nodes; the stages
    partition the model and the data ranks of a stage hold the same."""
    *_, tm, init = tiny
    stages = STEP_CASES[name]["stages"]
    dp = n_ranks // stages
    plans = par.plan_stages(tm, stages)
    held = [set(json.loads(str(r[f"{name}/local/{i}"])))
            for i, r in enumerate(runs["ranks"][n_ranks])]
    for rank, keys in enumerate(held):
        nodes = {tm._pname[k] for k in plans[rank // dp].keys}
        assert keys and {k.split(".")[1].replace("/", ".") for k in keys} <= nodes
    stage_keys = [held[s * dp] for s in range(stages)]
    assert set().union(*stage_keys) == set(init)
    assert sum(len(k) for k in stage_keys) == len(init)
    assert all(held[s * dp + d] == held[s * dp] for s in range(stages) for d in range(dp))


def test_batch_rejections(runs):
    """A batch that n_micro does not divide, and a micro-batch that dp does
    not divide, raise the reference's errors on every rank."""
    for r, rank in enumerate(runs["ranks"][4]):
        errors = json.loads(str(rank[f"reject/errors/{r}"]))
        assert errors == ["batch size 4 not divisible by n_micro 3",
                          "microbatch size 3 not divisible by the per-stage data-parallel "
                          "degree dp=2"], (r, errors)
