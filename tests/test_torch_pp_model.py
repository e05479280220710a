"""``yolodl_torch.parallel.PipelineModel``: the pipelined forward against the
reference's ``model.apply``, the split/merge round trip of parameters, BN
statistics and the optimizer tree, and the rejections of
``PipelineTrainStep`` and ``make_pp_mesh`` in the reference's words
(tests/test_pipeline.py).  The training steps are in test_torch_pp.py.

The model is tests/test_pipeline.py's ``tiny_model`` (yolov4-tiny at 96²,
3 classes) with the reference's seeded weights carried across by the
bridge; the ranks are gloo processes (``PP_RANK_SCRIPT`` of
tests/_torch_parity.py): 3 stages, and 2 stages × dp 2.

Tolerances: the forward's outputs within rtol 1e-4 and atol
1e-4 · max|ref| of the reference's (assert_forward_matches: f32
convolutions summed in another order); the BN statistics of the
train-mode forward within the reference test's 1e-5.  The round trip is
exact.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_trees_close, flat_leaves, pp_batches, pp_tiny, start_pp_ranks,
                           wait_ranks)
from yolodl_torch import parallel as par
from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.models import YoloModel
from yolodl_torch.parallel.mesh import destroy_process_group, free_port, init_process_group
from yolodl_torch.train import loop

torch.set_num_threads(2)

SGD = dict(optimizer="sgd", momentum=0.9, lr=1e-3)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_model")
    return (tmp, *pp_tiny(tmp))


@pytest.fixture(scope="module")
def runs(tiny):
    """A 3-rank and a 4-rank group at once while this process runs the
    reference's forward."""
    tmp, path, jm, params, state, tm, init = tiny
    data = pp_batches(1)
    common = {"model": path, "init": init, "config": SGD}
    groups = {
        3: {"forward3": {**common, "stages": 3, "mode": "forward"},
            "rt_adam": {**common, "stages": 3, "mode": "roundtrip",
                        "config": dict(optimizer="adam", lr=1e-3)},
            "rt_sgd": {**common, "stages": 3, "mode": "roundtrip"},
            "targets": {**common, "stages": 3, "mode": "targets"}},
        4: {"forward_dp": {**common, "stages": 2, "dp": 2, "mode": "forward"}},
    }
    started = {}
    for n, cases in groups.items():
        (tmp / f"g{n}").mkdir()
        started[n] = start_pp_ranks(tmp / f"g{n}", cases, data, n)
    p, s = (jax.tree_util.tree_map(jnp.asarray, t) for t in (params, state))
    x = jnp.asarray(data[0][0])
    j_eval, _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False))(p, s, x)
    _, j_state = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=True))(p, s, x)
    ranks = {}
    for n, (procs, prefix) in started.items():
        wait_ranks(procs, timeout=300)
        ranks[n] = [dict(np.load(f"{prefix}.r{r}.npz")) for r in range(n)]
    return dict(ranks=ranks, j_eval=j_eval, j_state=flat_leaves(jax.device_get(j_state)))


@pytest.mark.parametrize("name,n_ranks,dp", [("forward3", 3, 1), ("forward_dp", 4, 2)])
def test_forward_matches_reference_apply(runs, name, n_ranks, dp):
    """PipelineModel.forward in eval mode against the reference's apply on
    the same 4 images (the last stage of each data index holds its rows),
    then in train mode: the merged BN statistics against the reference's
    new_state (with dp 2, normalized over the 4 images, as GSPMD does)."""
    ranks = runs["ranks"][n_ranks]
    for f in ("cycxhw", "obj_logit", "class_logit"):
        ref = np.asarray(getattr(runs["j_eval"], f))
        got = np.concatenate([ranks[n_ranks - dp + d][f"{name}/False/{f}/{d}"]
                              for d in range(dp)])
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max(), err_msg=f)
    state = {k[len(f"{name}/state/"):]: v for k, v in ranks[0].items()
             if k.startswith(f"{name}/state/")}
    assert_trees_close(state, runs["j_state"], 1e-5)


@pytest.mark.parametrize("name", ["rt_adam", "rt_sgd"])
def test_split_merge_round_trip(runs, name):
    """After one Adam or SGD step of the whole model, the cut: each stage's
    parameters, BN statistics and optimizer tree equal split_* of the whole
    ones, and merge_* of the split trees (and of the live stages) gives
    the whole ones back on rank 0."""
    ranks = runs["ranks"][3]
    for r, rank in enumerate(ranks):
        checks = json.loads(str(rank[f"{name}/checks/{r}"]))
        assert all(checks.values()), (r, checks)
    assert {"merged", "merged_live"} <= set(json.loads(str(ranks[0][f"{name}/checks/0"])))


def test_targets_layout_mismatch_names_the_target(runs):
    """Stage 0 sends the targets' layout first: a last stage whose
    arguments give the classes another dtype raises, naming them, before
    it receives the tensors."""
    errors = json.loads(str(runs["ranks"][3][2]["targets/errors/2"]))
    assert len(errors) == 1
    assert re.fullmatch(r"pipeline: the target gt_classes from stage 0 is \(4, \d+\) "
                        r"torch\.int32; this stage expects \(4, \d+\) torch\.int64",
                        errors[0]), errors


@pytest.fixture
def solo(tiny):
    """A process group of one rank in this process, a one-stage pipeline."""
    path = tiny[1]
    init_process_group("cpu", init_method=f"tcp://127.0.0.1:{free_port()}", rank=0,
                       world_size=1)
    try:
        model = YoloModel(load_darknet_graph(path), device="cpu")
        yield par.PipelineModel(model, par.make_pp_mesh(1, 1))
    finally:
        destroy_process_group()


@pytest.mark.parametrize("kwargs,n_micro,message", [
    (dict(clip_grad_norm=1.0), 2, "clip_grad_norm requires a cross-stage global norm"),
    (dict(use_ema=True), 2, "EMA is not supported under pipeline parallelism"),
    ({}, 0, "n_micro must be >= 1, got 0"),
])
def test_step_rejects_what_the_reference_rejects(solo, kwargs, n_micro, message):
    with pytest.raises(ValueError, match=message):
        par.PipelineTrainStep(solo, loop.TrainConfig(**kwargs), n_micro)


def test_pipeline_mesh_rejects_missing_devices(solo):
    with pytest.raises(ValueError, match="2 stages x dp=1 need 2 devices, have 1"):
        par.make_pp_mesh(2, 1)
