"""``yolodl_torch.parallel.make_dp_train_step`` over 2 ranks against
``yolodl_tpu.parallel.make_dp_train_step`` on a 2-device mesh (the 8
virtual CPU devices of tests/conftest.py).

The port's ranks are processes joined over gloo (``DP_RANK_SCRIPT`` of
tests/_torch_parity.py, torchrun's variables); each takes its rows of the
same seeded global batches (16 images, 8 a rank; yolov4-tiny at 64², with
BN) from the same weights carried through the bridge.  Rank 1 starts from other weights,
which ``replicate_state`` must replace with rank 0's.  With BN, each rank
normalizes with its own rows' statistics and the running statistics are
averaged after the step, as the reference's ``pmean`` does; that is what
is compared.  Cases here: SGD over 3 steps, and ``accum=2``
(test_torch_dp_opts.py: remat, the darknet loss, clipping with the
maxima); plus the BN-free property of the reference's
tests/test_train.py:317: 2 ranks track the port's own single-process step
over the global batch.

Tolerances: every step's loss within rtol 1e-5 and ``num_matched`` exact,
as in test_torch_train_step.py; the two ranks bit-identical; parameters and
BN state within 1e-4 · max|ref| per tensor after the first step and within
test_torch_train.py's multi-step limit, 3e-4 · max|ref|, after the last.
test_torch_train_step.py's one-step 1e-5 holds on its own two rows; on
these rows the port's and the reference's single-device steps already
differ by up to 7.5e-5 · max|ref| (layer18/w, rows 8-15 with ``accum=2``;
1.7e-5 at layer35/w on rows 0-7): train-mode BN over few rows at
yolov4-tiny's 4×4 maps is ill-conditioned in both packages (ROADMAP C
"Sizes, not faults"), so the data-parallel step cannot be held closer than
the single-device one.  Eight rows a rank keep a micro-batch of
``accum=2`` at four (over two, the single-device steps differ by 4.4e-5 on
this seed's first two rows).  The BN-free property holds to the reference
test's own limits: loss rtol 2e-4, parameters atol 5e-5.
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import (assert_dp_matches_reference, assert_ranks_identical, dp_batches,
                           dp_case_runs, train_configs)
from yolodl_torch.graph import Graph
from yolodl_torch.models import YoloModel
from yolodl_torch.train import loop as t_loop

torch.set_num_threads(2)

CASES = {
    "sgd_3_steps": dict(config=dict(optimizer="sgd", lr=3e-4), steps=3),
    "accum_2": dict(config=dict(optimizer="sgd", lr=3e-4, momentum=0.9), steps=2, accum=2),
}
BN_FREE = {"main_group": "m", "groups": {"m": [
    {"name": "input", "kind": "Input", "shape": ["_", 3, 64, 64]},
    {"kind": "ConvBn2D", "c": 8, "k": 3, "s": 2, "bn": {"enabled": False}},
    {"kind": "ConvBn2D", "c": 16, "k": 3, "s": 2, "bn": {"enabled": False}},
    {"name": "head", "kind": "ConvBn2D", "c": 85, "k": 1, "act": "linear",
     "bn": {"enabled": False}},
    {"name": "det", "kind": "Detect2D", "classes": 80, "anchors": [[0.3, 0.3]]},
    {"name": "output", "kind": "MergeDetect2D", "from": ["det"]},
]}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks run every case (and the BN-free one) while the reference
    runs its DP steps in this process (tests/_torch_parity.py
    dp_case_runs)."""
    tmp = tmp_path_factory.mktemp("dp")
    batches = dp_batches(3, 16, seed=5)
    bn_free = tmp / "bn_free.json5"
    bn_free.write_text(json.dumps(BN_FREE))
    free_model = YoloModel(Graph.load_newslab_v1_json(str(bn_free)), device="cpu",
                           generator=torch.Generator().manual_seed(3))
    extra = {"bn_free": {"model": str(bn_free), "steps": 2,
                         "init": {k: v.clone() for k, v in free_model.state_dict().items()},
                         "config": dict(optimizer="adam", lr=1e-3)}}
    refs, ranks = dp_case_runs(tmp, CASES, batches, extra=extra)
    # the port's single-process step over the global batches, BN-free
    _, t_cfg = train_configs(optimizer="adam", lr=1e-3)
    ts, opt = t_loop.train_init(free_model, t_cfg)
    step = t_loop.make_train_step(free_model, opt, t_cfg)
    single = [float(step(ts, *map(torch.from_numpy, b))[1]["total_loss"]) for b in batches[:2]]
    refs["bn_free"] = (single, {k: v.clone() for k, v in free_model.state_dict().items()})
    return refs, ranks


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_matches_reference_dp_step(runs, name):
    refs, ranks = runs
    assert_ranks_identical(ranks, name)
    assert_dp_matches_reference(ranks[0], name, *refs[name])


def test_dp_step_without_bn_tracks_the_single_process_step(runs):
    """BN-free, so no per-rank statistics: 2 ranks of 8 images each take the
    step one process takes on all 16 (tests/test_train.py:317's property)."""
    refs, ranks = runs
    assert_ranks_identical(ranks, "bn_free")
    single, state = refs["bn_free"]
    dp = [float(ranks[0][f"bn_free/step{i}/total_loss"]) for i in range(2)]
    np.testing.assert_allclose(dp, single, rtol=2e-4)
    for k, v in state.items():
        np.testing.assert_allclose(ranks[0][f"bn_free/state/{k}"], v.numpy(), rtol=0, atol=5e-5,
                                   err_msg=k)

