"""The data-parallel step with remat and with gradient clipping and the
``log_weights_and_grads`` maxima (MULTICHIP_r05.json stage 2, and the
clip of the reference's dp.py:101-126), 2 ranks over gloo against
``yolodl_tpu.parallel.make_dp_train_step`` on a 2-device mesh: one SGD
step each from the same weights and global batch, with test_torch_dp.py's
set-up and limits (the maxima within the rel 1e-3 of
test_torch_train_step.py's metrics).  The darknet-exact loss:
test_torch_dp_darknet.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (assert_dp_matches_reference, assert_ranks_identical, dp_batches,
                           dp_case_runs)

torch.set_num_threads(2)

CASES = {
    "remat": dict(config=dict(optimizer="sgd", lr=3e-4), steps=1, remat="blocks"),
    "clip_and_maxima": dict(config=dict(optimizer="sgd", lr=3e-4, clip_grad_value=0.01,
                                        clip_grad_norm=0.05, log_weights_and_grads=True),
                            steps=1),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return dp_case_runs(tmp_path_factory.mktemp("dp_opts"), CASES, dp_batches(1, 16, seed=7))


@pytest.mark.parametrize("name", list(CASES))
def test_dp_step_option_matches_reference_dp_step(runs, name):
    refs, ranks = runs
    assert_ranks_identical(ranks, name)
    assert_dp_matches_reference(ranks[0], name, *refs[name])


def test_maxima_cover_every_parameter_and_no_obj_sample(runs):
    """One |w|max and one |grad|max per parameter (reduced gradients, so the
    same on both ranks); ``obj_sample`` is per-rank data and never comes
    back (dp.py:82-85)."""
    _, ranks = runs
    maxima = [k for k in ranks[0] if k.startswith("clip_and_maxima/step0/") and "_max/" in k]
    n_params = len([k for k in ranks[0] if k.startswith("clip_and_maxima/state/")
                    and not k.endswith((".mean", ".var"))])
    assert len(maxima) == 2 * n_params
    assert not any(k.endswith("/obj_sample") for k in ranks[0])
