"""The data-parallel step with the darknet-exact loss (MULTICHIP_r05.json
stage 4: DP × darknet loss), 2 ranks over gloo against
``yolodl_tpu.parallel.make_dp_train_step`` on a 2-device mesh with
``TrainConfig.darknet_loss`` from yolov4-tiny's two [yolo] heads at 64²:
two SGD steps (momentum 0.9) from the same weights and global batches,
with test_torch_dp.py's set-up and limits.  The darknet telemetry is
averaged over the ranks, ``num_matched`` summed.  lr 1e-5, not the other
cases' 3e-4: the darknet loss sums over cells (≈ 11 on these rows against
≈ 1.2 for the production loss), and at 3e-4 one step moves layer2/w by
1.8 % of its largest entry, where the single-device steps of the two
packages on one rank's rows already differ by 7.4e-4 · max|ref| (at 1e-5:
2.5e-5, inside the limit).
"""

import pytest
import torch

from _torch_parity import (assert_dp_matches_reference, assert_ranks_identical, dp_batches,
                           dp_case_runs)
from yolodl_torch.loss.darknet_loss import METRIC_KEYS

torch.set_num_threads(2)

CASES = {"darknet_loss": dict(config=dict(optimizer="sgd", lr=1e-5, momentum=0.9), steps=2,
                              darknet=True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return dp_case_runs(tmp_path_factory.mktemp("dp_darknet"), CASES, dp_batches(2, 16, seed=9))


def test_dp_darknet_loss_step_matches_reference_dp_step(runs):
    refs, ranks = runs
    assert_ranks_identical(ranks, "darknet_loss")
    assert_dp_matches_reference(ranks[0], "darknet_loss", *refs["darknet_loss"])


def test_dp_darknet_loss_step_returns_the_darknet_telemetry(runs):
    _, ranks = runs
    for i in range(2):
        keys = {k.split("/", 2)[2] for k in ranks[0] if k.startswith(f"darknet_loss/step{i}/")}
        assert keys == {"total_loss", *METRIC_KEYS}
