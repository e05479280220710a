"""The darknet-exact [yolo] loss's objectness and class options against
the reference: ``truth_thresh < 1`` (the per-cell multi-positive branch),
``objectness_smooth`` (alone, with truth_thresh, with iou_thresh),
``focal_loss``, ``label_smooth_eps`` and ``counters_per_class`` (class
multipliers capped at max_delta).  Set-up as in
test_torch_darknet_loss_opts.py; deltas and gradients within 1e-5 ·
max|ref|, costs rel 1e-5, counts exact.
"""

import pytest
import torch

from _torch_parity import assert_darknet_matches, darknet_inputs
from test_torch_darknet_loss_opts import one_head

torch.set_num_threads(2)

CASES = {
    "truth_thresh": dict(iou_loss="mse", truth_thresh=0.6),
    "truth_thresh_smooth_ciou": dict(iou_loss="ciou", truth_thresh=0.6, objectness_smooth=True),
    "objectness_smooth": dict(iou_loss="giou", objectness_smooth=True, ignore_thresh=0.3),
    "smooth_iou_thresh": dict(iou_loss="ciou", objectness_smooth=True, iou_thresh=0.3,
                              new_coords=True, scale_x_y=2.0),
    "focal_loss": dict(iou_loss="iou", focal_loss=True),
    "label_smooth": dict(iou_loss="diou", label_smooth_eps=0.1),
    # get_classes_multipliers of counts (100, 20, 5) capped at max_delta 6
    "counters_per_class": dict(iou_loss="giou", max_delta=6.0, cls_normalizer=0.7,
                               classes_multipliers=(1.0, 5.0, 6.0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_class_and_objectness_options(name):
    j_params, t_params = one_head(**CASES[name])
    raws, truth = darknet_inputs(j_params, [(8, 8)], seed=6)
    assert_darknet_matches(j_params, t_params, raws, truth)


@pytest.mark.parametrize("smooth", [False, True], ids=["plain", "smooth"])
def test_saturated_objectness(smooth):
    """Anchor slot 0's objectness logit at +40 everywhere: σ = 1 in f32, so a
    truth written there lands a zero objectness delta.  Then the
    iou_thresh averaging (averages_yolo_deltas) skips the cell although its
    class row is positive, and under objectness_smooth a later truth at the
    same cell still lands (its delta is still 0)."""
    j_params, t_params = one_head(iou_loss="ciou", iou_thresh=0.25, objectness_smooth=smooth)
    raws, truth = darknet_inputs(j_params, [(8, 8)], truths=16, real=14, seed=11)
    e = j_params[0].entries
    raws[0][:, 4] = 40.0  # channel slot·E + 4 of slot 0
    assert raws[0].shape[1] == 3 * e
    # two truths of different classes in one cell of slot 0's anchor shape:
    # two positive class entries there, so the averaging would halve its
    # box delta but for the zero objectness delta
    truth[0, 1, :4] = truth[0, 0, :4] = [0.3, 0.3, 8 / 64, 10 / 64]
    truth[0, 1, 0] += 0.01
    truth[0, 0, 4], truth[0, 1, 4] = 0, 1
    assert_darknet_matches(j_params, t_params, raws, truth)
