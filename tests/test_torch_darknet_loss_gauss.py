"""The darknet-exact [Gaussian_yolo] loss against the reference: the
Gaussian NLL box deltas with ``iou_loss`` mse and giou (giou replaces the
mu deltas by dx_box_iou while the sigma deltas stay NLL), with and
without ``objectness_smooth`` (the Gaussian flavour: iou² target plus a
class row), with ``iou_thresh`` (Gaussian_yolov3_BDD.cfg's 0.213), and
averages_gaussian_yolo_deltas at every cell.  One head at 8², three
classes, batch 2.  Tolerances: deltas and gradients within 1e-5 ·
max|ref|, costs rel 1e-5, counts exact.

Then the loss on bf16 raws (the logistic in bf16, the rest in f32, as in
both packages): the same bf16 inputs to both, deltas within 1e-5 ·
max|ref|, the gradient (bf16 in the port, f32 in the reference) within
8e-3 · max|ref| (bf16 keeps 8 bits: its rounding is 2⁻⁹ of the value).
"""

import pytest
import torch

from _torch_parity import assert_darknet_matches, darknet_inputs, darknet_params_pair
from test_torch_darknet_loss_opts import ANCHORS, one_head

torch.set_num_threads(2)


def gaussian_head(**fields):
    return one_head(gaussian=True, uc_normalizer=1.0, **fields)


@pytest.mark.parametrize("iou_loss", ["mse", "giou"])
@pytest.mark.parametrize("smooth", [False, True], ids=["plain", "smooth"])
def test_gaussian_modes(iou_loss, smooth):
    j_params, t_params = gaussian_head(iou_loss=iou_loss, objectness_smooth=smooth,
                                       ignore_thresh=0.4)
    raws, truth = darknet_inputs(j_params, [(8, 8)], seed=7)
    assert_darknet_matches(j_params, t_params, raws, truth)


def test_gaussian_like_bdd_with_multipliers():
    """Gaussian_yolov3_BDD.cfg's options (giou, iou_thresh 0.213,
    iou_normalizer 0.5), plus class multipliers and truth_thresh."""
    j_params, t_params = gaussian_head(iou_loss="giou", iou_thresh=0.213, iou_normalizer=0.5,
                                       truth_thresh=0.7, classes_multipliers=(1.0, 2.0, 3.0),
                                       max_delta=3.0)
    raws, truth = darknet_inputs(j_params, [(8, 8)], seed=8)
    assert_darknet_matches(j_params, t_params, raws, truth, plain=True)


@pytest.mark.parametrize("gaussian", [False, True], ids=["yolo_new_coords", "gaussian"])
def test_bf16_raws(gaussian):
    fields = (dict(gaussian=True, iou_loss="giou", iou_thresh=0.213) if gaussian else
              dict(iou_loss="ciou", new_coords=True, scale_x_y=2.0, iou_thresh=0.2))
    j, t = darknet_params_pair(anchors=ANCHORS, mask=(0, 1, 3), classes=3, net_w=64,
                               net_h=64, **fields)
    raws, truth = darknet_inputs([j], [(8, 8)], seed=9)
    assert_darknet_matches([j], [t], raws, truth, dtype="bfloat16", grad_tol=8e-3)
