"""The darknet-exact loss with ``new_coords=1`` (yolov4-csp's heads:
logistic on every entry, w = (2σ)²·anchor, σ′ applied in the gradient)
in each box mode, against the reference: one head at 8², ``scale_x_y=2``
as in yolov4-csp.cfg.  Set-up and tolerances as in test_torch_darknet_loss.py:
deltas and gradients within 1e-5 · max|ref|, costs rel 1e-5, counts
exact.
"""

import pytest
import torch

from _torch_parity import assert_darknet_matches, darknet_inputs
from test_torch_darknet_loss import heads

torch.set_num_threads(2)


@pytest.mark.parametrize("iou_loss", ["mse", "iou", "giou", "diou", "ciou"])
def test_yolo_new_coords_box_modes(iou_loss):
    j_params, t_params = heads(iou_loss=iou_loss, new_coords=True, scale_x_y=2.0)
    j_params, t_params = j_params[:1], t_params[:1]  # one head at 8², to keep the file short
    raws, truth = darknet_inputs(j_params, [(8, 8)], seed=2)
    ref = assert_darknet_matches(j_params, t_params, raws, truth)
    assert int(ref["metrics"]["num_matched"]) > 0
