"""``yolodl_torch.loss.darknet_loss`` against ``yolodl_tpu.loss.darknet_loss``:
the [yolo] head in each box mode (mse, iou, giou, diou, ciou) with
``new_coords`` 0 (exp w/h, the scal_add quirk at scale_x_y ≠ 1) and 1
(yolov4-csp's: logistic everywhere, σ′ in the gradient), two heads at 8²
and 4² (net 64², six anchors, three classes), batch 2, 12 truth rows of
which 8 are real.

Each case compares, on the same seeded inputs, every head's delta and
telemetry, ``darknet_detection_loss`` and
``darknet_detection_loss_with_metrics`` with their gradients
(``jax.grad`` through the reference's ``custom_vjp``).  Tolerances (f32):
deltas and gradients within 1e-5 · max|ref|, costs rel 1e-5, the counts
(``num_matched``, recall) exact.
"""

import pytest
import torch

from _torch_parity import assert_darknet_matches, darknet_inputs, darknet_params_pair

torch.set_num_threads(2)

ANCHORS = ((6, 8), (10, 14), (18, 24), (24, 40), (36, 30), (48, 56))
SIZES = [(8, 8), (4, 4)]


def heads(**fields):
    pairs = [darknet_params_pair(anchors=ANCHORS, mask=mask, classes=3, net_w=64, net_h=64,
                                 **fields)
             for mask in ((0, 1, 2), (3, 4, 5))]
    return [j for j, _ in pairs], [t for _, t in pairs]


@pytest.mark.parametrize("iou_loss", ["mse", "iou", "giou", "diou", "ciou"])
def test_yolo_box_modes(iou_loss):
    j_params, t_params = heads(iou_loss=iou_loss, scale_x_y=1.1)
    raws, truth = darknet_inputs(j_params, SIZES, seed=1)
    ref = assert_darknet_matches(j_params, t_params, raws, truth)
    # 5 + 7 valid truths (image 0 breaks at its sixth row), each applied
    # once: at its best anchor, which lies in exactly one head's mask
    assert int(ref["metrics"]["num_matched"]) == 12
