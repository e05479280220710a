"""The darknet-exact [yolo] loss's options against the reference: the
``iou_thresh`` multi-anchor match in each ``iou_thresh_kind``, and
``max_delta`` clipping (IoU-family deltas clip, MSE deltas never do).
One head at 8² of six anchors whose mask holds three (so a truth's best
anchor may lie outside it), net 64², three classes, batch 2.  Tolerances
as in test_torch_darknet_loss.py: deltas and gradients within 1e-5 ·
max|ref|, costs rel 1e-5, counts exact.
"""

import pytest
import torch

from _torch_parity import assert_darknet_matches, darknet_inputs, darknet_params_pair

torch.set_num_threads(2)

# shapes close enough that several masked anchors pass iou_thresh
ANCHORS = ((8, 10), (12, 12), (10, 16), (16, 20), (30, 30), (40, 56))


def one_head(**fields):
    j, t = darknet_params_pair(anchors=ANCHORS, mask=(0, 1, 3), classes=3, net_w=64, net_h=64,
                               **fields)
    return [j], [t]


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou"])
def test_iou_thresh_multi_anchor(kind):
    j_params, t_params = one_head(iou_loss="ciou", iou_thresh=0.25, iou_thresh_kind=kind,
                                  scale_x_y=1.05)
    raws, truth = darknet_inputs(j_params, [(8, 8)], truths=10, real=8, seed=3, scale=0.8)
    ref = assert_darknet_matches(j_params, t_params, raws, truth)
    # more applications than valid truths: the extra anchors were written
    assert int(ref["metrics"]["num_matched"]) > 5 + 7


def test_iou_thresh_new_coords_like_yolov4_csp():
    """yolov4-csp's head options: ciou, iou_thresh 0.2, new_coords, scale 2,
    max_delta 5, iou_normalizer 0.05, obj/cls normalizers 4 and 0.5."""
    j_params, t_params = one_head(iou_loss="ciou", iou_thresh=0.2, new_coords=True,
                                  scale_x_y=2.0, max_delta=5.0, iou_normalizer=0.05,
                                  obj_normalizer=4.0, cls_normalizer=0.5, ignore_thresh=0.7)
    raws, truth = darknet_inputs(j_params, [(8, 8)], seed=4)
    assert_darknet_matches(j_params, t_params, raws, truth, plain=True)


@pytest.mark.parametrize("iou_loss,max_delta", [("giou", 0.05), ("mse", 0.05), ("diou", 1.0)])
def test_max_delta(iou_loss, max_delta):
    j_params, t_params = one_head(iou_loss=iou_loss, max_delta=max_delta, iou_normalizer=2.0)
    raws, truth = darknet_inputs(j_params, [(8, 8)], seed=5, scale=1.5)
    assert_darknet_matches(j_params, t_params, raws, truth)


def test_head_decisions_agree_with_the_deltas():
    """``head_decisions`` (the discrete choices the card is held to in
    chip_smoke.py) against the delta the same call site produces: one
    application per written candidate, a zero objectness delta at every
    ignored cell no truth wrote, and the written cells' objectness deltas
    positive-targeted (1 - σ > 0)."""
    import numpy as np

    from yolodl_torch.loss import darknet_loss as tl

    _, (p,) = one_head(iou_loss="ciou", iou_thresh=0.25, ignore_thresh=0.5)
    raws, truth = darknet_inputs([p], [(8, 8)], seed=10)
    raw = tl.reshape_head_raw(torch.from_numpy(raws[0]), p)
    tr = torch.from_numpy(truth)
    dec = tl.head_decisions(raw, tr, p)
    delta, _, cnt = tl._head_deltas(raw, tr, p)
    assert int(dec["written"].sum()) == int(cnt.sum()) > 0
    written = torch.zeros(dec["ignored"].shape, dtype=torch.bool)
    for b, cells in enumerate(dec["written_cell"]):
        for slot, j, i in cells.reshape(-1, 3).tolist():
            if slot >= 0:
                written[b, slot, j, i] = True
    obj = delta[..., 4]
    assert int(dec["ignored"].sum()) > 0
    assert torch.all(obj[dec["ignored"] & ~written] == 0)
    assert torch.all(obj[written] > 0)
    assert np.array_equal(dec["best_anchor"].shape, truth.shape[:2])
