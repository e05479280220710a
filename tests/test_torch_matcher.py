"""Parity of the port's target matcher (yolodl_torch.loss.matcher) with the
JAX reference on the detect heads of yolov4-tiny and yolov4-csp at 64².

The matcher is integer and comparison logic over the same f32 arithmetic,
so every output must be identical: ``flat``, ``gt_cycxhw``, ``gt_class``
and ``valid`` (the dedupe's ties go to the lowest candidate index in both).
The collision sets put several boxes on one cell, some at exactly the same
centre, so that the two-pass scatter-min decides between equal distances.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import head_infos, random_prediction, random_targets
from yolodl_tpu.loss import matcher as j_matcher
from yolodl_torch.loss import matcher as t_matcher

torch.set_num_threads(2)

_INFOS = {}


def _infos(cfg_name):
    if cfg_name not in _INFOS:
        _INFOS[cfg_name] = head_infos(cfg_name, 64)
    return _INFOS[cfg_name]


def _collisions(batch):
    """Boxes that collide on one cell: equal centres (exact distance ties),
    centres a hair apart, cell-border fractions of exactly 0.5, and a
    zero-sized box."""
    boxes = np.array([
        [0.50, 0.50, 0.20, 0.20],
        [0.50, 0.50, 0.22, 0.18],   # same centre: a tie on every cell
        [0.51, 0.49, 0.20, 0.20],   # same cell, nearer neighbours differ
        [0.50, 0.50, 0.05, 0.40],   # same centre, another anchor shape
        [0.25, 0.75, 0.10, 0.10],   # fraction exactly 0.5 on the 8x8 grid ...
        [0.25, 0.75, 0.10, 0.10],   # ... twice
        [0.30, 0.30, 0.00, 0.10],   # zero height: skipped
        [0.01, 0.99, 0.30, 0.30],   # on the border: out-of-bounds neighbours
    ], np.float32)
    classes = np.arange(len(boxes), dtype=np.int32)
    boxes = np.broadcast_to(boxes, (batch,) + boxes.shape).copy()
    classes = np.broadcast_to(classes, (batch, len(classes))).copy()
    mask = np.ones(classes.shape, bool)
    mask[-1, 2] = False
    return boxes, classes, mask


CASES = [
    ("yolov4-tiny", "rect4", 4.0, None, "random"),
    ("yolov4-tiny", "rect2", 4.0, None, "random"),
    ("yolov4-tiny", "rect4", 4.0, None, "collide"),
    ("yolov4-tiny", "rect2", 2.0, 0.2, "collide"),
    ("yolov4-tiny", "rect4", 4.0, (0.3, 1.0), "random"),
    ("yolov4-csp", "rect4", 4.0, None, "random"),
    ("yolov4-csp", "rect4", 4.0, 0.2, "collide"),
    ("yolov4-csp", "rect2", 3.0, (0.2, 0.5, 0.7), "random"),
]


@pytest.mark.parametrize("cfg_name,grid,thresh,shape_iou,targets", CASES)
def test_match_targets_identical(cfg_name, grid, thresh, shape_iou, targets):
    infos, j_infos, nc = _infos(cfg_name)
    _, j_pred, t_pred = random_prediction(infos, j_infos, nc, 2, seed=0)
    if targets == "random":
        boxes, classes, mask = random_targets(2, 16, seed=1)
    else:
        boxes, classes, mask = _collisions(2)
    kw = dict(match_grid=grid, anchor_scale_thresh=thresh, shape_iou_thresh=shape_iou)
    ref = j_matcher.match_targets(j_pred, jnp.asarray(boxes), jnp.asarray(classes),
                                  jnp.asarray(mask), j_matcher.MatcherConfig(**kw))
    out = t_matcher.match_targets(t_pred, torch.from_numpy(boxes), torch.from_numpy(classes),
                                  torch.from_numpy(mask), t_matcher.MatcherConfig(**kw))
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.flat.numpy(), np.asarray(ref.flat))
    np.testing.assert_array_equal(out.gt_class.numpy(), np.asarray(ref.gt_class))
    np.testing.assert_array_equal(out.gt_cycxhw.numpy(), np.asarray(ref.gt_cycxhw))
    assert out.flat.dtype == torch.int32 and out.gt_class.dtype == torch.int32
    assert int(out.num_matched()) == int(ref.num_matched()) > 0

    j_g = ref.gather_pred(j_pred)
    t_g = out.gather_pred(t_pred)
    for a, b in zip(t_g, j_g):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_collisions_keep_one_candidate_per_cell():
    infos, j_infos, nc = _infos("yolov4-tiny")
    _, _, t_pred = random_prediction(infos, j_infos, nc, 2, seed=0)
    boxes, classes, mask = _collisions(2)
    out = t_matcher.match_targets(t_pred, torch.from_numpy(boxes), torch.from_numpy(classes),
                                  torch.from_numpy(mask))
    for i in range(2):
        cells = out.flat[i][out.valid[i]]
        assert cells.numel() == torch.unique(cells).numel() > 0


@pytest.mark.parametrize("kw,match", [
    (dict(match_grid="rect8"), "unknown match_grid"),
    (dict(anchor_scale_thresh=0.5), "must be >= 1"),
])
def test_matcher_config_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        t_matcher.MatcherConfig(**kw)


def test_per_head_shape_iou_length_checked():
    infos, j_infos, nc = _infos("yolov4-tiny")
    _, _, t_pred = random_prediction(infos, j_infos, nc, 1, seed=0)
    boxes, classes, mask = random_targets(1, 4, seed=2)
    with pytest.raises(ValueError, match="per-head shape_iou_thresh"):
        t_matcher.match_targets(t_pred, torch.from_numpy(boxes), torch.from_numpy(classes),
                                torch.from_numpy(mask),
                                t_matcher.MatcherConfig(shape_iou_thresh=(0.2, 0.2, 0.2)))
