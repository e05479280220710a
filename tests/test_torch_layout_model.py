"""The layout knobs in the port's model: yolov4-csp at 64² with
``spd_stem="auto"`` here ("deep", ``fold_region="on"`` and the two
together in test_torch_layout_model_{deep,fold,both}.py, one knob a file
to keep each file's reference compiles short), port knob against
reference knob on the same seed-0 weights with per-channel BN (the bridge
carries them; the names are canonical, so one state dict serves every
knob).  Eval: rtol 1e-4 with atol 1e-4 · max|ref|
(``_torch_parity.assert_forward_matches``), NCHW and NHWC, each rewrite
taken as often as the reference takes it.  One train-mode forward: every
new BN running statistic within the same tolerance
(``assert_train_state_matches``).

The default is pinned: ``YoloModel(graph, device="cpu")`` takes no rewrite
and computes bit for bit as ``spd_stem="off"``, and as the reference's
``spd_stem="off"`` within the eval tolerance.  The reference's own
default is "auto"; the port's defaults wait for its benchmark.  When a
rewrite is skipped: test_torch_layout_rules.py.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (MINI_CFG, assert_forward_matches, count_rewrites, knob_matches,
                           layout_models)
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.graph.from_darknet import graph_from_darknet
from yolodl_torch.models import YoloModel
from yolodl_torch.models.builder import GraphModel

torch.set_num_threads(2)


@pytest.mark.parametrize("train", [False, True])
def test_auto_matches_the_reference(train, monkeypatch):
    knob_matches("auto", train, monkeypatch)


def test_default_is_off(monkeypatch):
    """The port's default takes no rewrite: bit for bit ``spd_stem="off"``,
    and within the parity tolerance of the reference's ``spd_stem="off"``."""
    jm, params, state, off = layout_models({})
    default = YoloModel(off.graph, device="cpu")
    default.load_state_dict(off.state_dict())
    assert default._spd_pair is None and default._spd_res is None and not default._fold_keys
    assert jm._spd_pair is None
    counts = count_rewrites(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        a, b = default(x), off(x)
    for f in ("cycxhw", "obj_logit", "class_logit"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    assert_forward_matches("yolov4-csp", models=(jm, params, state, default))
    assert set(counts.values()) == {0}


def test_knob_values_are_checked():
    graph = graph_from_darknet(t_dk.Darknet.from_str(MINI_CFG))
    with pytest.raises(ValueError, match="spd_stem must be off|auto|stem|deep"):
        GraphModel(graph, device="cpu", spd_stem="on")
    with pytest.raises(ValueError, match="fold_region must be off|on"):
        GraphModel(graph, device="cpu", fold_region="auto")
    stem = GraphModel(graph, device="cpu", spd_stem="stem")
    assert stem._spd_pair == (0, 1, 2) and stem._spd_res is None
