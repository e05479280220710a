"""The knob ``fold_region="on"`` in the port's model: yolov4-csp at 64², port
knob against reference knob, eval and one train-mode forward, as
test_torch_layout_model.py holds "auto".  The region is the reference's
(layer2, layer3 and the shortcut layer4); the port folds layer1's output
once and unfolds only layer4's output, read by layer5, where the reference
records an unfolded output for every region node.
"""

import pytest
import torch

from _torch_parity import knob_matches

torch.set_num_threads(2)


@pytest.mark.parametrize("train", [False, True])
def test_fold_matches_the_reference(train, monkeypatch):
    knob_matches("fold", train, monkeypatch)
