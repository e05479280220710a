"""The knob ``spd_stem="deep"`` in the port's model: yolov4-csp at 64², port
knob against reference knob, eval and one train-mode forward, as
test_torch_layout_model.py holds "auto".  The stem trio and the stage-1
residual quintet (layer2, layer3, the shortcut layer4) run packed: one
``spd_stem_apply`` and one ``spd_res_block_apply`` a forward.
"""

import pytest
import torch

from _torch_parity import knob_matches

torch.set_num_threads(2)


@pytest.mark.parametrize("train", [False, True])
def test_deep_matches_the_reference(train, monkeypatch):
    knob_matches("deep", train, monkeypatch)
