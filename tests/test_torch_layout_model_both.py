"""The knobs ``spd_stem="auto"`` and ``fold_region="on"`` together in the
port's model: yolov4-csp at 64², port knobs against reference knobs, eval
and one train-mode forward, as test_torch_layout_model.py holds "auto"
alone: the stem runs packed, and its output is folded once for the
region.
"""

import pytest
import torch

from _torch_parity import knob_matches

torch.set_num_threads(2)


@pytest.mark.parametrize("train", [False, True])
def test_both_matches_the_reference(train, monkeypatch):
    knob_matches("auto+fold", train, monkeypatch)
