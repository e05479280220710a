"""The port's augment program with jitter on against the reference's: the
16 ``has_*`` combinations with ``has_jitter`` (the pack, the warps and the
bounds: test_torch_device_augment_program.py, which holds the other 16).
Port against the jitted reference: mean |Δ| ≤ 1e-5 and at most 0.2 % of
pixels with |Δ| > 1e-3.
"""

import pytest
import torch

from test_torch_device_augment_program import COMBOS, check_combo, combo_id, packs

torch.set_num_threads(2)

__all__ = ["packs"]  # the module-scoped fixture, shared


@pytest.mark.parametrize("combo", [c for c in COMBOS if c[0]], ids=combo_id)
def test_program_with_jitter_matches_reference(combo, packs):
    check_combo(combo, packs)
