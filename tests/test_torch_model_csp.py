"""Whole-model parity of yolodl_torch's YoloModel with the JAX reference on
yolov4-csp at 64x64: full depth (115 convs), Mish, SPP max-pools and the
scaled decode.  The tolerance and its reason are those of
test_torch_model.py: rtol 1e-4 with atol 1e-4 * max|ref|, f32 convolutions
summing in another order.
"""

import torch

from _torch_parity import assert_forward_matches

torch.set_num_threads(2)


def test_csp_forward_matches_reference():
    assert_forward_matches("yolov4-csp", 64)
