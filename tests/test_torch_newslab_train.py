"""One training step of a NEWSLAB model in the port against the JAX
reference: the 64×64 model of ``cfg/train.json5`` (it holds a DeconvBn2D)
here, and the deconv model of ``cfg/detect.json5`` in
``test_torch_newslab_train_big.py``.  Both start from the same seeded numpy
trees (``_torch_parity.seeded_trees``) through the bridge and take one
step on the same batch of two 64² images: AdamW with cfg/train.json5's
weight decay 5e-4 (lr 1e-5) for the 64×64 model, SGD (lr 3e-4, the rate
``test_torch_train.py`` explains) for the big one.

Tolerances: the loss within rel 1e-4; every parameter within
3e-4 · max|ref| of its tensor after the SGD step and 1e-2 · max|ref|
after the AdamW step (its first update is about lr · sign(g), so entries
whose gradient is rounding noise move by ±lr in either framework); the BN
running statistics within 1e-4 · max|ref|.
"""

import torch

from _torch_parity import newslab_one_step_matches

torch.set_num_threads(2)


def test_train_model_step_matches_reference():
    newslab_one_step_matches("yolov4-csp-custom-64x64-2021-08-21", "adamw")
