"""One SGD step of the deconv model of ``cfg/detect.json5`` (109.5 M
parameters) in the port against the JAX reference; see
``test_torch_newslab_train.py`` for the set-up and the tolerances."""

import torch

from _torch_parity import newslab_one_step_matches

torch.set_num_threads(2)


def test_detect_model_step_matches_reference():
    newslab_one_step_matches("yolov4-csp-custom-2021-03-11", "sgd")
