"""Corpus sweep, part 2 of 4: every third buildable `cfg/darknet/*.cfg`
(from the 2nd) builds in yolodl_torch and runs one finite eval
forward at 64² (128² for the p7 models and alexnet) whose node shapes
equal the graph's (`_torch_parity.corpus_forward`); the three 576-step
sequence cfgs are part 4's."""

import pytest
import torch

from _torch_parity import corpus_forward, corpus_slice

torch.set_num_threads(2)


@pytest.mark.parametrize("name", corpus_slice(1, 3))
def test_corpus_cfg_runs(name):
    corpus_forward(name)
