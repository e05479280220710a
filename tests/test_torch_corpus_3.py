"""Corpus sweep, part 4 of 4: the sequence cfgs that run 576 time steps
(rnn.train, lstm.train, crnn.train; `_torch_parity.CORPUS_LONG`) build in
yolodl_torch and run one finite eval forward over one 576-step sequence
whose node shapes equal the graph's (`_torch_parity.corpus_forward`); the
port only, as the reference's 576-step scan takes minutes to compile."""

import pytest
import torch

from _torch_parity import CORPUS_LONG, corpus_forward

torch.set_num_threads(2)


@pytest.mark.parametrize("name", CORPUS_LONG)
def test_corpus_cfg_runs(name):
    out = corpus_forward(name)
    assert tuple(out.shape) == (576, 256)
