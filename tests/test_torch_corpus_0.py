"""Corpus sweep, part 1 of 3: every third buildable `cfg/darknet/*.cfg`
(from the 1st) builds in yolodl_torch and runs one finite eval
forward at 64² (128² for the p7 models) whose node shapes equal the
graph's (`_torch_parity.corpus_forward`)."""

import pytest
import torch

from _torch_parity import corpus_forward, corpus_slice

torch.set_num_threads(2)


@pytest.mark.parametrize("name", corpus_slice(0, 3))
def test_corpus_cfg_runs(name):
    corpus_forward(name)


def test_corpus_census():
    """74 cfgs: 73 parse in both packages, 61 build in the port, the 12 that
    reach a node kind of ROADMAP A12 raise naming it."""
    from _torch_parity import CORPUS_A12, CORPUS_UNPARSABLE, corpus_names, corpus_text
    from yolodl_tpu.config import darknet_cfg as j_dk
    from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
    from yolodl_torch.config import darknet_cfg as t_dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet as t_graph
    from yolodl_torch.models import GraphModel

    names = corpus_names()
    assert len(names) == 74
    assert sum(len(corpus_slice(p, 3)) for p in range(3)) == 61
    for name in CORPUS_UNPARSABLE:
        text = corpus_text(name)
        with pytest.raises(ValueError, match="cannot unify"):
            t_graph(t_dk.Darknet.from_str(text))
        with pytest.raises(ValueError, match="cannot unify"):
            j_graph(j_dk.Darknet.from_str(text))
    for name in CORPUS_A12:
        graph = t_graph(t_dk.Darknet.from_str(corpus_text(name)))
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            GraphModel(graph, device="cpu")
