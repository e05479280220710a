"""Corpus sweep, part 1 of 4: every third buildable `cfg/darknet/*.cfg`
(from the 1st) builds in yolodl_torch and runs one finite eval
forward at 64² (128² for the p7 models and alexnet) whose node shapes
equal the graph's (`_torch_parity.corpus_forward`); the three 576-step
sequence cfgs are part 4's."""

import numpy as np
import pytest
import torch

from _torch_parity import corpus_forward, corpus_slice

torch.set_num_threads(2)


@pytest.mark.parametrize("name", corpus_slice(0, 3))
def test_corpus_cfg_runs(name):
    corpus_forward(name)


def test_corpus_census():
    """74 cfgs: 73 parse in both packages and all 73 build in the port (the
    12 with a dense or recurrent kind raised naming ROADMAP A12 until it
    was ported): each of those has the reference's parameter names and
    shapes through the bridge.  resnet152_trident.cfg parses in neither."""
    import jax

    from _torch_parity import (CORPUS_A12, CORPUS_DENSE, CORPUS_LONG, CORPUS_UNPARSABLE,
                               corpus_names, corpus_text)
    from yolodl_torch.bridge import params_from_jax
    from yolodl_tpu.config import darknet_cfg as j_dk
    from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
    from yolodl_tpu.models.builder import GraphModel as JGraphModel
    from yolodl_torch.config import darknet_cfg as t_dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet as t_graph
    from yolodl_torch.models import GraphModel

    names = corpus_names()
    assert len(names) == 74
    assert CORPUS_A12 == ()
    assert sum(len(corpus_slice(p, 3)) for p in range(3)) + len(CORPUS_LONG) == 73
    for name in CORPUS_UNPARSABLE:
        text = corpus_text(name)
        with pytest.raises(ValueError, match="cannot unify"):
            t_graph(t_dk.Darknet.from_str(text))
        with pytest.raises(ValueError, match="cannot unify"):
            j_graph(j_dk.Darknet.from_str(text))
    for name in CORPUS_DENSE:
        text = corpus_text(name)
        model = GraphModel(t_graph(t_dk.Darknet.from_str(text)), device="cpu")
        jm = JGraphModel(j_graph(j_dk.Darknet.from_str(text)), spd_stem="off")
        specs = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
        zeros = [jax.tree_util.tree_map(lambda a: np.zeros(a.shape, np.float32), t)
                 for t in specs]
        want = {k: tuple(v.shape) for k, v in params_from_jax(*zeros).items()}
        assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want, name
