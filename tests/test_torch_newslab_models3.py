"""Models 5 and 6 of the six NEWSLAB models of ``cfg/model/`` in the port (see
``test_torch_newslab_models.py``), against the JAX
reference: each builds with the reference's parameter tree (the same
leaves and shapes, so 22,775,906 parameters for the 64×64 model of
``cfg/train.json5`` and 109,524,631 for the model of ``cfg/detect.json5``)
and its forward at 64² matches, NCHW and NHWC, with seeded numpy weights
carried through the bridge.

The reference's ``init`` is never run (tens of seconds for the 100 M
models on the CPU): its trees come from ``jax.eval_shape`` and are filled
with numpy (``_torch_parity.seeded_trees``).  Tolerance as for the darknet
models: rtol 1e-4 with atol 1e-4 · max|ref| per MergedDetection field.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (NEWSLAB_MODELS, assert_forward_matches, flat_leaves,
                           newslab_reference_and_port)
from yolodl_torch.bridge import params_to_jax

torch.set_num_threads(2)

PARAMETERS = {"yolov4-csp-custom-64x64-2021-08-21": 22_775_906,
              "yolov4-csp-custom-2021-03-11": 109_524_631}


@pytest.mark.parametrize("name", NEWSLAB_MODELS[4:6])
def test_newslab_forward_matches_reference(name):
    models = newslab_reference_and_port(name)
    jm, params, state, tm = models
    ref_leaves = flat_leaves(jax.tree_util.tree_map(np.asarray, params))
    port_leaves = flat_leaves(params_to_jax(tm.state_dict())[0])
    assert {k: v.shape for k, v in port_leaves.items()} == \
        {k: v.shape for k, v in ref_leaves.items()}
    n = sum(p.numel() for p in tm.parameters())
    assert n == sum(v.size for v in ref_leaves.values()) == PARAMETERS.get(name, n)
    assert_forward_matches(name, 64, models=models)
