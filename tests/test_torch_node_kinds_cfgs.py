"""One real darknet cfg for each family of ROADMAP A4's node kinds, shrunk
to a small input, through yolodl_torch and yolodl_tpu with the same seeded
weights: yolov2 (Reorg2D old, [region] heads), enet-coco (scale_channels,
global avgpool), darknet19 (avgpool, softmax, cost) and cspx-p7-mish
(sam; stride 128, so 128²).

Tolerance: rtol 1e-4 with atol 1e-4 · max|ref|, as tests/test_torch_model.py.
"""

import os
import re

import jax
import numpy as np
import pytest
import torch

from _torch_parity import REPO, seeded_trees
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models.builder import GraphModel as JGraphModel
from yolodl_torch.bridge import params_from_jax
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.graph.from_darknet import graph_from_darknet as t_graph
from yolodl_torch.models import GraphModel

torch.set_num_threads(2)


def resized_cfg(name, size):
    with open(os.path.join(REPO, "cfg", "darknet", f"{name}.cfg")) as f:
        text = f.read()
    text = re.sub(r"(?m)^height *= *\d+", f"height={size}", text)
    return re.sub(r"(?m)^width *= *\d+", f"width={size}", text)


@pytest.mark.parametrize("name,size,kinds", [
    ("yolov2", 64, {"Reorg2D", "Detect2D"}),
    ("enet-coco", 64, {"DarknetScaleChannels", "GlobalAvgPool2D"}),
    ("darknet19", 64, {"GlobalAvgPool2D", "Softmax", "Identity"}),
    ("cspx-p7-mish", 128, {"DarknetSam"}),
])
def test_real_cfg_matches_reference(name, size, kinds):
    text = resized_cfg(name, size)
    jm = JGraphModel(j_graph(j_dk.Darknet.from_str(text)), spd_stem="off")
    params, state = seeded_trees(jm.init, 0)
    tm = GraphModel(t_graph(t_dk.Darknet.from_str(text)), device="cpu")
    tm.load_state_dict(params_from_jax(params, state))
    assert kinds <= {n.config.kind for n in tm.graph.nodes.values()}
    x = np.random.default_rng(1).uniform(0, 1, (2, 3, size, size)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False))(params, state, x)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    if isinstance(out, torch.Tensor):
        pairs = [(out.numpy(), np.asarray(ref).transpose(0, 3, 1, 2))]
    else:
        pairs = [(getattr(out, f).numpy(), np.asarray(getattr(ref, f)))
                 for f in ("cycxhw", "obj_logit", "class_logit")]
        assert [i.feature_h for i in out.infos] == [i.feature_h for i in ref.infos]
    for o, r in pairs:
        assert o.shape == r.shape
        assert np.isfinite(o).all()
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4 * np.abs(r).max())
