"""Whole-model tests of yolodl_torch's YoloModel: parity with the JAX
reference on yolov4-tiny (route groups, leaky, darknet decode), structure,
init, device rule and import isolation.

The reference is built with ``spd_stem="off"``: its space-to-depth stem is
exact in math but not in floats, and the port computes without it.  The
same seeded weights go to both through ``yolodl_torch.bridge``.  BN
statistics are randomized so that activations keep their scale through the
network instead of shrinking towards 0.

Tolerance: f32 convolutions sum in another order in XLA and in PyTorch, and
the differences grow with depth; all three MergedDetection fields must
agree to rtol 1e-4 with atol 1e-4 · max|ref| (yolov4-csp runs 115 convs).
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_parity import REPO, assert_forward_matches, randomize_bn
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.graph import Graph as JGraph
from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_torch.bridge import params_from_jax
from yolodl_torch.config import newslab as t_cfg
from yolodl_torch.graph import Graph as TGraph
from yolodl_torch.graph.from_darknet import load_darknet_graph as t_load
from yolodl_torch.models import GraphModel, YoloModel

torch.set_num_threads(2)

def test_tiny_forward_matches_reference():
    assert_forward_matches("yolov4-tiny", 64)


def test_newslab_conv2d_model_matches_reference():
    """A NEWSLAB graph: act_bn ConvBn2D, a Conv2D head (bias, no BN), and the
    default entry-major cycxhw scaled decode."""
    spec = {
        "main_group": "m",
        "groups": {"m": [
            {"name": "input", "kind": "Input", "shape": ["_", 3, 32, 32]},
            {"kind": "ConvBn2D", "c": 8, "k": 3, "s": 2},
            {"name": "head", "kind": "Conv2D", "c": 2 * 7, "k": 1},
            {"name": "det", "kind": "Detect2D", "classes": 2,
             "anchors": [[0.3, 0.4], [0.6, 0.5]]},
            {"name": "output", "kind": "MergeDetect2D", "from": ["det"]},
        ]},
    }
    jm = JYoloModel(JGraph.from_model(j_cfg.parse_model_dict(spec)), spd_stem="off")
    params, state = randomize_bn(*jm.init(jax.random.PRNGKey(4)), 4)
    tm = YoloModel(TGraph.from_model(t_cfg.parse_model_dict(spec)), device="cpu")
    tm.load_state_dict(params_from_jax(params, state))
    x = np.random.default_rng(5).uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    ref, _ = jm.apply(params, state, x, train=False)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    for f in ("cycxhw", "obj_logit", "class_logit"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-6)


def test_csp_structure_and_init():
    path = os.path.join(REPO, "cfg", "darknet", "yolov4-csp.cfg")
    tm = YoloModel(t_load(path), device="cpu", generator=torch.Generator().manual_seed(3))
    jm = JYoloModel(j_load(path), spd_stem="off")
    jp, js = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(jp))
    n_port = sum(p.numel() for p in tm.parameters())
    assert n_port == n_ref == 52_921_437
    assert tm.num_classes == 80 and len(tm.anchors) == 3
    # same seed → same weights; kernels within the torch-default bound
    again = YoloModel(t_load(path), device="cpu", generator=torch.Generator().manual_seed(3))
    w0 = tm.layers["layer0"].w
    assert torch.equal(w0, again.layers["layer0"].w)
    assert float(w0.detach().abs().max()) <= 1 / np.sqrt(27)
    assert torch.equal(tm.layers["layer0"].bn.var, torch.ones(32))


def test_no_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    graph = t_load(os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        YoloModel(graph)


def test_unported_node_kind_names_roadmap_item():
    """The NEWSLAB Linear kind, which raised naming ROADMAP A12 until the
    dense kinds were ported: it builds and matches the reference, its
    weight the reference's ``[in, out]`` transposed and its input the
    NHWC flatten of the map."""
    from yolodl_tpu.models.builder import GraphModel as JGraphModel

    spec = {
        "main_group": "m",
        "groups": {"m": [
            {"name": "input", "kind": "Input", "shape": ["_", 3, 8, 8]},
            {"name": "output", "kind": "Linear", "out": 8},
        ]},
    }
    jm = JGraphModel(JGraph.from_model(j_cfg.parse_model_dict(spec)), spd_stem="off")
    params, state = jm.init(jax.random.PRNGKey(2))
    tm = GraphModel(TGraph.from_model(t_cfg.parse_model_dict(spec)), device="cpu")
    params_from_jax(params, state, model=tm)
    assert tuple(tm.layers["output"].w.shape) == (8, 3 * 8 * 8)
    x = np.random.default_rng(3).uniform(0, 1, (2, 3, 8, 8)).astype(np.float32)
    ref, _ = jm.apply(params, state, x, train=False)
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import yolodl_torch\n"
        "for m in pkgutil.walk_packages(yolodl_torch.__path__, 'yolodl_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k in ('jax', 'json5', 'google_crc32c')\n"
        "             or k.startswith(('jax.', 'json5.', 'yolodl_tpu')))\n"
        "n = sum(1 for k in sys.modules if k.startswith('yolodl_torch'))\n"
        "need = {'yolodl_torch.' + m for m in (\n"
        "    'train.loop', 'train.lr_schedule', 'train.ema', 'loss.matcher',\n"
        "    'loss.yolo_loss', 'loss.benchmark', 'kernels._util',\n"
        "    'kernels.wgrad_lowch', 'kernels.wgrad_db',\n"
        "    'config.json5_reader', 'config.app_config', 'data.records', 'data.datasets',\n"
        "    'data.records_cache', 'data.cache', 'data.color', 'data.affine',\n"
        "    'utils.trees', 'models.weights', 'models.zoo', 'train.checkpoint',\n"
        "    'loss.average_precision', 'train.evaluation', 'train.logging',\n"
        "    'cli._guard', 'cli._common', 'cli.detect_main', 'cli.eval_main',\n"
        "    'cli.serve_main', 'ops.blocks', 'utils.timing', 'data.mosaic',\n"
        "    'data.pipeline', 'data.tfrecord_cache', 'cli.train_main',\n"
        "    'loss.darknet_loss', 'models.fold', 'models.export', 'parallel.pipeline',\n"
        "    'cli.tool_main', 'ops.recurrent', 'train.classifier', 'cli.classify_main',\n"
        "    'utils.tensor_ext', 'units', 'data.device_augment', 'parallel.mesh',\n"
        "    'parallel.dp', 'parallel.zero', 'parallel.tp')}\n"
        "missing = sorted(need - set(sys.modules))\n"
        "print(n, bad, missing)\n"
        "sys.exit(1 if bad or missing or n < 50 else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
