"""The port's deployment artifact (``yolodl_torch/models/export.py``) on the
CPU: a ``torch.export`` program and ``meta.json``, against the live port
model and against the reference's live model through the bridge (atol
1e-5, as tests/test_export.py), NHWC against NCHW, a bf16 program, a
Gaussian head's uncertainty, the serving artifact fed to NMS, and the
version and device mismatches.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.graph import Graph as JGraph
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_torch.bridge import params_from_jax
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.config import newslab as t_cfg
from yolodl_torch.graph import Graph as TGraph
from yolodl_torch.graph.from_darknet import graph_from_darknet as t_graph
from yolodl_torch.loss import non_max_suppression, yolo_inference
from yolodl_torch.models import YoloModel
from yolodl_torch.models.export import export_inference, load_exported

from _torch_parity import seeded_trees

torch.set_num_threads(2)

SPEC = {
    "main_group": "m",
    "groups": {"m": [
        {"name": "input", "kind": "Input", "shape": ["_", 3, 32, 32]},
        {"kind": "ConvBn2D", "c": 8, "k": 3, "s": 2},
        {"kind": "ConvBn2D", "c": 16, "k": 3, "s": 2},
        {"name": "head", "kind": "ConvBn2D", "c": 7 * 2, "k": 1,
         "act": "linear", "bn": {"enabled": False}},
        {"name": "det", "kind": "Detect2D", "classes": 2,
         "anchors": [[0.3, 0.3], [0.6, 0.6]]},
        {"name": "output", "kind": "MergeDetect2D", "from": ["det"]},
    ]},
}

GAUSSIAN = """[net]
width=32
height=32
channels=3

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
filters=22
size=1
stride=1
pad=1
activation=linear

[Gaussian_yolo]
mask=0,1
anchors=4,6, 10,12
classes=2
num=2
"""

FIELDS = ("cycxhw", "obj_logit", "class_logit")


@pytest.fixture(scope="module")
def models():
    """(reference model, params, state, port model): the same seeded weights."""
    jm = JYoloModel(JGraph.from_model(j_cfg.parse_model_dict(SPEC)), spd_stem="off")
    params, state = seeded_trees(jm.init, 3)
    tm = YoloModel(TGraph.from_model(t_cfg.parse_model_dict(SPEC)), device="cpu")
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


def images(seed, shape=(2, 3, 32, 32)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def test_artifact_matches_live_models(models, tmp_path):
    jm, params, state, tm = models
    path = export_inference(tm, str(tmp_path / "art"), batch_size=2, image_size=32)
    assert sorted(os.listdir(path)) == ["meta.json", "model.pt2"]
    infer, meta = load_exported(path, device="cpu")
    assert meta["num_classes"] == 2 and meta["device"] == "cpu"
    assert meta["input_shape"] == [2, 3, 32, 32] and meta["input_dtype"] == "float32"
    assert meta["torch_version"] == torch.__version__ and not meta["has_uncertainty"]
    x = images(0)
    with torch.no_grad():
        live = tm(torch.from_numpy(x))
        art = infer(torch.from_numpy(x))
    ref, _ = jm.apply(params, state, x, train=False)
    for f in FIELDS:
        assert torch.equal(getattr(art, f), getattr(live, f)), f
        np.testing.assert_allclose(getattr(art, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-5)
    assert art.infos == live.infos and art.uncertainty is None


def test_nhwc_artifact_matches_nchw(models, tmp_path):
    tm = models[3]
    nchw, _ = load_exported(export_inference(tm, str(tmp_path / "c"), batch_size=2,
                                             image_size=32), device="cpu")
    nhwc, meta = load_exported(export_inference(tm, str(tmp_path / "h"), batch_size=2,
                                                image_size=32, data_format="NHWC"),
                               device="cpu")
    assert meta["input_shape"] == [2, 32, 32, 3] and meta["data_format"] == "NHWC"
    x = torch.from_numpy(images(1))
    with torch.no_grad():
        a, b = nchw(x), nhwc(x.permute(0, 2, 3, 1).contiguous())
    for f in FIELDS:
        np.testing.assert_allclose(getattr(b, f).numpy(), getattr(a, f).numpy(), atol=1e-5)


def test_bf16_artifact_equals_live_bf16(models, tmp_path):
    tm = models[3]
    infer, meta = load_exported(export_inference(tm, str(tmp_path / "bf"), batch_size=2,
                                                 image_size=32, dtype="bfloat16"),
                                device="cpu")
    assert meta["input_dtype"] == "bfloat16"
    x = torch.from_numpy(images(2)).to(torch.bfloat16)
    with torch.no_grad():
        art, live = infer(x), tm(x)
    for f in FIELDS:
        assert getattr(art, f).dtype == torch.bfloat16
        assert torch.equal(getattr(art, f), getattr(live, f)), f


def test_serving_artifact_feeds_nms(models, tmp_path):
    """uint8 NHWC in, the service's bf16/255 inside: the live model on the
    same normalize, bit for bit, and the output goes through NMS."""
    tm = models[3]
    infer, meta = load_exported(export_inference(tm, str(tmp_path / "s"), batch_size=2,
                                                 image_size=32, serving=True),
                                device="cpu")
    assert meta["serving"] and meta["input_dtype"] == "uint8"
    assert meta["input_shape"] == [2, 32, 32, 3]
    u8 = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3),
                                                            dtype=np.uint8))
    with torch.no_grad():
        art = infer(u8)
        live = tm(u8.to(torch.bfloat16) / 255.0, data_format="NHWC")
        for f in FIELDS:
            assert torch.equal(getattr(art, f), getattr(live, f)), f
        nms = non_max_suppression(art, iou_threshold=0.5, confidence_threshold=0.001,
                                  class_mode="argmax")
        out = yolo_inference(nms, art.num_flats)
    assert out.valid.shape[0] == 2 and bool(out.valid.any())


def test_gaussian_head_keeps_uncertainty(tmp_path):
    jm = JYoloModel(j_graph(j_dk.Darknet.from_str(GAUSSIAN)), spd_stem="off")
    params, state = seeded_trees(jm.init, 5)
    tm = YoloModel(t_graph(t_dk.Darknet.from_str(GAUSSIAN)), device="cpu")
    tm.load_state_dict(params_from_jax(params, state))
    infer, meta = load_exported(export_inference(tm, str(tmp_path / "g"), batch_size=2,
                                                 image_size=32), device="cpu")
    assert meta["has_uncertainty"]
    x = images(4)
    with torch.no_grad():
        art = infer(torch.from_numpy(x))
    ref, _ = jm.apply(params, state, x, train=False)
    for f in FIELDS + ("uncertainty",):
        np.testing.assert_allclose(getattr(art, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-5)


def test_mismatches_rejected(models, tmp_path):
    tm = models[3]
    path = export_inference(tm, str(tmp_path / "a"), batch_size=1, image_size=32)
    meta_path = os.path.join(path, "meta.json")
    with open(meta_path) as f:
        meta = json.load(f)
    with open(meta_path, "w") as f:
        json.dump({**meta, "device": "cuda"}, f)
    with pytest.raises(ValueError, match="exported on device 'cuda'.*cannot run on 'cpu'"):
        load_exported(path, device="cpu")
    with open(meta_path, "w") as f:
        json.dump({**meta, "format_version": 999}, f)
    with pytest.raises(ValueError, match="format"):
        load_exported(path, device="cpu")
    with pytest.raises(FileNotFoundError, match="no exported artifact directory"):
        load_exported(str(tmp_path / "missing"), device="cpu")
    with pytest.raises(ValueError, match="image_size is required"):
        export_inference(tm, str(tmp_path / "b"))


def test_default_device_raises_without_a_card(models, tmp_path, monkeypatch):
    path = export_inference(models[3], str(tmp_path / "a"), batch_size=1, image_size=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_exported(path)
