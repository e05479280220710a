"""BN folding in yolodl_torch (``models/fold.py``, ``ops/norm.py``
``fold_batch_norm``) against yolodl_tpu's: the formulas (rtol 1e-6, as
tests/test_fold.py), the file-level fold of yolov4-tiny (the same cfg text,
byte-identical ``.weights``), the folded model's forward against the
unfolded one, and the skip of shared-weight convs.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import REPO, seeded_trees
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.models import fold as j_fold
from yolodl_tpu.models.weights import save_darknet_weights as j_save
from yolodl_tpu.ops import fold_batch_norm as j_fold_batch_norm
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.models import fold as t_fold
from yolodl_torch.models import zoo
from yolodl_torch.ops.norm import fold_batch_norm

torch.set_num_threads(2)

TINY = os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg")


def _bn_arrays(seed=0, c_in=8, c_out=16):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(3, 3, c_in, c_out)).astype(np.float32),   # HWIO
            rng.uniform(0.5, 2.0, c_out).astype(np.float32),           # scale
            rng.normal(size=c_out).astype(np.float32),                 # bias
            rng.normal(size=c_out).astype(np.float32),                 # mean
            rng.uniform(0.1, 3.0, c_out).astype(np.float32))           # var


def test_fold_formulas_match_reference():
    w, scale, bias, mean, var = _bn_arrays()
    fw_ref, fb_ref = j_fold.fold_conv_bn_arrays(w, scale, bias, mean, var)
    fw, fb = t_fold.fold_conv_bn_arrays(w, scale, bias, mean, var)
    np.testing.assert_array_equal(fw, fw_ref)
    np.testing.assert_array_equal(fb, fb_ref)

    conv_b = np.random.default_rng(1).normal(size=16).astype(np.float32)
    for b in (None, conv_b):
        jw, jb = j_fold_batch_norm(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
            {"mean": jnp.asarray(mean), "var": jnp.asarray(var)},
            jnp.asarray(w), None if b is None else jnp.asarray(b))
        tw, tb = fold_batch_norm(
            {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
            {"mean": torch.from_numpy(mean), "var": torch.from_numpy(var)},
            torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),  # OIHW
            None if b is None else torch.from_numpy(b))
        np.testing.assert_allclose(tw.numpy().transpose(2, 3, 1, 0), np.asarray(jw),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-5)
    # the numpy mirror and the tensor form agree
    tw, tb = fold_batch_norm(
        {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
        {"mean": torch.from_numpy(mean), "var": torch.from_numpy(var)},
        torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), None)
    np.testing.assert_allclose(tw.numpy().transpose(2, 3, 1, 0), fw, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), fb, rtol=1e-6, atol=1e-5)


def test_fold_files_byte_identical_to_reference(tmp_path):
    """yolov4-tiny with seeded weights and BN statistics: both packages'
    fold_darknet_files write the same cfg text and the same bytes, and the
    port's folded model gives the unfolded model's outputs."""
    d = j_dk.Darknet.load(TINY)
    params, state = seeded_trees(JYoloModel(j_graph(d), spd_stem="off").init, 7)
    src_c, src_w = tmp_path / "tiny.cfg", tmp_path / "tiny.weights"
    src_c.write_text(j_dk.to_cfg_string(d))
    j_save(d, params, state, src_w, seen=77)

    outs = {}
    for name, fold in (("ref", j_fold), ("port", t_fold)):
        out_c, out_w = tmp_path / f"{name}.cfg", tmp_path / f"{name}.weights"
        counts = fold.fold_darknet_files(src_c, src_w, out_c, out_w)
        outs[name] = (counts, out_c.read_text(), out_w.read_bytes())
    assert outs["port"][0] == outs["ref"][0]
    assert outs["port"][0][0] > 10 and outs["port"][0][1] == 0
    assert outs["port"][1] == outs["ref"][1]
    assert outs["port"][2] == outs["ref"][2]
    assert "batch_normalize=1" not in outs["port"][1]

    x = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 3, 96, 96))
                         .astype(np.float32))
    unfolded = zoo.load_darknet_model(str(src_c), str(src_w), device="cpu")
    folded = zoo.load_darknet_model(str(tmp_path / "port.cfg"),
                                    str(tmp_path / "port.weights"), device="cpu")
    assert not any(getattr(m, "bn", None) is not None for m in folded.layers.values())
    with torch.no_grad():
        a, b = unfolded(x), folded(x)
    for f in ("cycxhw", "obj_logit", "class_logit"):
        r, o = getattr(a, f), getattr(b, f)
        torch.testing.assert_close(o, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


def test_shared_weight_convs_are_skipped():
    """share_index aliases keep their BN — folding one side would corrupt
    the other; the port's fold returns the trees unchanged, as the
    reference's."""
    text = """[net]
width=32
height=32
channels=3

[convolutional]
filters=8
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=8
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky
share_index=-1

[convolutional]
filters=6
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0
anchors=10,14
classes=1
num=1
"""
    jd = j_dk.Darknet.from_str(text)
    params, state = seeded_trees(JYoloModel(j_graph(jd)).init, 3)
    _, jp, js = j_fold.fold_darknet(jd, params, state)
    folded, fp, fs = t_fold.fold_darknet(t_dk.Darknet.from_str(text), params, state)
    assert folded.layers[0].batch_normalize and folded.layers[1].batch_normalize
    assert fp == params and fs == state
    assert jax.tree_util.tree_structure(fp) == jax.tree_util.tree_structure(jp)
    assert t_fold._share_sources(t_dk.Darknet.from_str(text)) == {0}
