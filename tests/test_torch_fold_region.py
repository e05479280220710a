"""yolodl_torch/ops/fold_region.py against yolodl_tpu/ops/fold_region.py,
and the fold region in a model.

Exact: ``fold_w``/``unfold_w`` (the NCHW fold gives the reference's NHWC
fold's channel order, phase·C + c) and both weight builders after the
HWIO ↔ OIHW transpose.  ``fold_conv_bn_apply`` for k1 and k3, both orders,
BN on and off, eval and train, on per-channel seeded BN statistics:
outputs and new BN state within atol 1e-5.  The eligibility rule on a grid
of channel counts.  In a model (the reference test's MINI_CFG, 24²): the
region the reference finds, port fold against reference fold (atol 2e-4,
BN state 1e-4, the reference test's), the fall-through at a width that is
no multiple of 4, and one unfold copy (the shortcut's output, the graph
output) where the reference records an unfolded output for every region
node.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import MINI_CFG, flat_leaves, port_tree, seeded_trees
from yolodl_torch.bridge import _kernel_to_jax, _kernel_to_torch, params_from_jax
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.config import newslab as t_cfg
from yolodl_torch.graph.from_darknet import graph_from_darknet as t_graph
from yolodl_torch.models.builder import GraphModel as TGraphModel
from yolodl_torch.ops import fold_region as t_fr
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models.builder import GraphModel as JGraphModel
from yolodl_tpu.ops import fold_region as j_fr
from yolodl_tpu.ops.conv import conv_bn_init

torch.set_num_threads(2)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def test_fold_unfold_match_the_reference():
    x = np.random.default_rng(0).normal(size=(2, 3, 8, 5)).astype(np.float32)
    ref = np.asarray(j_fr.fold_w(jnp.asarray(x)))
    got = t_fr.fold_w(nchw(x))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    np.testing.assert_array_equal(t_fr.unfold_w(got).numpy(), nchw(x).numpy())
    # channel index phase·C + c: folded cell 0 holds w = 0..3
    row = torch.arange(16.0).reshape(1, 1, 2, 8)
    np.testing.assert_array_equal(t_fr.fold_w(row)[0, :, 0, 0].numpy(), [0, 1, 2, 3])


@pytest.mark.parametrize("k", [1, 3])
def test_fold_weights_equal_the_reference(k):
    w = np.random.default_rng(k).normal(size=(k, k, 4, 5)).astype(np.float32)
    build_j = j_fr.fold_conv1x1_weights if k == 1 else j_fr.fold_conv3x3_weights
    build_t = t_fr.fold_conv1x1_weights if k == 1 else t_fr.fold_conv3x3_weights
    got = build_t(_kernel_to_torch(w))
    np.testing.assert_array_equal(_kernel_to_jax(got.numpy()), np.asarray(build_j(jnp.asarray(w))))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("order", ["bn_act", "act_bn"])
@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_fold_conv_bn_apply_matches(k, order, bn, train):
    def layer(pkg):
        return pkg.ConvBn2D(c=8, k=k, s=1, p=k // 2, act="mish", order=order,
                            bias=not bn, bn=pkg.BatchNormConfig(enabled=bn))

    jl, tl = layer(j_cfg), layer(t_cfg)
    params, state = seeded_trees(lambda key: conv_bn_init(key, jl, 4), 10 + k)
    x = np.random.default_rng(11).normal(size=(2, 6, 8, 4)).astype(np.float32)
    ref, ref_s = j_fr.fold_conv_bn_apply(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, state),
        j_fr.fold_w(jnp.asarray(x)), jl, train)
    got, got_s = t_fr.fold_conv_bn_apply(port_tree(params), port_tree(state),
                                         t_fr.fold_w(nchw(x)), tl, train)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    want = flat_leaves(ref_s)
    have = flat_leaves(jax.tree_util.tree_map(lambda t: t.numpy(), got_s))
    assert set(want) == set(have)
    for name, v in want.items():
        np.testing.assert_allclose(have[name], v, rtol=0, atol=1e-5, err_msg=name)


def test_eligibility_matches():
    for in_c in (3, 16, 32, 48, 64, 128):
        for out_c in (16, 32, 64, 128):
            for k, s in ((1, 1), (3, 1), (3, 2), (5, 1)):
                jl = j_cfg.ConvBn2D(c=out_c, k=k, s=s, p=None, act="mish", order="bn_act")
                tl = t_cfg.ConvBn2D(c=out_c, k=k, s=s, p=None, act="mish", order="bn_act")
                assert t_fr.conv_is_foldable(tl, in_c) == j_fr.conv_is_foldable(jl, in_c)
    assert (t_fr.FOLD, t_fr.MAX_CHANNEL_PRODUCT) == (j_fr.FOLD, j_fr.MAX_CHANNEL_PRODUCT)


@pytest.fixture(scope="module")
def mini():
    jg = j_graph(j_dk.Darknet.from_str(MINI_CFG))
    j_fold = JGraphModel(jg, spd_stem="off", fold_region="on")
    params, state = seeded_trees(j_fold.init, 12)
    t_fold = TGraphModel(t_graph(t_dk.Darknet.from_str(MINI_CFG)), device="cpu",
                         fold_region="on")
    t_fold.load_state_dict(params_from_jax(params, state))
    return j_fold, params, state, t_fold


@pytest.mark.parametrize("train", [False, True])
def test_mini_graph_matches(mini, train):
    j_fold, params, state, t_fold = mini
    assert sorted(t_fold._fold_keys) == sorted(j_fold._fold_keys)
    assert len(t_fold._fold_keys) == 3  # 1x1, 3x3, shortcut
    before = {k: v.clone() for k, v in t_fold.state_dict().items()}
    x = np.random.default_rng(13).normal(size=(2, 3, 24, 24)).astype(np.float32)
    ref, ref_s = j_fold.apply(params, state, jnp.asarray(x), train=train)
    got = t_fold(torch.from_numpy(x), train=train)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(ref),
                               rtol=0, atol=2e-4)
    sd = t_fold.state_dict()
    for name, v in params_from_jax(params, jax.tree_util.tree_map(np.asarray, ref_s)).items():
        if name.endswith(("mean", "var")):
            np.testing.assert_allclose(sd[name].numpy(), v.numpy(), rtol=0, atol=1e-4,
                                       err_msg=name)
    t_fold.load_state_dict(before)


def test_width_not_divisible_falls_back(mini, monkeypatch):
    """At 20² the region's width is 10: the nodes run canonically."""
    j_fold, params, state, t_fold = mini
    calls = []
    monkeypatch.setattr(t_fr, "fold_conv_bn_apply", lambda *a: calls.append(1))
    x = np.random.default_rng(14).normal(size=(1, 3, 20, 20)).astype(np.float32)
    ref, _ = j_fold.apply(params, state, jnp.asarray(x))
    with torch.no_grad():
        got = t_fold(torch.from_numpy(x))
    assert calls == []
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=2e-4)


def test_one_fold_and_one_unfold(mini, monkeypatch):
    """The region folds the stride-2 conv's output once (read by the 1×1
    conv and the shortcut) and unfolds only the shortcut's output, the
    graph output."""
    *_, t_fold = mini
    counts = {"fold": 0, "unfold": 0, "conv": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            counts[name] += 1
            return fn(*a, **kw)
        return wrapped

    for name, attr in (("fold", "fold_w"), ("unfold", "unfold_w"), ("conv", "fold_conv_bn_apply")):
        monkeypatch.setattr(t_fr, attr, counting(name, getattr(t_fr, attr)))
    with torch.no_grad():
        t_fold(torch.zeros(1, 3, 24, 24))
    assert counts == {"fold": 1, "unfold": 1, "conv": 2}
