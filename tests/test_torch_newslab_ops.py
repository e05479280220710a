"""Parity of the port's NEWSLAB layer functions with the JAX reference:
avg pool, dynamic pad, sum and concat (ops/simple.py), DeconvBn2D
(ops/conv.py), DarkCsp2D and SppCsp2D (ops/blocks.py), and the builder's
``remat="blocks"``.

The same numpy inputs and parameters (seeded numpy trees of the shapes the
reference's init gives, carried to the port with the bridge's kernel
layout) go through both on the CPU in f32.
The reference is NHWC and the port NCHW.  Tolerances: pooling, padding and
sums are exact or elementwise (rtol 1e-6); convolutions sum in another
order, so deconv and blocks use rtol 1e-4 with atol 1e-5 (1e-4 · max|ref|
for the new BN state of a block, whose variance sums x² over the batch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import seeded_trees, small_newslab_batch, small_newslab_spec
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.ops import blocks as j_blocks
from yolodl_tpu.ops import conv as j_conv
from yolodl_tpu.ops import simple as j_simple
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.config import newslab as t_cfg
from yolodl_torch.graph import Graph as TGraph
from yolodl_torch.models import YoloModel
from yolodl_torch.ops import blocks as t_blocks
from yolodl_torch.ops import conv as t_conv
from yolodl_torch.ops import simple as t_simple

torch.set_num_threads(2)

CONV = dict(rtol=1e-4, atol=1e-5)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def to_nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def torch_tree(tree):
    """A reference params/state tree with torch leaves; kernels HWIO →
    the port's [out, in, k, k] (the bridge's permutation)."""
    return {k: torch_tree(v) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).permute(3, 2, 0, 1).contiguous()
            if k == "w" else torch.from_numpy(np.array(v, np.float32))
            for k, v in tree.items()}


def assert_trees_close(out, ref, **tol):
    assert out.keys() == ref.keys()
    for k in ref:
        if isinstance(ref[k], dict):
            assert_trees_close(out[k], ref[k], **tol)
        else:
            np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(ref[k]), **tol)


# -- avg pool, dynamic pad, sum, concat ---------------------------------------


@pytest.mark.parametrize("size,sy,sx,padding,total", [
    (2, 2, 2, 0, None), (3, 1, 1, 1, None), (3, 2, 2, 1, None),
    (2, 1, 1, 0, 1), (3, 2, 1, 0, 3), (5, 1, 2, 2, None), (4, 3, 3, 0, 5),
])
@pytest.mark.parametrize("kind", ["avg", "max"])
def test_pool_matches_reference(size, sy, sx, padding, total, kind):
    x = np.random.default_rng(size * 7 + sy).normal(size=(2, 9, 11, 5)).astype(np.float32)
    ref = np.asarray(j_simple.max_pool2d(jnp.asarray(x), size, sy, sx, padding, total, kind))
    out = to_nhwc(t_simple.max_pool2d(nchw(x), size, sy, sx, padding, total, kind))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def test_avg_pool_divides_by_in_bounds_cells():
    """A window that half hangs over the border averages its in-bounds
    cells only (darknet local_avgpool), so a constant map stays constant."""
    x = torch.full((1, 2, 5, 5), 3.0)
    out = t_simple.max_pool2d(x, 3, 2, 2, total_padding=3, pool_kind="avg")
    torch.testing.assert_close(out, torch.full_like(out, 3.0), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="pool_kind"):
        t_simple.max_pool2d(x, 2, 2, 2, pool_kind="min")


@pytest.mark.parametrize("kind", ["zero", "replication", "reflection"])
@pytest.mark.parametrize("tblr", [(1, 2, 0, 3), (2, 0, 1, 1), (0, 0, 0, 0)])
def test_dynamic_pad_matches_reference(kind, tblr):
    x = np.random.default_rng(3).normal(size=(2, 5, 6, 3)).astype(np.float32)
    ref = np.asarray(j_simple.dynamic_pad2d(jnp.asarray(x), *tblr, kind=kind))
    out = to_nhwc(t_simple.dynamic_pad2d(nchw(x), *tblr, kind=kind))
    np.testing.assert_array_equal(out, ref)


def test_sum_and_concat_match_reference():
    rng = np.random.default_rng(4)
    xs = [rng.normal(size=(2, 4, 4, 3)).astype(np.float32) for _ in range(3)]
    np.testing.assert_array_equal(
        to_nhwc(t_simple.sum2d([nchw(x) for x in xs])),
        np.asarray(j_simple.sum2d([jnp.asarray(x) for x in xs])))
    ys = [rng.normal(size=(2, 4, 4, c)).astype(np.float32) for c in (2, 5, 1)]
    np.testing.assert_array_equal(
        to_nhwc(t_simple.concat2d([nchw(y) for y in ys])),
        np.asarray(j_simple.concat2d([jnp.asarray(y) for y in ys])))


# -- DeconvBn2D ---------------------------------------------------------------


DECONV_CASES = {
    "k3s2op1": dict(c=6, k=3, s=2, op=1),
    "k3s2op1d2": dict(c=6, k=3, s=2, op=1, d=2, p=1),
    "k2s2": dict(c=4, k=2, s=2, p=0),
    "k4s2p1_nobias": dict(c=5, k=4, s=2, p=1, bias=False),
    "k3s1_linear_nobn": dict(c=3, k=3, s=1, act="linear",
                             bn={"enabled": False}),
    "k5s3op2": dict(c=4, k=5, s=3, op=2, p=1),
}


def _layer(module, kind, spec):
    spec = dict(spec)
    bn = spec.pop("bn", {})
    return getattr(module, kind)(bn=module.BatchNormConfig(**bn), **spec)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", list(DECONV_CASES))
def test_deconv_matches_reference(case, train):
    spec = DECONV_CASES[case]
    jl, tl = _layer(j_cfg, "DeconvBn2D", spec), _layer(t_cfg, "DeconvBn2D", spec)
    in_c = 5
    params, state = seeded_trees(lambda k: j_conv.deconv_bn_init(k, jl, in_c), 2)
    x = np.random.default_rng(5).normal(size=(2, 7, 6, in_c)).astype(np.float32)
    ref, ref_state = jax.jit(j_conv.deconv_bn_apply, static_argnums=(3, 4))(
        params, state, jnp.asarray(x), jl, train)
    out, out_state = t_conv.deconv_bn_apply(torch_tree(params), torch_tree(state),
                                            nchw(x), tl, train)
    assert out.shape[2:] == ref.shape[1:3]
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), **CONV)
    assert_trees_close(out_state, ref_state, **CONV)


def test_deconv_kernel_is_not_flipped():
    """One input pixel, stride 1, no padding: the output is the kernel
    itself, unflipped, in both packages (the reference flips for
    lax.conv_transpose; torch's conv_transpose2d needs none)."""
    layer = t_cfg.DeconvBn2D(c=1, k=3, s=1, p=0, bias=False, act="linear",
                             bn=t_cfg.BatchNormConfig(enabled=False))
    w_hwio = np.arange(9, dtype=np.float32).reshape(3, 3, 1, 1)
    x = np.ones((1, 1, 1, 1), np.float32)
    ref, _ = j_conv.deconv_bn_apply({"w": w_hwio}, {}, jnp.asarray(x), layer, False)
    out, _ = t_conv.deconv_bn_apply(torch_tree({"w": w_hwio}), {}, nchw(x), layer, False)
    np.testing.assert_array_equal(np.asarray(ref)[0, :, :, 0], w_hwio[:, :, 0, 0])
    np.testing.assert_array_equal(to_nhwc(out)[0, :, :, 0], w_hwio[:, :, 0, 0])


def test_grouped_deconv_raises():
    layer = t_cfg.DeconvBn2D(c=4, k=3, s=2, g=2)
    with pytest.raises(NotImplementedError, match="grouped"):
        t_conv.deconv_bn_apply({"w": torch.zeros(4, 2, 3, 3)}, {}, torch.zeros(1, 4, 3, 3),
                               layer, False)


# -- DarkCsp2D and SppCsp2D ---------------------------------------------------


BLOCK_CASES = {
    "dark_r2": ("DarkCsp2D", dict(c=12, repeat=2)),
    "dark_noshort_half": ("DarkCsp2D", dict(c=6, repeat=1, shortcut=False, c_mul=0.5)),
    "spp_default": ("SppCsp2D", dict(c=10)),
    "spp_k159": ("SppCsp2D", dict(c=8, k=(1, 5, 9), c_mul=1.0)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_block_matches_reference(case, train):
    kind, spec = BLOCK_CASES[case]
    jl, tl = _layer(j_cfg, kind, spec), _layer(t_cfg, kind, spec)
    in_c = 8
    j_init, j_apply, t_apply = {
        "DarkCsp2D": (j_blocks.dark_csp_init, j_blocks.dark_csp_apply, t_blocks.dark_csp_apply),
        "SppCsp2D": (j_blocks.spp_csp_init, j_blocks.spp_csp_apply, t_blocks.spp_csp_apply),
    }[kind]
    params, state = seeded_trees(lambda k: j_init(k, jl, in_c), 6)
    x = np.random.default_rng(7).normal(size=(2, 9, 9, in_c)).astype(np.float32)
    ref, ref_state = jax.jit(j_apply, static_argnums=(3, 4, 5))(
        params, state, jnp.asarray(x), jl, in_c, train)
    out, out_state = t_apply(torch_tree(params), torch_tree(state), nchw(x), tl, in_c, train)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), **CONV)
    assert_trees_close(out_state, ref_state, rtol=1e-4, atol=1e-6)
    # the port's sub-convs are the reference tree's, with its shapes
    convs = (t_blocks.dark_csp_convs if kind == "DarkCsp2D" else t_blocks.spp_csp_convs)(tl, in_c)
    assert sorted(c[0] for c in convs) == sorted(params)
    for name, ci, co, k in convs:
        assert params[name]["w"].shape == (k, k, ci, co)


# -- the builder: NEWSLAB kinds, bridge, remat --------------------------------


def test_remat_blocks_changes_no_value():
    """remat="blocks": the same output, gradients and BN statistics after
    two training forwards and backwards as without it — the statistics
    are written once per forward, not again at the recompute."""
    from yolodl_torch.loss import LossConfig, yolo_loss

    graph = TGraph.from_model(t_cfg.parse_model_dict(small_newslab_spec()))
    plain = YoloModel(graph, device="cpu")
    remat = YoloModel(graph, device="cpu", remat="blocks")
    remat.load_state_dict(plain.state_dict())
    for model in (plain, remat):
        for seed in (1, 2):
            x, boxes, classes, mask = map(torch.from_numpy, small_newslab_batch(seed))
            out, _ = yolo_loss(model(x, train=True), boxes, classes, mask, LossConfig())
            out.total_loss.backward()
    for (k, a), b in zip(plain.state_dict().items(), remat.state_dict().values()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    for (k, a), b in zip(plain.named_parameters(), remat.parameters()):
        torch.testing.assert_close(b.grad, a.grad, rtol=1e-6, atol=1e-7, msg=k)
    with pytest.raises(ValueError, match="remat"):
        YoloModel(graph, device="cpu", remat="all")


def test_small_newslab_graph_and_bridge_match_reference():
    """Every NEWSLAB kind in one graph: forward (eval and train) and the
    new BN statistics against the reference through the bridge, and the
    bridge's round trip of nested block trees."""
    from yolodl_tpu.graph import Graph as JGraph
    from yolodl_tpu.models import YoloModel as JYoloModel

    jm = JYoloModel(JGraph.from_model(j_cfg.parse_model_dict(small_newslab_spec())), spd_stem="off")
    params, state = seeded_trees(jm.init, 8)
    tm = YoloModel(TGraph.from_model(t_cfg.parse_model_dict(small_newslab_spec())), device="cpu")
    params_from_jax(params, state, model=tm)
    back_p, back_s = params_to_jax(tm.state_dict())
    jax.tree_util.tree_map(np.testing.assert_array_equal, back_p,
                           jax.tree_util.tree_map(np.asarray, params))
    jax.tree_util.tree_map(np.testing.assert_array_equal, back_s,
                           jax.tree_util.tree_map(np.asarray, state))
    x = small_newslab_batch(3)[0]
    for train in (False, True):
        ref, ref_state = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=train))(
            params, state, jnp.asarray(x))
        out = tm(torch.from_numpy(x), train=train)
        for f in ("cycxhw", "obj_logit", "class_logit"):
            np.testing.assert_allclose(getattr(out, f).detach().numpy(),
                                       np.asarray(getattr(ref, f)), **CONV)
        _, t_state = params_to_jax(tm.state_dict())
        jax.tree_util.tree_map(
            lambda a, b: np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-6),
            t_state, ref_state)
