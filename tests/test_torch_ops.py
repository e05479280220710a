"""Parity of the port's layer functions (yolodl_torch) with the JAX reference.

Each test feeds the same numpy inputs, made from a seeded
``np.random.default_rng``, to the JAX function and to its PyTorch
counterpart on the CPU in f32.  The reference is NHWC and the port NCHW, so
inputs and outputs are transposed at the boundary.

Tolerances: f32 elementwise math agrees to a few ulps (XLA's and PyTorch's
CPU libraries evaluate exp/log1p/tanh with different polynomials), so
elementwise tests use rtol 1e-5 / atol 1e-6.  Convolutions sum in another
order, so they use rtol 1e-4 / atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolodl_tpu import activations as j_act
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.ops import conv as j_conv
from yolodl_tpu.ops import detect as j_detect
from yolodl_tpu.ops import norm as j_norm
from yolodl_tpu.ops import simple as j_simple
from yolodl_torch import activations as t_act
from yolodl_torch.config import newslab as t_cfg
from yolodl_torch.ops import conv as t_conv
from yolodl_torch.ops import detect as t_detect
from yolodl_torch.ops import norm as t_norm
from yolodl_torch.ops import simple as t_simple

torch.set_num_threads(2)

EW = dict(rtol=1e-5, atol=1e-6)      # elementwise
CONV = dict(rtol=1e-4, atol=1e-5)    # reductions in another order


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def to_nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


# -- activations -------------------------------------------------------------


def test_activation_tables_agree():
    assert t_act.ALL_ACTIVATIONS == j_act.ALL_ACTIVATIONS
    assert t_act.DARKNET_NAMES == j_act.DARKNET_NAMES


@pytest.mark.parametrize("name", j_act.ALL_ACTIVATIONS)
def test_activation(name):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 5, 4, 6)) * 8).astype(np.float32)  # NHWC
    x[0, 0, 0, :] = [-40.0, -20.5, 0.0, 20.5, 30.0, 45.0]  # softplus threshold
    ref = np.asarray(j_act.apply(name, jnp.asarray(x)))
    out = to_nhwc(t_act.apply(name, nchw(x)))
    np.testing.assert_allclose(out, ref, **EW)


def test_activation_resolve_darknet_spelling():
    assert t_act.resolve("LEAKY") is t_act.leaky
    with pytest.raises(KeyError):
        t_act.resolve("nope")


# -- batch norm --------------------------------------------------------------


def _bn_inputs(rng, c=6):
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(size=c).astype(np.float32)}
    state = {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    x = (rng.normal(size=(3, 5, 4, c)) * 2 + 1).astype(np.float32)
    return params, state, x


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm(train):
    rng = np.random.default_rng(1)
    params, state, x = _bn_inputs(rng)
    ref, ref_state = j_norm.batch_norm_apply(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x), train)
    out, out_state = t_norm.batch_norm_apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in state.items()}, nchw(x), train)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), **CONV)
    for k in ("mean", "var"):
        np.testing.assert_allclose(out_state[k].numpy(), np.asarray(ref_state[k]), **CONV)


def test_batch_norm_bf16_casts_scale_and_shift():
    """inv/shift are computed in f32 and cast to the activation dtype."""
    rng = np.random.default_rng(2)
    params, state, x = _bn_inputs(rng)
    ref, _ = j_norm.batch_norm_apply(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state),
        jnp.asarray(x, jnp.bfloat16), False)
    out, _ = t_norm.batch_norm_apply(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in state.items()},
        nchw(x).to(torch.bfloat16), False)
    assert out.dtype == torch.bfloat16
    # one bf16 rounding of x*inv, one of the sum: within 2 bf16 ulps
    np.testing.assert_allclose(to_nhwc(out.float()), np.asarray(ref, np.float32),
                               rtol=2 ** -7, atol=2 ** -7)


# -- conv + bn ---------------------------------------------------------------


@pytest.mark.parametrize("order,act,k,s,g,bias", [
    ("bn_act", "mish", 3, 1, 1, False),
    ("bn_act", "leaky", 3, 2, 2, True),
    ("act_bn", "mish", 1, 1, 1, True),
    ("act_bn", "logistic", 3, 2, 1, False),
])
def test_conv_bn_apply(order, act, k, s, g, bias):
    rng = np.random.default_rng(3)
    in_c, out_c = 4, 6
    kw = dict(c=out_c, k=k, s=s, g=g, bias=bias, act=act, order=order)
    j_layer, t_layer = j_cfg.ConvBn2D(**kw), t_cfg.ConvBn2D(**kw)
    w = rng.normal(size=(k, k, in_c // g, out_c)).astype(np.float32) * 0.3  # HWIO
    params, state, _ = _bn_inputs(rng, out_c)
    x = rng.normal(size=(2, 9, 9, in_c)).astype(np.float32)
    b = rng.normal(size=out_c).astype(np.float32)
    jp = {"w": jnp.asarray(w), "bn": jax.tree_util.tree_map(jnp.asarray, params)}
    tp = {"w": torch.from_numpy(w).permute(3, 2, 0, 1).contiguous(),
          "bn": {k2: torch.from_numpy(v) for k2, v in params.items()}}
    if bias:
        jp["b"], tp["b"] = jnp.asarray(b), torch.from_numpy(b)
    ref, _ = j_conv.conv_bn_apply(jp, {"bn": jax.tree_util.tree_map(jnp.asarray, state)},
                                  jnp.asarray(x), j_layer, False)
    out, _ = t_conv.conv_bn_apply(tp, {"bn": {k2: torch.from_numpy(v) for k2, v in state.items()}},
                                  nchw(x), t_layer, False)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), **CONV)


def test_conv2d_apply_dilated_with_bias():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    x = rng.normal(size=(1, 11, 11, 3)).astype(np.float32)
    ref = j_conv.conv2d_apply(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                              stride=1, padding=2, dilation=2)
    out = t_conv.conv2d_apply(nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1),
                              torch.from_numpy(b), stride=1, padding=2, dilation=2)
    np.testing.assert_allclose(to_nhwc(out), np.asarray(ref), **CONV)


# -- pooling and resampling ----------------------------------------------------


@pytest.mark.parametrize("size,stride,padding,total_padding", [
    (3, 1, 1, None),      # symmetric, torch style
    (2, 2, 0, 1),         # yolov4-tiny: asymmetric lo=0, hi=1
    (5, 1, 0, 4),         # SPP 5
    (13, 1, 0, 12),       # SPP 13 (the reference chains 3x3 pools)
    (3, 2, 0, 3),         # odd total padding, stride 2
])
def test_max_pool2d(size, stride, padding, total_padding):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 13, 13, 3)).astype(np.float32)
    ref = j_simple.max_pool2d(jnp.asarray(x), size, stride, stride, padding, total_padding)
    out = t_simple.max_pool2d(nchw(x), size, stride, stride, padding, total_padding)
    assert out.shape == (2, 3) + ref.shape[1:3]
    np.testing.assert_array_equal(to_nhwc(out), np.asarray(ref))


@pytest.mark.parametrize("scale", [2.0, 1.5])
def test_upsample2d(scale):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 4, 6, 3)).astype(np.float32)
    ref = j_simple.upsample2d(jnp.asarray(x), scale)
    out = t_simple.upsample2d(nchw(x), scale)
    np.testing.assert_array_equal(to_nhwc(out), np.asarray(ref))


def test_downsample_concat_sum():
    rng = np.random.default_rng(7)
    a = rng.normal(size=(2, 6, 6, 3)).astype(np.float32)
    b = rng.normal(size=(2, 6, 6, 2)).astype(np.float32)
    np.testing.assert_array_equal(to_nhwc(t_simple.downsample2d(nchw(a), 2)),
                                  np.asarray(j_simple.downsample2d(jnp.asarray(a), 2)))
    np.testing.assert_array_equal(
        to_nhwc(t_simple.concat2d([nchw(a), nchw(b)])),
        np.asarray(j_simple.concat2d([jnp.asarray(a), jnp.asarray(b)])))
    np.testing.assert_array_equal(
        to_nhwc(t_simple.sum2d([nchw(a), nchw(a)])),
        np.asarray(j_simple.sum2d([jnp.asarray(a), jnp.asarray(a)])))


# -- detection heads -----------------------------------------------------------

ANCHORS = ((0.1, 0.2), (0.3, 0.25), (0.5, 0.6))


def _decode_kwargs(case):
    return {
        "scaled": dict(order="anchor_major", variant="scaled", scale_xy=2.0,
                       entry_layout="xywh"),
        "darknet": dict(order="entry_major", variant="darknet", scale_xy=1.05,
                        entry_layout="cycxhw"),
        "gaussian": dict(order="anchor_major", variant="darknet", scale_xy=1.0,
                         entry_layout="xywh", gaussian=True),
    }[case]


def _head(rng, classes, case, h=5, w=7):
    e = (9 if case == "gaussian" else 5) + classes
    return rng.normal(size=(2, h, w, len(ANCHORS) * e)).astype(np.float32)


@pytest.mark.parametrize("case", ["scaled", "darknet", "gaussian"])
def test_detect_decode(case):
    rng = np.random.default_rng(8)
    x = _head(rng, 4, case)
    kw = _decode_kwargs(case)
    ref = j_detect.detect_decode(jnp.asarray(x), ANCHORS, 4, **kw)
    out = t_detect.detect_decode(nchw(x), ANCHORS, 4, **kw)
    for f in ("cycxhw", "obj_logit", "class_logit", "uncertainty", "sigmas"):
        r, o = getattr(ref, f), getattr(out, f)
        if r is None:
            assert o is None
            continue
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **EW)
    assert out.anchors == ref.anchors


def test_merge_detections():
    rng = np.random.default_rng(9)
    kw = _decode_kwargs("scaled")
    shapes = [(8, 8), (4, 4), (2, 2)]
    xs = [_head(rng, 3, "scaled", h, w) for h, w in shapes]
    ref = j_detect.merge_detections(
        [j_detect.detect_decode(jnp.asarray(x), ANCHORS, 3, **kw) for x in xs])
    out = t_detect.merge_detections(
        [t_detect.detect_decode(nchw(x), ANCHORS, 3, **kw) for x in xs])
    assert out.num_flats == ref.num_flats == 3 * (64 + 16 + 4)
    for f in ("cycxhw", "obj_logit", "class_logit"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), **EW)
    np.testing.assert_allclose(out.confidence().numpy(), np.asarray(ref.confidence()), **EW)
    assert [dataclass_tuple(i) for i in out.infos] == [dataclass_tuple(i) for i in ref.infos]


def dataclass_tuple(info):
    return (info.feature_h, info.feature_w, info.anchors, info.flat_begin,
            info.flat_end, info.class_act)


def test_softmax_class_prob():
    rng = np.random.default_rng(10)
    kw = dict(order="anchor_major", variant="darknet", scale_xy=1.0,
              entry_layout="xywh", class_activation="softmax")
    x = _head(rng, 5, "darknet")
    ref = j_detect.merge_detections([j_detect.detect_decode(jnp.asarray(x), ANCHORS, 5, **kw)])
    out = t_detect.merge_detections([t_detect.detect_decode(nchw(x), ANCHORS, 5, **kw)])
    np.testing.assert_allclose(out.class_prob().numpy(), np.asarray(ref.class_prob()), **EW)
