"""yolodl_torch/ops/spd_stem.py against yolodl_tpu/ops/spd_stem.py on the
same seeded inputs and parameters (``_torch_parity.seeded_trees``: every BN
scale, bias, mean and var drawn per channel, so a phase-major tiling done
as ``repeat_interleave`` shows), carried across by the bridge's kernel
mapping (HWIO → OIHW).

Exact: space_to_depth / depth_to_space and every weight builder (after the
HWIO ↔ OIHW transpose), and the gather's backward against the reference's
``.at[].set`` VJP up to the order of a sum of at most 4 terms.
``spd_stem_apply`` and ``spd_res_block_apply`` with BN on and off, eval
and train: outputs within atol 2e-5 / 3e-5 and the new BN state within
1e-5 (the reference test's tolerances), every gradient of a seeded
weighted sum of the output (the canonical kernels, BN parameters, biases
and the input; ``jax.grad`` against autograd) within 1e-5 of the largest
reference gradient of the call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import _named, flat_leaves, port_tree, seeded_trees
from yolodl_torch.bridge import _kernel_to_jax, _kernel_to_torch
from yolodl_torch.config import newslab as t_cfg
from yolodl_torch.ops import simple as t_simple
from yolodl_torch.ops import spd_stem as t_spd
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.ops import spd_stem as j_spd
from yolodl_tpu.ops.conv import conv_bn_init

torch.set_num_threads(2)


def conv_cfgs(pkg, bn, c0=8, c1=16, k0=3, s0=1, k1=3, s1=2, act="mish"):
    bn_cfg = pkg.BatchNormConfig(enabled=bn)
    return (pkg.ConvBn2D(c=c0, k=k0, s=s0, p=k0 // 2, act=act, order="bn_act",
                         bias=not bn, bn=bn_cfg),
            pkg.ConvBn2D(c=c1, k=k1, s=s1, p=k1 // 2, act=act, order="bn_act",
                         bias=not bn, bn=bn_cfg))


def pair_trees(layers, in_c, seed):
    """Seeded numpy (params, state) of two convs ``a`` and ``b``."""
    la, lb = layers

    def init(key):
        pa, sa = conv_bn_init(key, la, in_c)
        pb, sb = conv_bn_init(key, lb, la.c)
        return {"a": pa, "b": pb}, {"a": sa, "b": sb}

    return seeded_trees(init, seed)


def assert_pair_matches(j_fn, t_fn, params, state, x, train, out_atol, seed=0):
    """``j_fn(params, state, x_nhwc, train)`` and ``t_fn(port params, port
    state, x_nchw, train)`` → (output, new state): equal outputs (atol
    ``out_atol``), new states (atol 1e-5) and gradients of a seeded
    weighted sum of the output (1e-5 of the largest reference gradient)."""
    out_shape = jax.eval_shape(lambda xx: j_fn(params, state, xx, train)[0], x).shape
    r = np.random.default_rng(seed + 1).normal(size=out_shape).astype(np.float32)

    def j_loss(p, xx):
        out, new_state = j_fn(p, state, xx, train)
        return jnp.sum(out * r), (out, new_state)

    (_, (j_out, j_state)), (j_gp, j_gx) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))

    tp, ts = port_tree(params, grad=True), port_tree(state)
    tx = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    t_out, t_state = t_fn(tp, ts, tx, train)
    out = t_out.permute(0, 2, 3, 1)
    (out * torch.from_numpy(r)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out), rtol=0, atol=out_atol)
    j_flat = flat_leaves(j_state)
    t_flat = flat_leaves(jax.tree_util.tree_map(lambda t: t.detach().numpy(), t_state))
    assert set(j_flat) == set(t_flat)
    for k, v in j_flat.items():
        np.testing.assert_allclose(t_flat[k], v, rtol=0, atol=1e-5, err_msg=f"state {k}")
    if train:
        assert j_flat == {} or any(not np.array_equal(v, flat_leaves(state)[k])
                                   for k, v in j_flat.items())
    t_params = dict(_named(tp))
    grads = [("input", tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(j_gx))]
    for k, g in flat_leaves(j_gp).items():
        got = t_params[k].grad.numpy()
        grads.append((k, _kernel_to_jax(got) if k.endswith("w") else got, np.asarray(g)))
    g_max = max(float(np.abs(g).max()) for _, _, g in grads)
    for k, got, want in grads:
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * g_max, err_msg=f"grad {k}")


def test_space_to_depth_matches_and_round_trips():
    x = np.random.default_rng(0).normal(size=(2, 8, 6, 5)).astype(np.float32)
    ref = np.asarray(j_spd.space_to_depth(jnp.asarray(x), 2))
    got = t_spd.space_to_depth(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), 2)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), ref)
    assert t_spd.space_to_depth is t_simple.space_to_depth
    np.testing.assert_array_equal(t_spd.depth_to_space(got, 2).permute(0, 2, 3, 1).numpy(), x)
    np.testing.assert_array_equal(
        t_spd.depth_to_space(got, 2).numpy(),
        np.asarray(j_spd.depth_to_space(jnp.asarray(ref), 2)).transpose(0, 3, 1, 2))


@pytest.mark.parametrize("which", ["s1", "1x1", "stem"])
def test_weight_builders_equal_the_reference(which):
    rng = np.random.default_rng(3)
    if which == "s1":
        w = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
        refs = [j_spd.build_spd_s1_weights(jnp.asarray(w))]
        gots = [t_spd.build_spd_s1_weights(_kernel_to_torch(w))]
    elif which == "1x1":
        w = rng.normal(size=(1, 1, 6, 3)).astype(np.float32)
        refs = [j_spd.build_spd_1x1_weights(jnp.asarray(w))]
        gots = [t_spd.build_spd_1x1_weights(_kernel_to_torch(w))]
    else:
        w0 = rng.normal(size=(3, 3, 3, 8)).astype(np.float32)
        w1 = rng.normal(size=(3, 3, 8, 16)).astype(np.float32)
        refs = j_spd.build_spd_stem_weights(jnp.asarray(w0), jnp.asarray(w1))
        gots = t_spd.build_spd_stem_weights(_kernel_to_torch(w0), _kernel_to_torch(w1))
    for ref, got in zip(refs, gots):
        np.testing.assert_array_equal(_kernel_to_jax(got.numpy()), np.asarray(ref))


def test_packed_kernel_gradient_sums_into_the_canonical_kernel():
    """The gather's backward is the reference's scatter VJP: each canonical
    tap collects the cotangents of every packed entry it was copied to."""
    rng = np.random.default_rng(4)
    w = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    ct = rng.normal(size=(3, 3, 16, 24)).astype(np.float32)
    _, vjp = jax.vjp(j_spd.build_spd_s1_weights, jnp.asarray(w))
    (ref,) = vjp(jnp.asarray(ct))
    tw = _kernel_to_torch(w).requires_grad_(True)
    t_spd.build_spd_s1_weights(tw).backward(_kernel_to_torch(ct))
    np.testing.assert_allclose(_kernel_to_jax(tw.grad.numpy()), np.asarray(ref),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_phase_grouped_bn_matches(train):
    rng = np.random.default_rng(5)
    c, phases = 6, 4
    params = {"scale": rng.uniform(0.5, 1.5, c), "bias": rng.normal(0, 0.3, c)}
    state = {"mean": rng.normal(0, 0.2, c), "var": rng.uniform(0.3, 2.0, c)}
    params, state = ({k: v.astype(np.float32) for k, v in t.items()} for t in (params, state))
    x = rng.normal(1.0, 2.0, size=(2, 5, 7, phases * c)).astype(np.float32)
    ref, ref_s = j_spd.phase_grouped_bn(params, state, jnp.asarray(x), train, phases=phases)
    got, got_s = t_spd.phase_grouped_bn(
        {k: torch.from_numpy(v) for k, v in params.items()},
        {k: torch.from_numpy(v) for k, v in state.items()},
        torch.from_numpy(x.transpose(0, 3, 1, 2).copy()), train, phases=phases)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s[k].numpy(), np.asarray(ref_s[k]), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_spd_stem_apply_matches(bn, train):
    jl, tl = conv_cfgs(j_cfg, bn), conv_cfgs(t_cfg, bn)
    params, state = pair_trees(jl, 3, seed=6)
    x = np.random.default_rng(7).normal(size=(2, 12, 16, 3)).astype(np.float32)

    def j_fn(p, s, xx, tr):
        out, sa, sb = j_spd.spd_stem_apply(p["a"], s["a"], jl[0], p["b"], s["b"], jl[1], xx, tr)
        return out, {"a": sa, "b": sb}

    def t_fn(p, s, xx, tr):
        out, sa, sb = t_spd.spd_stem_apply(p["a"], s["a"], tl[0], p["b"], s["b"], tl[1], xx, tr)
        return out, {"a": sa, "b": sb}

    assert_pair_matches(j_fn, t_fn, params, state, x, train, out_atol=2e-5)


@pytest.mark.parametrize("bn", [True, False])
@pytest.mark.parametrize("train", [False, True])
def test_spd_res_block_apply_matches(bn, train):
    c = 16
    kw = dict(c0=c // 2, c1=c, k0=1, s0=1, k1=3, s1=1)
    jl, tl = conv_cfgs(j_cfg, bn, **kw), conv_cfgs(t_cfg, bn, **kw)
    params, state = pair_trees(jl, c, seed=8)
    y1 = np.random.default_rng(9).normal(size=(2, 12, 20, c)).astype(np.float32)

    def j_fn(p, s, xx, tr):
        out, sa, sb = j_spd.spd_res_block_apply(p["a"], s["a"], jl[0], p["b"], s["b"], jl[1],
                                                "linear", xx, tr)
        return out, {"a": sa, "b": sb}

    def t_fn(p, s, xx, tr):
        out, sa, sb = t_spd.spd_res_block_apply(p["a"], s["a"], tl[0], p["b"], s["b"], tl[1],
                                                "linear", xx, tr)
        return out, {"a": sa, "b": sb}

    assert_pair_matches(j_fn, t_fn, params, state, y1, train, out_atol=3e-5)


def test_eligibility_matches():
    cases = [
        dict(),
        dict(k0=3, s0=2),
        dict(s1=1),
        dict(k0=1),
        dict(k0=1, s0=1, k1=3, s1=1),
        dict(k0=3, s0=1, k1=1, s1=1),
        dict(k0=1, s0=1, k1=3, s1=2),
    ]
    for kw in cases:
        jl, tl = conv_cfgs(j_cfg, True, **kw), conv_cfgs(t_cfg, True, **kw)
        assert t_spd.stem_is_eligible(*tl) == j_spd.stem_is_eligible(*jl), kw
        assert t_spd.res_block_is_eligible(*tl) == j_spd.res_block_is_eligible(*jl), kw
    assert t_spd.stem_is_eligible(*conv_cfgs(t_cfg, True))
    assert t_spd.res_block_is_eligible(*conv_cfgs(t_cfg, True, k0=1, s0=1, k1=3, s1=1))
    newslab = t_cfg.ConvBn2D(c=8, k=3, s=1, p=1, order="act_bn")
    assert not t_spd.stem_is_eligible(newslab, conv_cfgs(t_cfg, True)[1])
    grouped = t_cfg.ConvBn2D(c=8, k=3, s=1, p=1, g=2, order="bn_act")
    assert not t_spd.stem_is_eligible(grouped, conv_cfgs(t_cfg, True)[1])
