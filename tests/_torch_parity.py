"""Shared set-up of the whole-model parity tests (test_torch_model*.py,
test_torch_serve.py): the JAX reference and the port with the same weights."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_torch.bridge import params_from_jax
from yolodl_torch.graph.from_darknet import load_darknet_graph as t_load
from yolodl_torch.models import YoloModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def randomize_bn(params, state, seed):
    """Numpy copies of the reference trees with BN stats that keep the
    activation scale near 1 (scale ~1, var ~0.2 after a uniform-init conv)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(np.asarray, params)
    state = jax.tree_util.tree_map(np.asarray, state)
    for p in params.values():
        if "bn" in p:
            c = p["bn"]["scale"].shape[0]
            p["bn"]["scale"] = rng.uniform(0.8, 1.2, c).astype(np.float32)
            p["bn"]["bias"] = rng.normal(0, 0.2, c).astype(np.float32)
    for s in state.values():
        c = s["bn"]["mean"].shape[0]
        s["bn"]["mean"] = rng.normal(0, 0.05, c).astype(np.float32)
        s["bn"]["var"] = rng.uniform(0.1, 0.3, c).astype(np.float32)
    return params, state


def reference_and_port(cfg_name, seed=0):
    path = os.path.join(REPO, "cfg", "darknet", f"{cfg_name}.cfg")
    jm = JYoloModel(j_load(path), spd_stem="off")
    params, state = randomize_bn(*jm.init(jax.random.PRNGKey(seed)), seed)
    tm = YoloModel(t_load(path), device="cpu")
    tm.load_state_dict(params_from_jax(params, state))
    return jm, params, state, tm


def assert_forward_matches(cfg_name, size=64):
    """Port and reference forward on the same seeded input, NCHW and NHWC:
    rtol 1e-4 with atol 1e-4 * max|ref| (f32 convolutions sum in another
    order, and the difference grows with depth)."""
    jm, params, state, tm = reference_and_port(cfg_name)
    x = np.random.default_rng(1).uniform(0, 1, (2, 3, size, size)).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, x: jm.apply(p, s, x, train=False))(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, state), jnp.asarray(x))
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
        out_nhwc = tm(torch.from_numpy(x).permute(0, 2, 3, 1), data_format="NHWC")
    for f in ("cycxhw", "obj_logit", "class_logit"):
        r = np.asarray(getattr(ref, f))
        o = getattr(out, f).numpy()
        assert o.shape == r.shape
        assert np.abs(r).max() > 0.05, f"{f}: activations collapsed"
        np.testing.assert_allclose(o, r, rtol=1e-4, atol=1e-4 * np.abs(r).max())
        np.testing.assert_array_equal(getattr(out_nhwc, f).numpy(), o)
    assert [i.feature_h for i in out.infos] == [i.feature_h for i in ref.infos]
