"""Parity of the training path's parts with the JAX reference: the lr
schedule, EMA, the training-mode BN state of ConvBn2D,
``clamp_running_vars`` and the weight bridge in both directions (the
whole model's training forward is in test_torch_train_model.py).

Tolerances: the port's schedule function is the reference's pure-Python
``lr_at_step``, so the two are equal; the reference's traced version
computes powers in f32, rel 1e-5 from it over 50 steps; EMA and BN statistics
are f32 elementwise or f32 means summed in another order, rtol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import REPO, named_leaves, reference_and_port
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.graph import Graph as JGraph
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.ops import conv as j_conv
from yolodl_tpu.train import ema as j_ema
from yolodl_tpu.train import lr_schedule as j_lr
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.config import newslab as t_cfg
from yolodl_torch.graph import Graph as TGraph
from yolodl_torch.graph.from_darknet import load_darknet_graph as t_load
from yolodl_torch.models import YoloModel
from yolodl_torch.ops import conv as t_conv
from yolodl_torch.train import ema as t_ema
from yolodl_torch.train import lr_schedule as t_lr

torch.set_num_threads(2)

# -- lr schedule ---------------------------------------------------------------

SCHEDULES = [
    dict(kind="constant", lr=0.01),
    dict(kind="stepwise", steps=((0, 0.1), (10, 0.01), (25, 0.001))),
    dict(kind="darknet", lr=0.01, policy="constant", burn_in=8),
    dict(kind="darknet", lr=0.01, policy="steps", darknet_steps=(10, 30),
         darknet_scales=(0.1, 0.5), burn_in=5, burn_in_power=4.0),
    dict(kind="darknet", lr=0.1, policy="step", step_size=7, step_scale=0.5),
    dict(kind="darknet", lr=0.1, policy="exp", gamma=0.97),
    dict(kind="darknet", lr=0.01, policy="poly", max_batches=40, burn_in_power=2.0),
    dict(kind="darknet", lr=0.1, policy="sig", gamma=0.3, step_size=20),
    dict(kind="darknet", lr=0.1, policy="sgdr", sgdr_cycle=6, sgdr_mult=2, lr_min=1e-4,
         burn_in=3),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: kw.get("policy", kw["kind"]))
def test_lr_schedule(kw):
    j_conf, t_conf = j_lr.LrScheduleConfig(**kw), t_lr.LrScheduleConfig(**kw)
    j_fn, t_fn = j_lr.make_schedule_fn(j_conf), t_lr.make_schedule_fn(t_conf)
    for step in range(50):
        want = j_lr.lr_at_step(j_conf, step)
        assert t_lr.lr_at_step(t_conf, step) == want
        got = t_fn(step)
        assert isinstance(got, float) and got == want
        assert got == pytest.approx(float(j_fn(jnp.int32(step))), rel=1e-5, abs=1e-12)


@pytest.mark.parametrize("raw", [None, 0.02, {"type": "Constant", "lr": 0.5},
                                 {"type": "StepWise", "steps": [[0, 0.1], [5, 0.01]]},
                                 {"type": "FromModelCfg"}])
def test_lr_schedule_parse(raw):
    assert (dataclasses_dict(t_lr.LrScheduleConfig.parse(raw))
            == dataclasses_dict(j_lr.LrScheduleConfig.parse(raw)))


@pytest.mark.parametrize("cfg_name", ["yolov4-csp", "yolov4-tiny", "yolov3"])
def test_lr_schedule_from_darknet(cfg_name):
    path = os.path.join(REPO, "cfg", "darknet", f"{cfg_name}.cfg")
    j_conf = j_lr.lr_schedule_from_darknet(j_dk.Darknet.load(path).net)
    t_conf = t_lr.lr_schedule_from_darknet(t_dk.Darknet.load(path).net)
    assert dataclasses_dict(t_conf) == dataclasses_dict(j_conf)


@pytest.mark.parametrize("kw,match", [
    (dict(kind="stepwise", steps=((5, 0.1),)), "start from zero"),
    (dict(kind="stepwise", steps=((0, 0.1), (0, 0.2))), "monotonic"),
    (dict(kind="constant", lr=-1.0), "positive"),
    (dict(kind="darknet", policy="sgdr"), "sgdr"),
])
def test_lr_schedule_validation(kw, match):
    with pytest.raises(ValueError, match=match):
        t_lr.LrScheduleConfig(**kw)


def test_make_schedule_fn_rejects_unknown_policy():
    with pytest.raises(ValueError, match="unsupported darknet lr policy"):
        t_lr.make_schedule_fn(t_lr.LrScheduleConfig(kind="darknet", policy="random"))


def dataclasses_dict(obj):
    import dataclasses

    return dataclasses.asdict(obj)


# -- EMA -----------------------------------------------------------------------


def test_ema_update():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=7).astype(np.float32)}
    j_e = j_ema.ema_init({k: jnp.asarray(v) for k, v in params.items()})
    t_e = t_ema.ema_init({k: torch.from_numpy(v) for k, v in params.items()})
    for step in (1, 2, 50, 3000):
        new = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        j_e = j_ema.ema_update(j_e, {k: jnp.asarray(v) for k, v in new.items()},
                               jnp.int32(step), 0.999)
        out = t_ema.ema_update(t_e, {k: torch.from_numpy(v) for k, v in new.items()}, step,
                               0.999)
        assert out is t_e  # updated in place
        for k in params:
            np.testing.assert_allclose(t_e[k].numpy(), np.asarray(j_e[k]), rtol=1e-5, atol=1e-6)


# -- training-mode BN ------------------------------------------------------------


@pytest.mark.parametrize("order", ["bn_act", "act_bn"])
def test_conv_bn_train_returns_new_state(order):
    rng = np.random.default_rng(3)
    kw = dict(c=6, k=3, s=1, act="leaky", order=order, bias=False)
    w = (rng.normal(size=(3, 3, 4, 6)) * 0.3).astype(np.float32)
    bn_p = {"scale": rng.uniform(0.8, 1.2, 6).astype(np.float32),
            "bias": rng.normal(0, 0.2, 6).astype(np.float32)}
    bn_s = {"mean": rng.normal(0, 0.1, 6).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, 6).astype(np.float32)}
    x = rng.normal(size=(2, 7, 7, 4)).astype(np.float32)
    ref, ref_state = j_conv.conv_bn_apply(
        {"w": jnp.asarray(w), "bn": jax.tree_util.tree_map(jnp.asarray, bn_p)},
        {"bn": jax.tree_util.tree_map(jnp.asarray, bn_s)}, jnp.asarray(x),
        j_cfg.ConvBn2D(**kw), True)
    out, out_state = t_conv.conv_bn_apply(
        {"w": torch.from_numpy(w).permute(3, 2, 0, 1),
         "bn": {k: torch.from_numpy(v) for k, v in bn_p.items()}},
        {"bn": {k: torch.from_numpy(v) for k, v in bn_s.items()}},
        torch.from_numpy(x).permute(0, 3, 1, 2), t_cfg.ConvBn2D(**kw), True)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                               rtol=1e-4, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(out_state["bn"][k].numpy(), np.asarray(ref_state["bn"][k]),
                                   rtol=1e-5, atol=1e-6)


# -- clamp_running_vars ------------------------------------------------------------

_CLAMPED = {
    "main_group": "m",
    "groups": {"m": [
        {"name": "input", "kind": "Input", "shape": ["_", 3, 16, 16]},
        {"kind": "ConvBn2D", "c": 8, "k": 3, "bn": {"var_min": 0.5, "var_max": 1.5}},
        {"kind": "ConvBn2D", "c": 8, "k": 3, "bn": {"var_max": 0.8}},
        {"kind": "ConvBn2D", "c": 8, "k": 1},
        {"name": "head", "kind": "Conv2D", "c": 2 * 7, "k": 1},
        {"name": "det", "kind": "Detect2D", "classes": 2,
         "anchors": [[0.3, 0.4], [0.6, 0.5]]},
        {"name": "output", "kind": "MergeDetect2D", "from": ["det"]},
    ]},
}


def test_clamp_running_vars():
    jm = JYoloModel(JGraph.from_model(j_cfg.parse_model_dict(_CLAMPED)), spd_stem="off")
    params, state = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    state = jax.tree_util.tree_map(
        lambda a: rng.uniform(0.0, 2.0, a.shape).astype(np.float32), state)
    tm = YoloModel(TGraph.from_model(t_cfg.parse_model_dict(_CLAMPED)), device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, params), state, tm)
    ref = jm.clamp_running_vars(jax.tree_util.tree_map(jnp.asarray, state))
    tm.clamp_running_vars()
    _, t_state = params_to_jax(tm.state_dict())
    js, ts = named_leaves(ref), named_leaves(t_state)
    assert js.keys() == ts.keys()
    for k in js:
        np.testing.assert_array_equal(ts[k], js[k], err_msg=k)
    changed = [k for k in js if not np.array_equal(named_leaves(state)[k], js[k])]
    assert len(changed) == 2  # the two clamped layers' variances


# -- bridge --------------------------------------------------------------------------


def test_bridge_round_trip_in_place():
    _, params, state, tm = reference_and_port("yolov4-tiny", seed=5)
    w = tm.layers["layer0"].w
    params_from_jax(params, state, tm)
    assert tm.layers["layer0"].w is w  # loaded in place
    back_p, back_s = params_to_jax(tm.state_dict())
    for a, b in ((params, back_p), (state, back_s)):
        la, lb = named_leaves(a), named_leaves(b)
        assert la.keys() == lb.keys()
        for k in la:
            np.testing.assert_array_equal(lb[k], la[k], err_msg=k)


def test_bridge_rejects_a_mismatched_model():
    _, params, state, _ = reference_and_port("yolov4-tiny")
    other = YoloModel(t_load(os.path.join(REPO, "cfg", "darknet", "yolov3-tiny.cfg")),
                      device="cpu")
    with pytest.raises(KeyError, match="disagree"):
        params_from_jax(params, state, other)
