"""Checkpoints with optimizer state (``opt/``) cross-loaded between the
port and the JAX reference, and the next step after the resume.

The small graph of every NEWSLAB kind (``_torch_parity.small_newslab_spec``:
nested block parameters, a deconv) starts from the same seeded trees in
both packages.  One package takes a step and writes a checkpoint with
params, BN state and optimizer state; the other loads it and takes the
second step; that step is held against the writer's own second step.
The optimizer state is the reference's optax tree in both files: the same
keys (``opt/0/0/.mu/<node>/…``, ``.count`` int32, HWIO moments) and dtypes.

Tolerances: after the resumed step every parameter is within
1e-4 · max|ref| of its tensor (AdamW: the update is lr·m̂/(√v̂+eps) with
moments that agree, so rounding of the gradient moves an entry by much
less than lr), BN statistics within 1e-5 · max|ref|; the moments the
reader loaded equal the writer's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (flat_leaves, seeded_trees, small_newslab_batch,
                           small_newslab_spec, train_configs)
from yolodl_tpu.config import newslab as j_cfg
from yolodl_tpu.graph import Graph as JGraph
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.train import checkpoint as j_ckpt
from yolodl_tpu.train import loop as j_loop
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.config import newslab as t_cfg
from yolodl_torch.graph import Graph as TGraph
from yolodl_torch.models import YoloModel
from yolodl_torch.train import checkpoint as t_ckpt
from yolodl_torch.train import loop as t_loop

torch.set_num_threads(2)

CASES = {
    "adamw": dict(optimizer="adam", lr=1e-3, weight_decay=5e-4),
    "adam_clipped": dict(optimizer="adam", lr=1e-3, clip_grad_value=1.0, clip_grad_norm=5.0),
    "sgd_wd": dict(optimizer="sgd", lr=1e-2, weight_decay=5e-4),
}


def models():
    jm = JYoloModel(JGraph.from_model(j_cfg.parse_model_dict(small_newslab_spec())),
                    spd_stem="off")
    params, state = seeded_trees(jm.init, 21)
    tm = YoloModel(TGraph.from_model(t_cfg.parse_model_dict(small_newslab_spec())),
                   device="cpu")
    params_from_jax(params, state, model=tm)
    return jm, params, state, tm


def jax_step(jm, j_train_cfg):
    """The reference's train step (it donates its input state)."""
    step = j_loop.make_train_step(jm, j_loop.make_optimizer(j_train_cfg), j_train_cfg)
    return lambda ts, batch: step(ts, *map(jnp.asarray, batch))[0]


def jax_start(params, state, j_train_cfg):
    opt = j_loop.make_optimizer(j_train_cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    return j_loop.TrainState(p, jax.tree_util.tree_map(jnp.asarray, state), opt.init(p),
                             jnp.zeros((), jnp.int32), None)


def port_steps(ts, t_train_cfg, batches):
    step = t_loop.make_train_step(ts.model, ts.optimizer, t_train_cfg)
    for batch in batches:
        ts, _ = step(ts, *map(torch.from_numpy, batch))
    return ts


def assert_close_to(tm, j_ts):
    t_params, t_state = params_to_jax(tm.state_dict())
    jp, tp = flat_leaves(jax.tree_util.tree_map(np.asarray, j_ts.params)), flat_leaves(t_params)
    assert jp.keys() == tp.keys()
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0,
                                   atol=1e-4 * float(np.abs(jp[k]).max()), err_msg=k)
    js, ts = flat_leaves(jax.tree_util.tree_map(np.asarray, j_ts.state)), flat_leaves(t_state)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=0,
                                   atol=1e-5 * float(np.abs(js[k]).max()), err_msg=k)


def opt_files(path):
    with np.load(path) as data:
        return {k: (data[k].dtype, data[k].shape) for k in data.files if k.startswith("opt/")}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_state_crosses_both_ways(case, tmp_path):
    b1, b2 = small_newslab_batch(31), small_newslab_batch(32)
    j_train_cfg, t_train_cfg = train_configs(**CASES[case])
    jm, params, state, tm = models()
    step = jax_step(jm, j_train_cfg)

    # the reference writes after one step; the port resumes and takes step 2
    j_ts1 = step(jax_start(params, state, j_train_cfg), b1)
    j_path = j_ckpt.save_checkpoint(str(tmp_path / "j"), 1, 0.5, j_ts1.params, j_ts1.state,
                                    j_ts1.opt_state)
    j_opt1 = flat_leaves(reference_tree(j_ts1.opt_state))
    j_ts2 = step(j_ts1, b2)
    ts, _ = t_loop.train_init(tm, t_train_cfg)
    p, s, opt, meta = t_ckpt.load_checkpoint(
        j_path, *params_to_jax(tm.state_dict()), t_loop.optimizer_state_tree(ts, t_train_cfg))
    assert meta["has_opt"] and opt is not None
    params_from_jax(p, s, model=tm)
    ts.step = meta["step"]
    t_loop.load_optimizer_state_tree(ts, t_train_cfg, opt)
    back = flat_leaves(t_loop.optimizer_state_tree(ts, t_train_cfg))
    assert back.keys() == j_opt1.keys()
    for k, v in j_opt1.items():
        assert back[k].dtype == v.dtype
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    assert_close_to(port_steps(ts, t_train_cfg, [b2]).model, j_ts2)

    # the port writes after one step; the reference resumes and takes step 2
    _, _, _, tm2 = models()
    ts, _ = t_loop.train_init(tm2, t_train_cfg)
    ts = port_steps(ts, t_train_cfg, [b1])
    t_path = t_ckpt.save_checkpoint(str(tmp_path / "t"), 1, 0.5,
                                    *params_to_jax(tm2.state_dict()),
                                    t_loop.optimizer_state_tree(ts, t_train_cfg))
    assert opt_files(t_path) == opt_files(j_path)
    tpl = jax_start(params, state, j_train_cfg)
    jp, js, jopt, jmeta = j_ckpt.load_checkpoint(t_path, tpl.params, tpl.state, tpl.opt_state)
    assert jmeta["has_opt"]
    j_resumed = j_loop.TrainState(jp, js, jopt, jnp.asarray(jmeta["step"], jnp.int32), None)
    port_steps(ts, t_train_cfg, [b2])
    assert_close_to(tm2, step(j_resumed, b2))


def reference_tree(opt_state):
    """The reference's optax state as the port's nested-dict spelling."""
    from yolodl_tpu.utils.trees import path_entry_str

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(opt_state)[0]:
        node = out
        keys = [path_entry_str(p) for p in path]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(leaf)
    return out


def test_optimizer_state_tree_layout():
    """Step 0: zero moments and counts, in optax's layout for each chain."""
    _, _, _, tm = models()
    for case, first, count in (("adamw", "0/0", "0/2"), ("adam_clipped", "2/0", "2/1"),
                               ("sgd_wd", "1/0", "1/1")):
        _, t_train_cfg = train_configs(**CASES[case])
        ts, _ = t_loop.train_init(tm, t_train_cfg)
        flat = flat_leaves(t_loop.optimizer_state_tree(ts, t_train_cfg))
        assert flat[f"{count}/.count"].dtype == np.int32
        field = ".trace" if case.startswith("sgd") else ".mu"
        assert flat[f"{first}/{field}/stem/w"].shape == (3, 3, 3, 8)
        assert flat[f"{first}/{field}/csp/repeat_1_second/bn/scale"].shape == (8,)
        assert not any(v.any() for v in flat.values())

