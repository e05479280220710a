"""The whole model's training forward against the JAX reference: one
forward(train=True) + yolo_loss + backward on yolov4-tiny at 64², batch 2,
f32, from the same weights: the loss, every parameter's gradient, the new
BN running statistics written into the model's buffers, the inference
forward leaving them alone, and frozen layers (``stop_gradient_paths``).

Tolerance: gradients through training-mode BN rtol 1e-4 / atol
1e-4 · max|ref| per tensor (the same bound as the forward parity,
test_torch_model.py); BN statistics are f32 means summed in another order,
rtol 1e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import REPO, named_leaves, random_targets, reference_and_port
from yolodl_tpu.graph.from_darknet import load_darknet_graph as j_load
from yolodl_tpu.loss import yolo_loss as j_yolo_loss
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.graph.from_darknet import load_darknet_graph as t_load
from yolodl_torch.loss import yolo_loss as t_yolo_loss
from yolodl_torch.models import YoloModel

torch.set_num_threads(2)


def _loss_and_grads(jm, params, state, tm, size=64, seed=0):
    """One training forward + loss + backward in both; returns the
    reference's (loss, grads, new_state) and the port's loss."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (2, 3, size, size)).astype(np.float32)
    boxes, classes, mask = random_targets(2, 8, seed + 1)

    def loss_fn(p, s):
        pred, new_state = jm.apply(p, s, jnp.asarray(x), train=True)
        out, _ = j_yolo_loss(pred, jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(mask))
        return out.total_loss, new_state

    (j_l, j_state), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, state))
    pred = tm(torch.from_numpy(x), train=True)
    out, _ = t_yolo_loss(pred, *map(torch.from_numpy, (boxes, classes, mask)))
    out.total_loss.backward()
    return float(j_l), j_grads, j_state, float(out.total_loss.detach())


def test_model_train_forward_writes_bn_state_and_grads_match():
    jm, params, state, tm = reference_and_port("yolov4-tiny")
    j_l, j_grads, j_state, t_l = _loss_and_grads(jm, params, state, tm)
    assert t_l == pytest.approx(j_l, rel=1e-5)
    t_grads, _ = params_to_jax({k: p.grad for k, p in tm.named_parameters()})
    jg, tg = named_leaves(j_grads), named_leaves(t_grads)
    assert jg.keys() == tg.keys()
    for k in jg:
        scale = float(np.abs(jg[k]).max())
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-4 * scale, err_msg=k)
    _, t_state = params_to_jax(tm.state_dict())
    js, ts = named_leaves(j_state), named_leaves(t_state)
    assert js.keys() == ts.keys() and len(js) > 0
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_inference_forward_leaves_bn_state_alone():
    _, params, state, tm = reference_and_port("yolov4-tiny")
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tm.train()  # nn.Module's flag is not the mode: only the keyword is
    with torch.no_grad():
        tm(torch.zeros((1, 3, 64, 64)))
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_frozen_layers_get_no_gradient():
    """darknet stopbackward: the frozen prefix's parameters get exactly zero
    gradient in both, and the rest agree."""
    path = os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg")
    frozen = frozenset(f"layer{i}" for i in range(6))
    j_graph, t_graph = j_load(path), t_load(path)
    j_graph.stop_gradient_paths = frozen
    t_graph.stop_gradient_paths = frozen
    _, params, state, _ = reference_and_port("yolov4-tiny")
    jm = JYoloModel(j_graph, spd_stem="off")
    tm = YoloModel(t_graph, device="cpu")
    params_from_jax(params, state, tm)
    _, j_grads, _, _ = _loss_and_grads(jm, params, state, tm, seed=3)
    t_grads, _ = params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad
                                for k, p in tm.named_parameters()})
    jg, tg = named_leaves(j_grads), named_leaves(t_grads)
    n_frozen = 0
    for k in jg:
        if k.split("/")[0] in frozen:
            n_frozen += 1
            assert not np.any(jg[k]) and not np.any(tg[k]), k
        else:
            scale = float(np.abs(jg[k]).max())
            assert scale > 0, k
            np.testing.assert_allclose(tg[k], jg[k], rtol=1e-4, atol=1e-4 * scale, err_msg=k)
    assert n_frozen >= 6
