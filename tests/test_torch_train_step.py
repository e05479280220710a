"""The port's training step beyond the 5-step parity of test_torch_train.py:
gradient accumulation (against the reference and against micro-batches run
by hand), ``make_multi_step`` against single steps, gradient clipping
against optax, the step's metrics and their keys, bf16 compute, a step
with the darknet-exact loss, and the errors.  yolov4-tiny at 64², batch 2, f32, as there.

Tolerances: one SGD step at lr 3e-4 from the same weights agrees to
1e-5 · max|ref| per tensor (the first gradient agrees to 4e-5 of its
largest entry); the port against itself (accumulation by hand, multi-step
against single steps) runs the same operations in the same order, rel
1e-6; clipping is elementwise f32, rel 1e-6; the metrics are means over
the same cells, rel 1e-3 (the maxima of gradients carry the gradient's
rounding).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (REPO, named_leaves, train_batches, train_configs, train_models,
                           train_port, train_reference)
from yolodl_tpu.train import loop as j_loop
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.train import loop as t_loop

torch.set_num_threads(2)


def test_accumulation_matches_reference_and_sequential_microtrain_batches():
    """accum=2: the gradient is the mean of two micro-batches' gradients and
    the BN statistics thread through them in order — as the reference's
    scan does, and as two micro-batches run by hand do."""
    jm, params, state, tm = train_models()
    j_cfg, t_cfg = train_configs(optimizer="sgd", lr=3e-4, momentum=0.0)
    batch = train_batches(1, seed=1)[0]
    j_ts, j_losses = train_reference(jm, params, state, j_cfg, [batch], accum=2)
    t_ts, t_losses = train_port(tm, t_cfg, [batch], accum=2)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    after_accum = {k: v.clone() for k, v in tm.state_dict().items()}
    jp = named_leaves(j_ts.params)
    tp = named_leaves(params_to_jax(after_accum)[0])
    for k in jp:
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=1e-5 * float(np.abs(jp[k]).max()),
                                   err_msg=k)

    # by hand: two micro-batches, gradients summed, halved, one SGD update
    params_from_jax(params, state, tm)
    _, opt = t_loop.train_init(tm, t_cfg)
    grads_of = t_loop.make_batch_grads(tm, t_cfg)
    halves = [[torch.from_numpy(x[i:i + 1]) for x in batch] for i in range(2)]
    losses = [float(grads_of(*h)["total_loss"]) for h in halves]
    with torch.no_grad():
        for p in tm.parameters():
            p.sub_(3e-4 * p.grad / 2)
    assert np.mean(losses) == pytest.approx(t_losses[0], rel=1e-6)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, after_accum[k], rtol=1e-6, atol=1e-7, msg=k)


def test_multi_step_equals_single_steps():
    jm, params, state, tm = train_models()
    _, t_cfg = train_configs(optimizer="adam", lr=1e-5, use_ema=True, log_weights_and_grads=True)
    batches = train_batches(2, seed=2)
    ts, opt = t_loop.train_init(tm, t_cfg)
    multi = t_loop.make_multi_step(tm, opt, t_cfg, k=2)
    stacked = [torch.from_numpy(np.stack(x)) for x in zip(*batches)]
    ts, metrics = multi(ts, *stacked)
    assert ts.step == 2 and metrics["total_loss"].shape == (2,)
    multi_sd = {k: v.clone() for k, v in tm.state_dict().items()}
    multi_ema = {k: v.clone() for k, v in ts.ema_params.items()}

    params_from_jax(params, state, tm)
    ts, opt = t_loop.train_init(tm, t_cfg)
    step = t_loop.make_train_step(tm, opt, t_cfg)
    singles = []
    for batch in batches:
        ts, m = step(ts, *map(torch.from_numpy, batch))
        singles.append(m)
    for key in metrics:
        torch.testing.assert_close(metrics[key], torch.stack([m[key] for m in singles]),
                                   rtol=1e-6, atol=0, msg=key)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, multi_sd[k], rtol=1e-6, atol=1e-8, msg=k)
    for k, v in ts.ema_params.items():
        torch.testing.assert_close(v, multi_ema[k], rtol=1e-6, atol=1e-8, msg=k)


@pytest.mark.parametrize("value,norm", [(0.01, None), (None, 0.05), (None, 1e3), (0.01, 0.02)])
def test_gradient_clipping_matches_optax(value, norm):
    rng = np.random.default_rng(4)
    grads = {f"g{i}": (rng.normal(size=s) * 0.02).astype(np.float32)
             for i, s in enumerate([(3, 4), (17,), (2, 2, 5)])}
    chain = []
    if value is not None:
        chain.append(optax.clip(value))
    if norm is not None:
        chain.append(optax.clip_by_global_norm(norm))
    tx = optax.chain(*chain)
    j_grads = {k: jnp.asarray(v) for k, v in grads.items()}
    ref, _ = tx.update(j_grads, tx.init(j_grads))
    params = [torch.nn.Parameter(torch.zeros(v.shape)) for v in grads.values()]
    for p, v in zip(params, grads.values()):
        p.grad = torch.from_numpy(v.copy())
    t_loop._clip_gradients(params, t_loop.TrainConfig(clip_grad_value=value,
                                                      clip_grad_norm=norm))
    for p, k in zip(params, grads):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-9)


def test_step_metrics_and_maxima_keys_match_reference():
    jm, params, state, tm = train_models()
    kw = dict(optimizer="sgd", lr=3e-4, log_weights_and_grads=True, benchmark_confidence=0.3,
              debug_stat=True, return_obj_sample=True)
    j_cfg, t_cfg = train_configs(**kw)
    batch = train_batches(1, seed=3)[0]
    opt = j_loop.make_optimizer(j_cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    j_ts = j_loop.TrainState(p, jax.tree_util.tree_map(jnp.asarray, state), opt.init(p),
                             jnp.zeros((), jnp.int32), None)
    _, j_m = j_loop.make_train_step(jm, opt, j_cfg)(j_ts, *map(jnp.asarray, batch))
    ts, t_opt = t_loop.train_init(tm, t_cfg)
    _, t_m = t_loop.make_train_step(tm, t_opt, t_cfg)(ts, *map(torch.from_numpy, batch))
    assert set(t_m) == set(j_m)
    for k in j_m:
        assert not t_m[k].requires_grad, k
        np.testing.assert_allclose(t_m[k].numpy(), np.asarray(j_m[k]), rtol=1e-3,
                                   atol=1e-3 * float(np.abs(np.asarray(j_m[k])).max()) + 1e-7,
                                   err_msg=k)


def test_bf16_compute_keeps_f32_state():
    _, _, _, tm = train_models()
    _, t_cfg = train_configs(optimizer="adam", lr=1e-5, compute_dtype="bfloat16")
    ts, opt = t_loop.train_init(tm, t_cfg)
    ts, m = t_loop.make_train_step(tm, opt, t_cfg)(ts, *map(torch.from_numpy, train_batches(1)[0]))
    assert torch.isfinite(m["total_loss"]) and int(m["num_matched"]) > 0
    assert all(v.dtype == torch.float32 for v in tm.state_dict().values())
    assert all(s["exp_avg"].dtype == torch.float32 for s in opt.state.values())


def test_darknet_loss_step_trains():
    """TrainConfig(darknet_loss=...) on yolov4-tiny's two [yolo] heads: the
    step takes the raw head convs, returns the reference's darknet metric
    keys as detached device tensors, and moves every parameter.  (The
    step's parity with the reference: test_torch_darknet_loss_step.py.)"""
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.loss.darknet_loss import METRIC_KEYS, head_params_from_darknet

    _, _, _, tm = train_models()
    net = dk.Darknet.load(os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg"))
    spec = (tm.graph.detect_head_input_keys(),
            tuple(head_params_from_darknet(l, 64, 64) for l in net.layers
                  if isinstance(l, dk.Yolo)))
    assert len(spec[0]) == len(spec[1]) == 2
    _, cfg = train_configs(optimizer="sgd", lr=3e-4, momentum=0.9)
    cfg = dataclasses.replace(cfg, darknet_loss=spec)
    before = {k: v.clone() for k, v in tm.named_parameters()}
    ts, opt = t_loop.train_init(tm, cfg)
    ts, m = t_loop.make_train_step(tm, opt, cfg)(ts, *map(torch.from_numpy, train_batches(1)[0]))
    assert set(m) == {"total_loss", *METRIC_KEYS}
    assert all(not v.requires_grad for v in m.values())
    assert torch.isfinite(m["total_loss"]) and int(m["num_matched"]) > 0
    assert all(not torch.equal(v, before[k]) for k, v in tm.named_parameters())


def test_unknown_optimizer_and_bad_accum_raise():
    _, _, _, tm = train_models()
    with pytest.raises(ValueError, match="unknown optimizer"):
        t_loop.train_init(tm, t_loop.TrainConfig(optimizer="lamb"))
    with pytest.raises(ValueError, match="accum"):
        t_loop.make_batch_grads(tm, t_loop.TrainConfig(), accum=0)
