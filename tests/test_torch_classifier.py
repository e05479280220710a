"""yolodl_torch/train/classifier.py against yolodl_tpu/train/classifier.py:
five steps of ``make_classifier_train_step`` in both packages from the same
weights and BN statistics (carried across by the bridge), on the toy
classifier of tests/test_cli.py's classify workspace ([avgpool] +
[connected] + [softmax] after two BN convs, 24², batch 6) fed seeded
colour-coded batches; ``_pre_softmax_key`` on a softmax sink, behind an
identity tail ([cost]) and without a softmax; and one step on
cfg/darknet/rnn.cfg with its time steps cut to 4.

Tolerances, as tests/test_torch_train.py sets them for the detector (f32
rounding through train-mode BN, amplified by later steps): each step's loss
and accuracy within rel 1e-5; SGD parameters and BN statistics within
3e-4 · max|ref| of their tensor; Adam (whose first update is the sign of
the gradient, so a gradient of rounding noise moves by ±lr in either
package) parameters within 1e-2 · max|ref| and each tensor's distance
from the reference within 15 % of the reference's change over the 5 steps,
BN statistics within 1e-3 · max|ref|.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import REPO, named_leaves, seeded_trees
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.graph.from_darknet import graph_from_darknet as t_graph
from yolodl_torch.models import GraphModel
from yolodl_torch.train import loop as t_loop
from yolodl_torch.train import classifier as t_cls
from yolodl_torch.train.lr_schedule import LrScheduleConfig as TLr
from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.models.builder import GraphModel as JGraphModel
from yolodl_tpu.train import classifier as j_cls
from yolodl_tpu.train import loop as j_loop
from yolodl_tpu.train.lr_schedule import LrScheduleConfig as JLr

torch.set_num_threads(2)

TOY = """[net]
height=24
width=24
channels=3
batch=1

[convolutional]
batch_normalize=1
filters=8
size=3
stride=2
pad=1
activation=leaky

[convolutional]
batch_normalize=1
filters=16
size=3
stride=2
pad=1
activation=leaky

[avgpool]

[connected]
output=3
activation=linear
"""

CASES = {
    "sgd": dict(optimizer="sgd", momentum=0.9, lr=1e-2),
    "adam": dict(optimizer="adam", momentum=0.9, lr=1e-3),
}


def colour_batches(n, batch=6, seed=0):
    """``n`` seeded batches of the colour-coded set of tests/test_cli.py:
    noise in [0, 60/255], the class's channel in [180/255, 1]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labels = rng.integers(0, 3, batch)
        images = rng.uniform(0, 60, (batch, 3, 24, 24))
        images[np.arange(batch), labels] = rng.uniform(180, 255, (batch, 24, 24))
        out.append(((images / 255).astype(np.float32), labels.astype(np.int32)))
    return out


def pair(text, seed=0):
    jm = JGraphModel(j_graph(j_dk.Darknet.from_str(text)), spd_stem="off")
    params, state = seeded_trees(jm.init, seed)
    tm = GraphModel(t_graph(t_dk.Darknet.from_str(text)), device="cpu")
    params_from_jax(params, state, model=tm)
    return jm, params, state, tm


@pytest.mark.parametrize("case", list(CASES))
def test_five_steps_match_reference(case):
    kw = dict(CASES[case])
    lr = kw.pop("lr")
    jm, params, state, tm = pair(TOY + "\n[softmax]\n", 1)
    batches = colour_batches(5)

    j_cfg = j_loop.TrainConfig(lr=JLr(kind="constant", lr=lr), **kw)
    opt = j_loop.make_optimizer(j_cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    ts = j_loop.TrainState(p, jax.tree_util.tree_map(jnp.asarray, state), opt.init(p),
                           jnp.zeros((), jnp.int32), None)
    step = j_cls.make_classifier_train_step(jm, opt, j_cfg)
    j_metrics = []
    for images, labels in batches:
        ts, m = step(ts, jnp.asarray(images), jnp.asarray(labels))
        j_metrics.append((float(m["loss"]), float(m["accuracy"])))

    t_cfg = t_loop.TrainConfig(lr=TLr(kind="constant", lr=lr), **kw)
    t_ts, t_opt = t_loop.train_init(tm, t_cfg)
    t_step = t_cls.make_classifier_train_step(tm, t_opt, t_cfg)
    t_metrics = []
    for images, labels in batches:
        t_ts, m = t_step(t_ts, torch.from_numpy(images), torch.from_numpy(labels))
        t_metrics.append((float(m["loss"]), float(m["accuracy"])))
    assert t_ts.step == 5
    np.testing.assert_allclose(t_metrics, j_metrics, rtol=1e-5)
    assert j_metrics[-1][0] < j_metrics[0][0]

    sgd = case == "sgd"
    t_params, t_state = params_to_jax(tm.state_dict())
    jp, tp, p0 = named_leaves(ts.params), named_leaves(t_params), named_leaves(params)
    assert jp.keys() == tp.keys()
    for k in jp:
        scale = float(np.abs(jp[k]).max())
        np.testing.assert_allclose(tp[k], jp[k], rtol=0, atol=(3e-4 if sgd else 1e-2) * scale,
                                   err_msg=k)
        if not sgd:
            assert np.linalg.norm(tp[k] - jp[k]) <= 0.15 * np.linalg.norm(jp[k] - p0[k]), k
    js, tst = named_leaves(ts.state), named_leaves(t_state)
    assert js.keys() == tst.keys()
    for k in js:
        np.testing.assert_allclose(tst[k], js[k], rtol=0,
                                   atol=(3e-4 if sgd else 1e-3) * float(np.abs(js[k]).max()),
                                   err_msg=k)


@pytest.mark.parametrize("tail", ["\n[softmax]\n", "\n[softmax]\n\n[cost]\ntype=sse\n", ""],
                         ids=["softmax", "identity_tail", "no_softmax"])
def test_pre_softmax_key(tail):
    text = TOY + tail
    jm = JGraphModel(j_graph(j_dk.Darknet.from_str(text)))
    tm = GraphModel(t_graph(t_dk.Darknet.from_str(text)), device="cpu")
    key = t_cls._pre_softmax_key(tm)
    assert key == j_cls._pre_softmax_key(jm)
    if tail:
        assert tm.graph.nodes[key].config.kind == "Linear"
    else:
        assert key is None


def test_logits_graph_trains_on_log_softmax():
    """A graph without a softmax sink: CE is log_softmax of its output
    (``output_is_prob=False``) or log of it clamped at 1e-12 (True), each
    as the reference computes it on the same weights and batch."""
    jm, params, state, tm = pair(TOY, 2)
    images, labels = colour_batches(1, seed=3)[0]
    for output_is_prob in (False, True):
        j_cfg = j_loop.TrainConfig(lr=JLr(kind="constant", lr=1e-3), optimizer="sgd")
        opt = j_loop.make_optimizer(j_cfg)
        p = jax.tree_util.tree_map(jnp.asarray, params)
        ts = j_loop.TrainState(p, jax.tree_util.tree_map(jnp.asarray, state), opt.init(p),
                               jnp.zeros((), jnp.int32), None)
        _, m = j_cls.make_classifier_train_step(jm, opt, j_cfg, output_is_prob)(
            ts, jnp.asarray(images), jnp.asarray(labels))
        params_from_jax(params, state, model=tm)
        t_cfg = t_loop.TrainConfig(lr=TLr(kind="constant", lr=1e-3), optimizer="sgd")
        t_ts, t_opt = t_loop.train_init(tm, t_cfg)
        _, tm_m = t_cls.make_classifier_train_step(tm, t_opt, t_cfg, output_is_prob)(
            t_ts, torch.from_numpy(images), torch.from_numpy(labels))
        assert float(tm_m["loss"]) == pytest.approx(float(m["loss"]), rel=1e-5)
        assert float(tm_m["accuracy"]) == float(m["accuracy"])


def test_one_step_on_a_sequence_net():
    """cfg/darknet/rnn.cfg (three BN [rnn] layers of 1024, [connected],
    [softmax], [cost]) with 4 time steps over 2 sequences (train-mode BN
    over one row a step passes only the bias on): the step clamps BN
    (whose recurrent ``bn`` is a plain bool) without error, the loss is
    finite, every parameter moves and so do the running statistics."""
    with open(os.path.join(REPO, "cfg", "darknet", "rnn.cfg")) as f:
        text = f.read().replace("time_steps=1", "time_steps=4")
    darknet = t_dk.Darknet.from_str(text)
    assert darknet.net.time_steps == 4
    tm = GraphModel(t_graph(darknet), device="cpu", generator=torch.Generator().manual_seed(0))
    config = t_loop.TrainConfig()
    ts, opt = t_loop.train_init(tm, config)
    p0 = {k: v.detach().clone() for k, v in tm.named_parameters()}
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4 * 2, 256, 1, 1)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 256, 4 * 2))
    mean0 = tm.layers["layer0"]["input"].bn.mean.clone()
    ts, metrics = t_cls.make_classifier_train_step(tm, opt, config)(ts, x, labels)
    assert np.isfinite(float(metrics["loss"]))
    moved = [k for k, v in tm.named_parameters() if not torch.equal(v, p0[k])]
    assert len(moved) == len(p0)
    assert not torch.equal(tm.layers["layer0"]["input"].bn.mean, mean0)
