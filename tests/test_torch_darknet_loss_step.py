"""The port's train step with ``TrainConfig(darknet_loss=...)`` against the
reference's: the BN-free cfg of tests/test_train.py ``TestDarknetLossImpl``
(one stride-4 conv, a 24-channel [yolo] head with ciou, iou_thresh 0.2,
max_delta 5, ignore_thresh 0.6; 64², batch 2, up to 3 boxes an image),
parameters carried into the port through ``bridge.py``.

- 5 SGD steps (momentum 0.9, lr 1e-3): each step's total loss and darknet
  metrics within rel 1e-5 (``num_matched`` exact), every parameter after
  the fifth within 1e-5 · max|ref| of its tensor;
- ``accum=2`` against the reference's and against two micro-batches run
  by hand (the port against itself: rel 1e-6);
- ``make_multi_step(k=2)`` against two single steps (rel 1e-6);
- the forward with ``output_keys`` (the raw head convs) against the
  reference's ``apply(output_keys=...)``, which it returns without the
  decode/merge tail (rel 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import named_leaves
from yolodl_tpu.config import darknet_cfg as jdk
from yolodl_tpu.graph.from_darknet import graph_from_darknet as j_graph
from yolodl_tpu.loss import darknet_loss as jl
from yolodl_tpu.models import YoloModel as JYoloModel
from yolodl_tpu.train import loop as j_loop
from yolodl_tpu.train.lr_schedule import LrScheduleConfig as JLr
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.config import darknet_cfg as tdk
from yolodl_torch.graph.from_darknet import graph_from_darknet as t_graph
from yolodl_torch.loss import darknet_loss as tl
from yolodl_torch.models import YoloModel
from yolodl_torch.train import loop as t_loop
from yolodl_torch.train.lr_schedule import LrScheduleConfig as TLr

torch.set_num_threads(2)

# tests/test_train.py TestDarknetLossImpl.CFG, three classes
CFG = """[net]
width=64
height=64
channels=3
[convolutional]
filters=8
size=3
stride=4
pad=1
activation=leaky
[convolutional]
filters=24
size=1
activation=linear
[yolo]
mask=0,1,2
anchors=6,8, 10,14, 18,24
classes=3
num=3
iou_loss=ciou
iou_thresh=0.2
max_delta=5
ignore_thresh=0.6
"""
LR = 1e-3
METRICS = ("total_loss",) + tl.METRIC_KEYS


def setup():
    jd, td = jdk.Darknet.from_str(CFG), tdk.Darknet.from_str(CFG)
    jg, tg = j_graph(jd), t_graph(td)
    jm = JYoloModel(jg, spd_stem="off")
    params, state = jax.tree_util.tree_map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    tm = YoloModel(tg, device="cpu")
    params_from_jax(params, state, tm)
    j_spec = (jg.detect_head_input_keys(),
              tuple(jl.head_params_from_darknet(l, 64, 64) for l in jd.layers
                    if isinstance(l, jdk.Yolo)))
    t_spec = (tg.detect_head_input_keys(),
              tuple(tl.head_params_from_darknet(l, 64, 64) for l in td.layers
                    if isinstance(l, tdk.Yolo)))
    assert j_spec[0] == t_spec[0]
    return jm, params, state, tm, j_spec, t_spec


def batches(n, batch=2, seed=0):
    """Seeded (images, boxes (cy, cx, h, w), classes, mask) with 1-3
    prefix-packed boxes an image."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        images = rng.uniform(0, 1, (batch, 3, 64, 64)).astype(np.float32)
        boxes = np.zeros((batch, 3, 4), np.float32)
        boxes[..., :2] = rng.uniform(0.15, 0.85, (batch, 3, 2))
        boxes[..., 2:] = rng.uniform(0.1, 0.5, (batch, 3, 2))
        classes = rng.integers(0, 3, (batch, 3)).astype(np.int32)
        mask = np.arange(3)[None] < rng.integers(1, 4, (batch, 1))
        out.append((images, boxes * mask[..., None], classes, mask))
    return out


def configs(j_spec, t_spec, **kw):
    return (j_loop.TrainConfig(lr=JLr(kind="constant", lr=LR), optimizer="sgd", momentum=0.9,
                               darknet_loss=j_spec, **kw),
            t_loop.TrainConfig(lr=TLr(kind="constant", lr=LR), optimizer="sgd", momentum=0.9,
                               darknet_loss=t_spec, **kw))


def reference_steps(jm, params, state, j_cfg, data, accum=1):
    opt = j_loop.make_optimizer(j_cfg)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    ts = j_loop.TrainState(p, jax.tree_util.tree_map(jnp.asarray, state), opt.init(p),
                           jnp.zeros((), jnp.int32), None)
    step = j_loop.make_train_step(jm, opt, j_cfg, accum=accum)
    metrics = []
    for batch in data:
        ts, m = step(ts, *map(jnp.asarray, batch))
        metrics.append({k: np.asarray(v) for k, v in m.items()})
    return ts, metrics


def port_steps(tm, t_cfg, data, accum=1):
    ts, opt = t_loop.train_init(tm, t_cfg)
    step = t_loop.make_train_step(tm, opt, t_cfg, accum=accum)
    metrics = []
    for batch in data:
        ts, m = step(ts, *map(torch.from_numpy, batch))
        metrics.append({k: v.numpy() for k, v in m.items()})
    return ts, metrics


def assert_metrics(got, want, rtol):
    assert set(got) == set(want) == set(METRICS)
    for k in METRICS:
        if k == "num_matched":
            assert int(got[k]) == int(want[k]), k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-7, err_msg=k)


def assert_params(tm, j_params, scale=1e-5):
    want = named_leaves(j_params)
    got = named_leaves(params_to_jax(tm.state_dict())[0])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=scale * float(np.abs(want[k]).max()), err_msg=k)


def test_five_sgd_steps_match_reference():
    jm, params, state, tm, j_spec, t_spec = setup()
    j_cfg, t_cfg = configs(j_spec, t_spec)
    data = batches(5)
    j_ts, j_metrics = reference_steps(jm, params, state, j_cfg, data)
    _, t_metrics = port_steps(tm, t_cfg, data)
    for got, want in zip(t_metrics, j_metrics):
        assert_metrics(got, want, rtol=1e-5)
    assert all(int(m["num_matched"]) > 0 for m in t_metrics)
    assert t_metrics[-1]["total_loss"] < t_metrics[0]["total_loss"]  # it trains
    assert_params(tm, j_ts.params)


def test_accumulation_matches_reference_and_micro_batches():
    jm, params, state, tm, j_spec, t_spec = setup()
    j_cfg, t_cfg = configs(j_spec, t_spec)
    data = batches(1, batch=4, seed=1)
    j_ts, j_metrics = reference_steps(jm, params, state, j_cfg, data, accum=2)
    _, t_metrics = port_steps(tm, t_cfg, data, accum=2)
    assert_metrics(t_metrics[0], j_metrics[0], rtol=1e-5)
    assert_params(tm, j_ts.params)
    after = {k: v.clone() for k, v in tm.state_dict().items()}

    # by hand: two micro-batches, gradients summed and halved, one SGD update
    params_from_jax(params, state, tm)
    t_loop.train_init(tm, t_cfg)
    grads_of = t_loop.make_batch_grads(tm, t_cfg)
    halves = [[torch.from_numpy(x[i * 2:(i + 1) * 2]) for x in data[0]] for i in range(2)]
    parts = [grads_of(*h) for h in halves]
    with torch.no_grad():
        for p in tm.parameters():
            p.sub_(LR * p.grad / 2)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, after[k], rtol=1e-6, atol=1e-7, msg=k)
    assert int(t_metrics[0]["num_matched"]) == sum(int(m["num_matched"]) for m in parts)
    assert float(t_metrics[0]["total_loss"]) == pytest.approx(
        np.mean([float(m["total_loss"]) for m in parts]), rel=1e-6)


def test_multi_step_equals_single_steps():
    _, params, state, tm, _, t_spec = setup()
    _, t_cfg = configs(None, t_spec)
    data = batches(2, seed=2)
    _, singles = port_steps(tm, t_cfg, data)
    after = {k: v.clone() for k, v in tm.state_dict().items()}
    params_from_jax(params, state, tm)
    ts, opt = t_loop.train_init(tm, t_cfg)
    stacked = [torch.from_numpy(np.stack(parts)) for parts in zip(*data)]
    ts, multi = t_loop.make_multi_step(tm, opt, t_cfg, 2)(ts, *stacked)
    assert ts.step == 2
    for i, single in enumerate(singles):
        for k in METRICS:
            np.testing.assert_allclose(multi[k][i].numpy(), single[k], rtol=1e-6, err_msg=k)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, after[k], rtol=1e-6, atol=1e-7, msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_forward_output_keys_match_reference(train):
    jm, params, state, tm, j_spec, _ = setup()
    keys = j_spec[0]
    images = batches(1)[0][0]
    want, _ = jm.apply(params, state, jnp.asarray(images), train=train, data_format="NCHW",
                       output_keys=keys)
    got = tm(torch.from_numpy(images), train=train, output_keys=keys)
    assert set(got) == set(keys)
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy().transpose(0, 2, 3, 1),
                                   np.asarray(want[k]), rtol=1e-5, atol=1e-6)
    # only the head conv's ancestors ran: not the decode or the merge
    nodes = tm._nodes_for(tuple(keys), train)
    assert tm.output_key not in nodes and len(nodes) == len(tm.graph.order) - 2
