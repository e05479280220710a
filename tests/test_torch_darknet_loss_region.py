"""The darknet-exact [region] (YOLOv2) and [detection] (YOLOv1) losses
against the reference, which uses them at library level only (its
train_main rejects them; so does the port's).

[region]: one head at 8² of three grid-unit anchors, three classes,
batch 2, with ``bias_match`` on (anchor-shape match) and off (match by
the predicted wh at the truth's cell), ``rescore``, ``classfix`` 1, 2 and
-1, ``focal_loss`` and no softmax.  [detection]: side 4, two boxes per
cell, ``sqrt``/``rescore`` on and off, softmax on and off.  Each case
compares the per-image delta and ``darknet_detection_loss`` /
``darknet_v1_detection_loss`` with their gradients (``jax.grad`` through
the reference's ``custom_vjp``): deltas and gradients within 1e-5 ·
max|ref|, costs rel 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolodl_tpu.loss import darknet_loss as jl
from yolodl_torch.loss import darknet_loss as tl

torch.set_num_threads(2)

REGION_ANCHORS = ((1.0, 1.5), (2.0, 3.0), (4.0, 5.0))


def region_inputs(p, fh=8, fw=8, batch=2, truths=10, real=7, seed=0):
    """NCHW raws and truth rows; half the real truths near a cell's
    decoded prediction (moved 1 %, widened 3 %), the rest random."""
    rng = np.random.default_rng(seed)
    a, e = p.num_anchors, p.entries
    raw = rng.normal(0, 1.0, (batch, a * e, fh, fw)).astype(np.float32)
    cells = raw.reshape(batch, a, e, fh, fw)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    truth = np.zeros((batch, truths, 5), np.float32)
    for b in range(batch):
        for t in range(real):
            k, y, x = (int(rng.integers(n)) for n in (a, fh, fw))
            w = np.exp(cells[b, k, 2, y, x]) * p.anchors[k][0] / fw
            h = np.exp(cells[b, k, 3, y, x]) * p.anchors[k][1] / fh
            if t % 2 == 0 and 0.02 < w < 0.9 and 0.02 < h < 0.9:
                box = [(x + sig(cells[b, k, 0, y, x])) / fw + 0.01 * w,
                       (y + sig(cells[b, k, 1, y, x])) / fh - 0.01 * h, 1.03 * w, 1.03 * h]
            else:
                box = list(rng.uniform([0.05, 0.05, 0.05, 0.05], [0.95, 0.95, 0.7, 0.7]))
            truth[b, t] = box + [int(rng.integers(p.classes))]
    return raw, truth


REGION_CASES = {
    "bias_match": dict(bias_match=True, rescore=True, classfix=0),
    "pred_wh_match": dict(bias_match=False, object_scale=5.0, class_scale=1.0, coord_scale=1.0),
    "classfix1": dict(bias_match=True, classfix=1, thresh=0.4),
    "classfix2_focal": dict(bias_match=True, classfix=2, thresh=0.4, focal_loss=True),
    "classfix_minus1_no_softmax": dict(bias_match=False, classfix=-1, softmax=False,
                                       rescore=True, seen_lt_12800=False),
}


@pytest.mark.parametrize("name", list(REGION_CASES))
def test_region(name):
    fields = dict(anchors=REGION_ANCHORS, classes=3, noobject_scale=1.0, **REGION_CASES[name])
    jp, tp = jl.RegionHeadParams(**fields), tl.RegionHeadParams(**fields)
    raw, truth = region_inputs(jp, seed=len(name))

    def ref(r, tr):
        delta = jax.vmap(lambda x, y: jl._region_head_deltas(x, y, jp))(
            jl.reshape_head_raw(r, jp), tr)
        loss, grad = jax.value_and_grad(lambda r_: jl.darknet_detection_loss((r_,), tr, (jp,)))(r)
        return delta, loss, grad

    j_delta, j_loss, j_grad = (np.asarray(v) for v in jax.jit(ref)(
        jnp.asarray(raw.transpose(0, 2, 3, 1)), jnp.asarray(truth)))
    delta = tl._region_head_deltas(tl.reshape_head_raw(torch.from_numpy(raw), tp),
                                   torch.from_numpy(truth), tp)
    np.testing.assert_allclose(delta.numpy(), j_delta, rtol=0,
                               atol=1e-5 * float(np.abs(j_delta).max()))
    r = torch.from_numpy(raw).requires_grad_()
    loss = tl.darknet_detection_loss((r,), torch.from_numpy(truth), (tp,))
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    loss.backward()
    np.testing.assert_allclose(r.grad.numpy().transpose(0, 2, 3, 1), j_grad, rtol=0,
                               atol=1e-5 * float(np.abs(j_grad).max()))


def test_region_has_no_metrics_path():
    p = tl.RegionHeadParams(anchors=REGION_ANCHORS, classes=3)
    raw, truth = region_inputs(p)
    with pytest.raises(TypeError, match=r"\[yolo\]/\[gaussian_yolo\] only"):
        tl.darknet_detection_loss_with_metrics((torch.from_numpy(raw),),
                                               torch.from_numpy(truth), (p,))


@pytest.mark.parametrize("sqrt,rescore,softmax", [(True, True, False), (False, False, True)])
def test_v1_detection(sqrt, rescore, softmax):
    fields = dict(side=4, num=2, classes=3, sqrt=sqrt, rescore=rescore, softmax=softmax,
                  object_scale=1.0, noobject_scale=0.5, class_scale=1.0, coord_scale=5.0)
    jp, tp = jl.V1DetectionParams(**fields), tl.V1DetectionParams(**fields)
    rng = np.random.default_rng(int(sqrt) + 2 * int(softmax))
    batch, loc = 2, jp.side * jp.side
    raw = rng.uniform(0.05, 0.95, (batch, jp.inputs)).astype(np.float32)
    truth = np.zeros((batch, loc, 1 + jp.classes + 4), np.float32)
    obj = rng.random((batch, loc)) < 0.4
    truth[..., 0] = obj
    truth[np.arange(batch)[:, None], np.arange(loc)[None], 1 + rng.integers(0, 3, (batch, loc))] = 1
    truth[..., 1 + jp.classes:] = rng.uniform(0.1, 0.9, (batch, loc, 4))
    truth[..., 1:] *= obj[..., None]

    def ref(r, tr):
        delta = jax.vmap(lambda x, y: jl._v1_head_deltas(x, y, jp))(r, tr)
        loss, grad = jax.value_and_grad(lambda r_: jl.darknet_v1_detection_loss(r_, tr, jp))(r)
        return delta, loss, grad

    j_delta, j_loss, j_grad = (np.asarray(v) for v in jax.jit(ref)(jnp.asarray(raw),
                                                                   jnp.asarray(truth)))
    delta = tl._v1_head_deltas(torch.from_numpy(raw), torch.from_numpy(truth), tp)
    np.testing.assert_allclose(delta.numpy(), j_delta, rtol=0,
                               atol=1e-5 * float(np.abs(j_delta).max()))
    r = torch.from_numpy(raw).requires_grad_()
    loss = tl.darknet_v1_detection_loss(r, torch.from_numpy(truth), tp)
    assert float(loss.detach()) == pytest.approx(float(j_loss), rel=1e-5)
    loss.backward()
    np.testing.assert_allclose(r.grad.numpy(), j_grad, rtol=0,
                               atol=1e-5 * float(np.abs(j_grad).max()))
