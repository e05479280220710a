"""The port's YOLO loss beyond the parity cases of test_torch_loss.py: the
max_delta clamp really clamps, configuration errors, bf16 predictions, and
the per-step telemetry (loss.benchmark) against the JAX reference's, which
are ratios of the same counts (rel 1e-6).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import head_infos, random_prediction, random_targets
from yolodl_tpu.loss import benchmark as j_bench
from yolodl_torch.loss import benchmark as t_bench
from yolodl_torch.ops.detect import MergedDetection as TMerged

torch.set_num_threads(2)

# the packages re-export the function yolo_loss under the module's name
j_loss = importlib.import_module("yolodl_tpu.loss.yolo_loss")
t_loss = importlib.import_module("yolodl_torch.loss.yolo_loss")

_INFOS = {}


def _infos(cfg_name):
    if cfg_name not in _INFOS:
        _INFOS[cfg_name] = head_infos(cfg_name, 64)
    return _INFOS[cfg_name]


def test_max_delta_clamps_the_box_gradient():
    """With a tiny max_delta every matched box coordinate's gradient sits
    at the bound (the clamp is really active in the case above)."""
    infos, j_infos, nc = _infos("yolov4-tiny")
    arrays, _, _ = random_prediction(infos, j_infos, nc, 2, seed=3)
    boxes, classes, mask = random_targets(2, 12, seed=4)
    cyc = torch.from_numpy(arrays["cycxhw"]).requires_grad_()
    pred = TMerged(infos=infos, cycxhw=cyc, obj_logit=torch.from_numpy(arrays["obj_logit"]),
                   class_logit=torch.from_numpy(arrays["class_logit"]))
    out, aux = t_loss.yolo_loss(pred, torch.from_numpy(boxes), torch.from_numpy(classes),
                                torch.from_numpy(mask),
                                t_loss.LossConfig(max_delta=1e-6, iou_loss_weight=1.0,
                                                  objectness_loss_weight=0.0,
                                                  classification_loss_weight=0.0))
    out.total_loss.backward()
    assert float(cyc.grad.abs().max()) <= 1e-6 * 4  # a cell matched up to 4 times


@pytest.mark.parametrize("kw,match", [
    (dict(classification_loss_kind="hinge"), "unknown classification loss"),
    (dict(objectness_loss_kind="hinge"), "unknown objectness loss"),
    (dict(ignore_thresh=(0.5, 0.5, 0.5)), "per-layer ignore_thresh"),
    (dict(max_delta=(1.0,)), "per-head max_delta"),
])
def test_loss_config_errors(kw, match):
    infos, j_infos, nc = _infos("yolov4-tiny")
    _, _, t_pred = random_prediction(infos, j_infos, nc, 1, seed=0)
    boxes, classes, mask = random_targets(1, 4, seed=2)
    with pytest.raises(ValueError, match=match):
        t_loss.yolo_loss(t_pred, torch.from_numpy(boxes), torch.from_numpy(classes),
                         torch.from_numpy(mask), t_loss.LossConfig(**kw))


def test_bf16_prediction_is_scored_in_f32():
    infos, j_infos, nc = _infos("yolov4-tiny")
    arrays, _, t_pred = random_prediction(infos, j_infos, nc, 2, seed=5)
    boxes, classes, mask = random_targets(2, 8, seed=6)
    half = TMerged(infos=infos, **{f: getattr(t_pred, f).to(torch.bfloat16)
                                   for f in ("cycxhw", "obj_logit", "class_logit")})
    out, _ = t_loss.yolo_loss(half, *map(torch.from_numpy, (boxes, classes, mask)))
    assert out.total_loss.dtype == torch.float32 and torch.isfinite(out.total_loss)


@pytest.mark.parametrize("threshold", [0.5, 0.05])
def test_yolo_benchmark(threshold):
    infos, j_infos, nc = _infos("yolov4-tiny")
    _, j_pred, t_pred = random_prediction(infos, j_infos, nc, 2, seed=7)
    boxes, classes, mask = random_targets(2, 12, seed=8)
    _, j_aux = jax.jit(j_loss.yolo_loss)(j_pred, jnp.asarray(boxes), jnp.asarray(classes),
                                         jnp.asarray(mask))
    _, t_aux = t_loss.yolo_loss(t_pred, *map(torch.from_numpy, (boxes, classes, mask)))
    ref = j_bench.yolo_benchmark(j_pred, j_aux.matching, threshold)
    out = t_bench.yolo_benchmark(t_pred, t_aux.matching, threshold)
    for f in ("obj_accuracy", "obj_recall", "obj_precision", "class_accuracy"):
        np.testing.assert_allclose(float(getattr(out, f)), float(getattr(ref, f)),
                                   rtol=1e-6, err_msg=f)
