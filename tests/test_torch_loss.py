"""Parity of the port's YOLO loss (yolodl_torch.loss.yolo_loss) with the
JAX reference (its errors, bf16 input and the per-step telemetry of
loss.benchmark are in test_torch_loss_checks.py).

The same random prediction (yolov4-tiny's and yolov4-csp's heads at 64²,
batch 2) and bench.py-style ground truth go to both; every term of the
loss and its gradient with respect to ``cycxhw``, ``obj_logit`` and
``class_logit`` (and the sigmas of a Gaussian head) are compared, for the
defaults and for the cfg-style options.

Tolerance: the terms are means of f32 elementwise losses summed in another
order, rtol 1e-5 / atol 1e-7; gradients rtol 1e-4 / atol 1e-6 · max|ref|
(XLA's and PyTorch's log1p/exp/atan2 differ by an ulp or two, and the
matched-cell gather sums contributions of duplicate candidates).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import head_infos, random_prediction, random_targets
from yolodl_tpu.loss.matcher import MatcherConfig as JMatcherConfig
from yolodl_tpu.ops.detect import MergedDetection as JMerged
from yolodl_torch.loss.matcher import MatcherConfig as TMatcherConfig
from yolodl_torch.ops.detect import MergedDetection as TMerged

torch.set_num_threads(2)

# the packages re-export the function yolo_loss under the module's name
j_loss = importlib.import_module("yolodl_tpu.loss.yolo_loss")
t_loss = importlib.import_module("yolodl_torch.loss.yolo_loss")

VAL = dict(rtol=1e-5, atol=1e-7)
_INFOS = {}


def _infos(cfg_name):
    if cfg_name not in _INFOS:
        _INFOS[cfg_name] = head_infos(cfg_name, 64)
    return _INFOS[cfg_name]


TERMS = ("total_loss", "iou_loss", "classification_loss", "objectness_loss")

CASES = {
    "defaults": {},
    "ciou": dict(box_metric="ciou"),
    "giou": dict(box_metric="giou"),
    "iou": dict(box_metric="iou"),
    "hausdorff": dict(box_metric="hausdorff"),
    "ignore_0.7": dict(ignore_thresh=0.7),
    "iou_thresh_0.2": dict(iou_thresh=0.2),
    "max_delta_5": dict(max_delta=5.0),
    "max_delta_clipping": dict(max_delta=1e-4),
    "objectness_smooth": dict(ignore_thresh=0.5, objectness_smooth=True),
    "smooth_obj_coef": dict(smooth_objectness_coef=0.5, box_metric="ciou"),
    "focal": dict(objectness_loss_kind="focal", classification_loss_kind="focal"),
    "cross_entropy": dict(classification_loss_kind="cross_entropy"),
    "l2": dict(objectness_loss_kind="l2", classification_loss_kind="l2"),
    "pos_weight": dict(objectness_pos_weight=2.0),
    "rect2_matcher": dict(matcher=("rect2", 3.0)),
    "per_head_tuples": dict(ignore_thresh=(0.7, 0.5), iou_thresh=(0.2, 1.0),
                            max_delta=(None, 1e-4)),
    "csp_per_head_tuples": dict(cfg="yolov4-csp", ignore_thresh=(0.7, 0.7, 0.6),
                                iou_thresh=(0.2, 0.2, 0.3), max_delta=(1e-4, None, 5.0),
                                objectness_smooth=True, box_metric="ciou"),
    "gaussian_nll": dict(sigmas=True),
}


def _configs(opts):
    opts = dict(opts)
    opts.pop("cfg", None)
    opts.pop("sigmas", None)
    grid = opts.pop("matcher", None)
    j_kw, t_kw = dict(opts), dict(opts)
    if grid is not None:
        j_kw["matcher"] = JMatcherConfig(match_grid=grid[0], anchor_scale_thresh=grid[1])
        t_kw["matcher"] = TMatcherConfig(match_grid=grid[0], anchor_scale_thresh=grid[1])
    return j_loss.LossConfig(**j_kw), t_loss.LossConfig(**t_kw)


@pytest.mark.parametrize("case", list(CASES))
def test_yolo_loss_terms_and_grads(case):
    opts = CASES[case]
    infos, j_infos, nc = _infos(opts.get("cfg", "yolov4-tiny"))
    sigmas = opts.get("sigmas", False)
    arrays, _, _ = random_prediction(infos, j_infos, nc, 2, seed=3, sigmas=sigmas)
    boxes, classes, mask = random_targets(2, 12, seed=4)
    j_cfg, t_cfg = _configs(opts)
    fields = ["cycxhw", "obj_logit", "class_logit"] + (["sigmas"] if sigmas else [])

    def j_fn(*xs):
        pred = JMerged(infos=j_infos, **dict(zip(fields, xs)))
        out, aux = j_loss.yolo_loss(pred, jnp.asarray(boxes), jnp.asarray(classes),
                                    jnp.asarray(mask), j_cfg)
        return out.total_loss, (out, aux)

    (_, (j_out, j_aux)), j_grads = jax.jit(jax.value_and_grad(
        j_fn, argnums=tuple(range(len(fields))), has_aux=True))(
        *(jnp.asarray(arrays[f]) for f in fields))

    t_in = {f: torch.from_numpy(arrays[f]).requires_grad_() for f in fields}
    t_out, t_aux = t_loss.yolo_loss(TMerged(infos=infos, **t_in), torch.from_numpy(boxes),
                                    torch.from_numpy(classes), torch.from_numpy(mask), t_cfg)
    t_out.total_loss.backward()

    terms = TERMS + (("uncertainty_loss",) if sigmas else ())
    for term in terms:
        np.testing.assert_allclose(float(getattr(t_out, term).detach()),
                                   float(getattr(j_out, term)), err_msg=term, **VAL)
    assert int(t_aux.matching.num_matched()) == int(j_aux.matching.num_matched()) > 0
    np.testing.assert_array_equal(t_aux.matching.valid.numpy(),
                                  np.asarray(j_aux.matching.valid))
    if j_aux.iou_score is None:
        assert t_aux.iou_score is None
    else:
        np.testing.assert_allclose(t_aux.iou_score.detach().numpy(),
                                   np.asarray(j_aux.iou_score), rtol=1e-5, atol=1e-6)
    for f, jg in zip(fields, j_grads):
        jg = np.asarray(jg)
        scale = float(np.abs(jg).max())
        assert scale > 0, f"{f}: no gradient"
        np.testing.assert_allclose(t_in[f].grad.numpy(), jg, rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=f)
