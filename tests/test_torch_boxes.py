"""Parity of the port's box algebra (yolodl_torch.geometry.boxes) with the
JAX reference: values and gradients of IoU / GIoU / DIoU / CIoU / Hausdorff
and the conversions, on seeded random boxes plus hand-made degenerate
cases (identical, touching, disjoint and zero-area boxes).

Tolerance: f32 elementwise arithmetic in the same order; XLA and PyTorch
evaluate atan2/sqrt with different polynomials, so values agree to
rtol 1e-5 / atol 1e-6 and gradients to rtol 1e-4 / atol 1e-5.  Gradients
at ties (``maximum``/``minimum`` of equal operands) split half and half in
both frameworks, and the degenerate rows check exactly that.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolodl_tpu.geometry import boxes as j_boxes
from yolodl_torch.geometry import boxes as t_boxes

torch.set_num_threads(2)

VAL = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _pairs(seed=0, n=64):
    """[n+6, 4] × [n+6, 4] CyCxHW boxes: random pairs, then degenerate rows."""
    rng = np.random.default_rng(seed)
    a = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.4, (n, 2))], -1)
    b = np.concatenate([a[:, :2] + rng.normal(0, 0.1, (n, 2)),
                        a[:, 2:] * rng.uniform(0.5, 1.5, (n, 2))], -1)
    special_a = [
        [0.5, 0.5, 0.2, 0.2],   # identical to its partner
        [0.5, 0.5, 0.2, 0.2],   # touching: partner's top edge = this bottom edge
        [0.2, 0.2, 0.1, 0.1],   # disjoint
        [0.5, 0.5, 0.0, 0.2],   # zero height
        [0.4, 0.6, 0.3, 0.1],   # nested inside its partner
        [0.5, 0.5, 0.2, 0.3],   # shared centre, other shape
    ]
    special_b = [
        [0.5, 0.5, 0.2, 0.2],
        [0.7, 0.5, 0.2, 0.2],
        [0.8, 0.8, 0.1, 0.1],
        [0.5, 0.5, 0.1, 0.1],
        [0.4, 0.6, 0.5, 0.5],
        [0.5, 0.5, 0.3, 0.2],
    ]
    a = np.concatenate([a, special_a]).astype(np.float32)
    b = np.concatenate([b, special_b]).astype(np.float32)
    return a, b


FNS = ["iou", "giou", "diou", "ciou", "hausdorff_distance"]


@pytest.mark.parametrize("name", FNS)
def test_box_metric_values_and_grads(name):
    a, b = _pairs()
    if name == "hausdorff_distance":
        # sqrt'(0) is infinite: leave out the pairs at distance 0
        a, b = a[:-6], b[:-6]
    w = np.random.default_rng(1).normal(size=a.shape[0]).astype(np.float32)
    j_fn, t_fn = getattr(j_boxes, name), getattr(t_boxes, name)

    ref = np.asarray(j_fn(jnp.asarray(a), jnp.asarray(b)))
    ga, gb = jax.grad(lambda x, y: jnp.sum(j_fn(x, y) * w), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))

    ta = torch.from_numpy(a).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    out = t_fn(ta, tb)
    torch.sum(out * torch.from_numpy(w)).backward()

    np.testing.assert_allclose(out.detach().numpy(), ref, **VAL)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), **GRAD)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), **GRAD)


@pytest.mark.parametrize("kind", ["iou", "giou", "diou", "ciou", "CIoU"])
def test_iou_score_dispatch(kind):
    a, b = _pairs(2, 16)
    ref = np.asarray(j_boxes.iou_score(kind, jnp.asarray(a), jnp.asarray(b)))
    out = t_boxes.iou_score(kind, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(out.numpy(), ref, **VAL)


def test_iou_score_unknown_kind_raises():
    a = torch.zeros((1, 4))
    with pytest.raises(KeyError, match="unknown IoU kind"):
        t_boxes.iou_score("dice", a, a)


def test_conversions_area_and_closure():
    a, b = _pairs(3, 16)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    tl_j, tl_t = j_boxes.cycxhw_to_tlbr(ja), t_boxes.cycxhw_to_tlbr(ta)
    np.testing.assert_allclose(tl_t.numpy(), np.asarray(tl_j), **VAL)
    np.testing.assert_allclose(t_boxes.tlbr_to_cycxhw(tl_t).numpy(),
                               np.asarray(j_boxes.tlbr_to_cycxhw(tl_j)), **VAL)
    np.testing.assert_allclose(t_boxes.area(ta).numpy(), np.asarray(j_boxes.area(ja)), **VAL)
    np.testing.assert_allclose(
        t_boxes.closure_tlbr(tl_t, t_boxes.cycxhw_to_tlbr(tb)).numpy(),
        np.asarray(j_boxes.closure_tlbr(tl_j, j_boxes.cycxhw_to_tlbr(jb))), **VAL)


def test_ciou_aspect_coefficient_is_detached():
    """The reference stops the gradient through CIoU's shape coefficient:
    d ciou / d w differs from the gradient with the coefficient attached."""
    a = torch.tensor([[0.5, 0.5, 0.2, 0.4]], requires_grad=True)
    b = torch.tensor([[0.52, 0.5, 0.3, 0.2]])
    t_boxes.ciou(a, b).sum().backward()
    ga = jax.grad(lambda x: jnp.sum(j_boxes.ciou(x, jnp.asarray(b.numpy()))))(
        jnp.asarray(a.detach().numpy()))
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(ga), **GRAD)
