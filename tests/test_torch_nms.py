"""Parity of the port's IoU kernel wrapper, NMS, class selection and weight
bridge (yolodl_torch) with the JAX reference, on the CPU.

The CUDA kernel itself runs only on a card: on the CPU the wrapper takes its
plain version, which is held here against the TPU kernel run in interpret
mode (atol 1e-6).  NMS and ``yolo_inference`` must give **identical**
``valid``, ``classes`` and ``instances`` on identical inputs; boxes and
confidences agree to f32 rounding (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolodl_tpu.config import darknet_cfg as j_dk
from yolodl_tpu.geometry.boxes import box_iou_pairwise as j_box_iou_pairwise
from yolodl_tpu.geometry.boxes import cycxhw_to_tlbr as j_cycxhw_to_tlbr
from yolodl_tpu.kernels import pairwise_iou_pallas
from yolodl_tpu.loss import inference as j_inf
from yolodl_tpu.loss import nms as j_nms
from yolodl_tpu.ops import detect as j_detect
from yolodl_torch.bridge import params_from_jax, params_to_jax
from yolodl_torch.config import darknet_cfg as t_dk
from yolodl_torch.geometry.boxes import box_iou_pairwise as t_box_iou_pairwise
from yolodl_torch.geometry.boxes import cycxhw_to_tlbr as t_cycxhw_to_tlbr
from yolodl_torch.kernels import iou as t_iou
from yolodl_torch.loss import inference as t_inf
from yolodl_torch.loss import nms as t_nms
from yolodl_torch.ops import detect as t_detect

torch.set_num_threads(2)


def _tlbr(rng, shape):
    boxes = rng.uniform(0.0, 1.0, shape + (4,)).astype(np.float32)
    return np.stack([
        np.minimum(boxes[..., 0], boxes[..., 2]),
        np.minimum(boxes[..., 1], boxes[..., 3]),
        np.maximum(boxes[..., 0], boxes[..., 2]) + 0.01,
        np.maximum(boxes[..., 1], boxes[..., 3]) + 0.01,
    ], axis=-1)


# -- IoU: the kernel's plain version -----------------------------------------


@pytest.mark.parametrize("k", [8, 256, 300])
def test_iou_plain_matches_pallas_interpret(k):
    tlbr = _tlbr(np.random.default_rng(0), (k,))
    ref = np.asarray(pairwise_iou_pallas(jnp.asarray(tlbr), interpret=True))
    out = t_iou.pairwise_iou(torch.from_numpy(tlbr)[None], device="cpu")[0]
    assert out.shape == (k, k) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_iou_batched_equals_per_image_and_geometry():
    rng = np.random.default_rng(1)
    tlbr = _tlbr(rng, (3, 40))
    tlbr[1, :3, 2:] = tlbr[1, :3, :2]  # zero-area boxes
    out = t_iou.pairwise_iou(torch.from_numpy(tlbr), device="cpu")
    for b in range(3):
        ref = np.asarray(j_box_iou_pairwise(jnp.asarray(tlbr[b]), jnp.asarray(tlbr[b])))
        np.testing.assert_allclose(out[b].numpy(), ref, rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            t_box_iou_pairwise(torch.from_numpy(tlbr[b]), torch.from_numpy(tlbr[b])).numpy(),
            ref, rtol=0, atol=1e-6)
    diag = torch.diagonal(out, dim1=1, dim2=2)
    np.testing.assert_allclose(diag[0].numpy(), 1.0, atol=1e-6)
    np.testing.assert_array_equal(diag[1, :3].numpy(), 0.0)  # 0 / eps


def test_iou_casts_to_f32_and_checks_arguments():
    tlbr = torch.from_numpy(_tlbr(np.random.default_rng(2), (1, 5))).to(torch.bfloat16)
    assert t_iou.pairwise_iou(tlbr, device="cpu").dtype == torch.float32
    with pytest.raises(ValueError):
        t_iou.pairwise_iou(tlbr[0], device="cpu")  # not [B, K, 4]
    with pytest.raises(ValueError):
        t_iou.pairwise_iou(tlbr)  # default device is cuda; tensor is on the cpu


def test_cycxhw_to_tlbr():
    boxes = np.random.default_rng(3).uniform(0, 1, (2, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(t_cycxhw_to_tlbr(torch.from_numpy(boxes)).numpy(),
                                  np.asarray(j_cycxhw_to_tlbr(jnp.asarray(boxes))))


@pytest.mark.cuda
def test_iou_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tlbr = torch.from_numpy(_tlbr(np.random.default_rng(4), (8, 512))).cuda()
    before = t_iou.pairwise_iou.launches
    out = t_iou.pairwise_iou(tlbr)
    torch.cuda.synchronize()
    assert t_iou.pairwise_iou.launches == before + 1
    assert torch.equal(out, t_iou.pairwise_iou_reference(tlbr))


# -- NMS -------------------------------------------------------------------------


def _merged(rng, b=2, n=300, c=6):
    """Clustered boxes (deep suppression chains) with spread confidences."""
    centers = rng.uniform(0.2, 0.8, (b, 12, 2))
    pick = rng.integers(0, 12, (b, n))
    cyx = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 0.03, (b, n, 2))
    hw = rng.uniform(0.05, 0.3, (b, n, 2))
    cycxhw = np.concatenate([cyx, hw], -1).astype(np.float32)
    obj = rng.normal(0, 2, (b, n)).astype(np.float32)
    cls = rng.normal(0, 2, (b, n, c)).astype(np.float32)
    info_j = (j_detect.DetectionInfo(1, n, ((0.1, 0.1),), 0, n),)
    info_t = (t_detect.DetectionInfo(1, n, ((0.1, 0.1),), 0, n),)
    jm = j_detect.MergedDetection(jnp.asarray(cycxhw), jnp.asarray(obj), jnp.asarray(cls), info_j)
    tm = t_detect.MergedDetection(torch.from_numpy(cycxhw), torch.from_numpy(obj),
                                  torch.from_numpy(cls), info_t)
    return jm, tm


def _assert_same_nms(ref, out):
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.classes.numpy(), np.asarray(ref.classes))
    np.testing.assert_array_equal(out.instances.numpy(), np.asarray(ref.instances))
    np.testing.assert_allclose(out.confidence.numpy(), np.asarray(ref.confidence), rtol=1e-6)
    np.testing.assert_allclose(out.tlbr.numpy(), np.asarray(ref.tlbr), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind,class_mode,by_class", [
    ("greedy", "argmax", False),
    ("greedy", "pairs", False),
    ("diou", "argmax", False),
    ("diou", "pairs", True),
])
def test_non_max_suppression_identical(kind, class_mode, by_class):
    jm, tm = _merged(np.random.default_rng(5))
    kw = dict(iou_threshold=0.45, confidence_threshold=0.25, suppress_by_class=by_class,
              max_dets=200, kind=kind, class_mode=class_mode, beta=0.6)
    ref = j_nms.non_max_suppression(jm, **kw)
    out = t_nms.non_max_suppression(tm, **kw)
    _assert_same_nms(ref, out)
    # the case is not trivial: something survives and something is suppressed
    valid_top = out.confidence > 0
    assert 0 < int(out.valid.sum()) < int(valid_top.sum())


def test_non_max_suppression_ties_keep_lower_index():
    """Most masked confidences are exactly 0: instances of invalid rows must
    follow jax.lax.top_k's order (lower index first)."""
    jm, tm = _merged(np.random.default_rng(6), n=400)
    kw = dict(confidence_threshold=0.9, max_dets=64, class_mode="argmax")
    ref = j_nms.non_max_suppression(jm, **kw)
    out = t_nms.non_max_suppression(tm, **kw)
    assert int((out.confidence == 0).sum()) > 32
    _assert_same_nms(ref, out)


def test_suppress_deep_chain():
    """A chain where each box overlaps only its neighbour: greedy keeps every
    other box, which needs ~K fixed-point passes."""
    k = 40
    t = np.arange(k, dtype=np.float32) * 0.5
    tlbr = np.stack([np.zeros(k), t, np.ones(k), t + 1.0], -1).astype(np.float32)[None]
    keep = t_nms._suppress(torch.from_numpy(tlbr), torch.zeros(1, k, dtype=torch.long),
                           torch.ones(1, k, dtype=torch.bool), 0.3)
    np.testing.assert_array_equal(keep[0].numpy(), np.arange(k) % 2 == 0)


def test_nms_options_from_darknet():
    for name in ("yolov4-csp", "yolov4-tiny"):
        path = f"cfg/darknet/{name}.cfg"
        assert t_nms.nms_options_from_darknet(t_dk.Darknet.load(path)) == \
            j_nms.nms_options_from_darknet(j_dk.Darknet.load(path))


def test_yolo_inference_identical():
    jm, tm = _merged(np.random.default_rng(7), c=5)
    kw = dict(iou_threshold=0.5, confidence_threshold=0.2, max_dets=300, class_mode="pairs")
    j_out = j_nms.non_max_suppression(jm, **kw)
    t_out = t_nms.non_max_suppression(tm, **kw)
    ref = j_inf.yolo_inference(j_out, jm.num_flats)
    out = t_inf.yolo_inference(t_out, tm.num_flats)
    # pairs mode leaves several classes per instance for the selection
    inst = t_out.instances[t_out.valid]
    assert len(torch.unique(inst)) < len(inst)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    assert t_inf.to_host_detections(out) == j_inf.to_host_detections(ref)


def test_yolo_inference_exact_tie_keeps_first():
    conf = np.array([[0.5, 0.5, 0.7, 0.2]], np.float32)
    inst = np.array([[3, 3, 1, 1]], np.int32)
    valid = np.array([[True, True, True, False]])
    tlbr = np.zeros((1, 4, 4), np.float32)
    ref = j_inf.yolo_inference(j_nms.NmsOutput(jnp.asarray(tlbr), jnp.asarray(conf),
                                               jnp.zeros((1, 4), jnp.int32),
                                               jnp.asarray(inst), jnp.asarray(valid)), 5)
    out = t_inf.yolo_inference(t_nms.NmsOutput(torch.from_numpy(tlbr), torch.from_numpy(conf),
                                               torch.zeros(1, 4, dtype=torch.long),
                                               torch.from_numpy(inst).long(),
                                               torch.from_numpy(valid)), 5)
    np.testing.assert_array_equal(out.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(out.valid.numpy(), [[True, False, True, False]])


# -- weight bridge -------------------------------------------------------------


def test_bridge_round_trip():
    rng = np.random.default_rng(8)
    params = {
        "layer0": {"w": rng.normal(size=(3, 3, 3, 4)).astype(np.float32),
                   "bn": {"scale": rng.normal(size=4).astype(np.float32),
                          "bias": rng.normal(size=4).astype(np.float32)}},
        "layer1": {"w": rng.normal(size=(1, 1, 4, 6)).astype(np.float32),
                   "b": rng.normal(size=6).astype(np.float32)},
        "a.b": {"w": rng.normal(size=(1, 1, 6, 2)).astype(np.float32)},
    }
    state = {"layer0": {"bn": {"mean": rng.normal(size=4).astype(np.float32),
                               "var": rng.uniform(1, 2, 4).astype(np.float32)}}}
    sd = params_from_jax(params, state)
    assert sd["layers.layer0.w"].shape == (4, 3, 3, 3)  # OIHW
    assert "layers.a/b.w" in sd
    np.testing.assert_array_equal(sd["layers.layer0.w"].numpy(),
                                  params["layer0"]["w"].transpose(3, 2, 0, 1))
    p2, s2 = params_to_jax(sd)
    flat = lambda t: sorted((jax.tree_util.keystr(k), np.asarray(v).tolist())  # noqa: E731
                            for k, v in jax.tree_util.tree_leaves_with_path(t))
    assert flat(p2) == flat(params)
    assert flat(s2) == flat(state)
