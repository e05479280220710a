"""The serving slice end to end on the CPU: yolodl_torch's DetectionService
against the JAX DetectionService, and the port's service surface.

Both services run yolov4-tiny at 64x64 with the same weights (through the
bridge) on the same u8 frames.  They compare in f32: the reference service
takes the f32 forward through its ``forward_fn`` hook and the port's
service through a subclass that overrides ``forward`` the same way.  In bf16 the two frameworks round at
other places, and bf16 scores have so few digits that ties reorder the
lists, which says nothing about the port.  Everything after the forward —
batching, NMS, class selection, letterbox and the mapping to original
pixels — is each service's own.

Tolerance: the same detections in the same order, classes equal, scores
within 1e-4 and boxes within 0.01 px (the services round to 5 and 2
decimals; f32 forwards agree to ~1e-6).
"""

import io
import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from _torch_parity import reference_and_port
from yolodl_tpu.data.letterbox import letterbox_u8_pil as j_letterbox_u8_pil
from yolodl_tpu.serve import DetectionService as JDetectionService
from yolodl_torch.data.letterbox import letterbox_u8
from yolodl_torch.serve import (DetectionService, ServiceShutdownError,
                                make_http_server)

torch.set_num_threads(2)

KW = dict(image_size=64, batch_size=4, window_ms=20.0, nms_iou_thresh=0.45,
          nms_conf_thresh=0.3, nms_kind="diou", nms_beta=0.6)


class F32Service(DetectionService):
    def forward(self, images_u8):
        return self.model(images_u8.to(torch.float32) / 255.0, data_format="NHWC")


@pytest.fixture(scope="module")
def services():
    jm, params, state, tm = reference_and_port("yolov4-tiny", seed=2)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = jax.tree_util.tree_map(jnp.asarray, state)

    @jax.jit
    def forward_f32(p, s, images_u8):
        x = images_u8.astype(jnp.float32) / 255.0
        return jm.apply(p, s, x, train=False, data_format="NHWC")[0]

    ref = JDetectionService(jm, jp, js, forward_fn=forward_f32, **KW)
    port = F32Service(tm, device="cpu", **KW)
    for svc in (ref, port):
        svc.warmup()
        svc.start()
    yield ref, port
    ref.shutdown()
    port.shutdown()


def _frames():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
            for hw in [(64, 64), (48, 80), (64, 64), (100, 40), (64, 64), (30, 30)]]


def _assert_same_detections(ref, out):
    assert len(out) == len(ref)
    for r, o in zip(ref, out):
        assert o["class"] == r["class"]
        assert abs(o["score"] - r["score"]) <= 1e-4
        np.testing.assert_allclose(o["bbox"], r["bbox"], atol=0.011)


def test_service_matches_reference(services):
    ref_svc, port_svc = services
    frames = _frames()
    results = [None] * len(frames)

    def worker(i):
        results[i] = port_svc.submit_u8(frames[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    n_dets = 0
    for frame, out in zip(frames, results):
        ref = ref_svc.submit_u8(frame)
        _assert_same_detections(ref, out)
        n_dets += len(ref)
    assert n_dets > 10  # the comparison is not vacuous
    snap = port_svc.stats.snapshot(port_svc.batch_size)
    assert snap["errors"] == 0 and snap["images_done"] >= len(frames)
    assert 0 < snap["mean_batch_fill"] <= 1


def test_bf16_service_runs(services):
    _, port_svc = services
    svc = DetectionService(port_svc.model, device="cpu", **KW)
    svc.warmup()
    svc.start()
    try:
        dets = svc.submit_u8(_frames()[0])
        assert isinstance(dets, list)
        for d in dets:
            assert set(d) >= {"class", "score", "bbox"}
            assert all(np.isfinite(d["bbox"]))
    finally:
        svc.shutdown()


def test_http_endpoints(services):
    _, port_svc = services
    server = make_http_server(port_svc, port=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            assert json.load(r) == {"ok": True}
        buf = io.BytesIO()
        Image.fromarray(_frames()[1]).save(buf, format="PNG")
        req = urllib.request.Request(base + "/detect", data=buf.getvalue(), method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            body = json.load(r)
        assert body["detections"] == port_svc.submit_u8(_frames()[1])
        with urllib.request.urlopen(base + "/stats", timeout=10) as r:
            assert json.load(r)["errors"] == 0
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)


def test_letterbox_identity_and_resize_match_reference():
    for frame in _frames():
        ref = j_letterbox_u8_pil(Image.fromarray(frame), (64, 64))
        np.testing.assert_array_equal(letterbox_u8(frame, (64, 64)), ref)


def test_service_rejections(services, tmp_path):
    from yolodl_torch.models.export import export_inference

    _, port_svc = services
    with pytest.raises(ValueError):
        port_svc.submit_u8(np.zeros((48, 64, 3), np.float32))
    # several replicas (ROADMAP A14a): the batch must split evenly, as in
    # the reference (its service.py:138-144); more: test_torch_multi_device_infer.py
    with pytest.raises(ValueError, match="batch_size 4 not divisible by devices 3"):
        DetectionService(port_svc.model, device="cpu", devices=3, **KW)
    # a plain (non-serving) artifact has no uint8 NHWC ingest to serve
    plain = export_inference(port_svc.model, str(tmp_path / "plain"), batch_size=4,
                             image_size=64)
    with pytest.raises(ValueError, match="re-export with --serving"):
        DetectionService.from_artifact(plain, device="cpu")
    svc = DetectionService(port_svc.model, device="cpu", **KW)
    svc.shutdown()
    with pytest.raises(ServiceShutdownError):
        svc.submit_u8(_frames()[0])
