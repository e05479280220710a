#!/usr/bin/env python3
"""Smoke run of the PyTorch port (yolodl_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure exits non-zero with no
result line:

1. build  — compile every CUDA kernel of yolodl_torch/csrc with nvcc (one
   process per source, started together) into build/yolodl_torch/.
2. kernel — the IoU kernel against its plain PyTorch version on the card at
   [8,512,4] (the serving shape), [1,300,4] and [2,8,4] plus zero-area
   boxes: max|Δ| ≤ 1e-6 and a diagonal of 1; then the kernel's median time
   over 200 launches (CUDA events, queued behind a sleep so that host
   launch overhead is not timed) beside its bound and the plain version's.
3. serve  — YoloModel on cfg/darknet/yolov4-csp.cfg at 608x608 with seeded
   random weights, DetectionService(batch 8, bf16, NMS kind from the cfg)
   answering 32 requests from 8 threads and the HTTP endpoints.  The
   launch counter is zeroed right before and read right after: the IoU
   kernel must have launched once per served batch.  One batch is
   post-processed again with the plain IoU version: keep masks, classes
   and instances must be identical.  The f32 forward on the card is held
   against the same model on the CPU at 64x64.
4. card   — `nvidia-smi --query-gpu=name,power.limit` as it prints it.

The line before the last lists the kernels; the last line is
{"ok": true, "device": {...}}.  TF32 is switched off for every f32
comparison on the card (cuDNN would otherwise run f32 convs in TF32).
"""

from __future__ import annotations

import io
import json
import os
import statistics
import subprocess
import sys
import threading
import time
import traceback
import urllib.request

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CFG = os.path.join(REPO, "cfg", "darknet", "yolov4-csp.cfg")
IMAGE_SIZE = 608
BATCH = 8
MAX_DETS = 512          # non_max_suppression's default
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS = 67e12           # H100 SXM f32, outside the tensor cores


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def median_ms(fn, n: int = 200) -> float:
    """Median device time of one call over ``n`` calls, each between two
    CUDA events, all queued behind a sleep kernel."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(100_000_000)  # keeps the card busy while the host queues
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def random_tlbr(gen, b, k):
    tl = torch.rand((b, k, 2), generator=gen)
    hw = torch.rand((b, k, 2), generator=gen) * 0.3 + 0.001
    return torch.cat([tl, tl + hw], dim=-1)


def iou_bound(b, k):
    """(bound_ms, bound_by): each input byte read once, each output byte
    written once; 13 f32 operations per pair and 6 per box."""
    t_bytes = (b * k * 4 * 4 + b * k * k * 4) / HBM_BYTES_PER_S
    t_ops = (13 * b * k * k + 6 * b * k) / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel(iou):
    gen = torch.Generator().manual_seed(0)
    max_err = 0.0
    for b, k in [(8, MAX_DETS), (1, 300), (2, 8)]:
        tlbr = random_tlbr(gen, b, k)
        tlbr[:, : min(3, k), 2:] = tlbr[:, : min(3, k), :2]  # zero-area boxes
        tlbr = tlbr.cuda()
        out = iou.pairwise_iou(tlbr)
        torch.cuda.synchronize()
        ref = iou.pairwise_iou_reference(tlbr)
        err = float((out - ref).abs().max())
        if not err <= 1e-6:
            raise AssertionError(f"iou kernel [{b},{k}]: max|d|={err} > 1e-6")
        diag = torch.diagonal(out, dim1=1, dim2=2)[:, min(3, k):]
        if not torch.allclose(diag, torch.ones_like(diag), atol=1e-6):
            raise AssertionError(f"iou kernel [{b},{k}]: diagonal is not 1")
        max_err = max(max_err, err)

    tlbr = random_tlbr(gen, BATCH, MAX_DETS).cuda()
    kernel_ms = median_ms(lambda: iou.pairwise_iou(tlbr))
    plain_ms = median_ms(lambda: iou.pairwise_iou_reference(tlbr))
    bound_ms, bound_by = iou_bound(BATCH, MAX_DETS)
    result = {"phase": "kernel", "name": "pairwise_iou", "shape": [BATCH, MAX_DETS, 4],
              "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
              "bound_ms": bound_ms, "bound_by": bound_by}
    emit(result)
    return result


def profile_batch(svc, stacked, pred) -> dict:
    """torch.profiler over one forward and one postprocess: CUDA kernels
    launched by the postprocess, host syncs of its fixed-point loop
    (aten::equal), and the forward's costliest kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.postprocess(pred)
        torch.cuda.synchronize()
    events = prof.events()
    out["postprocess_kernels"] = sum(1 for e in events if e.device_type.name == "CUDA")
    out["postprocess_convergence_checks"] = sum(1 for e in events if e.name == "aten::equal")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        svc.forward(stacked)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) is not None
               and e.device_type.name == "CUDA"]

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    kernels.sort(key=dev_us, reverse=True)
    out["forward_kernels"] = sum(e.count for e in kernels)
    out["forward_device_ms"] = sum(dev_us(e) for e in kernels) / 1e3
    out["forward_top"] = [[e.key[:60], e.count, dev_us(e) / 1e3] for e in kernels[:6]]
    return out


def phase_serve(iou):
    from yolodl_torch.config import darknet_cfg as dk
    from yolodl_torch.graph.from_darknet import graph_from_darknet
    from yolodl_torch.loss import nms as nms_mod
    from yolodl_torch.loss import to_host_detections
    from yolodl_torch.models import YoloModel
    from yolodl_torch.serve import DetectionService, make_http_server

    darknet = dk.Darknet.load(CFG)
    nms_kind, nms_beta = nms_mod.nms_options_from_darknet(darknet)
    t0 = time.perf_counter()
    model = YoloModel(graph_from_darknet(darknet), device="cuda",
                      generator=torch.Generator().manual_seed(0))
    build_s = time.perf_counter() - t0

    # f32 forward on the card vs the same seeded model on the CPU, 64x64
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 3, 64, 64))
                         .astype(np.float32))
    cpu_model = YoloModel(graph_from_darknet(darknet), device="cpu",
                          generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        ref = cpu_model(x)
        out = model(x.cuda())
    for f in ("cycxhw", "obj_logit", "class_logit"):
        r, o = getattr(ref, f), getattr(out, f).cpu()
        scale = float(r.abs().max())
        err = float((o - r).abs().max())
        if not err <= 1e-4 * scale + 1e-6:
            raise AssertionError(f"f32 forward {f}: card vs cpu max|d|={err} (max {scale})")
    del cpu_model

    svc = DetectionService(model, image_size=IMAGE_SIZE, batch_size=BATCH,
                           window_ms=10.0, nms_kind=nms_kind, nms_beta=nms_beta)
    warm_s = svc.warmup()

    # device time of one batch, forward and postprocess apart
    frames = [np.random.default_rng(i).integers(0, 256, (IMAGE_SIZE, IMAGE_SIZE, 3),
                                                dtype=np.uint8) for i in range(BATCH)]
    stacked = torch.from_numpy(np.stack(frames)).cuda()
    with torch.inference_mode():
        pred = svc.forward(stacked)
        fwd_ms = median_ms(lambda: svc.forward(stacked), n=20)
        post_ms = median_ms(lambda: svc.postprocess(pred), n=20)
        finite = all(bool(torch.isfinite(getattr(pred, f)).all())
                     for f in ("cycxhw", "obj_logit", "class_logit"))
        if not finite or pred.cycxhw.shape != (BATCH, 22743, 4):
            raise AssertionError(f"bad forward output {tuple(pred.cycxhw.shape)}")
        # one batch post-processed with the kernel and with the plain version
        with_kernel = svc.postprocess(pred)
        launches_before = iou.pairwise_iou.launches
        nms_mod.pairwise_iou = lambda t, device: iou.pairwise_iou_reference(t)
        try:
            with_plain = svc.postprocess(pred)
        finally:
            nms_mod.pairwise_iou = iou.pairwise_iou
        if iou.pairwise_iou.launches != launches_before:
            raise AssertionError("the plain postprocess launched the kernel")
        for f in ("valid", "classes", "instances"):
            if not torch.equal(getattr(with_kernel, f), getattr(with_plain, f)):
                raise AssertionError(f"postprocess {f}: kernel and plain IoU disagree")
        kept = int(with_kernel.valid.sum())
        # host side of one batch: unpack + map to original pixels, as the
        # completer thread does it
        t0 = time.perf_counter()
        dets = to_host_detections(with_kernel)
        for d in dets:
            svc._to_original_pixels(d, (IMAGE_SIZE, IMAGE_SIZE))
        host_unpack_ms = (time.perf_counter() - t0) * 1e3
        try:  # auxiliary: a profiler that sees no device time is not a failure
            profiled = profile_batch(svc, stacked, pred)
        except Exception as e:
            profiled = {"profile": f"not measured: {type(e).__name__}: {e}"}
    emit({"phase": "breakdown", "forward_ms": fwd_ms, "postprocess_ms": post_ms,
          "batch": BATCH, "kept_detections": kept, "host_unpack_ms": host_unpack_ms,
          "model_build_s": build_s,
          "warmup_s": warm_s, **profiled})

    # the serving run: counters zeroed right before, read right after
    iou.pairwise_iou.launches = 0
    svc.start()
    server = make_http_server(svc, port=0)
    http = threading.Thread(target=server.serve_forever, daemon=True)
    http.start()
    results, errors = [None] * 32, []

    def client(i):
        try:
            for j in range(4):
                results[4 * i + j] = svc.submit_u8(frames[(i + j) % BATCH])
        except Exception as e:  # reported below
            errors.append(repr(e))

    try:
        t0 = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=300)
        wall = time.perf_counter() - t0
        snap_run = svc.stats.snapshot(BATCH)

        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            if json.load(r) != {"ok": True}:
                raise AssertionError("/healthz")
        from PIL import Image

        posted = 0
        for arr, fmt in [(frames[0], "PNG"),
                         (np.asarray(Image.fromarray(frames[1]).resize((640, 480))), "JPEG")]:
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format=fmt)
            req = urllib.request.Request(base + "/detect", data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                body = json.load(r)
            if not isinstance(body.get("detections"), list):
                raise AssertionError(f"/detect: {body}")
            posted += 1
        with urllib.request.urlopen(base + "/stats", timeout=30) as r:
            stats = json.load(r)
    finally:
        server.shutdown()
        server.server_close()
        svc.shutdown()
    launches = iou.pairwise_iou.launches

    if errors or any(r is None for r in results):
        raise AssertionError(f"requests failed: {errors[:3]}")
    for dets in results:
        for d in dets:
            x0, y0, w, h = d["bbox"]
            if not (0 <= d["class"] < 80 and 0.25 <= d["score"] <= 1.0
                    and 0 <= x0 <= IMAGE_SIZE and 0 <= y0 <= IMAGE_SIZE
                    and w >= 0 and h >= 0 and np.isfinite([x0, y0, w, h]).all()):
                raise AssertionError(f"malformed detection {d}")
    if stats["errors"] != 0:
        raise AssertionError(f"service errors: {stats}")
    if launches != stats["batches"] or launches == 0:
        raise AssertionError(f"iou launches {launches} != served batches {stats['batches']}")
    lat = snap_run.get("latency_ms", {})
    emit({"phase": "serve", "model": "yolov4-csp", "image_size": IMAGE_SIZE,
          "batch": BATCH, "dtype": "bfloat16", "nms_kind": nms_kind, "nms_beta": nms_beta,
          "requests": len(results), "http_posts": posted,
          "img_per_s": snap_run["images_done"] / wall,
          "latency_p50_ms": lat.get("p50"), "latency_p95_ms": lat.get("p95"),
          "mean_batch_fill": snap_run["mean_batch_fill"],
          "batches": stats["batches"], "iou_launches": launches,
          "detections": sum(len(r) for r in results), "errors": stats["errors"],
          "pil": True})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "yolodl_torch")):
        print("chip_smoke: yolodl_torch is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    # f32 comparisons on the card are exact f32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from yolodl_torch.kernels import _build, iou

    emit({"phase": "build", "seconds": _build.build_all(),
          "libraries": [str(_build.library_path(n).relative_to(REPO)) for n in _build.SOURCES]})
    k = phase_kernel(iou)
    launches = phase_serve(iou)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card.splitlines()[0], flush=True)
    emit({"kernels": [{
        "name": "pairwise_iou", "route": "cuda", "source": "yolodl_torch/csrc/iou.cu",
        "replaces": "yolodl_tpu/kernels/iou_pallas.py:32",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "kernel_ms": k["ms"], "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"], "bound_by": k["bound_by"], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:
        traceback.print_exc()
        code = 1
    sys.exit(code)
