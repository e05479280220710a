"""Traffic ``bulk``: offline detection over a dataset, the per-batch
program of the program's ``cli/detect_main.py``: the model on a batch of
letterboxed float32 NCHW images in [0, 1] cast to the compute dtype, then
``non_max_suppression`` (``class_mode="argmax"``, the cfg's NMS kind and
beta, detect_main's default thresholds), ``yolo_inference`` and
``to_host_detections``.

Set-up makes ``pool`` batches of ``batch`` images from the seed, each
image a smooth-noise source frame of one of the mix's sizes letterboxed
(``mix``: [h, w, share]; every seed draws the same number of each size,
in its own order), and stages them in pinned host memory.  The weights'
objectness bias is set so that the reference keeps ``kept_per_image``
detections an image over the pool (``weights.calibrate``).  The window
uploads batch i + 1 and issues its program before it reads batch i's
detections, and counts the images whose detections reached the host
inside it.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from .. import flops, weights
from ..judge import DetectionTally
from ..reference import detect as ref_detect
from ..reference.precision import full_precision
from . import common


def source_sizes(params: Dict, n: int, seed: int) -> List[tuple]:
    """``n`` (h, w) source sizes, each size its share of ``n``, shuffled."""
    sizes = []
    for h, w, share in params["mix"]:
        sizes += [(h, w)] * round(share * n)
    sizes = (sizes + sizes[:n])[:n]
    order = np.random.default_rng(int(seed) + 2).permutation(n)
    return [sizes[i] for i in order]


def nms_options(net) -> tuple:
    head = net.heads[0]
    return head.nms_kind, head.beta_nms


def setup(config: Dict, params: Dict, seed: int, device) -> Dict:
    from yolodl_torch.loss import non_max_suppression, to_host_detections, yolo_inference

    net = common.network(config)
    size = config["resolution"]
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    n = params["pool"] * params["batch"]
    sizes = source_sizes(params, n, seed)
    frames = common.frames_u8(gen, sizes, device)
    boxed = np.stack([ref_detect.letterbox(f, size) for f in frames])
    host = torch.from_numpy(boxed).permute(0, 3, 1, 2).float().div_(255.0)
    if torch.device(device).type == "cuda":
        host = host.pin_memory()
    batches = list(torch.split(host, params["batch"]))
    w = weights.make_weights(net, seed, device, params.get("bn_scale", 1.0),
                              params.get("bn_shift", 0.0))
    kind, beta = nms_options(net)
    step = params["reference_block"]
    weights.calibrate(net, w, batches[0][: params["calibrate_images"]].to(device),
                      (b[s:s + step].to(device) for b in batches for s in range(0, len(b), step)),
                      params["conf_thresh"], params["iou_thresh"], kind, beta, params["max_dets"],
                      params["kept_per_image"])
    model = common.program_model(config, device)
    weights.load_into(model, w)
    dtype = getattr(torch, config["dtype"])

    def infer_part(images):
        from torch.autograd.profiler import record_function

        with torch.inference_mode():
            with record_function("h100bench.forward"):
                pred = model(images.to(device, non_blocking=True).to(dtype))
            with record_function("h100bench.postprocess"):
                nms = non_max_suppression(pred, iou_threshold=params["iou_thresh"],
                                          confidence_threshold=params["conf_thresh"],
                                          suppress_by_class=False, class_mode="argmax",
                                          kind=kind, beta=beta)
                return yolo_inference(nms, pred.num_flats)

    for b in batches[:2]:   # warm-up: the one shape the window runs
        to_host_detections(infer_part(b))
    return {"net": net, "w": w, "model": model, "batches": batches, "infer": infer_part,
            "to_host": to_host_detections, "params": params, "device": device,
            "kind": kind, "beta": beta, "seed": seed, "dtype": dtype}


def window(state: Dict, seconds: float, tracer) -> Dict:
    infer, to_host, batches = state["infer"], state["to_host"], state["batches"]
    clock = common.Clock(state["device"])
    t0 = clock.start()
    done_at, answers, samples = [], [], []
    pending = None
    i = 0
    while True:
        elapsed = time.perf_counter() - t0
        tracer.tick(elapsed)
        if elapsed >= seconds and pending is None:
            break
        out = infer(batches[i % len(batches)]) if elapsed < seconds else None
        if pending is not None:
            j, prev = pending
            dets = to_host(prev)
            done_at.append(time.perf_counter() - t0)
            answers.append((j, dets))
            if j < len(batches):   # each batch's NMS candidates, for the stage's bound
                samples.append(prev.tlbr.float().cpu())
        pending = (i, out) if out is not None else None
        i += 1
    tracer.stop()
    batch = state["params"]["batch"]
    done = [t for t in done_at if t <= seconds]
    net = state["net"]
    _, fl = flops.network_cost(net)
    state["answers"] = answers
    cells = sum(len(h.anchors) * h.feature_hw[0] * h.feature_hw[1] for h in net.heads)
    itemsize = torch.finfo(state["dtype"]).bits // 8
    return {"attempted": len(done_at) * batch, "failed": 0,
            "e2e": [("infer_img_s", len(done) * batch / max(done) if done else 0.0, "img/s")],
            "images": len(done) * batch, "measured_s": max(done) if done else float("nan"),
            "flops_per_image": fl, "passes": 1, "batch": batch, "nms_samples": samples,
            "dense_bytes": batch * cells * (5 + net.heads[0].classes) * itemsize,
            "box_itemsize": itemsize, "iou_thresh": state["params"]["iou_thresh"],
            "nms_kind": state["kind"]}


def reference_detections(net, w, images: torch.Tensor, params, kind, beta, quant=None):
    """Per image, in pixels of the letterboxed input: the reference's
    detections (class, confidence, (x0, y0, x1, y1)), every cell's box and
    every cell's confidences."""
    size = net.size
    out = []
    with torch.no_grad(), full_precision():
        for start in range(0, images.shape[0], params["reference_block"]):
            x = images[start:start + params["reference_block"]].float()
            dense = ref_detect.decode(net, net.forward(x, w, train=False, quant=quant))
            dets = ref_detect.detections(dense, params["conf_thresh"], params["iou_thresh"],
                                         kind, beta, params["max_dets"])
            conf = ref_detect.confidences(dense)
            cells = ref_detect.tlbr(dense.cycxhw)[..., [1, 0, 3, 2]] * size
            for i, image_dets in enumerate(dets):
                out.append(([(c, s, (l * size, t * size, r * size, b * size), k)
                             for c, s, (t, l, b, r), k in image_dets], cells[i], conf[i]))
    return out


def program_as_pixels(dets, size: int):
    return [(d["class"], d["confidence"], (d["tlbr"][1] * size, d["tlbr"][0] * size,
                                           d["tlbr"][3] * size, d["tlbr"][2] * size))
            for d in dets]


def check(state: Dict) -> Dict:
    net, w, params = state["net"], state["w"], state["params"]
    batches, answers, device = state["batches"], state["answers"], state["device"]
    kind, beta, seed = state["kind"], state["beta"], state["seed"]
    state.clear()
    common.free_cuda()
    # a sample, drawn from the seed, of the batches answered in the window
    rng = np.random.default_rng(int(seed) + 3)
    picks = sorted(rng.choice(len(answers), min(len(answers), params["checked_batches"]),
                              replace=False)) if answers else []
    tally = DetectionTally(params["conf_thresh"])
    by_batch: Dict[int, list] = {}
    for k in picks:
        j, dets = answers[k]
        by_batch.setdefault(j % len(batches), []).append(dets)
    for index, answered in sorted(by_batch.items()):   # one batch's reference at a time
        reference = reference_detections(net, w, batches[index].to(device), params, kind, beta)
        for dets in answered:
            for prog, ref in zip(dets, reference):
                tally.add(program_as_pixels(prog, net.size), *ref)
        del reference
    return tally.numbers()
