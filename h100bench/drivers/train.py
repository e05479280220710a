"""Traffic ``train``: a closed training loop through the program's
``make_train_step``.

Set-up makes a pool of ``pool`` batches on the device from the seed:
``batch`` smooth-noise images (in the configuration's dtype, in which
the step then computes) and, for
each image, a heavy-tailed number of boxes (1 to ``max_boxes``, mean about
7, as COCO) of log-uniform size and COCO's 80 classes.  It builds the
step with ``accum`` micro-batches (darknet's subdivisions), warms it up
with ``WARMUP_STEPS`` steps, and then puts the same model and optimizer
back to the seed's weights with no optimizer state.  The window runs
steps on the pool's batches in turn, from batch 0, at most two in
flight, and counts the images of the steps that completed inside it.
Its first three steps, on batches 0, 1 and 2, are the ones the reference
follows: the window keeps their losses, the first gradient as Adam holds
it and the change of the weights over the three.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..judge import training_numbers
from ..reference import loss as ref_loss
from ..reference.detect import decode
from ..reference.precision import full_precision
from .. import flops, weights
from . import common

WARMUP_STEPS = 2     # set-up's steps: every kernel of the step's one shape built and tuned
CHECKED_STEPS = 3    # the window's first steps, which the reference follows


def make_pool(params: Dict, size: int, classes: int, dtype, seed: int, device):
    gen = torch.Generator(device=device).manual_seed(int(seed) + 1)
    b, m = params["batch"], params["max_boxes"]
    pool = []
    for _ in range(params["pool"]):
        images = common.smooth_images(gen, b, size, device).to(dtype)
        count = torch.clamp(torch.exp(1.5 + 0.8 * torch.randn((b, 1), generator=gen, device=device)),
                            1, m).floor()
        mask = torch.arange(m, device=device)[None] < count
        hw = torch.exp(math.log(0.02) + (math.log(0.6) - math.log(0.02))
                       * torch.rand((b, m, 2), generator=gen, device=device))
        centre = hw / 2 + (1 - hw) * torch.rand((b, m, 2), generator=gen, device=device)
        boxes = torch.cat([centre, hw], -1)   # cy, cx, h, w
        cls = torch.randint(0, classes, (b, m), generator=gen, device=device, dtype=torch.int32)
        pool.append((images, boxes, cls, mask))
    return pool


def train_config_of(config: Dict):
    """The program's TrainConfig for the configuration's ``optimizer``."""
    from yolodl_torch.train import TrainConfig
    from yolodl_torch.train.lr_schedule import LrScheduleConfig

    o = config["optimizer"]
    if o["kind"] != "adam" or o["decay"] or o["burn_in"] or o["policy"] != "constant":
        raise ValueError(f"the harness runs Adam at a constant rate, not {o}")
    return TrainConfig(optimizer="adam", momentum=o["momentum"], beta2=o["beta2"], eps=o["eps"],
                       lr=LrScheduleConfig(kind="constant", lr=o["learning_rate"]))


def setup(config: Dict, params: Dict, seed: int, device) -> Dict:
    from yolodl_torch.train import make_train_step, train_init

    net = common.network(config)
    w0 = weights.make_weights(net, seed, device, params.get("bn_scale", 1.0),
                              params.get("bn_shift", 0.0))
    model = common.program_model(config, device)
    weights.load_into(model, w0)
    train_config = train_config_of(config)
    ts, opt = train_init(model, train_config)
    step = make_train_step(model, opt, train_config, accum=params["accum"])
    pool = make_pool(params, config["resolution"], config["classes"], getattr(torch, config["dtype"]),
                     seed, device)
    for i in range(WARMUP_STEPS):
        ts, _ = step(ts, *pool[i])
    restart(model, ts, w0)
    return {"net": net, "w0": w0, "model": model, "opt": opt, "ts": ts, "step": step,
            "pool": pool, "params": params, "device": device, "train_config": train_config}


def restart(model, ts, w0) -> None:
    """The model back to ``w0``, the optimizer without state, step 0."""
    weights.load_into(model, w0)
    ts.optimizer.state.clear()
    ts.step = 0


def window(state: Dict, seconds: float, tracer) -> Dict:
    import time

    from torch.autograd.profiler import record_function

    step, ts, pool, opt = state["step"], state["ts"], state["pool"], state["opt"]
    named = list(state["model"].named_parameters())
    leaves = [p for _, p in named]
    w0 = state["w0"]
    start = [w0[int(k.split(".")[0])][k.split(".")[1]] for k in (common.leaf_name(n) for n, _ in named)]
    losses, grad, delta = [], None, None
    clock = common.Clock(state["device"])
    t0 = clock.start()
    i = 0
    while True:
        elapsed = time.perf_counter() - t0
        tracer.tick(elapsed)
        if elapsed >= seconds and i >= CHECKED_STEPS:
            break
        with record_function("h100bench.step"):
            ts, metrics = step(ts, *pool[i % len(pool)])
        if i < CHECKED_STEPS:   # device tensors, read once the window has closed
            losses.append(metrics["total_loss"])
            with torch.no_grad():
                if i == 0:   # the first gradient, as Adam holds it: m1 = (1 - beta1) g1
                    grad = torch.stack(torch._foreach_norm([opt.state[p]["exp_avg"] for p in leaves]))
                if i == CHECKED_STEPS - 1:
                    delta = torch.stack(torch._foreach_norm(torch._foreach_sub(leaves, start)))
        clock.mark()
        clock.wait(1)
        i += 1
    tracer.stop()
    times = clock.times()
    names = [common.leaf_name(n) for n, _ in named]
    beta1 = state["train_config"].momentum
    state["readings"] = {"losses": [float(x) for x in losses],
                         "grad": {k: float(v) / (1 - beta1) for k, v in zip(names, grad.tolist())},
                         "delta": dict(zip(names, delta.tolist()))}
    done = [t for t in times if t <= seconds]
    batch = state["params"]["batch"]
    last = max(done) if done else float("nan")
    img_s = len(done) * batch / last if done else 0.0
    _, fl = flops.network_cost(state["net"])
    return {"attempted": len(times), "failed": 0,
            "e2e": [("train_img_s", img_s, "img/s")],
            "images": len(done) * batch, "measured_s": last, "flops_per_image": fl,
            "passes": 3}


def reference_readings(net, w0, pool, params, train_config, quant=None, keep_rows=None,
                       ulp=False) -> Dict:
    """The reference's three steps from ``w0`` on batches 0..2: losses, the
    first gradient's norms, each leaf's change.  ``keep_rows`` (a fault)
    leaves out the rest of each micro-batch; ``ulp`` moves every image
    value one float32 ulp up."""
    p = {i: {k: v.clone().requires_grad_(k in ("w", "b", "scale", "bias")) for k, v in leaf.items()}
         for i, leaf in w0.items()}
    named = ref_loss.leaves(p)
    adam = ref_loss.Adam([t for _, t in named], train_config.lr.lr, train_config.momentum,
                         train_config.beta2, train_config.eps)
    accum = params["accum"]
    losses, grad = [], None
    with full_precision():
        for step in range(CHECKED_STEPS):
            images, boxes, cls, mask = pool[step]
            mb = images.shape[0] // accum
            grads = [torch.zeros_like(t) for _, t in named]
            total = 0.0
            for j in range(accum):
                rows = slice(j * mb, j * mb + (keep_rows or mb))
                x = images[rows].float()
                if ulp:
                    x = torch.nextafter(x, torch.full_like(x, float("inf")))
                dense = decode(net, net.forward(x, p, train=True, quant=quant, remat=True))
                loss = ref_loss.yolo_loss(dense, boxes[rows], cls[rows], mask[rows])
                g = torch.autograd.grad(loss, [t for _, t in named], allow_unused=True)
                for acc, gi in zip(grads, g):
                    if gi is not None:
                        acc += gi / accum
                total += float(loss.detach()) / accum
                del dense, loss, g
            if step == 0:
                grad = {k: float(torch.linalg.vector_norm(g)) for (k, _), g in zip(named, grads)}
            adam.step(grads)
            losses.append(total)
    delta = {k: float(torch.linalg.vector_norm(t.detach() - w0[int(k.split('.')[0])][k.split('.')[1]]))
             for k, t in named}
    return {"losses": losses, "grad": grad, "delta": delta}


def check(state: Dict) -> Dict:
    program = state["readings"]
    net, w0, pool, params = state["net"], state["w0"], state["pool"][:CHECKED_STEPS], state["params"]
    train_config = state["train_config"]
    state.clear()
    common.free_cuda()
    reference = reference_readings(net, w0, pool, params, train_config)
    numbers = training_numbers(program, reference)
    numbers["program_losses"], numbers["reference_losses"] = program["losses"], reference["losses"]
    return numbers
