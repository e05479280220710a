"""The plain reference against the measured program, on the CPU: the
forward of both configurations at 64 x 64, the FLOP count at 608, and the
detections of the reference against the program's in float32."""

import json
import os

import pytest
import torch

from h100bench import configs, flops, weights
from h100bench.drivers import bulk, common
from h100bench.judge import DetectionTally
from h100bench.reference import detect as ref_detect

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.mark.parametrize("name,params,gflop", [("yolov4-csp-608", 52_921_437, 108.52),
                                                ("yolov4-608", 64_363_101, 128.39)])
def test_flop_count_is_the_programs(name, params, gflop):
    p, f = flops.network_cost(common.network(configs.load(name)))
    assert p == params and round(f / 1e9, 2) == gflop


@pytest.mark.parametrize("name", ["yolov4-csp-608", "yolov4-608"])
@pytest.mark.parametrize("train", [False, True])
def test_forward_agrees_with_the_program(name, train):
    config = configs.load(name)
    config["resolution"] = 64
    net = common.network(config)
    w = weights.make_weights(net, 2**31 + 5, "cpu")
    x = common.smooth_images(torch.Generator().manual_seed(1), 2, 64, "cpu")
    head = net.heads[0]
    weights.calibrate(net, w, x, [x], 0.25, 0.6, head.nms_kind, head.beta_nms, 512, 5.0)
    model = common.program_model(config, "cpu")
    weights.load_into(model, w)
    with torch.no_grad():
        out = model(x, train=train)
        ref = ref_detect.decode(net, net.forward(x, w, train=train))
    for field in ("cycxhw", "obj_logit", "class_logit"):
        a, b = getattr(out, field), getattr(ref, field)
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())


def test_detections_agree_with_the_program_in_float32():
    params = json.load(open(os.path.join(ROOT, "h100bench", "workloads", "v4-608-bulk-b32.json")))
    params.update(batch=4, pool=1, reference_block=4, calibrate_images=4,
                  mix=[[96, 128, 0.5], [128, 96, 0.5]])
    config = configs.load("yolov4-608")
    config.update(resolution=128, dtype="float32")
    state = bulk.setup(config, params, 7, torch.device("cpu"))
    dets = state["to_host"](state["infer"](state["batches"][0]))
    ref = bulk.reference_detections(state["net"], state["w"], state["batches"][0], params,
                                    state["kind"], state["beta"])
    tally = DetectionTally(params["conf_thresh"])
    for prog, r in zip(dets, ref):
        tally.add(bulk.program_as_pixels(prog, 128), *r)
    numbers = tally.numbers()
    assert numbers["detections"] > 20
    assert numbers["score_gap_max"] < 1e-4 and numbers["missed_share"] < 0.02
