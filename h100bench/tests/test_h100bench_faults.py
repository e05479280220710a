"""A run driven on the CPU at a small size, past the harness's look for a
card: sound, its `correct` holds; with the timed path broken underneath
(each fault the cell can have), `correct` comes out false; and the
control, the reference in float8 in the program's place, fails too.  The
program computes in float32 here, so that a sound run reads round-off
alone against the cell's limits."""

import json
import os

import pytest
import torch

from h100bench import configs, run
from h100bench.judge import DetectionTally, training_numbers, verdict
from h100bench.reference.precision import fp8

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = {w["name"]: w for w in BENCH["workloads"]}
SMALL = {"train": dict(batch=4, accum=2, pool=3, max_boxes=8),
         "bulk": dict(batch=4, pool=2, checked_batches=2, reference_block=4,
                      calibrate_images=4, mix=[[96, 128, 0.5], [128, 96, 0.5]])}
SIZE = {"train": 64, "bulk": 128}


def small(cell):
    params = json.load(open(os.path.join(ROOT, "h100bench", "workloads", f"{cell}.json")))
    params.update(SMALL[params["driver"]])
    config = configs.load(CELLS[cell]["config"])
    config.update(resolution=SIZE[params["driver"]], dtype="float32")
    return params, config


def measure(cell):
    params, config = small(cell)
    line, _ = run.measure(BENCH, CELLS[cell], params, config, 2**31 + 101, 1.5, False,
                          torch.device("cpu"))
    return line


def unchanged_state(make_step):
    def make(model, opt, config, accum):
        step = make_step(model, opt, config, accum=accum)
        def broken(ts, *batch):
            saved = {k: v.detach().clone() for k, v in model.state_dict().items()}
            ts, metrics = step(ts, *batch)
            model.load_state_dict(saved)
            return ts, metrics
        return broken
    return make


def half_batch(make_step):
    def make(model, opt, config, accum):
        step = make_step(model, opt, config, accum=accum)
        def broken(ts, images, boxes, classes, mask):
            keep = images.shape[0] // 2
            return step(ts, images[:keep], boxes[:keep], classes[:keep], mask[:keep])
        return broken
    return make


def half_batch_in_the_window(make_step):
    """Sound through set-up's warm-up; every step after it, the window's,
    takes half of its batch."""
    from h100bench.drivers.train import WARMUP_STEPS

    def make(model, opt, config, accum):
        step = make_step(model, opt, config, accum=accum)
        calls = []

        def broken(ts, images, boxes, classes, mask):
            calls.append(1)
            if len(calls) <= WARMUP_STEPS:
                return step(ts, images, boxes, classes, mask)
            keep = images.shape[0] // 2
            return step(ts, images[:keep], boxes[:keep], classes[:keep], mask[:keep])
        return broken
    return make


def altered(to_host):
    def broken(out):
        dets = to_host(out)
        for image in dets:
            for d in image:
                d["class"] = (d["class"] + 1) % 80
        return dets
    return broken


TRAIN_CELLS = [c for c in CELLS if "train" in c]
DETECT_CELLS = [c for c in CELLS if "train" not in c]


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_sound_run_is_correct(cell):
    line = measure(cell)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch, half_batch_in_the_window])
def test_a_broken_train_step_is_not_correct(cell, fault, monkeypatch):
    import yolodl_torch.train as train

    monkeypatch.setattr(train, "make_train_step", fault(train.make_train_step))
    assert not measure(cell)["correct"]


@pytest.mark.parametrize("cell", DETECT_CELLS)
def test_an_altered_answer_is_not_correct(cell, monkeypatch):
    import yolodl_torch.loss as loss

    monkeypatch.setattr(loss, "to_host_detections", altered(loss.to_host_detections))
    assert not measure(cell)["correct"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_the_float8_control_is_not_correct(cell):
    import importlib

    params, config = small(cell)
    driver = importlib.import_module(f"h100bench.drivers.{params['driver']}")
    device = torch.device("cpu")
    state = driver.setup(config, params, 2**31 + 103, device)
    net = state["net"]
    if params["driver"] == "train":
        pool = state["pool"][:3]
        ref = driver.reference_readings(net, state["w0"], pool, params, state["train_config"])
        low = driver.reference_readings(net, state["w0"], pool, params, state["train_config"],
                                        quant=fp8)
        numbers = training_numbers(low, ref)
    else:
        tally = DetectionTally(params["conf_thresh"])
        for batch in state["batches"]:
            args = (net, state["w"], batch, params, state["kind"], state["beta"])
            for lo, r in zip(driver.reference_detections(*args, quant=fp8),
                             driver.reference_detections(*args)):
                tally.add([d[:3] for d in lo[0]], *r)
        numbers = tally.numbers()
    ok, checks = verdict(numbers, params["limits"])
    assert not ok, checks
