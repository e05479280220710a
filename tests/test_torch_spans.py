"""The program's spans (``utils/timing.py`` ``span``): none is entered while
no profiler runs; under a profiler that records only ``record_function``
ranges (``RecordScope.USER_SCOPE``, as the benchmark's traced runs start
it), a train step and a detect batch record their layers' ranges, nested
as the step and the batch run them.  yolov4-tiny at 64², f32, CPU."""

import contextlib
import os

import numpy as np
import pytest
import torch
from torch._C._autograd import _disable_profiler, _enable_profiler, _prepare_profiler
from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope,
                                _ExperimentalConfig)

from yolodl_torch.graph.from_darknet import load_darknet_graph
from yolodl_torch.loss import non_max_suppression, to_host_detections, yolo_inference
from yolodl_torch.models import YoloModel
from yolodl_torch.train import loop
from yolodl_torch.train.lr_schedule import LrScheduleConfig
from yolodl_torch.utils import timing

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP, FORWARD, LOSS, MATCH = ("yolodl.train.step", "yolodl.model.forward", "yolodl.loss",
                              "yolodl.loss.match")
BACKWARD, UPDATE = "yolodl.train.backward", "yolodl.train.update"


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return YoloModel(load_darknet_graph(os.path.join(REPO, "cfg", "darknet", "yolov4-tiny.cfg")),
                     device="cpu")


def batch(b=4, size=64, max_gt=6, seed=0):
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0.2, 0.8, (b, max_gt, 4)).astype(np.float32)
    boxes[..., 2:] = rng.uniform(0.05, 0.3, (b, max_gt, 2))
    return (torch.from_numpy(rng.uniform(0, 1, (b, 3, size, size)).astype(np.float32)),
            torch.from_numpy(boxes),
            torch.from_numpy(rng.integers(0, 80, (b, max_gt)).astype(np.int32)),
            torch.ones((b, max_gt), dtype=torch.bool))


def train_step(model, accum=2):
    config = loop.TrainConfig(lr=LrScheduleConfig(kind="constant", lr=1e-5))
    ts, opt = loop.train_init(model, config)
    step = loop.make_train_step(model, opt, config, accum=accum)
    return lambda: step(ts, *batch())


def detect_batch(model):
    images = batch()[0]

    def run():
        with torch.inference_mode():
            pred = model(images)
            nms = non_max_suppression(pred, confidence_threshold=0.0, class_mode="argmax")
            return to_host_detections(yolo_inference(nms, pred.num_flats))
    return run


@contextlib.contextmanager
def user_scope_profile():
    """The profiler as the benchmark starts it, with the CPU activity alone:
    yields a dict whose ``spans`` are the recorded ``yolodl.*`` ranges,
    (name, start_ns, end_ns) by start, once the block has ended."""
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    activities = {ProfilerActivity.CPU}
    _prepare_profiler(config, activities)
    _enable_profiler(config, activities, {RecordScope.USER_SCOPE})
    out = {}
    try:
        yield out
    finally:
        events = _disable_profiler().events()
        out["spans"] = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                               for e in events if e.name().startswith("yolodl.")),
                              key=lambda s: (s[1], -s[2]))


def test_no_span_is_entered_without_a_profiler(model, monkeypatch):
    entered = []
    real = timing.record_function

    def counting(name):
        entered.append(name)
        return real(name)

    monkeypatch.setattr(timing, "record_function", counting)
    step, detect = train_step(model), detect_batch(model)
    step()
    detect()
    assert entered == []
    with user_scope_profile():   # the same calls do enter them under a profiler
        step()
        detect()
    assert STEP in entered and "yolodl.inference.to_host" in entered


def test_train_step_records_its_phases_inside_the_step(model):
    step = train_step(model, accum=2)
    step()   # first call outside the profile: lazy state made
    with user_scope_profile() as prof:
        step()
    spans = prof["spans"]
    names = [n for n, _, _ in spans]
    assert names.count(STEP) == 1
    for name in (FORWARD, LOSS, MATCH, BACKWARD):
        assert names.count(name) == 2, name
    (_, s0, e0), = [s for s in spans if s[0] == STEP]
    assert all(s0 <= s <= e <= e0 for _, s, e in spans)
    last_backward = max(e for n, _, e in spans if n == BACKWARD)
    updates = [(s, e) for n, s, e in spans if n == UPDATE]
    assert 1 <= len(updates) <= 2 and all(s >= last_backward for s, _ in updates)
    # the matcher inside the loss; forward, loss and backward in turn per micro-batch
    losses = [(s, e) for n, s, e in spans if n == LOSS]
    assert all(any(ls <= s and e <= le for ls, le in losses)
               for n, s, e in spans if n == MATCH)
    order = [n for n in names if n in (FORWARD, LOSS, BACKWARD, UPDATE)]
    assert order[:6] == [FORWARD, LOSS, BACKWARD] * 2 and set(order[6:]) == {UPDATE}


def test_train_step_without_accumulation_has_one_update_range(model):
    step = train_step(model, accum=1)
    with user_scope_profile() as prof:
        step()
    names = [n for n, _, _ in prof["spans"]]
    assert [names.count(n) for n in (STEP, FORWARD, LOSS, BACKWARD, UPDATE)] == [1] * 5


def test_detect_batch_records_forward_nms_select_and_download_in_order(model):
    detect = detect_batch(model)
    with user_scope_profile() as prof:
        dets = detect()
    assert len(dets) == 4
    spans = prof["spans"]
    top = [n for n in (n for n, _, _ in spans)
           if n in (FORWARD, "yolodl.nms", "yolodl.inference.select", "yolodl.inference.to_host")]
    assert top == [FORWARD, "yolodl.nms", "yolodl.inference.select", "yolodl.inference.to_host"]
    (_, ns, ne), = [s for s in spans if s[0] == "yolodl.nms"]
    inner = [(n, s, e) for n, s, e in spans if n.startswith("yolodl.nms.")]
    assert [n for n, _, _ in inner] == ["yolodl.nms.conflict", "yolodl.nms.keep"]
    assert all(ns <= s <= e <= ne for _, s, e in inner)


@pytest.mark.parametrize("enabled", [False, True])
def test_timing_stages_are_mirrored_into_spans(monkeypatch, enabled):
    monkeypatch.setattr(timing, "_ENABLED", enabled)
    monkeypatch.setattr(timing, "_WHITELIST", set())
    t = timing.Timing("pipeline")
    with user_scope_profile() as prof:
        with t.timed("load"):
            pass
    assert [n for n, _, _ in prof["spans"]] == ["yolodl.data.load"]
    assert ("load" in t.events) == enabled
