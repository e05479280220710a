"""The span readers (``spans.py``, ``metrics/*``) on synthetic traces, built
as ``test_h100bench_trace.py`` builds them: device ops (name, start, end,
(correlation, linked)), host ops (name, start, end, thread), launches
(correlation → (start, thread)).  Times in ns."""

import pytest

from h100bench.run import metric_reader
from h100bench.trace import Trace

MS = 1_000_000
NEW = ["forward_ms.train", "loss_ms.train", "backward_ms.train", "update_ms.train",
       "launches.train", "syncs.train", "launches.infer", "syncs.infer", "to_host_idle_ms.infer"]


def read(name, trace):
    return metric_reader(name)({"trace": trace})


class TraceMaker:
    """Device ops launched by runtime calls, each a host op with a correlation."""

    def __init__(self):
        self.device, self.host, self.launches = [], [], {}

    def span(self, name, s, e, thread=1):
        self.host.append((name, s, e, thread))

    def call(self, name, at, thread=1, op=None, dur=MS, delay=10_000):
        corr = len(self.launches) + 1
        self.launches[corr] = (at, thread)
        self.host.append((name, at, at + 1000, thread))
        if op is not None:   # the device runs it ``delay`` after the call
            self.device.append((op, at + delay, at + delay + dur, (corr, 0)))

    def trace(self, span):
        return Trace(self.device, self.host, self.launches, span)


def train_trace():
    """Two steps at 0 and 100 ms; in each: zero grads (1 ms), forward 2 ×
    (a 3 ms op), loss 1 ms, backward launched from thread 2 (5 + 6 ms),
    update 2 ms, a copy to the host with its stream sync and a copy from
    the host.  A third step's first op makes the second whole."""
    b = TraceMaker()
    for t0 in (0, 100 * MS):
        b.span("yolodl.train.step", t0, t0 + 90 * MS)
        b.call("cudaLaunchKernel", t0 + 1 * MS, op="zero", dur=1 * MS)
        for k in range(2):
            b.span("yolodl.model.forward", t0 + (2 + k) * MS, t0 + (3 + k) * MS)
            b.call("cudaLaunchKernel", t0 + int((2.5 + k) * MS), op="fwd", dur=3 * MS)
        b.span("yolodl.loss", t0 + 10 * MS, t0 + 20 * MS)
        b.span("yolodl.loss.match", t0 + 12 * MS, t0 + 14 * MS)
        b.call("cudaLaunchKernel", t0 + 13 * MS, op="match", dur=1 * MS)
        b.span("yolodl.train.backward", t0 + 20 * MS, t0 + 60 * MS)
        b.call("cudaLaunchKernel", t0 + 30 * MS, thread=2, op="dgrad", dur=5 * MS)
        b.call("cudaLaunchKernel", t0 + 40 * MS, thread=2, op="wgrad", dur=6 * MS)
        b.span("yolodl.train.update", t0 + 60 * MS, t0 + 89 * MS)
        b.call("cudaLaunchKernel", t0 + 61 * MS, op="adam", dur=2 * MS)
        b.call("cudaMemcpyAsync", t0 + 70 * MS, op="Memcpy DtoH (Device -> Pageable)", dur=1000)
        b.call("cudaStreamSynchronize", t0 + 71 * MS)
        b.call("cudaMemcpyAsync", t0 + 72 * MS, op="Memcpy HtoD (Pinned -> Device)", dur=1000)
    b.call("cudaLaunchKernel", 195 * MS, op="zero", dur=1 * MS)
    return b.trace((0, 200 * MS))


def test_backward_launched_from_another_thread_counts_under_its_span():
    t = train_trace()
    assert t.device_under("yolodl.train.backward") == [[], []]   # the launch thread's rule
    assert read("backward_ms.train", t) == pytest.approx(11.0)
    assert read("forward_ms.train", t) == pytest.approx(6.0)
    assert read("loss_ms.train", t) == pytest.approx(1.0)
    assert read("update_ms.train", t) == pytest.approx(2.0 + 0.002)
    # zero, 2 fwd, match, dgrad, wgrad, adam, two copies
    assert read("launches.train", t) == pytest.approx(9.0)


def test_a_copy_to_the_host_is_a_sync_and_a_copy_to_the_device_is_not():
    assert read("syncs.train", train_trace()) == pytest.approx(2.0)   # DtoH + stream sync
    b = TraceMaker()
    b.span("yolodl.train.step", 0, 10 * MS)
    b.call("cudaMemcpyAsync", 1 * MS, op="Memcpy HtoD (Pinned -> Device)", dur=1000)
    b.call("cudaLaunchKernel", 20 * MS, op="next")
    assert read("syncs.train", b.trace((0, 30 * MS))) == 0.0


def test_a_step_cut_off_by_the_window_is_not_averaged():
    """The second step's host span ends inside the window, but its second
    op runs after the window has closed: only the first, whole step is read
    (else 4.5 ms and 1.5 ops)."""
    b = TraceMaker()
    for t0 in (0, 50 * MS):
        b.span("yolodl.train.step", t0, t0 + 40 * MS)
        b.span("yolodl.model.forward", t0 + 1 * MS, t0 + 3 * MS)
        b.call("cudaLaunchKernel", t0 + 1 * MS, op="fwd", dur=3 * MS)
        b.call("cudaLaunchKernel", t0 + 2 * MS, op="fwd", dur=3 * MS,
               delay=(10_000 if t0 == 0 else 50 * MS))
    t = b.trace((0, 95 * MS))
    assert len(t.device) == 3
    assert read("forward_ms.train", t) == pytest.approx(6.0)
    assert read("launches.train", t) == pytest.approx(2.0)


def bulk_trace():
    """Two batches 100 ms apart: forward (3 ops), nms with conflict and keep
    (2 ops), select (1 op), to_host (two copies to the host, each with its
    stream sync).  The to_host span starts while the device still runs."""
    b = TraceMaker()
    for t0 in (0, 100 * MS):
        b.span("yolodl.model.forward", t0, t0 + 10 * MS)
        for k in range(3):
            b.call("cudaLaunchKernel", t0 + (1 + k) * MS, op="conv", dur=5 * MS)
        b.span("yolodl.nms", t0 + 10 * MS, t0 + 20 * MS)
        b.span("yolodl.nms.conflict", t0 + 11 * MS, t0 + 12 * MS)
        b.call("cudaLaunchKernel", t0 + 11 * MS, op="conflict")
        b.span("yolodl.nms.keep", t0 + 12 * MS, t0 + 13 * MS)
        b.call("cudaLaunchKernel", t0 + 12 * MS, op="keep")
        b.span("yolodl.inference.select", t0 + 20 * MS, t0 + 21 * MS)
        b.call("cudaLaunchKernel", t0 + 20 * MS, op="select")
        b.span("yolodl.inference.to_host", t0 + 21 * MS, t0 + 41 * MS)
        for k in range(2):
            b.call("cudaMemcpyAsync", t0 + (22 + k) * MS, op="Memcpy DtoH (Device -> Pageable)",
                   dur=1000)
            b.call("cudaStreamSynchronize", t0 + (22 + k) * MS + 5000)
    b.call("cudaLaunchKernel", 190 * MS, op="conv")
    return b


def test_batch_launches_and_syncs():
    t = bulk_trace().trace((0, 200 * MS))
    assert read("launches.infer", t) == pytest.approx(6.0)
    assert read("syncs.infer", t) == pytest.approx(4.0)


def test_to_host_idle_subtracts_the_busy_union_and_clips_to_the_window():
    t = bulk_trace().trace((0, 200 * MS))
    # ops end at 6.01, 7.01, 8.01 (conv), 12.01, 13.01 (nms), 21.01 (select)
    # and 22.011, 23.011 (copies): the span [21, 41] is busy 0.01 + 2 × 0.001 ms
    assert read("to_host_idle_ms.infer", t) == pytest.approx(20.0 - 0.012)
    # a window that opens at 30 ms into the second batch's to_host: clipped
    t = bulk_trace().trace((130 * MS, 200 * MS))
    assert read("to_host_idle_ms.infer", t) == pytest.approx(11.0)


@pytest.mark.parametrize("name", NEW)
def test_no_spans_or_no_ops_read_zero(name):
    b = TraceMaker()
    b.call("cudaLaunchKernel", 1 * MS, op="k")   # ops but no span of the program
    assert read(name, b.trace((0, 10 * MS))) == 0.0
    b = TraceMaker()
    b.span("yolodl.train.step", 0, 5 * MS)
    b.span("yolodl.inference.to_host", 0, 5 * MS)
    for span in ("yolodl.model.forward", "yolodl.loss", "yolodl.train.backward",
                 "yolodl.train.update", "yolodl.nms", "yolodl.inference.select"):
        b.span(span, 1 * MS, 2 * MS)
    value = read(name, b.trace((0, 10 * MS)))   # spans that hold no ops and no calls
    assert isinstance(value, float) and value == (5.0 if name == "to_host_idle_ms.infer" else 0.0)
