"""The traced window: torch.profiler over a contiguous span inside the
measured window, and what is read from it.

``window_s`` is the span between two marks the harness sets on the host
(``h100bench.trace_begin`` / ``h100bench.trace_end``), in the profiler's
clock.  ``busy_s`` is the length of the union of the device's kernels,
copies and sets inside that span, each clipped to it, so
0 <= busy_s <= window_s holds by construction.  A device operation is
attributed to a host range (``record_function``) when the runtime call
that launched it started inside that range on the same thread.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

Interval = Tuple[int, int]
BEGIN, END = "h100bench.trace_begin", "h100bench.trace_end"


def union(intervals: List[Interval]) -> List[Interval]:
    """Sorted, disjoint union of [start, end) intervals."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def clip(intervals: List[Interval], lo: int, hi: int) -> List[Interval]:
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


class Trace:
    """What the harness reads of one profiled span.

    ``device``: (name, start_ns, end_ns, (correlation, linked correlation))
    of every device operation; ``host``: (name, start_ns, end_ns, thread) of every host op;
    ``launches``: correlation → (start_ns, thread) of the runtime calls."""

    def __init__(self, device, host, launches, span: Interval):
        self.span = span
        self.device = [d for d in device if d[2] > span[0] and d[1] < span[1]]
        self.host = host
        self.launches = launches
        self.busy = union(clip([(d[1], d[2]) for d in self.device], *span))

    @property
    def window_s(self) -> float:
        return (self.span[1] - self.span[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def ranges(self, name: str) -> List[Tuple[int, int, int]]:
        """(start, end, thread) of the host ranges called ``name``."""
        return sorted((s, e, t) for n, s, e, t in self.host if n == name)

    def device_under(self, name: str) -> List[List[Tuple[str, int, int]]]:
        """For each host range ``name`` that ends inside the span, the device
        operations it launched: [(name, start, end)]."""
        ranges = [r for r in self.ranges(name) if self.span[0] <= r[1] <= self.span[1]]
        by_thread: Dict[int, List[Tuple[int, int, int]]] = defaultdict(list)
        for i, (s, e, t) in enumerate(ranges):
            by_thread[t].append((s, e, i))
        starts = {t: [r[0] for r in rs] for t, rs in by_thread.items()}
        out: List[List[Tuple[str, int, int]]] = [[] for _ in ranges]
        for dname, ds, de, corrs in self.device:
            launch = self.launches.get(corrs[0]) or self.launches.get(corrs[1])
            if launch is None or launch[1] not in by_thread:
                continue
            rs = by_thread[launch[1]]
            k = bisect.bisect_right(starts[launch[1]], launch[0]) - 1
            if k >= 0 and rs[k][0] <= launch[0] <= rs[k][1]:
                out[rs[k][2]].append((dname, ds, de))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations of most time (summed by name, clipped to
        the span) and the longest idle gaps, each named by the innermost
        host op open when it began (or ``host code between ops``)."""
        by_name: Dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.device:
            s, e = max(s, self.span[0]), min(e, self.span[1])
            if e > s:
                by_name[name[:120]] += (e - s) / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, last = [], self.span[0]
        for s, e in self.busy + [(self.span[1], self.span[1])]:
            if s > last:
                gaps.append((last, s))
            last = max(last, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            open_ops = [(hs, he, n) for n, hs, he, _ in self.host
                        if hs <= s < he and not n.startswith("h100bench.trace_")]
            name = min(open_ops, key=lambda o: o[1] - o[0])[2] if open_ops else "host code between ops"
            named.append([name[:120], (e - s) / 1e9])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def _is_device(event) -> bool:
    return (event.device_type().name == "CUDA"
            and not event.is_user_annotation()
            and "annotation" not in str(getattr(event, "activity_type", lambda: "")()).lower())


class _Profile:
    """torch's profiler, CPU and CUDA activities, whose CPU side records
    the ``record_function`` ranges alone (``RecordScope.USER_SCOPE``): the
    runtime's calls and the device's operations come from CUPTI as
    always, while no other host op pays the profiler's cost, which would
    slow a program that launches a kernel an operation."""

    def __init__(self):
        from torch._C._autograd import _enable_profiler, _prepare_profiler
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                        RecordScope, _ExperimentalConfig)

        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                _ExperimentalConfig())
        activities = {ProfilerActivity.CPU, ProfilerActivity.CUDA}
        _prepare_profiler(config, activities)
        _enable_profiler(config, activities, {RecordScope.USER_SCOPE})

    @staticmethod
    def stop():
        from torch._C._autograd import _disable_profiler

        return _disable_profiler()


class Tracer:
    """Starts the profiler at ``start_s`` into the measured window and stops
    it at ``stop_s``; drivers call :meth:`tick` with the seconds elapsed
    in the window, as often as they like.  Disabled, it does nothing."""

    def __init__(self, enabled: bool, seconds: float, trace_seconds: float):
        self.enabled = enabled
        span = min(seconds, trace_seconds)
        self.start_s = (seconds - span) / 2
        self.stop_s = self.start_s + span
        self.prof = None
        self.done = False
        self.trace: Optional[Trace] = None

    def prepare(self) -> None:
        """Start and stop the profiler once around a small device operation,
        so that the traced span does not pay its first start (CUPTI's)."""
        if not self.enabled:
            return
        import torch

        prof = _Profile()
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.stop()

    def tick(self, elapsed: float) -> None:
        if not self.enabled or self.done:
            return
        if self.prof is None and elapsed >= self.start_s:
            from torch.autograd.profiler import record_function

            self.prof = _Profile()
            with record_function(BEGIN):
                pass
        elif self.prof is not None and elapsed >= self.stop_s:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        from torch.autograd.profiler import record_function

        with record_function(END):
            pass
        self.result = self.prof.stop()
        self.done = True

    def read(self) -> Optional[Trace]:
        """The trace of the span; None when the profiler never ran."""
        if self.prof is None:
            return None
        if not self.done:
            self.stop()
        events = self.result.events()
        device, host, launches, marks = [], [], {}, {}
        for ev in events:
            start, dur = ev.start_ns(), ev.duration_ns()
            if _is_device(ev):
                device.append((ev.name(), start, start + dur,
                               (ev.correlation_id(), ev.linked_correlation_id())))
            elif ev.device_type().name == "CPU":
                name = ev.name()
                if name in (BEGIN, END):
                    marks[name] = start
                host.append((name, start, start + dur, ev.start_thread_id()))
                if name.startswith("cu"):   # a runtime call: cudaLaunchKernel, ...
                    for corr in (ev.correlation_id(), ev.linked_correlation_id()):
                        if corr:
                            launches[corr] = (start, ev.start_thread_id())
        if BEGIN not in marks or END not in marks:
            raise RuntimeError("the trace lacks the harness's begin or end mark")
        self.trace = Trace(device, host, launches, (marks[BEGIN], marks[END]))
        self.prof = None
        return self.trace
