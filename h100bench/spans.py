"""The program's own spans in the traced window, and what the span readers
(``metrics/{forward,loss,backward,update}_ms.train.py``,
``launches.*``, ``syncs.*``, ``to_host_idle_ms.infer``) compute from them.

``yolodl_torch`` opens a ``record_function`` range named ``yolodl.*`` at
each boundary of its layers while a profiler runs (its ``utils/timing.py``
``span``).  Two rules:

- A device operation belongs to a span when the runtime call that launched
  it started inside the span, on any thread: autograd launches the
  backward's kernels from a thread of its own while the span is open on the
  caller's.
- A span is whole when it ended inside the traced span and the device then
  began there an operation launched after the span's end: on the one stream
  the program runs on, every operation the span launched ran before it, so
  none was cut off at the span's end.  Per-step numbers are averages over
  whole ``yolodl.train.step`` spans; per-batch numbers add up, over the
  names of a batch's spans, each name's average over its spans (its whole
  ones where device operations are counted).

A blocking call is a ``cudaStreamSynchronize``, ``cudaDeviceSynchronize``
or ``cudaEventSynchronize``, or a ``cudaMemcpy*`` whose device copy
(paired by correlation id) goes device to host.  Where the trace holds no
span of the program (a program that opens none), every reader gives 0.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple

from .trace import Interval, union

PREFIX = "yolodl."
STEP = "yolodl.train.step"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")
Op = Tuple[str, int, int, tuple]


class Spans:
    """The program's spans of one :class:`h100bench.trace.Trace`, and the
    device operations and blocking calls launched under them."""

    def __init__(self, trace):
        self.trace = trace
        launched = []
        for op in trace.device:
            launch = trace.launches.get(op[3][0]) or trace.launches.get(op[3][1])
            if launch is not None:
                launched.append((launch[0], op))
        launched.sort(key=lambda x: x[0])
        self.launch_times = [t for t, _ in launched]
        self.ops: List[Op] = [op for _, op in launched]
        # the last launch whose operation began inside the traced span
        self.last_launch = self.launch_times[-1] if launched else trace.span[0]
        self.blocking = self._blocking()

    def _blocking(self) -> List[int]:
        """Start times of the blocking calls, sorted."""
        trace = self.trace
        calls = {(s, t): n for n, s, _, t in trace.host if n.startswith("cu")}
        out = [s for n, s, _, _ in trace.host if n in SYNCS]
        for name, _, _, corrs in trace.device:
            if name.startswith("Memcpy DtoH"):
                launch = trace.launches.get(corrs[0]) or trace.launches.get(corrs[1])
                if launch is not None and calls.get(launch, "").startswith("cudaMemcpy"):
                    out.append(launch[0])
        return sorted(out)

    def spans(self, name: str) -> List[Interval]:
        """(start, end) of the ranges ``name`` that ended inside the traced span."""
        lo, hi = self.trace.span
        return [(s, e) for s, e, _ in self.trace.ranges(name) if lo <= e <= hi]

    def whole(self, name: str) -> List[Interval]:
        return [(s, e) for s, e in self.spans(name) if e < self.last_launch]

    def ops_in(self, intervals: Iterable[Interval]) -> List[Op]:
        """The device operations launched inside any of ``intervals`` ([s, e))."""
        out: List[Op] = []
        for s, e in union(list(intervals)):
            out += self.ops[bisect.bisect_left(self.launch_times, s):
                            bisect.bisect_left(self.launch_times, e)]
        return out

    def calls_in(self, s: int, e: int) -> int:
        """The blocking calls started inside [s, e)."""
        return bisect.bisect_left(self.blocking, e) - bisect.bisect_left(self.blocking, s)

    def per_step(self, names: Optional[Tuple[str, ...]] = None) -> List[List[Op]]:
        """For each whole step, the device operations launched in it under
        the spans ``names`` (under the step itself when None)."""
        inner = [iv for n in names or () for iv in self.spans(n)]
        return [self.ops_in([(s, e)] if names is None
                            else [(a, b) for a, b in inner if s <= a and b <= e])
                for s, e in self.whole(STEP)]

    def outermost(self) -> Dict[str, List[Interval]]:
        """The program's spans that ended inside the traced span and lie in
        no other of its spans on their thread, by name."""
        lo, hi = self.trace.span
        by_thread: Dict[int, List[Tuple[int, int, str]]] = defaultdict(list)
        for n, s, e, t in self.trace.host:
            if n.startswith(PREFIX) and lo <= e <= hi:
                by_thread[t].append((s, e, n))
        out: Dict[str, List[Interval]] = defaultdict(list)
        for ranges in by_thread.values():
            end = None
            for s, e, n in sorted(ranges, key=lambda r: (r[0], -r[1])):
                if end is None or s >= end:
                    out[n].append((s, e))
                    end = e
        return out


def of(trace) -> Spans:
    """The trace's :class:`Spans`, made once for all of a run's readers."""
    spans = getattr(trace, "_program_spans", None)
    if spans is None:
        spans = trace._program_spans = Spans(trace)
    return spans


def mean(values: List[float]) -> float:
    return sum(values) / len(values) if values else 0.0


def device_ms(groups: List[List[Op]]) -> float:
    """The device time of each group's operations, averaged over the groups, in ms."""
    return mean([sum(e - s for _, s, e, _ in ops) for ops in groups]) / 1e6


def phase_ms(trace, name: str) -> float:
    """Device ms a step of the operations launched under ``name``."""
    return device_ms(of(trace).per_step((name,)))


def step_launches(trace) -> float:
    return mean([len(ops) for ops in of(trace).per_step()])


def step_syncs(trace) -> float:
    sp = of(trace)
    return mean([sp.calls_in(s, e) for s, e in sp.whole(STEP)])


def batch_launches(trace, names: Tuple[str, ...]) -> float:
    """Device operations a batch launched under the spans ``names``, each
    name averaged over its whole spans."""
    sp = of(trace)
    return sum((mean([len(sp.ops_in([iv])) for iv in sp.whole(n)]) for n in names), 0.0)


def batch_syncs(trace) -> float:
    """Blocking calls a batch made under the program's spans, each
    outermost name averaged over its spans."""
    sp = of(trace)
    return sum((mean([sp.calls_in(s, e) for s, e in ivs]) for ivs in sp.outermost().values()), 0.0)


def idle_ms(trace, name: str) -> float:
    """For each span ``name`` that ended inside the traced span, the part of
    it (clipped to the traced span) in which no device operation ran,
    averaged over the spans, in ms."""
    lo, hi = trace.span
    gaps = []
    for s, e in of(trace).spans(name):
        s, e = max(s, lo), min(e, hi)
        busy = sum(min(b, e) - max(a, s) for a, b in trace.busy if b > s and a < e)
        gaps.append(max(e - s, 0) - busy)
    return mean(gaps) / 1e6
