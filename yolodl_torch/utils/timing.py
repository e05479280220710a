"""Stage-event timing + throughput counters.

Equivalent capability to ``yolo-dl/src/profiling.rs`` (named event timeline
with parallel-merge taking the max, tree report, env-var whitelist
``YOLODL_PROFILING_WHITELIST``) and ``train/src/utils/rate_counter.rs``
(records/s, batches/s).

Counterpart of ``yolodl_tpu/utils/timing.py``.  Device-side timing belongs
to ``torch.profiler``; this tracks the host pipeline, as the reference does.
The environment switches are read when the module is imported, as there.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

_ENABLED = os.environ.get("YOLODL_PROFILING", "0") not in ("0", "", "false")
_WHITELIST = {
    name.strip()  # 'a, b' must whitelist 'b', not ' b'
    for name in os.environ.get("YOLODL_PROFILING_WHITELIST", "").split(",")
    if name.strip()
}


def profiling_enabled(name: Optional[str] = None) -> bool:
    if not _ENABLED:
        return False
    if _WHITELIST and name is not None and name not in _WHITELIST:
        return False
    return True


class Timing:
    """Named event durations (seconds).  Zero-cost-ish when disabled."""

    def __init__(self, name: str):
        self.name = name
        self.events: Dict[str, float] = {}
        self._enabled = profiling_enabled(name)
        self._last = time.perf_counter() if self._enabled else 0.0

    def add_event(self, name: str) -> None:
        """Stamp the elapsed time since the previous event (profiling.rs:90-99)."""
        if not self._enabled:
            return
        now = time.perf_counter()
        self.events[name] = self.events.get(name, 0.0) + (now - self._last)
        self._last = now

    @contextlib.contextmanager
    def timed(self, name: str):
        if not self._enabled:
            yield
            return
        start = time.perf_counter()
        try:
            yield
        finally:
            self.events[name] = self.events.get(name, 0.0) + time.perf_counter() - start

    def merge(self, other: "Timing") -> None:
        """Merge a parallel timeline, taking the max per event
        (profiling.rs:57-87)."""
        for key, value in other.events.items():
            self.events[key] = max(self.events.get(key, 0.0), value)

    def report(self) -> str:
        if not self.events:
            return f"[{self.name}] (no events)"
        total = sum(self.events.values())
        lines = [f"[{self.name}] total {total * 1e3:.1f} ms"]
        for key, value in sorted(self.events.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {key}: {value * 1e3:.1f} ms")
        return "\n".join(lines)


class RateCounter:
    """Sliding-window rate (rate_counter.rs:5-39)."""

    def __init__(self, window_secs: float = 10.0):
        self.window = window_secs
        self.samples: List[tuple] = []

    def add(self, count: float) -> None:
        now = time.monotonic()
        self.samples.append((now, count))
        cutoff = now - self.window
        while self.samples and self.samples[0][0] < cutoff:
            self.samples.pop(0)

    def rate(self) -> float:
        if len(self.samples) < 2:
            return 0.0
        span = self.samples[-1][0] - self.samples[0][0]
        if span <= 0:
            return 0.0
        return sum(c for _, c in self.samples[1:]) / span
