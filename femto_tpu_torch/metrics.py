"""Timing and counter instrumentation (the port's own copy of
femto_tpu/metrics.py).

The reference threads start_clock/stop_clock/print_timings through
construction (femto's src/utils/timing.h:53-55, dcx.hh:4651-4745)
and keeps per-pipe io_stats plus server block_request/fault counters
(iostats.h:31-64, server.h:633-636).  This module is the equivalent:
nestable named timers forming a timing tree, plus global counters that hot
paths bump cheaply; `report()` prints the tree like print_timings.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = defaultdict(int)
        self.timings: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self._stack: List[str] = []

    def count(self, name: str, inc: int = 1) -> None:
        with self._lock:
            self.counters[name] += inc

    @contextlib.contextmanager
    def timer(self, name: str) -> Iterator[None]:
        path = "/".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._stack.pop()
            with self._lock:
                self.timings[path] += dt
                self.calls[path] += 1

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "counters": dict(self.counters),
                "timings": {
                    k: {"seconds": v, "calls": self.calls[k]}
                    for k, v in self.timings.items()
                },
            }

    def report(self) -> str:
        snap = self.snapshot()
        lines = []
        for k in sorted(snap["timings"]):
            t = snap["timings"][k]
            depth = k.count("/")
            lines.append(
                f"{'  ' * depth}{k.split('/')[-1]}: "
                f"{t['seconds']:.3f}s ({t['calls']} calls)"
            )
        for k in sorted(snap["counters"]):
            lines.append(f"{k} = {snap['counters'][k]}")
        return "\n".join(lines)

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.timings.clear()
            self.calls.clear()


# Global registry (the analog of the reference's global io_stats).
metrics = Metrics()
