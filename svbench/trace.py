"""The device trace of a traced run: torch.profiler's CUDA activities over
the measured window, reduced to busy time, per-kernel time and idle gaps
labelled by the host span they fell in."""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Tuple

from .spans import Spans, gaps, labels_at, union_s

TOP = 10
NAME = 120  # characters of a kernel's name kept in the breakdown


class DeviceTrace:
    """Profile the block between ``start`` and ``stop``; ``events`` then
    holds (name, start ns, end ns) of every device activity, in the
    profiler's clock, and ``host_offset_ns`` turns a ``perf_counter_ns``
    reading into that clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.events: List[Tuple[str, int, int]] = []
        self.host_offset_ns = 0
        self.window_ns = (0, 0)
        self.stopped = False

    def start(self) -> None:
        self._prof.__enter__()
        self._clocks = (time.perf_counter_ns(), time.time_ns(),
                        time.monotonic_ns())

    def stop(self, t0_perf_ns: int, t1_perf_ns: int) -> None:
        import torch
        self.stopped = True
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        from torch.autograd import DeviceType
        results = self._prof.profiler.kineto_results
        for e in results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            start = e.start_ns()
            self.events.append((e.name(), start, start + e.duration_ns()))
        # which host clock the profiler's timestamps follow: the one whose
        # reading at the start lies nearest the trace's start
        perf, wall, mono = self._clocks
        ref = results.trace_start_ns()
        base = min((wall, mono, perf), key=lambda c: abs(ref - c))
        self.host_offset_ns = base - perf
        self.window_ns = (t0_perf_ns + self.host_offset_ns,
                          t1_perf_ns + self.host_offset_ns)
        lo, hi = self.window_ns
        self.events = [(n, max(a, lo), min(b, hi)) for n, a, b in self.events
                       if b > lo and a < hi]

    def busy_s(self) -> float:
        return union_s([(a, b) for _n, a, b in self.events])

    def window_s(self) -> float:
        lo, hi = self.window_ns
        return (hi - lo) / 1e9

    def kernel(self, name: str) -> Tuple[int, float]:
        """(activities recorded, device seconds) of the activities whose
        name contains ``name``."""
        hits = [(b - a) for n, a, b in self.events if name in n]
        return len(hits), sum(hits) / 1e9

    def breakdown(self, spans: Spans) -> Dict[str, list]:
        by_name: Dict[str, int] = defaultdict(int)
        for n, a, b in self.events:
            by_name[n] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        lo, hi = self.window_ns
        idle = gaps([(a, b) for _n, a, b in self.events], lo, hi)
        mids = [(a + b) // 2 - self.host_offset_ns for a, b in idle]
        order = sorted(range(len(idle)), key=lambda i: mids[i])
        labels = labels_at(spans.timeline, [mids[i] for i in order])
        by_label: Dict[str, int] = defaultdict(int)
        for i, label in zip(order, labels):
            a, b = idle[i]
            by_label[label] += b - a
        idle_top = sorted(by_label.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n[:NAME], ns / 1e9] for n, ns in ops],
                "idle_gaps": [[n, ns / 1e9] for n, ns in idle_top]}
