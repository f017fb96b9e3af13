"""Tracing / profiling: named timers and rotating-bucket metric reports.

Reference semantics: ``/root/reference/Sources/SwiftVideo/stats.swift:25-340``.

``StatsReport`` collects typed samples (int / float / TimePoint) into five
rotating time buckets keyed by ``(now - epoch) / period % 5`` and, on a
clock-scheduled cadence, recomputes a JSON summary per metric
(median / mean / peak / low / total / average-per-second / count).  It rides
*inside* events: ``EventInfo = StatsReport`` — each pipeline stage can start
and end timers on the report carried by the sample flowing through it, and
reports merge when event lists merge.

The JSON layout (including the odd embedded newlines) reproduces the
reference's format strings byte-for-byte (stats.swift:252-322) so that ported
tests assert identical output.
"""

from __future__ import annotations

import threading
import time as _time
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .clock import Clock, WallClock
from .time import TimePoint, fseconds, rescale, seconds


@dataclass
class StatsResult:
    asset_id: Optional[str]
    event_time: float  # unix seconds
    time_point: TimePoint
    results: Dict[str, str]


@dataclass
class _Samples:
    """One time bucket of samples, per type (stats.swift:27-48)."""

    double_samples: Dict[str, List[Tuple[TimePoint, float]]] = field(default_factory=dict)
    timepoint_samples: Dict[str, List[Tuple[TimePoint, TimePoint]]] = field(default_factory=dict)
    int_samples: Dict[str, List[Tuple[TimePoint, int]]] = field(default_factory=dict)

    def clear(self) -> None:
        self.double_samples.clear()
        self.timepoint_samples.clear()
        self.int_samples.clear()

    def merging(self, other: "_Samples") -> "_Samples":
        def merged(a, b):
            out = {k: list(v) for k, v in a.items()}
            for k, v in b.items():
                out.setdefault(k, []).extend(v)
            return out

        return _Samples(merged(self.double_samples, other.double_samples),
                        merged(self.timepoint_samples, other.timepoint_samples),
                        merged(self.int_samples, other.int_samples))


_NUM_BUCKETS = 5


class StatsReport:
    """Metric collector with periodic recompute (stats.swift:25-340)."""

    def __init__(self, asset_id: Optional[str] = None,
                 period: TimePoint = TimePoint(5000, 1000),
                 clock: Optional[Clock] = None):
        clock = clock if clock is not None else WallClock()
        self._clock = clock
        self._id_asset = asset_id
        self._inflight: Dict[str, TimePoint] = {}
        self._lock = threading.RLock()
        self._epoch = clock.current()
        now = clock.current()
        self._period = period
        self._last_computed = now
        self._samples = [_Samples() for _ in range(_NUM_BUCKETS)]
        self._results: Optional[StatsResult] = None
        self._closed = False
        self._schedule_tick(now + period)

    def _schedule_tick(self, at: TimePoint) -> None:
        # the clock callback holds the report WEAKLY: reports are created
        # per connection / per merging() call, and a strong bound-method
        # ref would make every one an immortal self-rescheduling timer
        ref = weakref.ref(self)

        def tick(event):
            report = ref()
            if report is not None and not report._closed:
                report._recompute(event.time())

        self._clock.schedule(at, tick)

    def close(self) -> None:
        """Stop the periodic recompute (the pending tick no-ops)."""
        self._closed = True

    # --- construction helpers (stats.swift:86-109) -----------------------
    def merging(self, other: "StatsReport") -> "StatsReport":
        report = StatsReport(asset_id=other.asset_id(),
                             period=other._period, clock=other._clock)
        report._epoch = other._epoch
        report._last_computed = other._last_computed
        with self._lock, other._lock:
            report._samples = [a.merging(b) for a, b in zip(self._samples, other._samples)]
            report._inflight = dict(other._inflight)
        return report

    # --- timers (stats.swift:110-128) -----------------------------------
    def start_timer(self, name: str) -> None:
        now = self._clock.current()
        with self._lock:
            self._inflight[name] = now

    def end_timer(self, name: str) -> None:
        end = self._clock.current()
        with self._lock:
            start = self._inflight.pop(name, None)
        if start is not None:
            self.add_sample(name, end - start)

    # --- samples ---------------------------------------------------------
    def add_sample(self, name: str, val) -> None:
        sample_time = self._clock.current()
        idx = self._bucket_index(sample_time)
        with self._lock:
            bucket = self._samples[idx]
            if isinstance(val, TimePoint):
                bucket.timepoint_samples.setdefault(name, []).append((sample_time, val))
            elif isinstance(val, float):
                bucket.double_samples.setdefault(name, []).append((sample_time, val))
            else:
                bucket.int_samples.setdefault(name, []).append((sample_time, int(val)))

    def _bucket_index(self, time: TimePoint) -> int:
        # stats.swift:162-167
        duration = rescale(self._period, time.scale)
        now = time - rescale(self._epoch, time.scale)
        if duration.value == 0:
            return 0
        return int(now.value // duration.value % _NUM_BUCKETS)

    # --- reporting (stats.swift:185-228) ---------------------------------
    def report(self) -> Optional[StatsResult]:
        with self._lock:
            res = self._results
            self._results = None
        return res

    def asset_id(self) -> Optional[str]:
        return self._id_asset

    def _recompute(self, now: TimePoint) -> None:
        try:
            duration = self._period
            idx = (_NUM_BUCKETS + self._bucket_index(now) - 2) % _NUM_BUCKETS
            sample_time = now - duration
            with self._lock:
                bucket = self._samples[idx]
                results: Dict[str, str] = {}
                for name, samples in bucket.double_samples.items():
                    results.update(self._compute_double(sample_time, name, duration, samples))
                for name, samples in bucket.timepoint_samples.items():
                    results.update(self._compute_time(sample_time, name, duration, samples))
                for name, samples in bucket.int_samples.items():
                    results.update(self._compute_int(sample_time, name, duration, samples))
                self._results = StatsResult(
                    asset_id=self.asset_id(),
                    event_time=_time.time() - seconds(duration),
                    time_point=now - duration,
                    results=results)
                bucket.clear()
        finally:
            self._last_computed = now
            if not self._closed:
                self._schedule_tick(now + self._period)

    # window filter shared by all three compute variants (stats.swift:235-241)
    @staticmethod
    def _window(now: TimePoint, duration: TimePoint, samples):
        by_time = sorted(samples, key=lambda s: seconds(s[0]), reverse=True)
        older_than = now - duration
        idx = next((i for i, s in enumerate(by_time) if s[0] < older_than), len(by_time))
        if idx == 0:
            return None
        return by_time[:idx] if idx < len(by_time) else by_time

    def _compute_time(self, now, name, duration, samples) -> Dict[str, str]:
        base = self._window(now, duration, samples)
        if not base:
            return {}
        period = f"{seconds(duration):.2f}"
        by_val = sorted(base, key=lambda s: seconds(s[1]))
        vals = [fseconds(v) for _, v in by_val]
        total = sum(vals)
        report = (f'{{ "name": "{name}", "period": {period}, "type": "time", '
                  f'"median": {vals[len(vals)//2]:.5f}, "mean": {total/len(vals):.5f}, '
                  f'"peak": {vals[-1]:.5f}, "low": {vals[0]:.5f}, "total": {total:.5f},\n'
                  f'  "averagePerSecond": {total/fseconds(duration):.5f}, "count": {len(vals)}}}')
        return {f"{name}.{period}": report}

    def _compute_double(self, now, name, duration, samples) -> Dict[str, str]:
        base = self._window(now, duration, samples)
        if not base:
            return {}
        period = f"{seconds(duration):.2f}"
        vals = sorted(v for _, v in base)
        total = sum(vals)
        report = (f'{{ "name": "{name}", "period": {period}, "type": "double", '
                  f'"median": {vals[len(vals)//2]:.5f}, "mean": {total/len(vals):.5f},\n'
                  f'"peak": {vals[-1]:.5f}, "low": {vals[0]:.5f}, "total": {total:.5f},\n'
                  f'  "averagePerSecond": {total/fseconds(duration):.5f}, "count": {len(vals)} }}')
        return {f"{name}.{period}": report}

    def _compute_int(self, now, name, duration, samples) -> Dict[str, str]:
        base = self._window(now, duration, samples)
        if not base:
            return {}
        period = f"{seconds(duration):.2f}"
        vals = sorted(v for _, v in base)
        total = sum(vals)
        report = (f'{{ "name": "{name}", "period": {period}, "type": "int", '
                  f'"median": {vals[len(vals)//2]}, "mean": {total/len(vals):.5f}, '
                  f'"peak": {vals[-1]}, "low": {vals[0]}, "total": {total},\n'
                  f'  "averagePerSecond": {total/fseconds(duration):.5f}, "count": {len(vals)} }}')
        return {f"{name}.{period}": report}
