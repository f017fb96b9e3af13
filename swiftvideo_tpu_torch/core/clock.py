"""Clocks: wall-time scheduling and stepped virtual time.

Reference semantics: ``/root/reference/Sources/SwiftVideo/clock.swift:22-178``.

* ``Clock`` — protocol: ``step``, ``current``, ``schedule(at, fn)``,
  unix-time conversions (unix time is expressed at scale 100000, "flicks-ish").
* ``WallClock`` — real time relative to a process epoch; ``schedule`` fires
  callbacks from a timer thread.  Callbacks scheduled at or before "now" fire
  asynchronously but immediately.
* ``StepClock`` — manually stepped virtual clock used for deterministic
  tests: ``step()`` advances time by ``step_size`` and runs every callback
  whose deadline has passed, *on the calling thread*.  This is the determinism
  lever for the whole test suite (audio mixer sine tests, RTMP loopback).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time as _time
import uuid
from dataclasses import dataclass
from typing import Callable, List, Optional, Protocol, Tuple

from . import spans
from .time import TimePoint, from_seconds, seconds


@dataclass(frozen=True)
class ClockTickEvent:
    """Event handed to scheduled callbacks (clock.swift:289-305)."""

    time_point: TimePoint
    id_asset: str
    id_workspace: str

    def type(self) -> str:
        return "clock.tick"

    def time(self) -> TimePoint:
        return self.time_point

    def asset_id(self) -> str:
        return self.id_asset

    def workspace_id(self) -> str:
        return self.id_workspace

    def workspace_token(self) -> Optional[str]:
        return None

    def info(self):
        return None


class Clock(Protocol):
    def step(self) -> TimePoint: ...
    def current(self) -> TimePoint: ...
    def schedule(self, at: TimePoint, fn: Callable[[ClockTickEvent], None]) -> None: ...
    def from_unix_time(self, t: int) -> TimePoint: ...
    def to_unix_time(self, t: TimePoint) -> int: ...


class WallClock:
    """Real-time clock with a dedicated scheduler thread.

    The reference uses DispatchSourceTimer per scheduled event
    (clock.swift:79-106); here a single daemon thread drains a heap, which is
    the idiomatic Python equivalent and keeps ordering deterministic for
    same-deadline events.
    """

    def __init__(self, epoch: Optional[float] = None,
                 asset_id: Optional[str] = None,
                 workspace_id: str = "wallclock"):
        self._epoch = _time.time() if epoch is None else epoch
        self._asset_id = asset_id or str(uuid.uuid4())
        self._workspace_id = workspace_id
        self._heap: List[Tuple[float, int, TimePoint, Callable[[ClockTickEvent], None]]] = []
        self._counter = itertools.count()
        self._cv = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name=f"clock.schedule.{workspace_id}/{self._asset_id}")
        self._thread.start()

    # --- Clock protocol --------------------------------------------------
    def step(self) -> TimePoint:
        return self.current()

    def current(self) -> TimePoint:
        return from_seconds(_time.time() - self._epoch)

    def from_unix_time(self, t: int) -> TimePoint:
        return from_seconds(float(t) / 100000.0 - self._epoch)

    def to_unix_time(self, t: TimePoint) -> int:
        return int((self._epoch + seconds(t)) * 100000.0)

    def schedule(self, at: TimePoint, fn: Callable[[ClockTickEvent], None]) -> None:
        deadline = self._epoch + seconds(at)
        with self._cv:
            heapq.heappush(self._heap, (deadline, next(self._counter), at, fn))
            self._cv.notify()

    def close(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify()

    # --- scheduler thread ------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._stopped and (not self._heap or self._heap[0][0] > _time.time()):
                    timeout = None
                    if self._heap:
                        timeout = max(0.0, self._heap[0][0] - _time.time())
                    self._cv.wait(timeout=timeout)
                if self._stopped:
                    return
                _, _, at, fn = heapq.heappop(self._heap)
            span = spans.ON and spans.begin("clock.step")
            try:
                fn(ClockTickEvent(at, self._asset_id, self._workspace_id))
            except Exception:  # pragma: no cover - callback errors must not kill the clock
                import traceback
                traceback.print_exc()
            if span:
                spans.end_step(span)


class StepClock:
    """Virtual clock advanced manually by ``step()`` (clock.swift:109-178).

    ``schedule`` with a deadline at or before "now" runs the callback
    synchronously on the calling thread; future deadlines run when a ``step``
    crosses them.  Tests step the clock from their receive callbacks to build
    closed generator -> mixer -> validator loops that run as fast as the CPU
    allows.
    """

    def __init__(self, step_size: TimePoint,
                 asset_id: Optional[str] = None,
                 workspace_id: str = "stepclock"):
        self._time = TimePoint(0, 100000)
        self._step_size = step_size
        self._scheduled: List[Tuple[TimePoint, Callable[[ClockTickEvent], None]]] = []
        self._asset_id = asset_id or str(uuid.uuid4())
        self._workspace_id = workspace_id
        self._lock = threading.RLock()

    def step(self) -> TimePoint:
        span = spans.ON and spans.begin("clock.step")
        with self._lock:
            self._time = self._time + self._step_size
        cur = self._run_events()
        if span:
            spans.end_step(span)
        return cur

    def current(self) -> TimePoint:
        return self._time

    def from_unix_time(self, t: int) -> TimePoint:
        return self.current()

    def to_unix_time(self, t: TimePoint) -> int:
        return 0

    def reset(self) -> None:
        with self._lock:
            self._time = TimePoint(0, 100000)
            self._scheduled.clear()

    def schedule(self, at: TimePoint, fn: Callable[[ClockTickEvent], None]) -> None:
        if at <= self.current():
            fn(ClockTickEvent(at, self._asset_id, self._workspace_id))
        else:
            with self._lock:
                self._scheduled.append((at, fn))

    def pending_count(self) -> int:
        """Number of not-yet-due scheduled callbacks.  Drivers that step
        the clock to exhaustion (CLI transcode drain) poll this instead of
        guessing a fixed tick budget — a FileSource's read-ahead can leave
        minutes of emits scheduled past the moment pulling hits EOF."""
        with self._lock:
            return len(self._scheduled)

    def _run_events(self) -> TimePoint:
        cur = self.current()
        with self._lock:
            pending = self._scheduled
            self._scheduled = []
            keep: List[Tuple[TimePoint, Callable[[ClockTickEvent], None]]] = []
            due: List[Tuple[TimePoint, Callable[[ClockTickEvent], None]]] = []
            for at, fn in pending:
                (due if at <= cur else keep).append((at, fn))
            self._scheduled.extend(keep)
        # deadline order (stable), matching WallClock's heap — insertion
        # order let a later-scheduled earlier deadline run second, so
        # StepClock-driven tests could observe A/V interleavings the
        # production clock never produces
        due.sort(key=lambda e: e[0])
        # run callbacks outside the lock: callbacks commonly re-schedule
        for at, fn in due:
            fn(ClockTickEvent(at, self._asset_id, self._workspace_id))
        return cur
