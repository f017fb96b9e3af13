"""Repeater: re-emit the last sample when upstream is silent.

Reference semantics: SwiftVideo's ``Sources/SwiftVideo/repeater.swift`` —
used to hold video frames for mixing (composer.swift:211).  Each received
sample resets the timer; when a clock tick fires and no fresh sample
arrived within the interval, the held sample is re-emitted and the timer
re-arms.

One armed timer per repeater: digest only arms when no tick is
outstanding, and a non-due tick re-arms itself at the earliest possible
due time.  (Arming per received sample would flood the clock queue at the
input frame rate — ~interval/frame_duration concurrent heap entries per
repeater, scaling with source count in a composer wall.)
"""

from __future__ import annotations

import threading
from ..core import AsyncTx, Clock, EventBox, TimePoint, rescale


class Repeater(AsyncTx):
    def __init__(self, clock: Clock, interval: TimePoint):
        super().__init__()
        self._clock = clock
        self._interval = rescale(interval, clock.current().scale)
        self._last_emit = clock.current()
        self._sample = None
        self._armed = False
        self._lock = threading.RLock()

        def digest(sample) -> EventBox:
            now = self._clock.current()
            with self._lock:
                self._sample = sample
                self._last_emit = now
                arm = not self._armed
                self._armed = True
            if arm:
                self._run()
            return EventBox.just(sample)

        self.set(digest)

    def _run(self) -> None:
        now = self._clock.current()
        self._clock.schedule(now + self._interval, self._tick)

    def _tick(self, evt) -> None:
        with self._lock:
            sample = self._sample
            if sample is None:        # dormant (gone downstream)
                self._armed = False
                return
            next_due = self._last_emit + self._interval
            due = next_due <= evt.time()
            if due:
                self._last_emit = evt.time()
        if due:
            result = self.emit(sample)
            if result.is_gone():
                # downstream chain dropped (repeater.swift holds self
                # weakly and dies with the chain): go dormant instead of
                # re-arming forever — the clock.schedule closure would
                # otherwise keep this object and one callback per
                # interval alive for the life of the session
                with self._lock:
                    self._sample = None
                    self._armed = False
                return
            self._run()
        else:
            # a fresh sample moved the deadline: re-arm at the earliest
            # possible due time (keeps the single-timer invariant without
            # changing emission cadence)
            self._clock.schedule(next_due, self._tick)
