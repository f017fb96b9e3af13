"""Host-clock spans recorded from the benchmark's own files, and the
reduction of a device trace.

``Spans.wrap`` replaces a function or method of the program by a wrapper
that adds the call's host time to its label, in place, for the life of
the process: the program's files are not edited.  The traced run installs
the spans its per-layer metrics name before the cell builds the program,
so methods bound later (clock callbacks) are the wrapped ones.  Each call
also appends (start ns, end ns, label) to a timeline, so the device's idle
gaps can be labelled by what the host was doing.
"""

from __future__ import annotations

import functools
import importlib
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


class Spans:
    def __init__(self):
        self.total_ns: Dict[str, int] = defaultdict(int)
        self.count: Dict[str, int] = defaultdict(int)
        self.timeline: List[Tuple[int, int, str]] = []
        self.on = False
        self._wrapped = set()

    def add(self, label: str, t0: int, t1: int) -> None:
        if self.on:
            self.total_ns[label] += t1 - t0
            self.count[label] += 1
            self.timeline.append((t0, t1, label))

    def wrap(self, label: str, module: str, path: str) -> None:
        """Time every call of ``module``'s ``path`` (a function or a
        ``Class.method``) under ``label``."""
        if label in self._wrapped:
            return
        owner = importlib.import_module(module)
        *outer, name = path.split(".")
        for part in outer:
            owner = getattr(owner, part)
        fn = getattr(owner, name)
        clock, add = time.perf_counter_ns, self.add

        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = clock()
            try:
                return fn(*args, **kwargs)
            finally:
                add(label, t0, clock())

        setattr(owner, name, timed)
        self._wrapped.add(label)

    def seconds(self, label: str) -> float:
        return self.total_ns.get(label, 0) / 1e9

    def calls(self, label: str) -> int:
        return self.count.get(label, 0)


def union_s(intervals: Sequence[Tuple[int, int]]) -> float:
    """Seconds covered by the union of (start ns, end ns) intervals."""
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e9


def gaps(intervals: Sequence[Tuple[int, int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The (start ns, end ns) stretches of [lo, hi] that no interval
    covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


def labels_at(timeline: Sequence[Tuple[int, int, str]],
              times: Sequence[int]) -> List[str]:
    """For each of ``times`` (ascending), the innermost host span covering
    it, or "harness" outside every span.  Spans of one thread nest, so the
    covering spans form a stack ordered by start."""
    spans = sorted(timeline, key=lambda s: (s[0], -s[1]))
    out, stack, k = [], [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "harness")
    return out
