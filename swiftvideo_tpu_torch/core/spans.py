"""Host spans and counters recorded inside the port, for an operator who
wants to see where a station's host time goes.

The recorder is off by default, and an instrumented site then costs one
test of the module flag ``ON``: it reads no clock, allocates nothing and
takes no lock.  ``start()`` turns it on; from then on every instrumented
stage records a span and every counter site adds to its counter, until
``stop()`` turns it off and returns the ``Records``.  Nothing is written
anywhere: the records stay in memory until ``stop()``.

    from swiftvideo_tpu_torch.core import spans

    spans.start()
    for _ in range(300):
        clock.step()                      # run the station
    rec = spans.stop()
    rec.total_ns("barriers.upload")       # time inside the uploads
    rec.self_ns("bus.append")             # the buses' own time

A span holds its name, its start and end on ``time.perf_counter_ns``, its
parent (the span open on the same thread when it began; each thread keeps
its own stack, since a ``WallClock`` and a network server call in from
their own threads), its thread, and its clock step.  The step id counts
the clock steps that have ended since ``start()``: every span that begins
after one ``clock.step`` span ends, up to the end of the next, shares its
id, so the publishing of a frame's inputs, their upload and repeat, the
animation, the mixing and the emission of one step join up.  Under a
``WallClock`` a step is the run of one due callback.

The names, and what each covers:

=========================  ==============================================
``clock.step``             a ``StepClock.step`` with every callback it
                           runs; a ``WallClock``'s run of a due callback
``bus.append``             a bus's append: its lock, the granularity test
                           and the fan-out to every observer, with the
                           asset filters and the graph's ``Tx`` and
                           ``EventBox`` plumbing between stages
``stage.repeater``         a ``Repeater``'s own work, on a fresh sample
                           and on its clock tick (its re-emission is not)
``stage.picture_animator`` a ``PictureAnimator`` placing a picture
``stage.sound_animator``   a ``SoundAnimator`` placing an audio sample
``stage.src``              an ``AudioSampleRateConversion``, with
``resample.process``       its resampler's ``process`` call, with
``resample.device``        the device route's copy to the device, the
                           product's enqueue and the wait on its result
``stats.timer``            a ``StatsReport``'s start or end of a timer, or
                           its adding of a sample
``stats.recompute``        a ``StatsReport``'s periodic summary
``stats.audio``            the ``audio_stats`` stage (peak and RMS)
``barriers.upload``        one host buffer's upload to the card, with
``barriers.pin``           its copy into page-locked memory, and
``barriers.h2d``           the enqueue of its host-to-device copy
``audio_mixer.tick``       an ``AudioMixer`` tick, with
``audio_mixer.fold``       its s16 fold, and
``audio_mixer.emit``       the emission of the mixed sample downstream
``video_mixer.tick``       a ``VideoMixer`` tick, with
``video_mixer.uniforms``   its sources' uniforms and device planes,
``frame.launch``           the frame kernel's launches, and
``video_mixer.emit``       the emission of the mixed frame downstream
``wall.step``              a ``MixingWall.step``, with
``wall.audio``             its audio mix, and
``frame.cells``            the cell wrapper (``composite_cells_cuda``, or
                           ``composite_ladder_cuda`` for every rung of
                           a ladder), whose launches are
                           ``frame.launch`` spans
``motion.search``          a motion search through the compute registry
                           (``run_compute_kernel``'s motion branch: the
                           planes, the wrapper calls, the map's buffer),
                           with
``motion.launch``          each of its kernel launches (the ctypes call)
``matscale.ladder``        a rendition ladder (``scale_ladder``): a batch
                           of frames scaled to every rung, on the card
                           one ``frame.cells`` span for all of them
=========================  ==============================================

Counters: ``barriers.uploads`` and ``barriers.upload_bytes`` (the copies
to the card and their bytes), ``video_mixer.uniform_lookups`` and
``video_mixer.uniform_misses`` (the video mixer's kept uniforms, and the
lookups that had to compute them), ``frame.cell_plan_lookups`` and
``frame.cell_plan_misses`` (the cell wrapper's kept plans, one lookup a
call, a ladder's included, and the lookups that built a plan), ``frame.cell_plan_fast`` (the
lookups that the last plan answered after its short check), ``frame.cell_launches`` and
``frame.cell_row_launches`` (the cell wrapper's kernel launches, and those
that took the frame kernel's row kernel), ``motion.searches`` (the
registry's motion searches, one a ``motion.search`` span),
``wall.audio_mixes`` and ``wall.audio_kernel_mixes`` (the wall's audio
mixes, one a ``wall.audio`` span, and those that launched the wall's mix
kernel), ``resample.calls`` and ``resample.device_calls`` (the
resampler's ``process`` calls, one a ``resample.process`` span, and those
that ran the product on the device, one a ``resample.device`` span),
``resample.in_samples`` and ``resample.out_samples`` (the samples a
channel those calls took and emitted).

A site reads:

    span = spans.ON and spans.begin("stage.src")
    ...
    if span:
        spans.end(span)

A span left open by an exception is dropped when the records are taken,
and the spans it held take its parent.
"""

from __future__ import annotations

import threading
from array import array
from time import perf_counter_ns
from typing import Dict, List, Optional, Sequence, Tuple

ON = False

_lock = threading.Lock()
_local = threading.local()
_step = 0
_ids: Dict[str, int] = {}
_names: List[str] = []


class _Recording:
    """The threads that recorded between one ``start()`` and its
    ``stop()``."""

    def __init__(self):
        self.threads: List["_Thread"] = []


_recording = _Recording()


class _Thread:
    """One thread's spans, as columns, its stack of open spans and its
    counters."""

    __slots__ = ("recording", "index", "name", "start", "end", "parent",
                 "step", "stack", "counters")

    def __init__(self, recording: _Recording):
        self.recording = recording
        self.index = 0
        self.name = array("i")
        self.start = array("q")
        self.end = array("q")
        self.parent = array("q")
        self.step = array("q")
        self.stack: List[int] = []
        self.counters: Dict[str, int] = {}


def _thread() -> _Thread:
    st = getattr(_local, "st", None)
    rec = _recording
    if st is None or st.recording is not rec:
        st = _local.st = _Thread(rec)
        with _lock:
            st.index = len(rec.threads)
            rec.threads.append(st)
    return st


def _intern(name: str) -> int:
    with _lock:
        nid = _ids.get(name)
        if nid is None:
            nid = _ids[name] = len(_names)
            _names.append(name)
    return nid


def begin(name: str) -> Tuple[_Thread, int]:
    """Open a span called ``name`` on this thread; pass what it returns
    to ``end``."""
    st = _thread()
    i = len(st.start)
    stack = st.stack
    st.parent.append(stack[-1] if stack else -1)
    stack.append(i)
    nid = _ids.get(name)
    st.name.append(_intern(name) if nid is None else nid)
    st.step.append(_step)
    st.end.append(0)
    st.start.append(perf_counter_ns())
    return st, i


def end(span: Tuple[_Thread, int]) -> None:
    """Close a span ``begin`` opened (and any it still held open)."""
    t = perf_counter_ns()
    st, i = span
    st.end[i] = t
    stack = st.stack
    if stack and stack[-1] == i:
        stack.pop()
    elif i in stack:
        del stack[stack.index(i):]


def end_step(span: Tuple[_Thread, int]) -> None:
    """Close a clock step's span: the spans that begin after it take the
    next step id."""
    global _step
    end(span)
    with _lock:
        _step += 1


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    c = _thread().counters
    c[name] = c.get(name, 0) + n


def start() -> None:
    """Turn the recorder on, with no records and the step id at 0 (a
    recording already running is dropped)."""
    global ON, _recording, _step
    with _lock:
        _recording = _Recording()
        _step = 0
        ON = True


def stop() -> "Records":
    """Turn the recorder off and return what it recorded since
    ``start()`` (nothing, if it was off)."""
    global ON, _recording
    with _lock:
        rec, _recording = _recording, _Recording()
        threads = list(rec.threads) if ON else []
        ON = False
        names = list(_names)
    return Records.collect(threads, names)


class Records:
    """The spans and counters of one recording.  Span ``k`` is
    ``names[name[k]]``, from ``start[k]`` to ``end[k]`` (perf_counter_ns),
    inside span ``parent[k]`` (-1: none), in clock step ``step[k]``, on
    thread ``thread[k]`` (the threads numbered in the order they first
    recorded); the spans of a thread lie in the order they began.
    ``counters`` holds each counter's total."""

    def __init__(self, names: Sequence[str], name, start, end, parent,
                 step, thread, counters: Dict[str, int]):
        self.names = list(names)
        self.name, self.start, self.end = name, start, end
        self.parent, self.step, self.thread = parent, step, thread
        self.counters = counters

    @classmethod
    def collect(cls, threads: Sequence[_Thread],
                names: Sequence[str]) -> "Records":
        import numpy as np
        cols: List[list] = [[] for _ in range(6)]
        counters: Dict[str, int] = {}
        base = 0
        for st in threads:
            for k, v in st.counters.items():
                counters[k] = counters.get(k, 0) + v
            n = min(len(st.start), len(st.end), len(st.parent),
                    len(st.name), len(st.step))
            if not n:
                continue
            name = np.frombuffer(st.name, np.int32)[:n].copy()
            start = np.frombuffer(st.start, np.int64)[:n].copy()
            end = np.frombuffer(st.end, np.int64)[:n].copy()
            parent = np.frombuffer(st.parent, np.int64)[:n].copy()
            step = np.frombuffer(st.step, np.int64)[:n].copy()
            done = end > 0
            # a span left open hands its spans to its own parent
            while True:
                up = parent >= 0
                lost = np.zeros(n, bool)
                lost[up] = ~done[parent[up]]
                if not lost.any():
                    break
                parent[lost] = parent[parent[lost]]
            index = np.cumsum(done) - 1 + base
            parent = np.where(parent >= 0, index[np.maximum(parent, 0)], -1)
            for col, v in zip(cols, (name, start, end, parent, step,
                                     np.full(n, st.index, np.int64))):
                col.append(v[done])
            base += int(done.sum())
        empty = (np.int32,) + (np.int64,) * 5
        arrays = [np.concatenate(c) if c else np.zeros(0, t)
                  for c, t in zip(cols, empty)]
        return cls(names, *arrays, counters)

    def __len__(self) -> int:
        return len(self.start)

    def _rows(self, names: Sequence[str]):
        import numpy as np
        ids = [i for i, n in enumerate(self.names) if n in names]
        return np.flatnonzero(np.isin(self.name, ids))

    def _under(self, rows, name: str):
        """Of ``rows``, which have an ancestor called ``name``."""
        import numpy as np
        found = np.zeros(len(rows), bool)
        if name not in self.names:
            return found
        nid = self.names.index(name)
        up = self.parent[rows]
        while True:
            live = up >= 0
            if not live.any():
                return found
            found[live] |= self.name[up[live]] == nid
            up[live] = self.parent[up[live]]

    def count(self, name: str) -> int:
        """The spans called ``name``."""
        return len(self._rows((name,)))

    def total_ns(self, name: str, inside: Optional[str] = None) -> int:
        """Nanoseconds inside spans called ``name`` (one nested in another
        of its name counted once), only those inside a span called
        ``inside`` where it is given."""
        rows = self._rows((name,))
        rows = rows[~self._under(rows, name)]
        if inside is not None:
            rows = rows[self._under(rows, inside)]
        return int((self.end[rows] - self.start[rows]).sum())

    def self_ns(self, *names: str) -> int:
        """Nanoseconds inside spans called any of ``names``, less what
        their child spans cover."""
        import numpy as np
        rows = self._rows(names)
        if not len(rows):
            return 0
        dur = self.end - self.start
        kids = np.flatnonzero(np.isin(self.parent, rows))
        return int(dur[rows].sum() - dur[kids].sum())

    def window(self, lo: int, hi: int) -> "Records":
        """The spans that lie wholly between ``lo`` and ``hi`` ns (their
        parents outside it become -1); the counters are the recording's."""
        import numpy as np
        keep = (self.start >= lo) & (self.end <= hi)
        index = np.cumsum(keep) - 1
        parent = self.parent[keep]
        inside = parent >= 0
        inside[inside] = keep[parent[inside]]
        parent = np.where(inside, index[np.maximum(parent, 0)], -1)
        return Records(self.names, self.name[keep], self.start[keep],
                       self.end[keep], parent, self.step[keep],
                       self.thread[keep], dict(self.counters))

    def timeline(self) -> List[Tuple[int, int, str]]:
        """(start ns, end ns, name) of every span."""
        names = self.names
        return [(a, b, names[k]) for a, b, k in
                zip(self.start.tolist(), self.end.tolist(),
                    self.name.tolist())]
