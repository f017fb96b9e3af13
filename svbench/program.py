"""The program's own spans and counters, for the per-layer metrics that
read them in a traced run.

The program records spans inside its stages while its recorder
(``swiftvideo_tpu_torch.core.spans``) is on, and counts a few events; it
is off unless something starts it.  A traced run's set-up goes through
each per-layer reader's ``SPANS`` to wrap the functions it names; a reader
of the program's records sets ``SPANS = program.ARM``, which names none and
starts the program's recorder instead, before the cell builds the program.
An untraced run never goes through ``SPANS``, so there the recorder stays
off and the program runs as it does in production.

The first reader to read (``records``) stops the recorder, keeps the
spans that lie inside the measured window (the stretch the harness's own
spans cover: every tick's spans are recorded only in the window) as
``run.program``, and adds those inside the device trace's window to the
host timeline the trace's idle gaps are labelled from, so that a gap takes
the name of the innermost program span it fell in.  The counters cover the
whole recording: the window, the warm-up and the last of the set-up.

A program without the recorder (an older commit) gives ``None``, and its
readers report nothing.
"""

from __future__ import annotations


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from swiftvideo_tpu_torch.core import spans
    except ImportError:
        return None
    return spans


class _Arm:
    """Iterated by a traced run's set-up as a reader's ``SPANS``: wraps
    nothing, and starts the program's recorder if it is off."""

    def __iter__(self):
        spans = recorder()
        if spans is not None and not spans.ON:
            spans.start()
        return iter(())


ARM = _Arm()


def records(run):
    """The program's records of ``run``'s window (``spans.Records``), or
    None where the program recorded nothing."""
    if not hasattr(run, "program"):
        run.program = _take(run)
    return run.program


def _take(run):
    spans = recorder()
    if spans is None or not spans.ON:
        return None
    rec = spans.stop()
    timeline = run.spans.timeline
    if not len(rec) or not timeline:
        return None
    lo = min(a for a, _b, _n in timeline)
    hi = max(b for _a, b, _n in timeline)
    rec = rec.window(lo, hi)
    if not len(rec):
        return None
    trace = run.device_trace
    if trace is not None:
        a, b = (t - trace.host_offset_ns for t in trace.window_ns)
        timeline.extend(rec.window(a, b).timeline())
    return rec


def per_frame(run, ns: int, unit: float):
    """``ns`` a completed frame in ``unit`` ns (1e6: ms, 1e3: us), or None
    where nothing was recorded or completed."""
    if not ns or not run.frames:
        return None
    return ns / unit / run.frames
