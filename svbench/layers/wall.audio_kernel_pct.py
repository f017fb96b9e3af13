"""The share of the wall's audio mixes that launched the wall's mix kernel
(the program's counters ``wall.audio_kernel_mixes`` over
``wall.audio_mixes``); nothing to read where the program counts no mix,
or in a run with no device trace (a CPU run, where no mix can launch a
kernel)."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    mixes = rec.counters.get("wall.audio_mixes", 0) if rec else 0
    if not mixes or run.device_trace is None:
        return None
    return rec.counters.get("wall.audio_kernel_mixes", 0) / mixes * 100
