"""Host us a video frame in the operator stats, by the program's spans
(self time): the ``StatsReport`` timers and samples, its periodic summary
and the ``audio_stats`` stage."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    return program.per_frame(
        run, rec.self_ns("stats.timer", "stats.recompute", "stats.audio"),
        1e3)
