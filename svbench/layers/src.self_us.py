"""Host us a frame in the SRC stage less its resampler (the program's
``stage.src`` spans less the ``resample.process`` spans inside them): the
stage's format conversions (f32p in, s16i out), its pts bookkeeping and
the sample it builds.  Nothing to read in a program without the
resampler's span."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None or not rec.count("resample.process"):
        return None
    return program.per_frame(
        run, rec.total_ns("stage.src")
        - rec.total_ns("resample.process", inside="stage.src"), 1e3)
