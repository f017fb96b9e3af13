"""Host us a frame in the resampler less its device route (the program's
``resample.process`` spans less the ``resample.device`` spans inside
them): the FIFO's concatenation, the cycle count, the window's host copy
and the trim."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None or not rec.count("resample.process"):
        return None
    return program.per_frame(
        run, rec.total_ns("resample.process")
        - rec.total_ns("resample.device", inside="resample.process"), 1e3)
