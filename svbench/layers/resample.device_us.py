"""Host us a frame in the resampler's device route (the program's
``resample.device`` spans): the window's copy to the card from pageable
memory, the product's enqueue and the wait on its result's copy back."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    return program.per_frame(run, rec.total_ns("resample.device"), 1e3)
