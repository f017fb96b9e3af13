"""Host ms a video frame in the uploads' copies into page-locked memory
(the program's ``barriers.pin`` spans); nothing to read where no buffer
went to the card."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    return program.per_frame(run, rec.total_ns("barriers.pin"), 1e6)
