"""Host us a tick in ``matscale.scale_ladder`` less the cell wrapper inside
it (the program's ``matscale.ladder`` less its ``frame.cells`` spans): the
ladder's own loop over the rungs and the batch scale's checks and views;
nothing to read in a program without the ladder's span."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    us = program.per_frame(
        run, rec.total_ns("matscale.ladder")
        - rec.total_ns("frame.cells", inside="matscale.ladder"), 1e3)
    return us and us * run.config["channels"]
