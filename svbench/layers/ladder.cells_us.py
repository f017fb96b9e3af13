"""Host us a tick in the cell wrapper less its kernel launches (the
program's ``frame.cells`` spans, one a rung, less the ``frame.launch``
spans inside them): the kept plan's lookup, the canvas's allocations and
the parameter words.  Every cell-wrapper call of the cell is a rung's."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    us = program.per_frame(
        run, rec.total_ns("frame.cells")
        - rec.total_ns("frame.launch", inside="frame.cells"), 1e3)
    return us and us * run.config["channels"]
