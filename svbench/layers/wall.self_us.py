"""Host us a tick in ``MixingWall.step`` less the cell wrapper inside it
(the program's ``wall.step`` less ``frame.cells``): the step's checks,
its audio mix and the output's assembly."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    return program.per_frame(
        run, rec.total_ns("wall.step")
        - rec.total_ns("frame.cells", inside="wall.step"), 1e3)
