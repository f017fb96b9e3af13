"""Host us a tick in the cell wrapper's kernel launches (the program's
``frame.launch`` spans inside ``frame.cells``: the ctypes calls that
enqueue them)."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    return program.per_frame(
        run, rec.total_ns("frame.launch", inside="frame.cells"), 1e3)
