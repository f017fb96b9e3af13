"""Host us a tick in the cell wrapper less its kernel launches (the
program's ``frame.cells`` less the ``frame.launch`` spans inside it): the
checks, the launch table's lookup and the parameter words; nothing to
read where the wrapper launched no kernel."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    launch = rec.total_ns("frame.launch", inside="frame.cells")
    return program.per_frame(run, launch and rec.total_ns("frame.cells")
                             - launch, 1e3)
