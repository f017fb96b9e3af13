"""The share of the ladder's kernel launches that took the frame kernel's
row kernel (the program's counters ``frame.cell_row_launches`` over
``frame.cell_launches``; every cell launch of the cell is a rung's);
nothing to read where the program counts no cell launch, or in a run with
no device trace (a CPU run, where no launch is made)."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    made = rec.counters.get("frame.cell_launches", 0) if rec else 0
    if not made or run.device_trace is None:
        return None
    return rec.counters.get("frame.cell_row_launches", 0) / made * 100
