"""The share of the cell wrapper's plan lookups that the last plan answered
after its short check (the program's counters ``frame.cell_plan_fast`` over
``frame.cell_plan_lookups``); a ladder whose rungs take turns misses it.
Nothing to read in a program without the ladder's span, which came with
the counter (an older program counts no fast lookup at all)."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None or not rec.count("matscale.ladder"):
        return None
    lookups = rec.counters.get("frame.cell_plan_lookups", 0)
    if not lookups:
        return None
    return rec.counters.get("frame.cell_plan_fast", 0) / lookups * 100
