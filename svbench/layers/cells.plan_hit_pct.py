"""The share of the cell wrapper's plan lookups that found a kept plan
(the program's counters ``frame.cell_plan_lookups`` less
``frame.cell_plan_misses``, over the lookups); nothing to read where the
program counts no lookup."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    lookups = rec.counters.get("frame.cell_plan_lookups", 0) if rec else 0
    if not lookups:
        return None
    return (lookups - rec.counters.get("frame.cell_plan_misses", 0)) \
        / lookups * 100
