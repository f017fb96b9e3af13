"""Host us a tick in the ladder's kernel launches (the program's
``frame.launch`` spans inside ``matscale.ladder``: the ctypes calls that
enqueue them, one a rung)."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    us = program.per_frame(
        run, rec.total_ns("frame.launch", inside="matscale.ladder"), 1e3)
    return us and us * run.config["channels"]
