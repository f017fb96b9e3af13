"""Host us a motion search in its kernel launches (the program's
``motion.launch`` spans inside ``motion.search``: the ctypes calls that
enqueue them), over the program's ``motion.searches``; nothing to read
where no search launched a kernel."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    searches = rec.counters.get("motion.searches", 0) if rec else 0
    launch = rec.total_ns("motion.launch", inside="motion.search") \
        if searches else 0
    if not launch:
        return None
    return launch / 1e3 / searches
