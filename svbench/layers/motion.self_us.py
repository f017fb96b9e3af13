"""Host us a motion search in the registry's motion branch less its kernel
launches (the program's ``motion.search`` less the ``motion.launch`` spans
inside it): the plane lookup, the device check, the wrappers' checks and
allocations, the map's buffer; over the program's ``motion.searches``."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    searches = rec.counters.get("motion.searches", 0) if rec else 0
    if not searches:
        return None
    own = rec.total_ns("motion.search") \
        - rec.total_ns("motion.launch", inside="motion.search")
    return own / 1e3 / searches
