"""The share of its bound that ``motion_refine_kernel`` (the two-stage
search's refine stage) reaches: the bound (``bounds/motion.py``, from the
cell's shapes) over the kernel's device time a search.  Device time a
launch comes from the launches the trace recorded; launches a search from
the cell's launch counter (``Cell.counters``) over the window."""

from svbench.bounds import motion

KERNEL = "motion_refine_kernel"
COUNTER = "refine_launches"


def read(run):
    t = run.device_trace
    if t is None or not run.frames:
        return None
    recorded, seconds = t.kernel(KERNEL)
    launches = run.counters.get(COUNTER, 0)
    if not recorded or not launches or seconds <= 0:
        return None
    per_search = seconds / recorded * launches / run.frames
    return motion.refine_bound_s(run.config) / per_search * 100
