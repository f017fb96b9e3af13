"""The frame kernel's share of its byte bound on the ladder's tick: the
bound (``bounds/ladder.py``: every channel's 32-byte sectors that hold a
tap of any rung, read once, and each rung written once) over the kernel's
device time a tick.  Device time a launch comes from the launches the
trace recorded (the tile and the row kernel both); launches a tick from
the program's counter over the window."""

from svbench.bounds import ladder, peaks

KERNEL = "frame_composite_kernel"


def read(run):
    t = run.device_trace
    if t is None or not run.frames:
        return None
    recorded, seconds = t.kernel(KERNEL)
    launches = run.counters.get("launches", 0)
    if not recorded or not launches or seconds <= 0:
        return None
    ticks = run.frames / run.config["channels"]
    per_tick = seconds / recorded * launches / ticks
    return ladder.bytes_per_tick(run.config) / peaks.HBM_BPS / per_tick * 100
