"""The frame kernel's cell launches' share of their byte bound on the
wall tick: the bound (``bounds/cell_kernel.py``: the 32-byte sectors that
hold a tap, the canvas, the audio) over the launches' device time a tick.
Device time a launch comes from the launches the trace recorded; launches
a tick from the program's counter over the window."""

from svbench.bounds import cell_kernel, peaks

KERNEL = "frame_composite_kernel"


def read(run):
    t = run.device_trace
    if t is None or not run.frames:
        return None
    recorded, seconds = t.kernel(KERNEL)
    launches = run.counters.get("launches", 0)
    if not recorded or not launches:
        return None
    per_tick = seconds / recorded * launches / run.frames
    return cell_kernel.bytes_per_tick(run.config) / peaks.HBM_BPS \
        / per_tick * 100
