"""The frame kernel's share of its byte bound on the live stack: the
bound (``bounds/frame_kernel.py``, from the cell's shapes) over the
kernel's device time a frame.  Device time a launch comes from the
launches the trace recorded; launches a frame from the program's counter
over the window."""

from svbench.bounds import frame_kernel, peaks

KERNEL = "frame_composite_kernel"


def read(run):
    t = run.device_trace
    if t is None or not run.frames:
        return None
    recorded, seconds = t.kernel(KERNEL)
    launches = run.counters.get("launches", 0)
    if not recorded or not launches:
        return None
    per_frame = seconds / recorded * launches / run.frames
    return frame_kernel.bytes_per_frame(run.config) / peaks.HBM_BPS \
        / per_frame * 100
