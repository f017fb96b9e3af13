"""The resampler's device product's share of its bound: the bound of a
call (``bounds/resample.py``: each new input sample read once and each
output written once as float32, or 2 K operations an output at the
float32 peak), for the average device call of the recording (the program's
counters), times the ``resample.device`` spans that lie inside the device
trace's window, over the device time of the kernels the trace recorded
(copies left out; the cell launches no kernel but the product's)."""

from svbench import program
from svbench.bounds import resample

SPANS = program.ARM


def read(run):
    t = run.device_trace
    rec = program.records(run)
    if t is None or rec is None:
        return None
    calls = rec.counters.get("resample.device_calls", 0)
    a, b = (w - t.host_offset_ns for w in t.window_ns)
    traced = rec.window(a, b).count("resample.device")
    seconds = sum(e - s for n, s, e in t.events
                  if not n.startswith(("Memcpy", "Memset"))) / 1e9
    if not calls or not traced or seconds <= 0:
        return None
    bound = resample.seconds_per_call(
        run.config["channels"], rec.counters["resample.in_samples"] / calls,
        rec.counters["resample.out_samples"] / calls,
        run.config["taps_per_phase"])
    return bound * traced / seconds * 100
