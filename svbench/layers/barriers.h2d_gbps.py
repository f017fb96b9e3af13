"""GB/s of the uploads' host-to-device copies on the card: the bytes a
copy (the program's counters ``barriers.upload_bytes`` over
``barriers.uploads``) over the device seconds a host-to-device copy the
trace recorded."""

from svbench import program

SPANS = program.ARM
KERNEL = "Memcpy HtoD"


def read(run):
    rec, trace = program.records(run), run.device_trace
    if rec is None or trace is None:
        return None
    copies = rec.counters.get("barriers.uploads", 0)
    recorded, seconds = trace.kernel(KERNEL)
    if not copies or not recorded or seconds <= 0:
        return None
    return rec.counters["barriers.upload_bytes"] / copies \
        / (seconds / recorded) / 1e9
