"""The share of the resampler's calls that ran the product on the device
(the program's counters ``resample.device_calls`` over
``resample.calls``); nothing in a program without them."""

from svbench import program

SPANS = program.ARM


def read(run):
    rec = program.records(run)
    if rec is None:
        return None
    calls = rec.counters.get("resample.calls", 0)
    if not calls:
        return None
    return rec.counters.get("resample.device_calls", 0) / calls * 100
