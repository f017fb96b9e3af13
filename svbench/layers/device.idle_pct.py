"""The share of the traced window in which no device activity ran."""


def read(run):
    t = run.device_trace
    if t is None or t.window_s() <= 0:
        return None
    return (1.0 - t.busy_s() / t.window_s()) * 100
