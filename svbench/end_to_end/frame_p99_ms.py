"""The 99th percentile of every completed frame's latency, in ms: from the
start of handing the frame's inputs to the program to the host seeing the
output complete on the card."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 99))
