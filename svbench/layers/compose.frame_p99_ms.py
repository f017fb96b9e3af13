"""The 99th percentile of the live station's frame latency, in ms, in a
traced run: from the start of handing a frame's inputs to the program to
the host seeing the mixed frame complete on the card, over every frame
completed in the window.  The end-to-end ``frame_p99_ms`` reads the same
statistic; in the live cells it swings too far between processes on a
shared host to hold a bound, so there it is read here, with no bound."""

import numpy as np


def read(run):
    if not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies) * 1e3, 99))
