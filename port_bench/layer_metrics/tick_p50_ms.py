"""The median latency of the same ticks as tick_p95_ms (the measured window
of the traced run)."""

import numpy as np


def read(r):
    return float(np.percentile(r.window["latencies_ms"], 50))
