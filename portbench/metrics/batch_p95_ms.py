"""The 95th percentile of every batch's latency in the window, from the
client handing over its inputs to its outputs on the host (host clock;
numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    if ctx['kind'] != 'infer':
        return None
    return float(np.percentile(ctx['latencies_s'], 95)) * 1e3
