"""The 95th percentile of all the window's solve latencies (each from
the call to the synchronise that makes x ready), in ms; numpy's linear
interpolation between order statistics."""

import numpy as np


def read(run):
    if run.kind != "solve" or not run.latency_s:
        return None
    return float(np.percentile(np.asarray(run.latency_s), 95.0)) * 1e3
