"""Median host microseconds of one ``SellSpMV.__call__`` (the benchmark's
span around the call, before any synchronise): checks, x padding, the y
allocation and the launch."""

import statistics


def read(run):
    if run.kind != "spmv" or not run.call_host_s:
        return None
    return statistics.median(run.call_host_s) * 1e6
