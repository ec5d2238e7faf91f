"""Median µs per call of the call's ``spmv.launch`` spans, summed: the
wrapper's plane checks, y's allocation and the kernel's launch."""

from portbench.metrics._spans import per_request_us


def read(run):
    return per_request_us(run, "spmv.launch", "spmv")
