"""Median µs per call of ``spmv.x_tiles``: x checked, cast and padded to
the plan's column tiles."""

from portbench.metrics._spans import per_request_us


def read(run):
    return per_request_us(run, "spmv.x_tiles", "spmv")
