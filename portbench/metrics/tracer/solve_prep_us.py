"""Median µs per solve of ``solve.prep``: b padded to the state and the
state vectors allocated."""

from portbench.metrics._spans import per_request_us


def read(run):
    return per_request_us(run, "solve.prep", "solve")
