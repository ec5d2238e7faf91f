"""Seconds of the IC(0) factorization's passes in set-up: every
``factor.ic0.pass`` span (one per shift the ladder tries)."""

from portbench.metrics._spans import total_s


def read(run):
    return total_s(run, "setup", "factor.ic0.pass")
