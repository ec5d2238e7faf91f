"""Seconds of the autotuner in set-up: every ``plan.tune`` span (the
pricing of the candidate chunks and the cut of the pick)."""

from portbench.metrics._spans import total_s


def read(run):
    return total_s(run, "setup", "plan.tune")
