"""Seconds of the planes' upload in set-up: every ``plan.upload`` span
(``SellSpMV.__init__``: the plan's check, the host planes and their copy
to the device)."""

from portbench.metrics._spans import total_s


def read(run):
    return total_s(run, "setup", "plan.upload")
