"""Seconds of the planner's sorts in set-up: every ``plan.sort`` span
(``_auto_plan``), from the port's own spans."""

from portbench.metrics._spans import total_s


def read(run):
    return total_s(run, "setup", "plan.sort")
