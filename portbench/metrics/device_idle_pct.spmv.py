"""Share of the traced window of the spmv cells in which no operation ran
on the device, in %."""

from portbench.metrics._idle import idle_pct


def read(run):
    return idle_pct(run, "spmv")
