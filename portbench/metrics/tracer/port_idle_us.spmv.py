"""Device-idle µs per call of the SpMV cells during which a port span was
open (the rest of the idle time is the caller's)."""

from portbench.metrics._spans import port_idle_us


def read(run):
    return port_idle_us(run, "spmv")
