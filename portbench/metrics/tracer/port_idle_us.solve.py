"""Device-idle µs per solve of the solve cells during which a port span
was open (the rest of the idle time is the caller's)."""

from portbench.metrics._spans import port_idle_us


def read(run):
    return port_idle_us(run, "solve")
