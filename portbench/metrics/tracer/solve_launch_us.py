"""Median µs per solve of ``solve.launch``: the plane and state checks,
the occupancy query, the partials' allocation and the cooperative
launch."""

from portbench.metrics._spans import per_request_us


def read(run):
    return per_request_us(run, "solve.launch", "solve")
