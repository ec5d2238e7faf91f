"""Readings of the port's own spans (``smvp_toolkit_tpu_torch.utils.tracing``)
as a traced run drains them: ``run.program_setup`` after set-up and
``run.program_window`` after the window, each ``{"spans": [...],
"counters": {...}}``. A run without them (the tracer off, or a port that
has none) reads None."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional


def spans_of(run, phase: str) -> Optional[list]:
    """The spans drained after ``phase`` (``setup`` or ``window``)."""
    got = getattr(run, f"program_{phase}", None)
    return None if got is None else got["spans"]


def total_s(run, phase: str, name: str) -> Optional[float]:
    """Seconds of every span ``name`` of ``phase``, or None where there is
    none."""
    d = [s.end_ns - s.start_ns for s in spans_of(run, phase) or ()
         if s.name == name]
    return sum(d) / 1e9 if d else None


def per_request_us(run, name: str, kind: Optional[str] = None
                   ) -> Optional[float]:
    """Median over the window's requests of the µs of the request's spans
    ``name``, summed; None where there is none, or where ``kind`` is not
    the run's."""
    if kind is not None and run.kind != kind:
        return None
    per: Dict[int, int] = {}
    for s in spans_of(run, "window") or ():
        if s.name == name:
            per[s.request] = per.get(s.request, 0) + s.end_ns - s.start_ns
    return statistics.median(per.values()) / 1e3 if per else None


def union(intervals) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def port_idle_us(run, kind: str) -> Optional[float]:
    """Device-idle µs per request during which a port span was open: the
    idle intervals of the traced window (``devtrace.Summary.gaps``)
    against the union of the window's spans, on the profiler's clock."""
    tr, spans = run.device_trace, spans_of(run, "window")
    if run.kind != kind or tr is None or not tr.device or not spans \
            or not run.requests:
        return None
    port = union((s.start_ns / 1e3, s.end_ns / 1e3) for s in spans)
    covered, i = 0.0, 0
    for a, b in sorted(tr.gaps()):
        while i < len(port) and port[i][1] <= a:
            i += 1
        j = i
        while j < len(port) and port[j][0] < b:
            covered += min(b, port[j][1]) - max(a, port[j][0])
            j += 1
    return covered / run.requests
