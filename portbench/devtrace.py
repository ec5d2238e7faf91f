"""Reading a ``torch.profiler`` trace of the measured window.

The profiler runs around the window alone (CUDA activity only on a card,
so that recording host operations does not slow the host's work per
call). The device operations (kernels, copies, fills) and the host's
CUDA runtime calls come from its raw results. The window starts at the
first device operation and lasts the window's seconds on the host clock;
busy time is the union of the device operations, and each idle gap is
named by the innermost host event (a runtime call, where the trace has
one) running at its middle.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Sequence, Tuple

TOP = 10
NAME_CHARS = 160

Event = Tuple[str, float, float]  # name, start µs, end µs


def _raw_events(prof):
    """(device, host) event lists from a finished profiler."""
    from torch.autograd import DeviceType

    device: List[Event] = []
    host: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        ev = (e.name(), start, start + e.duration_ns() / 1e3)
        (device if e.device_type() == DeviceType.CUDA else host).append(ev)
    return device, host


def _union(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Summary:
    """The device's work inside the window of one traced run."""

    def __init__(self, device: Sequence[Event], host: Sequence[Event],
                 window_s: float):
        self.start = min((e[1] for e in device), default=0.0)
        self.end = self.start + window_s * 1e6
        self.device = [(n, max(a, self.start), min(b, self.end))
                       for n, a, b in device if b > self.start and a < self.end]
        self.host = list(host)
        self.busy = _union((a, b) for _, a, b in self.device)
        self.window_s = window_s
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6

    def kernel_stats(self, parts: Sequence[str]) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds one
        of ``parts`` as a whole word."""
        if not parts:
            return 0, 0.0
        pat = re.compile(r"\b(" + "|".join(map(re.escape, parts)) + r")\b")
        hits = [b - a for n, a, b in self.device if pat.search(n)]
        return len(hits), sum(hits) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the window, longest first."""
        edges = [self.start] + [x for iv in self.busy for x in iv] + [self.end]
        out = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
               if edges[i + 1] > edges[i]]
        return sorted(out, key=lambda g: g[0] - g[1])

    def host_at(self, t: float) -> str:
        """The innermost host event running at time ``t``."""
        best: Optional[Event] = None
        for e in self.host:
            if e[1] <= t <= e[2] and (best is None
                                      or e[2] - e[1] < best[2] - best[1]):
                best = e
        return best[0] if best else "host code, no CUDA call"

    def breakdown(self) -> dict:
        by_name: dict = {}
        for n, a, b in self.device:
            key = n[:NAME_CHARS]
            by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = [[self.host_at((a + b) / 2)[:NAME_CHARS], (b - a) / 1e6]
                for a, b in self.gaps()[:TOP]]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": gaps}


def summarize(prof, window_s: float) -> Summary:
    """The trace of a window of ``window_s`` seconds on the host clock."""
    return Summary(*_raw_events(prof), window_s)
