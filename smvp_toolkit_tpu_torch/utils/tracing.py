"""Spans and counters inside the port, on the profiler's clock.

The tracer is off by default. While it is off, ``span(name, attrs)``
returns one shared no-op context manager (``NO_SPAN``) and ``count``
returns at once: one module-level check, no allocation, no clock read
(callers pass attributes as a dict built once, or only while
``enabled()``). ``enable()`` turns it on; ``disable()`` turns it off and
keeps what it recorded for ``drain``.

When on, a span records its name, its start and end, its attributes and
its thread, and nothing else: two clock reads and one append. ``drain()``
returns the spans closed and the counters moved since the last drain, and
clears them; it gives each span its id, the id of its parent (the
innermost span of the same thread that holds it, 0 for a top-level one)
and a request id, that of the top-level span every span under it shares.
Spans on one thread nest, so their times alone say which holds which;
drain outside any open span (a span still open is not recorded yet, and
its closed children come out as top-level ones). Spans stay in memory, at
most ``CAPACITY`` of them between two drains; the counter
``tracing.dropped`` counts those that did not fit.

The clock: a span is stamped with ``time.perf_counter_ns()`` and shifted by
one ``time.time_ns() - time.perf_counter_ns()`` offset taken at
``enable()``. Its ``start_ns`` and ``end_ns`` are so nanoseconds of the
Unix clock, on which ``torch.profiler`` (kineto) stamps its host events
and maps the device's: a span lies over a profiler trace as recorded.

Counters: the kernel wrappers' ``.launches`` stay the one launch count
(``kernel_wrappers``); ``counters()`` reads them beside the tracer's own:
``plan.slots`` and ``plan.live_slots`` (a plan's sublanes · 128 and its
nonzeros, at upload), ``build.compiles`` and ``tracing.dropped``.

Where the port records what (PERF.md §3 keeps the table with the metric
each one serves):

* planner: ``plan`` (``SellSpMV.from_coo``), ``plan.to_host``,
  ``plan.sort`` (``_auto_plan``), ``plan.tune`` (``autotune.pick_plan``),
  ``plan.upload`` (``SellSpMV.__init__``);
* factorization: ``encode.csr``, ``factor.ic0``, ``factor.ic0.pass``,
  ``factor.ic0.upload``, ``factor.planes`` (the fused IC(0) planes);
* operator: ``spmv.call``, ``spmv.x_tiles``, ``spmv.launch``;
* solvers: ``solve.call`` (attribute ``solver``), ``solve.prep``,
  ``solve.launch``;
* builds: ``build`` (attribute ``names``), only when a source compiles.
"""

from __future__ import annotations

import threading
import time
from threading import get_ident
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

__all__ = [
    "CAPACITY",
    "NO_SPAN",
    "Span",
    "Tracer",
    "chrome_events",
    "count",
    "counters",
    "disable",
    "drain",
    "enable",
    "enabled",
    "kernel_wrappers",
    "kernel_counts",
    "self_times",
    "span",
]

CAPACITY = 1 << 20


class Span(NamedTuple):
    """One closed span; times in ns of the Unix clock."""

    id: int
    parent: int  # 0: a top-level span
    request: int
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


class _NoSpan:
    """The span handed out while the tracer is off: it does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


def kernel_wrappers() -> Dict[str, Callable]:
    """Every kernel's wrapper by kernel name; each counts its launches in
    ``.launches``."""
    from smvp_toolkit_tpu_torch.ops import spmv_sell as S
    from smvp_toolkit_tpu_torch.ops.csr_merge import CSR_KERNELS
    from smvp_toolkit_tpu_torch.ops.pcg_fused import SOLVER_KERNELS
    from smvp_toolkit_tpu_torch.ops.spmv_df64 import DF64_KERNELS

    return {**{S.KERNEL_NAMES[(route, bench)]: S._ROUTE_FNS[route][bench]
               for route in S.ROUTES for bench in (False, True)},
            **S.MAT_KERNELS, **SOLVER_KERNELS, **S.PACKED_KERNELS,
            **DF64_KERNELS, **S.SWITCH_KERNELS, **CSR_KERNELS}


def kernel_counts() -> Dict[str, int]:
    """Each kernel's launches so far, by kernel name."""
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


_now = time.perf_counter_ns


class _Open:
    """A span being recorded."""

    __slots__ = ("tracer", "name", "attrs", "start")

    def __init__(self, tracer: "Tracer", name: str, attrs: Optional[dict]):
        self.tracer, self.name, self.attrs = tracer, name, attrs

    def __enter__(self):
        self.start = _now()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        end = _now()
        t = self.tracer
        # No lock: a list's append is atomic, and a race past the check
        # only lets the buffer pass ``capacity`` by a span per thread.
        if len(t._spans) < t.capacity:
            t._spans.append((self.name, self.start, end, self.attrs,
                             get_ident()))
        else:
            t.count("tracing.dropped", 1)
        return False


class Tracer:
    """What one ``enable()`` records: closed spans (at most ``CAPACITY``,
    as it was at ``enable()``, between two drains) and the tracer's own
    counters."""

    def __init__(self):
        self.capacity = CAPACITY
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._spans: List[tuple] = []  # (name, start, end, attrs, thread)
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()  # the counters
        self._drain_lock = threading.Lock()
        self._next_id = 1
        self._seen = kernel_counts()  # the counters at the last drain

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def counters(self) -> Dict[str, int]:
        with self._lock:
            own = dict(self._counts)
        return {**kernel_counts(), **own}

    def drain(self) -> dict:
        with self._drain_lock:
            now = self.counters()
            # Copy, then cut the copied head: a span that another thread
            # closes meanwhile lands past it and stays for the next drain.
            n = len(self._spans)
            spans = self._spans[:n]
            del self._spans[:n]
            moved = {k: v - self._seen.get(k, 0) for k, v in now.items()
                     if v != self._seen.get(k, 0)}
            self._seen = now
            tree = self._tree(spans)
        return {"spans": tree, "counters": moved}

    def _tree(self, recs: List[tuple]) -> List[Span]:
        """The records as spans in time order, ids from ``_next_id``,
        parents from how they nest on their thread."""
        off, nid, out = self.offset_ns, self._next_id, []
        recs.sort(key=lambda r: (r[1], -r[2]))
        open_by_thread: Dict[int, list] = {}
        for name, start, end, attrs, thread in recs:
            held = open_by_thread.setdefault(thread, [])  # (end, id, req)
            while held and held[-1][0] < end:
                held.pop()
            parent, request = held[-1][1:] if held else (0, nid)
            out.append(Span(nid, parent, request, name, start + off,
                            end + off, dict(attrs or ())))
            held.append((end, nid, request))
            nid += 1
        self._next_id = nid
        return out


_active: Optional[Tracer] = None  # recording now; None: off
_last: Optional[Tracer] = None  # the tracer ``drain`` reads


def span(name: str, attrs: Optional[dict] = None):
    """A context manager that records ``name`` and ``attrs`` around its
    block while the tracer is on; ``NO_SPAN`` while it is
    off."""
    tracer = _active
    if tracer is None:
        return NO_SPAN
    return _Open(tracer, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the tracer's counter ``name`` while it is on."""
    tracer = _active
    if tracer is not None:
        tracer.count(name, n)


def enabled() -> bool:
    return _active is not None


def enable() -> Tracer:
    """Turn the tracer on (a new one, unless one is recording) and return
    it."""
    global _active, _last
    if _active is None:
        _active = _last = Tracer()
    return _active


def disable() -> None:
    """Turn the tracer off; what it recorded stays for ``drain``."""
    global _active
    _active = None


def drain() -> dict:
    """``{"spans": [Span, ...], "counters": {name: moved}}`` since the last
    drain (the kernels' launches and the tracer's own counters that
    moved), and clear them; empty when nothing was ever recorded."""
    if _last is None:
        return {"spans": [], "counters": {}}
    return _last.drain()


def counters() -> Dict[str, int]:
    """Every kernel's launches and the tracer's own counters so far."""
    if _last is None:
        return kernel_counts()
    return _last.counters()


def self_times(spans: Iterable[Span]) -> Dict[int, int]:
    """Each span's self time in ns, by id: its duration less the part of
    it that its children cover."""
    spans = list(spans)
    kids: Dict[int, list] = {}
    for s in spans:
        kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, reach = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out


# A pid no process has (Linux pids stay below 2**22): the port's spans get
# a track of their own in a Chrome trace.
TRACK_PID = (1 << 22) + 1


def chrome_events(spans: Iterable[Span], base_ns: int = 0) -> List[dict]:
    """The spans as Chrome trace ``"X"`` events (µs after ``base_ns``, a
    profiler trace's ``baseTimeNanoseconds``) on a track of their own,
    with their ids, attributes and self time as arguments."""
    spans = list(spans)
    own = self_times(spans)
    events = [{"ph": "M", "name": "process_name", "pid": TRACK_PID,
               "tid": 0, "args": {"name": "smvp_toolkit_tpu_torch spans"}}]
    for s in spans:
        events.append({
            "ph": "X", "cat": "smvp_toolkit_tpu_torch", "name": s.name,
            "pid": TRACK_PID, "tid": 0,
            "ts": (s.start_ns - base_ns) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {**s.attrs, "id": s.id, "parent": s.parent,
                     "request": s.request, "self_us": own[s.id] / 1e3}})
    return events

