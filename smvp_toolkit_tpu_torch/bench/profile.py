"""Profiler integration: device traces around benchmark runs.

Counterpart of the JAX package's ``bench/profile.py`` on
``torch.profiler``: a context manager that records host operators and,
on a card, every kernel launch in the process (CUPTI sees the ctypes
launches of the SELL kernels as it sees PyTorch's), and writes one Chrome
trace (``trace.json``, viewable in Perfetto or ``chrome://tracing``) into
the given directory; and the CLI-facing helper ``profile_fn``. The port's
tracer (``utils/tracing.py``) is on for the block, and its spans go into
the same file on a track of their own, on the profiler's timeline.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Iterator

import torch

from smvp_toolkit_tpu_torch.utils import tracing

__all__ = ["trace", "profile_fn", "TRACE_FILE"]

TRACE_FILE = "trace.json"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record a trace of the block into ``log_dir/trace.json``, the port's
    spans among it; yields the profiler (``key_averages()`` summarises it).
    Where the tracer is on already, it is left as it is and its spans to
    the caller's ``drain``: the file then holds the profiler's events
    alone."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    own = not tracing.enabled()
    if own:
        tracing.enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            try:
                yield prof
            finally:
                _sync()
    finally:
        spans = []
        if own:
            tracing.disable()
            spans = tracing.drain()["spans"]
    path = os.path.join(log_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    if not spans:
        return
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += tracing.chrome_events(
        spans, doc.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(doc, f)


def profile_fn(fn, *args, log_dir: str, iterations: int = 10):
    """Run ``fn(*args)`` ``iterations`` times under the profiler, after
    one call outside it (kernel builds and plans stay out of the trace)."""
    result = fn(*args)
    _sync()
    with trace(log_dir):
        for _ in range(iterations):
            result = fn(*args)
    return result
