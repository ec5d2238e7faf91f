"""Profiler integration: device traces around benchmark runs.

Counterpart of the JAX package's ``bench/profile.py`` on
``torch.profiler``: a context manager that records host operators and,
on a card, every kernel launch in the process (CUPTI sees the ctypes
launches of the SELL kernels as it sees PyTorch's), and writes one Chrome
trace (``trace.json``, viewable in Perfetto or ``chrome://tracing``) into
the given directory; and the CLI-facing helper ``profile_fn``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch

__all__ = ["trace", "profile_fn", "TRACE_FILE"]

TRACE_FILE = "trace.json"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Record a trace of the block into ``log_dir/trace.json``; yields the
    profiler (``key_averages()`` summarises it)."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def profile_fn(fn, *args, log_dir: str, iterations: int = 10):
    """Run ``fn(*args)`` ``iterations`` times under the profiler, after
    one call outside it (kernel builds and plans stay out of the trace)."""
    result = fn(*args)
    _sync()
    with trace(log_dir):
        for _ in range(iterations):
            result = fn(*args)
    return result
