"""Timing harness: warmup + device-synchronised per-iteration timing + stats.

Counterpart of the JAX package's ``bench/harness.py``. Reference
equivalents: per-iteration ``clock_gettime`` pairs around the hot loop
(main-cli.c:408,419) and the total/avg/min/max/stdev reduction
(main-cli.c:428-456).

On the card each sample is bracketed by CUDA events and synchronised, so
it measures device execution, not the enqueue (PyTorch returns before
the device finishes). On the CPU a sample is host wall time.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import numpy as np
import torch

__all__ = [
    "TimingStats",
    "time_fn",
    "bench_spmv",
    "bench_fused",
    "bench_native_batched",
]


@dataclasses.dataclass(frozen=True)
class TimingStats:
    """Per-iteration wall-clock statistics, in milliseconds.

    Field-for-field analog of the reference ``_time_data_`` struct
    (main-cli.c:87-95).
    """

    times_ms: np.ndarray  # per-sample ms (flexible array member analog)
    iterations: int
    # Fused device-loop runs cannot observe individual iterations: each
    # sample is a per-launch average over the whole loop, so min/max/stdev
    # describe launches, not iterations. Reports label this.
    per_launch: bool = False

    @property
    def total_ms(self) -> float:
        return float(self.times_ms.sum())

    @property
    def avg_ms(self) -> float:
        return float(self.times_ms.mean())

    @property
    def min_ms(self) -> float:
        return float(self.times_ms.min())

    @property
    def max_ms(self) -> float:
        return float(self.times_ms.max())

    @property
    def stdev_ms(self) -> float:
        # Population stdev like the reference's calcStDevDouble
        # (main-cli.c:114-130), minus its UB.
        return float(self.times_ms.std())

    def nnz_per_s(self, nnz: int) -> float:
        return nnz / (self.avg_ms * 1e-3) if self.avg_ms > 0 else float("inf")

    def gb_per_s(self, bytes_per_iter: float) -> float:
        return (
            bytes_per_iter / (self.avg_ms * 1e-3) / 1e9
            if self.avg_ms > 0
            else float("inf")
        )


class _Timer:
    """One timed sample: CUDA events on the card, host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def __enter__(self):
        if self.cuda:
            self.start = torch.cuda.Event(enable_timing=True)
            self.end = torch.cuda.Event(enable_timing=True)
            self.start.record()
        else:
            self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            self.end.record()
            torch.cuda.synchronize(self.device)
            self.ms = self.start.elapsed_time(self.end)
        else:
            self.ms = (time.perf_counter_ns() - self.t0) / 1e6
        return False


def time_fn(
    fn: Callable[[], object],
    *,
    device,
    iterations: int = 1000,
    warmup: int = 2,
) -> TimingStats:
    """Time ``fn`` for ``iterations`` samples after ``warmup`` calls.

    Each sample ends in a device synchronise (the analog of the JAX
    harness's ``block_until_ready``).
    """
    device = torch.device(device)
    for _ in range(max(warmup, 0)):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    samples: List[float] = []
    for _ in range(iterations):
        with _Timer(device) as t:
            fn()
        samples.append(t.ms)
    return TimingStats(times_ms=np.asarray(samples), iterations=iterations)


def bench_spmv(
    spmv: Callable,
    matrix,
    x: torch.Tensor,
    *,
    iterations: int = 1000,
    warmup: int = 2,
) -> TimingStats:
    """Benchmark ``y = spmv(matrix, x)`` with fresh-y semantics.

    Matches the reference protocol: y is recomputed from scratch each
    iteration (main-cli.c:405); each call allocates a fresh y.
    """
    return time_fn(
        lambda: spmv(matrix, x),
        device=x.device,
        iterations=iterations,
        warmup=warmup,
    )


def bench_fused(
    loop: Callable,
    x: torch.Tensor,
    *,
    iterations: int = 1000,
    repeats: int = 3,
    warmup: int = 1,
):
    """Time ``loop(x, iterations)``, which runs N iterations and returns
    the last result, between one pair of CUDA events per sample: the
    operator's N-iteration kernel (``SellSpMV.bench_loop``, K2 in the
    branch of its route; ``bench_loop_mat``) or N calls.

    Each of ``repeats`` samples times one call. Returns ``(stats, y)``:
    per-iteration stats (``per_launch=True``: min/max/stdev describe call
    averages) and the last call's final result.
    """
    for _ in range(max(warmup, 0)):
        loop(x, iterations)
    samples, y = [], None
    for _ in range(max(repeats, 1)):
        with _Timer(x.device) as t:
            y = loop(x, iterations)
        samples.append(t.ms / iterations)
    # One sample per iteration so totals/extrema mean what the report
    # says they mean (Total ≈ iterations x avg).
    per_iter = np.repeat(
        np.asarray(samples), -(-iterations // len(samples))
    )[:iterations]
    stats = TimingStats(times_ms=per_iter, iterations=iterations,
                        per_launch=True)
    return stats, y


def bench_native_batched(
    op,
    x,
    *,
    iterations: int = 1000,
    repeats: int = 8,
    warmup: int = 1,
) -> TimingStats:
    """Time a native (ctypes) operator with the iterations batched inside
    the C loop (the native operators take ``iterations=``).

    The Python-to-ctypes call costs a few microseconds, which would
    dominate small matrices if every iteration were a call of its own;
    ``repeats`` calls of about ``iterations / repeats`` iterations each
    time the C hot loop itself, like the reference's in-process timed
    loop (main-cli.c:402-420). Host wall time; one sample per iteration,
    each the average of its call (``per_launch`` when a call batches more
    than one).
    """
    xn = np.ascontiguousarray(
        x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
        else np.asarray(x), dtype=np.float32)
    repeats = max(min(repeats, iterations), 1)
    per = iterations // repeats
    for _ in range(max(warmup, 0)):
        op(xn, iterations=max(min(per, 20), 1))

    samples = []
    left = iterations
    for i in range(repeats):
        k = per if i < repeats - 1 else left
        left -= k
        t0 = time.perf_counter_ns()
        op(xn, iterations=k)
        t1 = time.perf_counter_ns()
        samples.append((t1 - t0) / 1e6 / k)
    per_iter = np.repeat(np.asarray(samples), max(per, 1))[:iterations]
    if per_iter.size < iterations:
        per_iter = np.pad(per_iter, (0, iterations - per_iter.size),
                          mode="edge")
    return TimingStats(times_ms=per_iter, iterations=iterations,
                       per_launch=per > 1)
