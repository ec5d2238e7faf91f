"""``y = op(x)`` on ``SellSpMV``: a closed loop of one client that
dispatches ahead, with one synchronise every ``sync_every`` calls, x
rotating over ``vectors`` seeded vectors."""

from __future__ import annotations

import time

import torch

from portbench.entries._common import coo_of, operator
from portbench.harness import Reservoir
from portbench.needed_bytes import spmv_bytes
from portbench.reference.sparse64 import Csr64, max_rel_err

KERNELS = ("sell_spmv_kernel",)  # K1


class State:
    def __init__(self, op, xs):
        self.op, self.xs, self.sample = op, xs, None


def setup(ctx):
    run, mix = ctx.run, ctx.run.mix
    op = operator(ctx, coo_of(ctx))
    run.kind, run.kernels = "spmv", KERNELS
    run.needed_bytes = spmv_bytes(run.nnz, run.nrows, run.ncols,
                                  run.value_bytes)
    xs = torch.randn(int(mix["vectors"]), run.ncols,
                     generator=ctx.generator(1), device=ctx.device)
    for _ in range(int(mix["warmup"])):
        for i in range(int(mix["sync_every"])):
            op(xs[i % len(xs)])
        ctx.sync()
    return State(op, xs)


def window(ctx, st, seconds, cap):
    run, mix = ctx.run, ctx.run.mix
    op, xs = st.op, st.xs
    nv, per = len(xs), int(mix["sync_every"])
    sample = Reservoir(int(mix["sample"]), run.seed)
    host = run.call_host_s
    events = []
    cuda = ctx.device.type == "cuda"
    timed = cap is not None and cuda
    calls = 0
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        for _ in range(per):
            i = calls % nv
            if timed:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            t = time.perf_counter()
            y = op(xs[i])
            host.append(time.perf_counter() - t)
            if timed:
                ev[1].record()
                events.append(ev)
            sample.offer((i, y))
            calls += 1
        ctx.sync()
        now = time.perf_counter()
        if now >= deadline or (cap is not None and calls >= cap):
            break
    run.window_s = now - start
    run.requests = calls
    run.event_call_s = [a.elapsed_time(b) / 1e3 for a, b in events]
    st.sample = sample


def release(st):
    items = [(i, y) for i, y in st.sample.items]
    xs = st.xs.cpu()
    st.op = st.xs = st.sample = None
    return [(xs[i], y) for i, y in items]


def check(ctx, samples, matrix) -> dict:
    """``y_err``: the largest max |y − y_ref| / max |y_ref| of the sampled
    calls, y_ref the float64 product of the generator's triplets."""
    rows, cols, vals, shape = matrix
    a = Csr64(rows, cols, vals, shape, ctx.device)
    worst = 0.0
    for x, y in samples:
        worst = max(worst, max_rel_err(y, a.matvec(x)))
    return {"y_err": worst if samples else float("inf")}
