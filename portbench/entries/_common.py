"""What the entries share: the operator's set-up and the solve loop."""

from __future__ import annotations

import time

import torch

from portbench.harness import Reservoir
from portbench.reference.sparse64 import Csr64, rel_residual


def coo_of(ctx):
    """The generated triplets as the port's ``COOMatrix`` on the device."""
    from smvp_toolkit_tpu_torch.formats.coo import COOMatrix

    rows, cols, vals, shape = ctx.matrix
    return COOMatrix(rows=rows, cols=cols, vals=vals, shape=tuple(shape),
                     nnz=int(rows.shape[0]))


def operator(ctx, coo):
    """``SellSpMV.from_coo`` on the autotuned plan, timed as ``plan_s``."""
    from smvp_toolkit_tpu_torch.ops.spmv_sell import SellSpMV

    with ctx.run.span("plan_s", ctx.sync):
        op = SellSpMV.from_coo(coo, value_dtype=ctx.value_dtype,
                               device=ctx.device)
    run = ctx.run
    run.nrows, run.ncols = op.shape
    run.nnz = coo.nnz
    run.value_bytes = torch.empty((), dtype=ctx.value_dtype).element_size()
    run.counters["plan_slots"] = op.plan.n_sublanes * 128
    return op


def solve_window(ctx, solve, n: int, seconds: float, cap) -> Reservoir:
    """Closed loop, one client: a fresh seeded b per request, solved and
    synchronised before the next; each latency from the call to the
    synchronise that makes x ready."""
    run, mix = ctx.run, ctx.run.mix
    g = ctx.generator(2)
    sample = Reservoir(int(mix["sample"]), run.seed)
    events = []
    cuda = ctx.device.type == "cuda"
    start = time.perf_counter()
    deadline = start + seconds
    while True:
        b = torch.randn(n, generator=g, device=ctx.device)
        if cap is not None and cuda:
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t = time.perf_counter()
        x = solve(b)
        if cap is not None and cuda:
            ev[1].record()
            events.append(ev)
        ctx.sync()
        now = time.perf_counter()
        run.latency_s.append(now - t)
        sample.offer((b, x))
        if now >= deadline or (cap is not None
                               and len(run.latency_s) >= cap):
            break
    run.window_s = now - start
    run.requests = len(run.latency_s)
    run.event_call_s = [a.elapsed_time(b) / 1e3 for a, b in events]
    return sample


def warm_solves(ctx, solve, n: int) -> None:
    g = ctx.generator(1)
    for _ in range(int(ctx.run.mix["warmup"])):
        solve(torch.randn(n, generator=g, device=ctx.device))
    ctx.sync()


def check_solves(ctx, samples, matrix) -> dict:
    """``relres``: the largest float64 relative residual ‖b − A·x‖/‖b‖ of
    the sampled solves, A from the generator's triplets."""
    rows, cols, vals, shape = matrix
    a = Csr64(rows, cols, vals, shape, ctx.device)
    worst = 0.0
    for b, x in samples:
        worst = max(worst, rel_residual(a, x, b))
    return {"relres": worst if samples else float("inf")}
