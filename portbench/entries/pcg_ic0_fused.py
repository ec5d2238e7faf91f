"""``fused_pcg_ic0(op, factors, b, iterations, sweeps)``: IC(0)-PCG in one
launch of K11, one client in a closed loop, a fresh seeded b per request.
The factor (``ops.ilu.ic0`` of the port's CSR encoding) is made in
set-up, timed as ``factor_s``; its L and Lᵀ plans are made at the first
solve, in the warm-up."""

from __future__ import annotations

from portbench.entries._common import (check_solves, coo_of, operator,
                                       solve_window, warm_solves)
from portbench.needed_bytes import pcg_ic0_step_bytes

KERNELS = ("sell_pcg_ic0_kernel",)  # K11


class State:
    def __init__(self, op, factors, solve):
        self.op, self.factors, self.solve = op, factors, solve
        self.sample = None


def setup(ctx):
    from smvp_toolkit_tpu_torch.formats.csr import csr_encode
    from smvp_toolkit_tpu_torch.ops import pcg_fused
    from smvp_toolkit_tpu_torch.ops.ilu import ic0

    run, mix = ctx.run, ctx.run.mix
    iters, sweeps = int(mix["iterations"]), int(mix["sweeps"])
    rows, cols = ctx.matrix[0], ctx.matrix[1]
    nnz_strict = int((rows > cols).sum())
    coo = coo_of(ctx)
    op = operator(ctx, coo)
    with run.span("factor_s", ctx.sync):
        factors = ic0(csr_encode(coo))
    run.kind, run.kernels = "solve", KERNELS
    run.needed_bytes = iters * pcg_ic0_step_bytes(
        run.nnz, run.nrows, nnz_strict, sweeps, run.value_bytes)

    def solve(b):
        return pcg_fused.fused_pcg_ic0(op, factors, b, iters, sweeps=sweeps)

    warm_solves(ctx, solve, run.nrows)
    return State(op, factors, solve)


def window(ctx, st, seconds, cap):
    st.sample = solve_window(ctx, st.solve, ctx.run.nrows, seconds, cap)


def release(st):
    items = [(b.cpu(), x.cpu()) for b, x in st.sample.items]
    st.op = st.factors = st.solve = st.sample = None
    return items


check = check_solves
