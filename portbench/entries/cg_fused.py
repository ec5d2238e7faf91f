"""``fused_cg(op, b, iterations)``: the whole CG solve in one launch of
K9, one client in a closed loop, a fresh seeded b per request."""

from __future__ import annotations

from portbench.entries._common import (check_solves, coo_of, operator,
                                       solve_window, warm_solves)
from portbench.needed_bytes import cg_step_bytes

KERNELS = ("sell_cg_kernel", "sell_cg_split_kernel")  # K9, either route


class State:
    def __init__(self, op, solve):
        self.op, self.solve, self.sample = op, solve, None


def setup(ctx):
    from smvp_toolkit_tpu_torch.ops import cg_fused

    run = ctx.run
    iters = int(run.mix["iterations"])
    op = operator(ctx, coo_of(ctx))
    run.kind, run.kernels = "solve", KERNELS
    run.needed_bytes = iters * cg_step_bytes(run.nnz, run.nrows,
                                             run.value_bytes)

    def solve(b):
        return cg_fused.fused_cg(op, b, iters)

    warm_solves(ctx, solve, run.nrows)
    return State(op, solve)


def window(ctx, st, seconds, cap):
    st.sample = solve_window(ctx, st.solve, ctx.run.nrows, seconds, cap)


def release(st):
    items = [(b.cpu(), x.cpu()) for b, x in st.sample.items]
    st.op = st.solve = st.sample = None
    return items


check = check_solves
