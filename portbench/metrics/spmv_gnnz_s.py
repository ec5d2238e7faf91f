"""Nonzeros of every SpMV completed in the window over the window's
seconds, in 10^9 per second."""


def read(run):
    if run.kind != "spmv" or run.window_s <= 0:
        return None
    return run.nnz * run.requests / run.window_s / 1e9
