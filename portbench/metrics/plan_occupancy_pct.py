"""Useful slots over attempted slots of the operator's plan:
nnz / (sublanes · 128), in %."""


def read(run):
    slots = run.counters.get("plan_slots")
    if run.kind != "spmv" or not slots:
        return None
    return 100.0 * run.nnz / slots
