"""A solve's wall time less its kernel's device time, in ms: the state
padding, allocations, the launch and the synchronise (means over the
traced window)."""


def read(run):
    if run.kind != "solve" or not run.latency_s:
        return None
    t = run.kernel_s_per_request()
    if t is None:
        return None
    return (sum(run.latency_s) / len(run.latency_s) - t) * 1e3
