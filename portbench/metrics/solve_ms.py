"""The window's milliseconds over the solves completed in it."""


def read(run):
    if run.kind != "solve" or not run.requests:
        return None
    return run.window_s / run.requests * 1e3
