"""Seconds of the IC(0) factorization in set-up: the port's CSR encoding
of A and ``ops.ilu.ic0`` on it."""


def read(run):
    return run.spans.get("factor_s")
