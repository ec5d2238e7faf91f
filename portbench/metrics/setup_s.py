"""Seconds from the start of the process to the start of the window:
the interpreter and imports, the matrix made from the seed, the port's
plan and upload, any factorization, kernel builds on a first run, and the
warm-up of every shape the window uses."""


def read(run):
    return run.setup_s
