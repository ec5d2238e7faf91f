"""The port's entries that a mix drives, one module per ``entry`` name.

Each module has ``setup(ctx)`` (the operator through the port's public
entry, every shape of the window warmed up), ``window(ctx, state,
seconds, cap)`` (the measured loop), ``release(state)`` (drops the port's
state, returns the sampled answers) and ``check(ctx, samples, matrix)``
(the numbers that decide ``correct``, from the plain reference).
"""
