"""Seconds of ``SellSpMV.from_coo`` in set-up: the host plan (the
autotuner's pick) and the upload of its planes."""


def read(run):
    return run.spans.get("plan_s")
