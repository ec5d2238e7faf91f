"""The device's idle share of the traced window."""


def idle_pct(run, kind):
    tr = run.device_trace
    if run.kind != kind or tr is None or tr.window_s <= 0 or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
