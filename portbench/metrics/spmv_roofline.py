"""K1's share of the HBM roofline, in %: the SpMV's format-independent
bytes (``needed_bytes.spmv_bytes``) over the card's peak bandwidth,
divided by K1's mean device time per call in the traced window."""


def read(run):
    if run.kind != "spmv" or not run.peak_bytes_per_s:
        return None
    t = run.kernel_s_per_request()
    if not t:
        return None
    return 100.0 * run.needed_bytes / run.peak_bytes_per_s / t
