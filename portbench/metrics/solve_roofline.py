"""The fused solve kernel's (K9 or K11) share of the HBM roofline, in %:
one step's format-independent bytes times the steps
(``needed_bytes``), over the card's peak bandwidth, divided by the
kernel's mean device time per solve in the traced window."""


def read(run):
    if run.kind != "solve" or not run.peak_bytes_per_s:
        return None
    t = run.kernel_s_per_request()
    if not t:
        return None
    return 100.0 * run.needed_bytes / run.peak_bytes_per_s / t
