"""device.idle_pct: 100 x (1 - busy / window) over the traced requests,
busy the union of the device's kernels, copies and sets inside each
request's host window, averaged over the ranks."""


def read(ctx):
    if ctx["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["window_s"])
