"""kernels_roofline: the least time the traced requests' work could
take, every input byte read once and every output byte written once at
the card's peak HBM bandwidth over the chips used, as a share of the
device time of all their kernels (the union of kernel intervals, averaged
over the ranks). Counted from the work, not from the kernels that do it."""


def read(ctx):
    peak = ctx["peak_bytes_per_s"]
    if not peak or ctx["kernel_s"] <= 0:
        return None
    least = (ctx["bytes_in"] + ctx["bytes_out"]) / (peak * ctx["chips"])
    return 100.0 * least / ctx["kernel_s"]
