"""kernels.own_hbm_pct: the port's own kernels' traffic as a share of one
card's peak HBM bandwidth over their time. 100 x the bytes a request that
the program's spans around its own launches carry (`sort.rows` and the
four LZ4 kernels: what each launch reads and writes by its contract,
from the program's counters `tpu7z_torch.utils.trace.totals` over the
traced window's root spans; rank 0's, whose share of the blocks every
rank has) over the peak bandwidth x the device seconds a traced request
of the program's own kernels (`class_ms["own"]`, the ranks' mean). The
bytes leave out what a kernel reads only where the data asks, so the
share stays under 100%. Each cell's requests are of one size, so the
window's requests and the traced ones carry the same work."""


def read(ctx):
    peak = ctx["peak_bytes_per_s"]
    own_ms = ctx["class_ms"].get("own")
    if not peak or not own_ms or not ctx["spans_ms"]:
        return None
    from tpu7z_torch.utils import trace

    totals = getattr(trace, "totals", None)
    got = totals() if totals is not None else None
    if not got or not got["requests"] or not got["bytes"]:
        return None
    moved = sum(got["bytes"].values()) / got["requests"]
    return 100.0 * moved / (peak * own_ms / 1e3)
