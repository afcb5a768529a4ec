"""entry.host_reads: the program's `read.*` spans a request, one for each
blocking read from the card before the result (the result's own copy is
`entry.d2h`). Read from the program's counters
(`tpu7z_torch.utils.trace.totals`): the `read.*` spans emitted while the
traced window's callback was attached, over the root spans, one a
request."""


def read(ctx):
    if not ctx["spans_ms"]:
        return None
    from tpu7z_torch.utils import trace

    totals = getattr(trace, "totals", None)
    got = totals() if totals is not None else None
    if not got or not got["requests"]:
        return None
    return sum(v for k, v in got["count"].items() if k.startswith("read.")) / got["requests"]
