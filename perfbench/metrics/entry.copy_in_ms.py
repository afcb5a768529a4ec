"""entry.copy_in_ms: the program's `entry.split` (the input cut into
zero-padded blocks, LZ4) and `entry.h2d` (the input's copy to the card)
spans, host milliseconds a request over the traced window."""


def read(ctx):
    spans = ctx["spans_ms"]
    if "entry.split" not in spans and "entry.h2d" not in spans:
        return None
    return spans.get("entry.split", 0.0) + spans.get("entry.h2d", 0.0)
