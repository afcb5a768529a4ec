"""deflate.header_ms: the program's `deflate.header` span (histograms,
code lengths and block headers, `models/deflate/codec.py`), milliseconds
a request over the traced window."""


def read(ctx):
    return ctx["spans_ms"].get("deflate.header")
