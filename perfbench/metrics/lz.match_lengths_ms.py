"""lz.match_lengths_ms: the program's `lz.match_lengths` span (the shared
LZ matcher's lengths, `ops/hash_chain.py`), milliseconds a request over
the traced window."""


def read(ctx):
    return ctx["spans_ms"].get("lz.match_lengths")
