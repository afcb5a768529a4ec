"""entry.read_wait_ms: host milliseconds a request in the program's
`read.*` spans over the traced window: what the host waits on the card
before the result."""


def read(ctx):
    reads = [v for k, v in ctx["spans_ms"].items() if k.startswith("read.")]
    return sum(reads) if reads else None
