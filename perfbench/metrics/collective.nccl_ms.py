"""collective.nccl_ms: device milliseconds a request of NCCL's kernels,
averaged over the ranks."""


def read(ctx):
    return ctx["class_ms"].get("nccl") or None
