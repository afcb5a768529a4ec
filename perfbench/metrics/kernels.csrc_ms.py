"""kernels.csrc_ms: device milliseconds a request of the program's own
kernels (`csrc/*.cu`): every kernel that is neither PyTorch's nor NCCL's;
copies and sets are not kernels."""


def read(ctx):
    return ctx["class_ms"].get("own") or None
