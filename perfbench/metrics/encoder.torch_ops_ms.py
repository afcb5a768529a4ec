"""encoder.torch_ops_ms: device milliseconds a request of PyTorch's own
kernels (names with `at::`, and its CUB kernels): on the LZ4 device path
the candidate stage and the frame's assembly."""


def read(ctx):
    return ctx["class_ms"].get("torch") or None
