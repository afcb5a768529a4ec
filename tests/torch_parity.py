"""What the port's container tests share: run one call of tpu7z and its
counterpart in the port on the same input, and compare what each gave,
a result or an error. The two packages' error classes are distinct
classes of one name, so an error is compared by its class's name and
its message."""

from __future__ import annotations

import numpy as np


def outcome(fn, *args, **kw):
    """("ok", fn's result), or (its error's class name, message)."""
    try:
        return "ok", fn(*args, **kw)
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return type(e).__name__, str(e)


def same(ref_fn, port_fn, *args, port_kw=None, **kw):
    """Call tpu7z's `ref_fn` and the port's `port_fn` on the same
    arguments (the port's also with `port_kw`, e.g. device="cpu"),
    assert that both gave the same result or the same error, and
    return the port's outcome."""
    ref = outcome(ref_fn, *args, **kw)
    port = outcome(port_fn, *args, **kw, **(port_kw or {}))
    assert port == ref
    return port


def text(n: int, seed: int) -> bytes:
    """n bytes of seeded words: compressible, as file content is."""
    rng = np.random.default_rng(seed)
    vocab = [b"alpha ", b"beta ", b"gamma\n", b"delta ", b"epsilon ", b"zeta, ", b"eta. "]
    picks = rng.integers(0, len(vocab), n // 4 + 1)
    return b"".join(vocab[i] for i in picks)[:n]


def noise(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


def flipped(data: bytes, pos: int, mask: int = 0xFF) -> bytes:
    bad = bytearray(data)
    bad[pos] ^= mask
    return bytes(bad)
