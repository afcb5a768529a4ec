"""The port's PPMd (tpu7z_torch/models/ppmd: ppmd7, var.H with 7z's range
coder; ppmd8, var.I with zip's framing) against tpu7z's on the CPU: raw
streams at orders 2-16 (and 64 for var.H), memory sizes of 1 and 16 MiB,
both var.I restore methods, on the empty input, one byte, text and binary,
each byte for byte, and each decoder reading the other's streams; an
input that fills a 32 KiB model several times (its restart and cut-off);
flipped bytes, cut streams and bad props raise tpu7z's error classes with
its messages.
Inputs are made from seeds and stay a few KiB (both sides are Python)."""

import numpy as np
import pytest

pytest.importorskip("torch")

from tpu7z.models import ppmd as jppmd  # noqa: E402
from tpu7z.models.ppmd import ppmd7 as j7  # noqa: E402
from tpu7z.models.ppmd import ppmd8 as j8  # noqa: E402
from tpu7z_torch.models import ppmd as tppmd  # noqa: E402
from tpu7z_torch.models.ppmd import ppmd7 as t7  # noqa: E402
from tpu7z_torch.models.ppmd import ppmd8 as t8  # noqa: E402

MIB = 1 << 20
TEXT = (b"It is a truth universally acknowledged, that a single man in possession "
        b"of a good fortune, must be in want of a wife. However little known the "
        b"feelings or views of such a man may be on his first entering a "
        b"neighbourhood, this truth is so well fixed in the minds of the "
        b"surrounding families, that he is considered the rightful property of "
        b"some one or other of their daughters. ") * 6


def _input(kind: str) -> bytes:
    rng = np.random.default_rng(len(kind))
    if kind == "empty":
        return b""
    if kind == "one_byte":
        return b"\xa7"
    if kind == "text":
        return TEXT
    # binary: records of small integers, runs and noise
    rec = rng.integers(0, 16, 1200, np.uint8)
    rec[::7] = 0xFF
    return rec.tobytes() + bytes(100) + rng.integers(0, 256, 300, np.uint8).tobytes()


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # noqa: BLE001 - the class and message are compared
        return ("raises", type(exc).__name__, str(exc))


KINDS = ["empty", "one_byte", "text", "binary"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("mem", [MIB, 16 * MIB], ids=["1m", "16m"])
@pytest.mark.parametrize("order", [2, 3, 4, 6, 8, 12, 16, 64])
def test_ppmd7_streams_equal_tpu7z(order, mem, kind):
    data = _input(kind)
    want = j7.compress(data, order=order, mem=mem)
    got = t7.compress(data, order=order, mem=mem)
    assert got == want
    stream, props = got
    assert props == bytes([order]) + mem.to_bytes(4, "little")
    assert t7.decompress(stream, props, len(data)) == data
    assert j7.decompress(stream, props, len(data)) == data


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("restore", [0, 1], ids=["restart", "cut_off"])
@pytest.mark.parametrize("mem_mb", [1, 16], ids=["1m", "16m"])
@pytest.mark.parametrize("order", [2, 3, 4, 6, 8, 12, 16])
def test_ppmd8_streams_equal_tpu7z(order, mem_mb, restore, kind):
    data = _input(kind)
    want = j8.compress(data, order=order, mem_mb=mem_mb, restore=restore)
    got = t8.compress(data, order=order, mem_mb=mem_mb, restore=restore)
    assert got == want
    assert t8.decompress(got, len(data)) == data
    assert t8.decompress(got) == j8.decompress(got) == data


def _ppmd8_raw(mod, data, order, mem, restore):
    """A var.I stream of a model of any memory size (the zip framing
    takes whole MiB), through the module's own model and coder."""
    p, rc = mod.Ppmd8(order, mem, restore), mod._REnc()
    for b in data:
        mod._encode_symbol(p, rc, b)
    mod._encode_symbol(p, rc, -1)
    return rc.flush()


def _ppmd8_raw_decode(mod, stream, order, mem, restore):
    p, rc, out = mod.Ppmd8(order, mem, restore), mod._RDec(stream), bytearray()
    while (sym := mod._decode_symbol(p, rc)) >= 0:
        out.append(sym)
    return bytes(out)


@pytest.mark.parametrize("variant", ["ppmd7", "ppmd8_restart", "ppmd8_cut_off"])
def test_a_full_model_restarts_as_tpu7z(variant):
    """Text, noise and text at order 16 in a 32 KiB model: the
    suballocator runs out several times, and the model restarts (var.H,
    var.I restart) or cuts off (var.I) as tpu7z's does."""
    rng = np.random.default_rng(5)
    data = TEXT[:3000] + rng.integers(0, 256, 3000, np.uint8).tobytes() + TEXT[:3000]
    mem = 1 << 15
    if variant == "ppmd7":
        got = t7.compress(data, order=16, mem=mem)
        assert got == j7.compress(data, order=16, mem=mem)
        assert t7.decompress(*got, len(data)) == data
    else:
        restore = 0 if variant == "ppmd8_restart" else 1
        got = _ppmd8_raw(t8, data, 16, mem, restore)
        assert got == _ppmd8_raw(j8, data, 16, mem, restore)
        assert _ppmd8_raw_decode(t8, got, 16, mem, restore) == data


def test_package_exports_as_tpu7z():
    assert tppmd.__all__ == jppmd.__all__ == ["decompress", "compress"]
    assert tppmd.compress(TEXT[:500]) == jppmd.compress(TEXT[:500])


@pytest.mark.parametrize("at", [0, 1, 2, 5, 40, 100, -8, -2])
def test_ppmd7_damage_raises_as_tpu7z(at):
    stream, props = j7.compress(TEXT, order=6, mem=MIB)
    bad = bytearray(stream)
    bad[at] ^= 0x5A
    for data, size in ((bytes(bad), len(TEXT)), (stream[:len(stream) // 2], len(TEXT)),
                       (stream, len(TEXT) + 40)):
        assert _outcome(t7.decompress, data, props, size) == \
            _outcome(j7.decompress, data, props, size)


@pytest.mark.parametrize("props", [b"", b"\x06\x00\x00", bytes([1]) + MIB.to_bytes(4, "little"),
                                   bytes([65]) + MIB.to_bytes(4, "little")],
                         ids=["none", "short", "order_1", "order_65"])
def test_ppmd7_bad_props_raise_as_tpu7z(props):
    stream, _ = j7.compress(TEXT[:300])
    want = _outcome(j7.decompress, stream, props, 300)
    assert want[0] == "raises"
    assert _outcome(t7.decompress, stream, props, 300) == want


@pytest.mark.parametrize("at", [2, 3, 10, 50, 200, -3, -1])
def test_ppmd8_damage_raises_as_tpu7z(at):
    stream = j8.compress(TEXT)
    bad = bytearray(stream)
    bad[at] ^= 0x21
    for data, size in ((bytes(bad), len(TEXT)), (bytes(bad), None),
                       (stream[:len(stream) // 2], len(TEXT)), (stream, len(TEXT) - 1),
                       (stream, len(TEXT) + 1)):
        assert _outcome(t8.decompress, data, size) == _outcome(j8.decompress, data, size)


@pytest.mark.parametrize("head", [b"", b"\x07", b"\x00\x00", b"\x07\x20", b"\x07\x00\x00"],
                         ids=["none", "one_byte", "order_1", "restore_2", "zero_model"])
def test_ppmd8_bad_props_raise_as_tpu7z(head):
    body = j8.compress(TEXT[:300])[2:]
    data = head + body if len(head) != 3 else head
    want = _outcome(j8.decompress, data, 300)
    assert _outcome(t8.decompress, data, 300) == want
    if len(head) < 2 or head in (b"\x00\x00", b"\x07\x20"):
        assert want[:2] == ("raises", "CorruptError")


@pytest.mark.parametrize("mem_mb", [0, 257])
def test_ppmd8_bad_memory_raises_as_tpu7z(mem_mb):
    assert _outcome(t8.compress, TEXT[:50], mem_mb=mem_mb) == \
        _outcome(j8.compress, TEXT[:50], mem_mb=mem_mb)
    assert _outcome(t8.compress, TEXT[:50], mem_mb=mem_mb)[:2] == ("raises", "ParamError")
