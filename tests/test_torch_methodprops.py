"""The port's method properties (`tpu7z_torch.utils.methodprops`) and codec
registry (`tpu7z_torch.models.registry`) against tpu7z's: `parse_size`,
`parse_method_spec` and `parse_mt` on a grid of spellings (the value, or
the error's class name); the registered codecs' names, method IDs and
levels, their streams, and the trace span a registered codec emits; and
an unknown name refused as tpu7z refuses it."""

import pytest

torch = pytest.importorskip("torch")

from tpu7z.models import registry as jreg  # noqa: E402
from tpu7z.utils import methodprops as jmp  # noqa: E402
from tpu7z_torch.models import registry as treg  # noqa: E402
from tpu7z_torch.utils import methodprops as tmp  # noqa: E402
from tpu7z_torch.utils import trace  # noqa: E402

PORTED = ("copy", "lz4", "zstd", "lzma2", "xz", "bzip2", "deflate", "gzip", "brotli", "lz5",
          "lizard", "z", "lzip")
# the codecs whose tensor stages take the device (the tests name the CPU)
ON_DEVICE = ("bzip2", "deflate", "gzip", "brotli", "lz5", "lizard", "lzip")


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 - the class is what is compared
        return ("raises", type(exc).__name__)


@pytest.mark.parametrize("spelling", [
    "24", "0", "63", "64", "16m", "64k", "1g", "123b", "8M", " 27 ", "", "abc", "12x",
    "1t", "k"])
def test_parse_size_equals_tpu7z(spelling):
    assert _outcome(tmp.parse_size, spelling) == _outcome(jmp.parse_size, spelling)


@pytest.mark.parametrize("spelling", [
    "zstd", "ZSTD:x22", "zstd:x22:wlog=27:long", "lzma2:d=24:fb=64", "lz4:dev",
    "zstd:mt=off", "zstd:mt=on", "zstd:mt=-", "zstd:mt=+", "zstd:mt=", "zstd::x3",
    "copy:x", "bcj2:x0:d24m", "zstd:level=abc", "zstd:wlog=-3"])
def test_parse_method_spec_equals_tpu7z(spelling):
    assert _outcome(tmp.parse_method_spec, spelling) == _outcome(jmp.parse_method_spec,
                                                                  spelling)


@pytest.mark.parametrize("num_cpus", [1, 8, 32])
@pytest.mark.parametrize("spelling", [
    None, True, False, 0, 4, 64, "on", "off", "", "=4", "4", "100", "p50", "p25u1", "p1+1",
    "d2", "-", "+", "-2", "+2", "u3", "dp50", "-p25", "+p50", "up10", "x", "p", "d", "u",
    "2d1", "ON", " 3 "])
def test_parse_mt_equals_tpu7z(spelling, num_cpus):
    assert _outcome(tmp.parse_mt, spelling, num_cpus) == _outcome(jmp.parse_mt, spelling,
                                                                  num_cpus)


@pytest.mark.parametrize("name", PORTED)
def test_registered_codecs_equal_tpu7z(name):
    mine, ref = treg.get_codec(name.upper()), jreg.get_codec(name)
    assert (mine.name, mine.method_id, mine.levels) == (ref.name, ref.method_id, ref.levels)
    data = b"registry round trip " * 300 + bytes(range(256))
    kw = {"device": "cpu"} if name in ON_DEVICE else {}
    packed = mine.compress(data, level=5, **kw)
    assert packed == ref.compress(data, level=5)
    assert mine.decompress(packed, **kw) == data


def test_registry_holds_only_ported_codecs():
    """Every codec of tpu7z's registry is ported (PR 14 the last five)."""
    assert sorted(treg.CODECS) == sorted(PORTED) == sorted(jreg.CODECS)


def test_unknown_codec_raises_as_tpu7z():
    from tpu7z.utils.errors import UnsupportedError as JUnsupported
    from tpu7z_torch.utils.errors import UnsupportedError
    with pytest.raises(JUnsupported):
        jreg.get_codec("nosuch")
    with pytest.raises(UnsupportedError, match="unknown codec 'nosuch'"):
        treg.get_codec("nosuch")


def test_registered_codec_emits_a_span():
    events = []
    trace.attach(events.append)
    try:
        treg.get_codec("lz4").compress(b"x" * 1000, level=1)
    finally:
        trace.detach()
    assert [e["name"] for e in events] == ["lz4.compress"]
    assert events[0]["size"] == 1000 and events[0]["level"] == 1


def test_zstd_through_the_registry_records_one_span_a_call():
    """zstd's frame module opens its own spans; the registry adds none."""
    events = []
    trace.attach(events.append)
    try:
        packed = treg.get_codec("zstd").compress(b"y" * 1000, level=3)
        treg.get_codec("zstd").decompress(packed)
    finally:
        trace.detach()
    assert [e["name"] for e in events] == ["zstd.compress", "zstd.decompress"]
