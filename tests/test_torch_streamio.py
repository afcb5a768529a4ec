"""The port's streaming extract (tpu7z_torch/utils/streamio.py) against
tpu7z's: the same bytes written, the same counts and progress, the same
errors, for .lz4 (independent and linked blocks, skippable frames, a
block that the host library refuses), .zst (several frames), .gz, .bz2
and .xz; and `x -mmt1` through the port's CLI, which streams them as
tpu7z's does (tests/test_streamio.py's cases, held against tpu7z)."""

import bz2
import gzip
import io
import lzma
import struct

import pytest

from tests.torch_parity import flipped, noise, text
from tpu7z.cli.main import main as jmain
from tpu7z.models.lz4 import frame as jlz4
from tpu7z.models.zstd import frame as jzstd
from tpu7z.utils import streamio as jstream
from tpu7z_torch.cli.main import main as tmain
from tpu7z_torch.utils import streamio as tstream


def _data():
    return b"streaming extraction payload " * 4000 + noise(65536, 1) + b"tail" * 999


class _Progress:
    def __init__(self):
        self.adds = []

    def add(self, nbytes, name=""):
        self.adds.append(nbytes)


def _both(tmp_path, blob, kind):
    """Each package's stream_extract of `blob` as `kind`: (bytes written
    and the count, or the error's class and message; the progress adds)."""
    p = tmp_path / "in.bin"
    p.write_bytes(blob)
    runs = []
    for mod in (jstream, tstream):
        out, prog = io.BytesIO(), _Progress()
        try:
            n = mod.stream_extract(str(p), kind, out, prog)
            runs.append((("ok", n, out.getvalue()), prog.adds))
        except Exception as e:  # noqa: BLE001 - the class is what is compared
            runs.append(((type(e).__name__, str(e)), prog.adds))
    assert runs[0] == runs[1]
    return runs[1][0]


def _skippable(payload: bytes) -> bytes:
    return struct.pack("<II", 0x184D2A53, len(payload)) + payload


@pytest.mark.parametrize("case", ["independent", "linked", "block_checksums", "skippable",
                                  "two_frames", "empty_frame", "small_blocks"])
def test_stream_lz4_equals_tpu7z(tmp_path, case):
    data = _data()
    blob = {"independent": lambda: jlz4.compress_frame(data),
            "linked": lambda: jlz4.compress_frame(data, block_size=1 << 16,
                                                  block_independence=False),
            "block_checksums": lambda: jlz4.compress_frame(data, block_checksum=True),
            "skippable": lambda: _skippable(b"meta") + jlz4.compress_frame(data) + _skippable(b""),
            "two_frames": lambda: jlz4.compress_frame(data[:5000]) + jlz4.compress_frame(data),
            "empty_frame": lambda: jlz4.compress_frame(b""),
            "small_blocks": lambda: jlz4.compress_frame(data, block_size=1 << 16)}[case]()
    assert _both(tmp_path, blob, "lz4")[2] == (b"" if case == "empty_frame" else
                                                data[:5000] + data if case == "two_frames" else
                                                data)


def test_stream_zstd_multiframe_equals_tpu7z(tmp_path):
    data = _data()
    half = len(data) // 2
    blob = (jzstd.compress(data[:half], level=3) + _skippable(b"x" * 9)
            + jzstd.compress(data[half:], level=1))
    assert _both(tmp_path, blob, "zstd")[2] == data


@pytest.mark.parametrize("kind", ["gzip", "bzip2", "xz"])
@pytest.mark.parametrize("members", [1, 2])
def test_stream_zlib_family_equals_tpu7z(tmp_path, kind, members):
    data = _data()
    one = {"gzip": gzip.compress, "bzip2": bz2.compress, "xz": lzma.compress}[kind]
    blob = b"".join(one(data[i::members]) for i in range(members))
    assert _both(tmp_path, blob, kind)[2] == b"".join(data[i::members] for i in range(members))


def test_stream_large_input_in_chunks_equals_tpu7z(tmp_path):
    """More than one 1 MiB input chunk through the standard decoders."""
    data = noise(1 << 20, 2) + text(1 << 20, 3)
    assert _both(tmp_path, gzip.compress(data, 1), "gzip")[2] == data


@pytest.mark.parametrize("case", [
    "lz4_magic", "lz4_descriptor", "lz4_block_size", "lz4_block", "lz4_bad_block",
    "lz4_skippable_cut", "zstd_magic", "zstd_cut", "zstd_body", "zstd_header",
    "gzip_body", "bzip2_body", "xz_body", "empty"])
def test_stream_corrupt_as_tpu7z(tmp_path, case):
    """Each error of the streaming decoders: the same class and message
    (a corrupt LZ4 block too: where the host library refuses it, the
    plain decoder gives tpu7z's message)."""
    data = text(200000, 4)
    lz = jlz4.compress_frame(data)
    zs = jzstd.compress(data)
    blob, kind = {
        "lz4_magic": (b"\x04\x22\x4d\x19" + lz[4:], "lz4"),
        "lz4_descriptor": (lz[:5], "lz4"),
        "lz4_block_size": (b"\x04\x22\x4d\x18" + b"\xff" * 10, "lz4"),
        "lz4_block": (lz[:len(lz) // 2], "lz4"),
        "lz4_bad_block": (flipped(lz, 30, 0xF0), "lz4"),
        "lz4_skippable_cut": (b"\x50\x2a\x4d\x18\x05", "lz4"),
        "zstd_magic": (b"\x28\xb5\x2f\xfe" + zs[4:], "zstd"),
        "zstd_cut": (zs[:len(zs) // 2], "zstd"),
        "zstd_body": (flipped(zs, len(zs) // 2), "zstd"),
        "zstd_header": (zs[:5], "zstd"),
        "gzip_body": (flipped(gzip.compress(data), 500), "gzip"),
        "bzip2_body": (flipped(bz2.compress(data), 500), "bzip2"),
        "xz_body": (flipped(lzma.compress(data), 500), "xz"),
        "empty": (b"", "lz4"),
    }[case]
    _both(tmp_path, blob, kind)


def _lz4_corrupt(kind: str) -> bytes:
    """A frame with block checksums whose header, a block's checksum, its
    content checksum or its content size is wrong."""
    framed = bytearray(jlz4.compress_frame(text(300000, 5), block_size=1 << 16,
                                           block_checksum=True))
    first = 4 + 2 + 8 + 1
    word = int.from_bytes(framed[first:first + 4], "little") & 0x7FFFFFFF
    where = {"header": 4 + 2 + 8, "block": first + 4 + word, "content": len(framed) - 1,
             "size": 4 + 2}[kind]
    framed[where] ^= 0x01
    if kind == "size":
        # the header checksum made anew, so that only the size is wrong
        from tpu7z_torch.ops.hashing import xxh32
        framed[4 + 2 + 8] = (xxh32(bytes(framed[4:4 + 2 + 8])) >> 8) & 0xFF
    return bytes(framed)


@pytest.mark.parametrize("kind,message", [
    ("header", "header checksum mismatch"), ("block", "block checksum mismatch"),
    ("content", "content checksum mismatch"), ("size", "content size mismatch")])
def test_stream_lz4_checks_where_tpu7z_streams_other_bytes(tmp_path, kind, message):
    """tpu7z's streaming walk skips the header, block and content
    checksums and the content size: it writes the frame's blocks without
    a word. The port checks them, with its frame decoder's messages."""
    p = tmp_path / "bad.lz4"
    p.write_bytes(_lz4_corrupt(kind))
    got = io.BytesIO()
    assert jstream.stream_extract(str(p), "lz4", got) == len(got.getvalue()) > 0
    with pytest.raises(tstream.CorruptError, match=f"^lz4 frame: {message}$"):
        tstream.stream_extract(str(p), "lz4", io.BytesIO())
    from tpu7z_torch.models.lz4 import frame as tlz4
    with pytest.raises(tstream.CorruptError, match=f"^lz4 frame: {message}$"):
        tlz4.decompress(p.read_bytes())


def test_stream_refuses_other_types_as_tpu7z(tmp_path):
    p = tmp_path / "a.bin"
    p.write_bytes(b"abc")
    for mod in (jstream, tstream):
        with pytest.raises(KeyError):
            mod.stream_extract(str(p), "tar", io.BytesIO())
    assert tstream.STREAMABLE == jstream.STREAMABLE


@pytest.mark.parametrize("name,make", [
    ("doc.bin.lz4", lambda d: jlz4.compress_frame(d)), ("doc.bin.zst", lambda d: jzstd.compress(d)),
    ("doc.bin.gz", gzip.compress), ("doc.bin.bz2", bz2.compress), ("doc.bin.xz", lzma.compress),
    ("noext", lambda d: jlz4.compress_frame(d))])
@pytest.mark.parametrize("progress", [[], ["-bb"], ["-bd"]], ids=["tty", "bb", "bd"])
def test_cli_streaming_extract_as_tpu7z(tmp_path, monkeypatch, capsys, name, make, progress):
    """`x -mmt1` of each streamed type: tpu7z's file, stdout line and
    progress on standard error (-bb), in directories of their own."""
    data = _data()
    said = []
    for which, run in (("ref", jmain), ("port", lambda a: tmain(a, device="cpu"))):
        d = tmp_path / which
        d.mkdir()
        (d / name).write_bytes(make(data))
        monkeypatch.chdir(d)
        capsys.readouterr()
        rc = run(["x", "-mmt1", "-oout", name, *progress])
        cap = capsys.readouterr()
        said.append((rc, cap.out, cap.err, {p.name: p.read_bytes() for p in (d / "out").iterdir()}))
    assert said[0] == said[1]
    rc, out, err, files = said[1]
    assert rc == 0 and list(files.values()) == [data]
    assert ("%" in err) == (progress == ["-bb"])   # its total is 3 x the input's size
