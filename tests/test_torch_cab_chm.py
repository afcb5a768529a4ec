"""The port's LZX codec, cab and chm (tpu7z_torch/models/lzx.py,
tpu7z_torch/containers/{cab,chm}.py) and deflate's `compress_streams`
against tpu7z's: the same streams, cabinets and CHM files from the same
input, the same files from tpu7z's, the same errors. A cabinet's MSZIP
chunks are rows of one parse (the CPU here, `device="cpu"`); each stream
equals tpu7z's `deflate.compress` of its chunk. LZX inputs stay at 64 KiB
or less: tpu7z's Python encoder runs at about 0.05 MB/s."""

import struct
import zlib

import pytest

from tests.torch_parity import flipped, noise, same, text
from tpu7z.containers import cab as jcab
from tpu7z.containers import chm as jchm
from tpu7z.models import lzx as jlzx
from tpu7z.models.deflate import codec as jdef
from tpu7z_torch.containers import cab as tcab
from tpu7z_torch.containers import chm as tchm
from tpu7z_torch.models import lzx as tlzx
from tpu7z_torch.models.deflate import codec as tdef
from tpu7z_torch.ops import match

CPU = {"device": "cpu"}
SIZES = {"empty": b"", "one_byte": b"Q", "under_16": b"fifteen bytes!!",
         "exactly_32768": text(32768, 1), "32769": text(32769, 2),
         "text_and_noise": text(30000, 3) + noise(9000, 4) + text(25000, 5)}
# MSZIP and stored cabinets are cheap: larger and more chunks there
MSZIP_SIZES = {**SIZES, "many_chunks": text(100000, 6) + noise(40000, 7) + bytes(50000),
               "noise_chunks": noise(70000, 8)}


def _chunks(blob: bytes):
    return [blob[off:off + 32768] for off in range(0, max(len(blob), 1), 32768)]


@pytest.mark.parametrize("kind", list(MSZIP_SIZES))
def test_compress_streams_equal_tpu7z_per_chunk(kind):
    chunks = _chunks(MSZIP_SIZES[kind])
    got = tdef.compress_streams(chunks, device="cpu")
    assert got == [jdef.compress(c) for c in chunks]
    # each a raw deflate stream the standard library reads, BFINAL set
    assert [zlib.decompress(g, -15) for g in got] == chunks
    assert all(g[0] & 1 for g in got)


@pytest.mark.parametrize("width", [16, 100, 4096])
def test_compress_streams_other_widths_equal_tpu7z(width):
    data = text(5 * width + 7, 9)
    chunks = [data[off:off + width] for off in range(0, len(data), width)]
    assert tdef.compress_streams(chunks, device="cpu") == [jdef.compress(c) for c in chunks]


def test_compress_streams_one_parse_for_every_chunk(monkeypatch):
    """Every chunk a row of one candidate sort: one `match.sort_order`
    call over every chunk's 32765 hashes, a short last chunk padded to a
    full row, as `write_cab` makes it."""
    shapes = []
    real = match.sort_order
    monkeypatch.setattr(match, "sort_order",
                        lambda h, *a, **k: shapes.append(tuple(h.shape)) or real(h, *a, **k))
    files = {"m.bin": MSZIP_SIZES["many_chunks"][:5 * 32768], "n.bin": b"tail" * 3000}
    assert tcab.write_cab(files, device="cpu") == jcab.write_cab(files)
    assert shapes == [(6, 32765)]       # five full chunks and the padded last


@pytest.mark.parametrize("chunks", [[b"ab", b"abc"], [b"abc", b"ab", b"abc"], [b"", b"a"]])
def test_compress_streams_refuses_ragged_chunks(chunks):
    with pytest.raises(ValueError, match="every chunk but the last"):
        tdef.compress_streams(chunks, device="cpu")


def test_compress_streams_of_nothing():
    assert tdef.compress_streams([], device="cpu") == []
    assert tdef.compress_streams([b""], device="cpu") == [jdef.compress(b"")]


@pytest.mark.parametrize("comp", ["mszip", "none", "unknown_is_none"])
@pytest.mark.parametrize("kind", list(MSZIP_SIZES))
def test_write_cab_equals_tpu7z(kind, comp):
    comp = "nosuch" if comp == "unknown_is_none" else comp
    files = {"a/b.bin": MSZIP_SIZES[kind], "c.txt": text(3000, 10), "e": b""}
    blob = same(jcab.write_cab, tcab.write_cab, files, comp, port_kw=CPU)[1]
    assert same(jcab.read_cab, tcab.read_cab, blob) == ("ok", files)


@pytest.mark.parametrize("kind", list(SIZES))
def test_write_cab_lzx_equals_tpu7z(kind):
    files = {"m.bin": SIZES[kind], "t.txt": b"tail text " * 20}
    blob = same(jcab.write_cab, tcab.write_cab, files, "lzx", port_kw=CPU)[1]
    assert same(jcab.read_cab, tcab.read_cab, blob) == ("ok", files)


def test_write_cab_of_no_files_as_tpu7z():
    blob = same(jcab.write_cab, tcab.write_cab, {}, port_kw=CPU)[1]
    assert same(jcab.read_cab, tcab.read_cab, blob) == ("ok", {})


def test_read_cab_primes_mszip_with_the_folder_window():
    """MSZIP blocks that refer back into the previous block (zlib with a
    preset dictionary): the port's host inflate reads them as tpu7z's."""
    data = text(90000, 11)
    chunks = _chunks(data)
    datas = bytearray()
    for i, c in enumerate(chunks):
        z = zlib.compressobj(9, zlib.DEFLATED, -15, zdict=data[max(0, i * 32768 - 32768):i * 32768]) \
            if i else zlib.compressobj(9, zlib.DEFLATED, -15)
        payload = b"CK" + z.compress(c) + z.flush()
        datas += struct.pack("<IHH", 0, len(payload), len(c)) + payload
    name = b"w.txt\x00"
    coff_files = 44
    coff_data = coff_files + 16 + len(name)
    head = (b"MSCF" + struct.pack("<IIIII", 0, coff_data + len(datas), 0, coff_files, 0)
            + struct.pack("<BBHHHHH", 3, 1, 1, 1, 0, 0, 0)
            + struct.pack("<IHH", coff_data, len(chunks), 1)
            + struct.pack("<IIHHHH", len(data), 0, 0, 0, 0, 0x20) + name)
    assert same(jcab.read_cab, tcab.read_cab, head + bytes(datas)) == ("ok", {"w.txt": data})


def _cab():
    return jcab.write_cab({"f.txt": text(50000, 12), "g.bin": noise(2000, 13)})


@pytest.mark.parametrize("case", [
    "bad_magic", "short", "version", "reserve_flag", "multi_cabinet", "quantum", "checksum",
    "signature", "truncated_cfdata", "truncated_payload", "size_mismatch", "folder_index",
    "out_of_range", "body_byte"])
def test_corrupt_cabinets_as_tpu7z(case):
    """Each error of the reader: the same class and message, or the same
    bytes where tpu7z reads on (it checks no CFDATA checksum, ROADMAP.md
    section 3)."""
    blob = _cab()
    coff_data = struct.unpack_from("<I", blob, 36)[0]
    bad = {
        "bad_magic": b"MSCG" + blob[4:], "short": blob[:30], "version": flipped(blob, 25, 0x02),
        "reserve_flag": flipped(blob, 30, 0x04), "multi_cabinet": flipped(blob, 30, 0x01),
        "quantum": flipped(blob, 42, 0x01), "checksum": flipped(blob, coff_data, 0x5A),
        "signature": flipped(blob, coff_data + 8, 0x01),
        "truncated_cfdata": blob[:coff_data + 4],
        "truncated_payload": blob[:coff_data + 100],
        "size_mismatch": flipped(blob, coff_data + 6, 0x01),
        "folder_index": flipped(blob, 44 + 8, 0x01),
        "out_of_range": flipped(blob, 44 + 3, 0x10),
        "body_byte": flipped(blob, coff_data + 200),
    }[case]
    same(jcab.read_cab, tcab.read_cab, bad)


LZX_CASES = {**SIZES, "zeros": bytes(40000), "repeats": (b"abcabcabcabd" * 3000)[:36000]}


@pytest.mark.parametrize("kind", list(LZX_CASES))
def test_lzx_frames_equal_tpu7z(kind):
    data = LZX_CASES[kind]
    comp, offs = same(jlzx.encode_frames, tlzx.encode_frames, data, 16)[1]
    assert same(jlzx.decode_frames, tlzx.decode_frames, comp, offs, 16, jlzx.FRAME,
                len(data)) == ("ok", data)


@pytest.mark.parametrize("window_bits", [15, 16, 17, 21, 22])
def test_lzx_window_bits_as_tpu7z(window_bits):
    data = text(20000, 14)
    comp = same(jlzx.encode_frame, tlzx.encode_frame, data, window_bits)
    if comp[0] != "ok":
        return
    st_j, st_t = jlzx.State(window_bits), tlzx.State(window_bits)
    out_j, out_t = bytearray(), bytearray()
    jlzx.decode_frame(st_j, comp[1], out_j, len(data))
    tlzx.decode_frame(st_t, comp[1], out_t, len(data))
    assert out_j == out_t == data


@pytest.mark.parametrize("window_bits", [14, 26, 0])
def test_lzx_bad_window_bits_as_tpu7z(window_bits):
    assert same(jlzx.State, tlzx.State, window_bits) == \
        ("CorruptError", f"lzx: window bits {window_bits}")


def test_lzx_e8_translation_as_tpu7z():
    """A frame of x86 calls (E8 and a 32-bit offset): the encoder's header
    bit turns on the decoder's E8 filter, as the cab reader runs it."""
    data = b"".join(b"\x55\xe8" + struct.pack("<i", 1000 + 37 * i) + b"\x90" * 9
                    for i in range(2000))[:32768]
    comp = same(jlzx.encode_frame, tlzx.encode_frame, data, 16)[1]
    outs = []
    for mod in (jlzx, tlzx):
        st = mod.State(16)
        buf = bytearray()
        mod.decode_frame(st, comp, buf, len(data))
        mod._e8_filter(buf, 0, len(data), st.e8_size)
        outs.append(bytes(buf))
    assert outs[0] == outs[1] == data


@pytest.mark.parametrize("where", ["header", "middle", "cut"])
def test_lzx_corrupt_streams_as_tpu7z(where):
    data = text(30000, 15)
    comp, offs = jlzx.encode_frames(data, 16)
    bad = {"header": flipped(comp, 0), "middle": flipped(comp, len(comp) // 2),
           "cut": comp[:len(comp) // 3]}[where]
    same(jlzx.decode_frames, tlzx.decode_frames, bad, offs, 16, jlzx.FRAME, len(data))


CHM_FILES = {"index.html": b"<html>hello chm</html>" * 300, "data/blob.bin": bytes(range(256)) * 40,
             "rand.bin": noise(9000, 16)}


@pytest.mark.parametrize("kind", list(SIZES))
def test_write_chm_equals_tpu7z(kind):
    files = {**CHM_FILES, "m.bin": SIZES[kind]}
    blob = same(jchm.write_chm, tchm.write_chm, files)[1]
    assert same(jchm.read_chm, tchm.read_chm, blob) == ("ok", files)


def test_write_chm_of_no_files_as_tpu7z():
    blob = same(jchm.write_chm, tchm.write_chm, {})[1]
    same(jchm.read_chm, tchm.read_chm, blob)


def _chm():
    return jchm.write_chm(CHM_FILES)


@pytest.mark.parametrize("case", ["bad_magic", "short", "directory_count", "directory_cut",
                                  "content_byte", "truncated"])
def test_corrupt_chm_as_tpu7z(case):
    blob = _chm()
    _s0o, _s0l, dir_off, _dl = struct.unpack_from("<QQQQ", blob, 0x38)
    if case == "directory_count":
        bad = bytearray(blob)
        struct.pack_into("<I", bad, dir_off + 0x2C, 0xFFFFFFFF)
        bad = bytes(bad)
    else:
        bad = {"bad_magic": b"ITSG" + blob[4:], "short": blob[:40],
               "directory_cut": blob[:dir_off + 0x30], "content_byte": flipped(blob, len(blob) - 300),
               "truncated": blob[:len(blob) - 500]}[case]
    kind = same(jchm.read_chm, tchm.read_chm, bad)[0]
    assert kind != "ok" or case in ("content_byte", "directory_cut")
