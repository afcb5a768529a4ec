"""The port's .7z container (`tpu7z_torch.containers.sevenzip`) against
tpu7z's on the CPU: `write_archive` gives tpu7z's archive bytes for every
method the port has, solid and not, with empty files, directory and
non-ASCII names, at levels 1, 5 and 9, with a password and with the
header encrypted (the IV fixed by patching `os.urandom` in both); each
reader reads the other's archives; `update_archive` keeps, deletes,
replaces and adds as tpu7z does; corruptions, truncation and passwords
raise tpu7z's error classes; and folders tpu7z's writer never emits
(LZMA, Delta, the branch filters, swap4, a filter chained to LZMA2),
built with tpu7z's own `_build_header` and `_write_folder`, read the
same. tpu7z's AES encrypt is a Python loop (about 5 KB/s), so encrypted
cases carry a few hundred packed bytes."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.containers.sevenzip import SevenZipReader as JReader  # noqa: E402
from tpu7z.containers.sevenzip import format as JF  # noqa: E402
from tpu7z.containers.sevenzip import writer as jw  # noqa: E402
from tpu7z.models.filters import bcj as jbcj  # noqa: E402
from tpu7z.models.filters import delta as jdelta  # noqa: E402
from tpu7z.models.lzma import encoder as jlzma  # noqa: E402
from tpu7z.models.lzma import lzma2 as jlzma2  # noqa: E402
from tpu7z_torch.containers.sevenzip import SevenZipReader, write_archive  # noqa: E402
from tpu7z_torch.containers.sevenzip import writer as tw  # noqa: E402

IV = bytes(range(0x30, 0x40))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _fixed_iv(monkeypatch):
    """Both writers draw their IVs from os.urandom(16)."""
    monkeypatch.setattr(os, "urandom", lambda n: IV[:n])


def _files(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    text = b"the quick brown fox jumps over the lazy dog " * 90
    return {
        "a.txt": text,
        "dir/sub/b.bin": rng.integers(0, 256, 1500, np.uint8).tobytes(),
        "empty.txt": b"",
        "ünïcødé/名前.txt": text[:700] + bytes(rng.integers(0, 4, 600, np.uint8)),
        "x86.bin": bytes(rng.integers(0, 256, 900, np.uint8)).replace(b"\x01", b"\xe8"),
    }


def _read(reader, data, password=None):
    return reader(data, password=password, **({"device": "cpu"} if reader is SevenZipReader
                                             else {})).extract_all()


def _both_read(archive_j, archive_t, files, password=None):
    assert _read(SevenZipReader, archive_j, password) == files
    assert _read(JReader, archive_t, password) == files


@pytest.mark.parametrize("level", [1, 5, 9])
@pytest.mark.parametrize("solid", [True, False], ids=["solid", "non_solid"])
@pytest.mark.parametrize("method", ["copy", "lzma2", "zstd", "lz4", "bcj2", "deflate", "bzip2",
                                    "brotli", "ppmd"])
def test_write_archive_equals_tpu7z(method, solid, level):
    files = _files(level)
    want = jw.write_archive(files, method=method, level=level, solid=solid)
    got = write_archive(files, method=method, level=level, solid=solid, device="cpu")
    assert got == want
    _both_read(want, got, files)


@pytest.mark.parametrize("encrypt_header", [False, True], ids=["data", "header_too"])
@pytest.mark.parametrize("method", ["copy", "lzma2", "zstd", "lz4", "brotli", "ppmd"])
def test_encrypted_archive_equals_tpu7z(method, encrypt_header):
    files = {"a.txt": _files()["a.txt"][:600], "d/ü.bin": b"\x00\x01" * 40, "e": b""}
    kw = dict(method=method, password="pässwörd", encrypt_header=encrypt_header)
    want = jw.write_archive(files, **kw)
    got = write_archive(files, device="cpu", **kw)
    assert got == want
    _both_read(want, got, files, password="pässwörd")


def test_encrypted_non_solid_equals_tpu7z():
    files = {"a": b"first file " * 20, "b": b"second file " * 20}
    want = jw.write_archive(files, method="lzma2", solid=False, password="pw")
    assert write_archive(files, solid=False, password="pw", device="cpu") == want
    _both_read(want, want, files, password="pw")


@pytest.mark.parametrize("files", [{}, {"only_empty": b""}, {"d/x": b"", "e": b""},
                                   {"one": b"a single byte stream"}],
                         ids=["nothing", "one_empty", "two_empty", "one_file"])
def test_edge_file_sets_equal_tpu7z(files):
    want = jw.write_archive(files)
    got = write_archive(files, device="cpu")
    assert got == want
    _both_read(want, got, files)


def test_errors_of_the_writer_as_tpu7z():
    from tpu7z.utils.errors import ParamError as JParam
    from tpu7z_torch.utils.errors import ParamError
    files = {"a": b"abc"}
    with pytest.raises(JParam):
        jw.write_archive(files, method="bcj2", password="pw")
    with pytest.raises(ParamError):
        write_archive(files, method="bcj2", password="pw", device="cpu")
    with pytest.raises(JParam):
        jw.write_archive(files, encrypt_header=True)
    with pytest.raises(ParamError):
        write_archive(files, encrypt_header=True, device="cpu")
    with pytest.raises(ParamError, match="unknown method lzma"):
        write_archive(files, method="lzma", device="cpu")


def test_brotli_folder_props_name_the_level_as_tpu7z():
    """tpu7z writes the level into a brotli folder's props but compresses
    at quality 9 whatever it is; the port writes the same bytes, and
    each reader reads them."""
    files = {"a.txt": b"some text to pack " * 300}
    want = {lv: jw.write_archive(files, method="brotli", level=lv) for lv in (1, 14)}
    for lv, archive in want.items():
        assert write_archive(files, method="brotli", level=lv, device="cpu") == archive
        assert _read(SevenZipReader, archive) == files
    # the folders differ in their props only (level 14 is written as 11)
    assert want[1] != want[14]
    assert len(want[1]) == len(want[14])


@pytest.mark.parametrize("order,mem", [(2, 1 << 20), (6, 1 << 24), (16, 1 << 20), (64, 1 << 24)],
                         ids=["o2_1m", "o6_16m", "o16_1m", "o64_16m"])
def test_ppmd_folders_of_any_props_read_as_tpu7z(order, mem):
    """tpu7z's writer takes order 6 and 16 MiB; both readers take a
    PPMd folder of any order and memory size from its props."""
    import zlib
    from tpu7z.models.ppmd import ppmd7 as jppmd7
    files = {"a.txt": b"some text to pack " * 30 + _data(order, 700)}
    packed, props = jppmd7.compress(files["a.txt"], order=order, mem=mem)
    arc = _archive([_single(JF.M_PPMD, props, packed, len(files["a.txt"]),
                            zlib.crc32(files["a.txt"]))], [packed], ["a.txt"], files)
    assert _read(JReader, arc) == files
    assert _read(SevenZipReader, arc) == files


@pytest.mark.parametrize("solid", [True, False], ids=["solid", "non_solid"])
def test_update_of_ppmd_archives_equals_tpu7z(solid):
    files = _files(4)
    old = jw.write_archive(files, method="ppmd", solid=solid)
    add, delete = {"x86.bin": b"replaced content " * 10, "new/n.txt": b"a new file"}, ["a.txt"]
    for method in ("ppmd", "lzma2"):
        want = jw.update_archive(old, add=add, delete=delete, method=method)
        got = tw.update_archive(old, add=add, delete=delete, method=method, device="cpu")
        assert got == want
        expect = {k: v for k, v in files.items() if k not in delete}
        expect.update(add)
        _both_read(want, got, expect)


@pytest.mark.parametrize("at", ["first", "quarter", "middle"])
def test_corrupt_ppmd_folder_raises_tpu7z_class(at):
    """A flipped byte in a PPMd stream: the file's CRC fails in both
    readers alike (the coder's last bytes may not change the output, so
    none is flipped there)."""
    files = {"a.txt": _files()["a.txt"]}
    arc = bytearray(jw.write_archive(files, method="ppmd"))
    packed_len = int.from_bytes(arc[12:20], "little")
    pos = 32 + {"first": 0, "quarter": packed_len // 4, "middle": packed_len // 2}[at]
    arc[pos] ^= 0x5A
    ref, port = _error_classes(bytes(arc))
    assert ref == port and ref is not None


# --- update_archive ---------------------------------------------------------

@pytest.mark.parametrize("change", ["keep", "delete", "replace", "add", "all"])
def test_update_archive_equals_tpu7z(change):
    files = _files(3)
    old_solid = jw.write_archive(files, solid=True)
    old_loose = jw.write_archive(files, method="zstd", solid=False)
    add, delete = {}, []
    if change in ("delete", "all"):
        delete = ["a.txt", "empty.txt"]
    if change in ("replace", "all"):
        add["x86.bin"] = b"replaced content " * 10
    if change in ("add", "all"):
        add.update({"new/file.txt": b"a new file", "new/empty": b""})
    for old in (old_solid, old_loose):
        for method in ("lzma2", "zstd"):
            want = jw.update_archive(old, add=add, delete=delete, method=method)
            got = tw.update_archive(old, add=add, delete=delete, method=method,
                                    device="cpu")
            assert got == want
            expect = {k: v for k, v in files.items() if k not in delete}
            expect.update(add)
            _both_read(want, got, expect)


# --- corruption and passwords -------------------------------------------------

def _error_classes(data, password=None):
    """The class names each reader raises on `data`, or None."""
    names = []
    for reader in (JReader, SevenZipReader):
        try:
            _read(reader, data, password)
            names.append(None)
        except Exception as exc:  # noqa: BLE001 - the class is what is compared
            names.append(type(exc).__name__)
    return names


def _reseal(arc: bytes, header_start: int) -> bytes:
    """Recompute the next-header and start-header CRCs after an edit."""
    import zlib
    arc = bytearray(arc)
    arc[28:32] = zlib.crc32(bytes(arc[header_start:])).to_bytes(4, "little")
    arc[8:12] = zlib.crc32(bytes(arc[12:32])).to_bytes(4, "little")
    return bytes(arc)


def _corrupt(kind: str):
    files = {"a.txt": b"hello, corruption " * 30, "b.txt": b"more text " * 20}
    arc = bytearray(jw.write_archive(files, method="copy"))
    nh_off = int.from_bytes(arc[12:20], "little")
    if kind == "start_header":
        arc[14] ^= 0x01
    elif kind == "next_header":
        arc[32 + nh_off + 3] ^= 0x01
    elif kind == "file_crc":
        arc[40] ^= 0x01
    elif kind == "truncated":
        arc = arc[:-5]
    elif kind == "signature":
        arc[0] = ord("8")
    elif kind == "folder_crc":
        # the encoded header's folder CRC: the kEncodedHeader's last u32
        arc = bytearray(jw.write_archive(files, password="pw", encrypt_header=True))
        nh_off = int.from_bytes(arc[12:20], "little")
        arc[-6] ^= 0x01
        return _reseal(bytes(arc), 32 + nh_off), "pw"
    return bytes(arc), None


@pytest.mark.parametrize("kind", ["start_header", "next_header", "file_crc", "truncated",
                                  "signature", "folder_crc"])
def test_corruption_raises_tpu7z_class(kind):
    data, password = _corrupt(kind)
    ref, port = _error_classes(data, password)
    assert ref == port == "CorruptError"


@pytest.mark.parametrize("encrypt_header", [False, True], ids=["data", "header_too"])
@pytest.mark.parametrize("password", [None, "wrong"], ids=["missing", "wrong"])
def test_password_errors_as_tpu7z(password, encrypt_header):
    files = {"a.txt": b"secret text " * 40}
    arc = jw.write_archive(files, password="right", encrypt_header=encrypt_header)
    ref, port = _error_classes(arc, password)
    assert ref == port
    assert ref == ("UnsupportedError" if password is None else "CorruptError")


def test_sfx_stub_is_skipped():
    files = {"a.txt": b"inside an sfx " * 10}
    arc = b"MZ" + b"\x90" * 3000 + jw.write_archive(files)
    assert _read(SevenZipReader, arc) == _read(JReader, arc) == files


def test_reader_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        SevenZipReader(jw.write_archive({"a": b"x"}))
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        write_archive({"a": b"x"})


# --- folders tpu7z's writer never emits ---------------------------------------

def _data(seed: int, n: int = 3001) -> bytes:
    """Bytes with branch opcodes planted at aligned and odd places."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, n, dtype=np.uint8)
    b[3::4][rng.random(b[3::4].size) < 0.2] = 0xEB     # ARM BL
    b[::4][rng.random(b[::4].size) < 0.2] = 0x94       # ARM64 BL (LE top byte at +3)
    b[3::4][rng.random(b[3::4].size) < 0.1] = 0x94
    b[::4][rng.random(b[::4].size) < 0.2] = 0x48       # PPC bl (BE)
    b[::4][rng.random(b[::4].size) < 0.2] = 0x40       # SPARC call (BE)
    b[1::2][rng.random(b[1::2].size) < 0.2] = 0xF0     # Thumb BL pairs
    b[rng.random(n) < 0.05] = 0xE8                     # x86 call
    return b.tobytes()


def _single(mid, props, packed, size, crc):
    return {"coders": [(mid, props, 1, 1)], "bind": [], "packed_indices": [0],
            "sizes": [size], "crc": crc}


def _archive(folders, pack_streams, names, files):
    """A .7z around the given folders, one file each, by tpu7z's
    `_build_header` and `_write_folder` and its start-header layout."""
    from tpu7z.containers.sevenzip.format import ByteWriter
    import zlib
    header = jw._build_header(names, files, [], folders, pack_streams, [1] * len(names),
                              [len(files[n]) for n in names],
                              [zlib.crc32(files[n]) for n in names])
    packed_all = b"".join(pack_streams)
    start = ByteWriter()
    start.u64(len(packed_all))
    start.u64(len(header))
    start.u32(zlib.crc32(header))
    sh = start.getvalue()
    return JF.SIGNATURE + bytes([0, 4]) + zlib.crc32(sh).to_bytes(4, "little") + sh \
        + packed_all + header


FILTER_FOLDERS = {
    # name: (method ID, props, encoder)
    "delta1": (JF.M_DELTA, bytes([0]), lambda d: jdelta.delta_encode(d, 1)),
    "delta4": (JF.M_DELTA, bytes([3]), lambda d: jdelta.delta_encode(d, 4)),
    "delta256": (JF.M_DELTA, bytes([255]), lambda d: jdelta.delta_encode(d, 256)),
    "bcj_x86": (JF.M_BCJ, b"", jbcj.bcj_x86_encode),
    "bcj_x86_alias": (JF.M_BCJ_X86, b"", jbcj.bcj_x86_encode),
    "arm": (JF.M_ARM, b"", jbcj.bcj_arm_encode),
    "arm64": (JF.M_ARM64, b"", jbcj.bcj_arm64_encode),
    "armt": (JF.M_ARMT, b"", jbcj.bcj_armt_encode),
    "ppc": (JF.M_PPC, b"", jbcj.bcj_ppc_encode),
    "sparc": (JF.M_SPARC, b"", jbcj.bcj_sparc_encode),
    "ia64": (JF.M_IA64, b"", jbcj.bcj_ia64_encode),
    "riscv": (JF.M_RISCV, b"", jbcj.bcj_riscv_encode),
    "swap2": (JF.M_SWAP2, b"", jbcj.swap2),
    "swap4": (JF.M_SWAP4, b"", jbcj.swap4),
}


@pytest.mark.parametrize("name", sorted(FILTER_FOLDERS))
def test_filter_folders_read_as_tpu7z(name):
    import zlib
    mid, props, enc = FILTER_FOLDERS[name]
    names = ["f0", "f1"]
    files = {"f0": _data(len(name)), "f1": _data(7, 1023)}
    folders, packs = [], []
    for n in names:
        packed = enc(files[n])
        packs.append(packed)
        folders.append(_single(mid, props, packed, len(files[n]), zlib.crc32(files[n])))
    arc = _archive(folders, packs, names, files)
    assert _read(JReader, arc) == files
    assert _read(SevenZipReader, arc) == files


@pytest.mark.parametrize("name", ["bcj_x86", "arm64", "delta4"])
def test_filter_chained_to_lzma2_reads_as_tpu7z(name):
    """[filter <- LZMA2 <- pack]: the filter's input bound to LZMA2's output."""
    import zlib
    mid, props, enc = FILTER_FOLDERS[name]
    files = {"exe": _data(11, 5000)}
    packed = jlzma2.compress(enc(files["exe"]))
    folder = {"coders": [(mid, props, 1, 1), (JF.M_LZMA2, bytes([24]), 1, 1)],
              "bind": [(0, 1)], "packed_indices": [1],
              "sizes": [len(files["exe"]), len(enc(files["exe"]))],
              "crc": zlib.crc32(files["exe"])}
    arc = _archive([folder], [packed], ["exe"], files)
    assert _read(JReader, arc) == files
    assert _read(SevenZipReader, arc) == files


def test_deflate64_folder_reads_as_tpu7z():
    """tpu7z writes no Deflate64; a folder of a stream whose match uses
    symbol 285's 16 extra bits and distance code 30."""
    import zlib
    from tpu7z.models.deflate import codec as jdef
    head = _data(3, 33000)
    w = jdef._LSBWriter()
    w.write(1, 1)
    w.write(1, 2)
    codes = jdef._canonical_codes(jdef._FIXED_LIT_LEN)

    def sym(s):
        n = int(jdef._FIXED_LIT_LEN[s])
        w.write(jdef._rev_bits(int(codes[s]), n), n)

    for b in head:
        sym(b)
    sym(285)
    w.write(1000 - 3, 16)
    w.write(jdef._rev_bits(30, 5), 5)
    w.write(33000 - 32769, 14)
    sym(256)
    packed = w.close()
    files = {"d64": head + head[:1000]}
    folder = _single(JF.M_DEFLATE64, b"", packed, len(files["d64"]), zlib.crc32(files["d64"]))
    arc = _archive([folder], [packed], ["d64"], files)
    assert _read(JReader, arc) == files
    assert _read(SevenZipReader, arc) == files


def test_lzma_folder_reads_as_tpu7z():
    import zlib
    files = {"a": _files()["a.txt"], "b": _data(5, 2000)}
    folders, packs = [], []
    for n in ("a", "b"):
        stream, props = jlzma.compress_raw(files[n])
        packs.append(stream)
        folders.append(_single(JF.M_LZMA, props, stream, len(files[n]), zlib.crc32(files[n])))
    arc = _archive(folders, packs, ["a", "b"], files)
    assert _read(JReader, arc) == files
    assert _read(SevenZipReader, arc) == files
