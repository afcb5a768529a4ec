"""The port's .zip, .tar and gzip (tpu7z_torch/containers/zip.py, tar.py,
models/deflate gzip_compress and gzip_decompress) against tpu7z's on the
CPU: every archive and member byte for byte, for each .zip method the
port writes, ZIP64 forced, stored fallbacks, empty and non-ASCII names,
tar names over 100 bytes; zipfile, tarfile and zlib read the port's, and
the port reads theirs, including a .gz with FEXTRA, FNAME, FCOMMENT and
FHCRC and a Deflate64 .zip entry built here; corrupt and refused inputs
raise tpu7z's error classes. Inputs are made from seeds; the corpus past
its sparse first 696156 bytes. Everything compared is bytes, so equality
is exact."""

import io
import struct
import tarfile
import zipfile
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.containers import tar as jtar  # noqa: E402
from tpu7z.containers import zip as jzip  # noqa: E402
from tpu7z.models.deflate import codec as jdef  # noqa: E402
from tpu7z_torch.containers import tar as ttar  # noqa: E402
from tpu7z_torch.containers import zip as tzip  # noqa: E402
from tpu7z_torch.models.deflate import codec as tdef  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

TEXT = 696156            # the corpus's first byte past its sparse chunk
# the methods the port writes, and those zipfile reads
WRITTEN = {"store": 0, "deflate": 8, "bzip2": 12, "lzma": 14, "zstd": 93, "xz": 95, "ppmd": 98}
ZIPFILE_READS = (0, 8, 12, 14)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(TEXT + (300 << 10))[TEXT:]


@pytest.fixture(scope="module")
def files(corpus):
    rng = np.random.default_rng(7)
    return {
        "text.txt": corpus[:40000],
        "dir/sub/random.bin": rng.integers(0, 256, 3000, np.uint8).tobytes(),
        "empty": b"",
        "ünïcødé/名前.txt": corpus[50000:52000],
        "one": b"z",
    }


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as exc:  # noqa: BLE001 - the class is what is compared
        return ("raises", type(exc).__name__)


def _zipfile_read(data):
    with zipfile.ZipFile(io.BytesIO(data)) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("zip64", [False, True], ids=["zip32", "zip64"])
@pytest.mark.parametrize("method", sorted(WRITTEN))
def test_write_zip_equals_tpu7z(files, method, zip64):
    mid = WRITTEN[method]
    got = tzip.write_zip(files, method=mid, zip64=zip64, device="cpu")
    assert got == jzip.write_zip(files, method=mid, zip64=zip64)
    assert tzip.read_zip(got, device="cpu") == files
    if mid in ZIPFILE_READS:
        assert _zipfile_read(got) == files


@pytest.mark.parametrize("level", [1, 9, 22])
def test_write_zip_levels_equal_tpu7z(files, level):
    for mid in (12, 93):
        assert tzip.write_zip(files, method=mid, level=level, device="cpu") == \
            jzip.write_zip(files, method=mid, level=level)


def test_random_entries_fall_back_to_store_as_tpu7z():
    data = {"r.bin": np.random.default_rng(1).integers(0, 256, 5000, np.uint8).tobytes()}
    got = tzip.write_zip(data, device="cpu")
    assert got == jzip.write_zip(data)
    with zipfile.ZipFile(io.BytesIO(got)) as zf:
        assert zf.infolist()[0].compress_type == zipfile.ZIP_STORED


@pytest.mark.parametrize("compression", [zipfile.ZIP_STORED, zipfile.ZIP_DEFLATED,
                                         zipfile.ZIP_BZIP2, zipfile.ZIP_LZMA],
                         ids=["stored", "deflated", "bzip2", "lzma"])
def test_read_zip_reads_zipfile_as_tpu7z(files, compression):
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", compression) as zf:
        for name, data in files.items():
            zf.writestr(name, data)
    data = buf.getvalue()
    assert tzip.read_zip(data, device="cpu") == jzip.read_zip(data) == files


def test_read_zip_reads_a_deflate64_entry_as_tpu7z(corpus):
    """Method 9: a stream built with symbol 285's 16 extra bits."""
    content = corpus[:3000] + corpus[:3000]
    w = jdef._LSBWriter()
    w.write(1, 1)
    w.write(1, 2)
    codes = jdef._canonical_codes(jdef._FIXED_LIT_LEN)

    def sym(s):
        n = int(jdef._FIXED_LIT_LEN[s])
        w.write(jdef._rev_bits(int(codes[s]), n), n)

    for b in corpus[:3000]:
        sym(b)
    sym(285)
    w.write(3000 - 3, 16)
    dc = int(np.searchsorted(jdef.DIST_BASE64, 3000, side="right") - 1)
    w.write(jdef._rev_bits(dc, 5), 5)
    w.write(3000 - int(jdef.DIST_BASE64[dc]), int(jdef.DIST_EXTRA64[dc]))
    sym(256)
    comp = w.close()
    name = b"d64.bin"
    crc = zlib.crc32(content)
    local = struct.pack("<IHHHHHIIIHH", 0x04034B50, 21, 0, 9, 0, 0, crc, len(comp),
                        len(content), len(name), 0) + name + comp
    central = struct.pack("<IHHHHHHIIIHHHHHII", 0x02014B50, 21, 21, 0, 9, 0, 0, crc,
                          len(comp), len(content), len(name), 0, 0, 0, 0, 0, 0) + name
    eocd = struct.pack("<IHHHHIIH", 0x06054B50, 0, 0, 1, 1, len(central), len(local), 0)
    arc = local + central + eocd
    assert tzip.read_zip(arc, device="cpu") == jzip.read_zip(arc) == {"d64.bin": content}


def test_ppmd_entries_read_as_tpu7z(monkeypatch):
    """Method-98 entries of other orders, memory sizes and restore
    methods than the writer's (order 8, 16 MiB, restart), made by
    tpu7z's writer with its PPMd var.I so set: both readers give the
    same files."""
    from tpu7z.models.ppmd import ppmd8 as jppmd8
    data = {"a.txt": b"some text to pack " * 40, "b.bin": bytes(range(256)) * 3}
    usual = jzip.write_zip(data, method=98)
    plain, params = jppmd8.compress, iter([(2, 1, 1), (16, 3, 0)])
    monkeypatch.setattr(jppmd8, "compress", lambda d: plain(d, *next(params)))
    archive = jzip.write_zip(data, method=98)
    assert archive != usual
    assert tzip.read_zip(archive, device="cpu") == jzip.read_zip(archive) == data


def _zip_corruptions(archive):
    cases = [archive[:-30], archive[:10], b"PK" + bytes(40)]
    for at in (40, len(archive) // 2, len(archive) - 60):
        bad = bytearray(archive)
        bad[at] ^= 0x11
        cases.append(bytes(bad))
    return cases


@pytest.mark.parametrize("method", ["store", "deflate", "bzip2", "ppmd"])
def test_corrupt_zip_raises_as_tpu7z(files, method):
    archive = jzip.write_zip(files, method=WRITTEN[method])
    for bad in _zip_corruptions(archive):
        assert _outcome(tzip.read_zip, bad, device="cpu") == _outcome(jzip.read_zip, bad)


def test_unknown_method_raises_as_tpu7z(files):
    assert _outcome(tzip.write_zip, files, method=77, device="cpu") == \
        _outcome(jzip.write_zip, files, method=77)


# --- tar -----------------------------------------------------------------------

LONG = "d" * 60 + "/" + "e" * 50 + "/" + "f" * 99


def test_write_tar_equals_tpu7z(files):
    names = dict(files)
    names[LONG] = b"a long name split into prefix and name"
    got = ttar.write_tar(names)
    assert got == jtar.write_tar(names)
    assert ttar.read_tar(got) == jtar.read_tar(got) == names
    with tarfile.open(fileobj=io.BytesIO(got)) as tf:
        assert {m.name: tf.extractfile(m).read() for m in tf.getmembers()} == names


@pytest.mark.parametrize("fmt", [tarfile.USTAR_FORMAT, tarfile.GNU_FORMAT],
                         ids=["ustar", "gnu_longname"])
def test_read_tar_reads_tarfile_as_tpu7z(files, fmt):
    names = dict(files)
    if fmt == tarfile.GNU_FORMAT:
        names["g" * 150] = b"a GNU long name"
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=fmt) as tf:
        for name, data in names.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        d = tarfile.TarInfo("a_directory")
        d.type = tarfile.DIRTYPE
        tf.addfile(d)
    data = buf.getvalue()
    assert ttar.read_tar(data) == jtar.read_tar(data) == names


@pytest.mark.parametrize("name", ["x" * 101, "a/" + "y" * 101, "p" * 160 + "/q"])
def test_tar_names_that_do_not_fit_raise_as_tpu7z(name):
    assert _outcome(ttar.write_tar, {name: b"1"}) == _outcome(jtar.write_tar, {name: b"1"})


def test_corrupt_tar_raises_as_tpu7z(files):
    archive = jtar.write_tar(files)
    bad = bytearray(archive)
    bad[148] ^= 0x01
    for data in (bytes(bad), archive[:700], archive[:100]):
        assert _outcome(ttar.read_tar, data) == _outcome(jtar.read_tar, data)


# --- gzip ----------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1, 15, 4096, 131072, 300 << 10])
def test_gzip_compress_equals_tpu7z(corpus, size):
    data = corpus[:size]
    got = tdef.gzip_compress(data, device="cpu")
    assert got == jdef.gzip_compress(data)
    assert zlib.decompress(got, 31) == data
    assert tdef.gzip_decompress(got) == data


def _member(data, flags, extra=b"\x01\x02AB", name=b"name.txt", comment=b"a comment"):
    """A .gz member with the given header fields, its body from zlib."""
    hdr = bytearray([0x1F, 0x8B, 8, flags, 1, 2, 3, 4, 0, 3])
    if flags & 4:
        hdr += struct.pack("<H", len(extra)) + extra
    if flags & 8:
        hdr += name + b"\x00"
    if flags & 16:
        hdr += comment + b"\x00"
    if flags & 2:
        hdr += struct.pack("<H", zlib.crc32(bytes(hdr)) & 0xFFFF)
    c = zlib.compressobj(6, zlib.DEFLATED, -15)
    return bytes(hdr) + c.compress(data) + c.flush() + struct.pack(
        "<II", zlib.crc32(data), len(data) & 0xFFFFFFFF)


@pytest.mark.parametrize("flags", [0, 4, 8, 16, 2, 4 | 8 | 16 | 2],
                         ids=["plain", "fextra", "fname", "fcomment", "fhcrc", "all"])
def test_gzip_decompress_reads_header_fields_as_tpu7z(corpus, flags):
    data = corpus[:20000]
    member = _member(data, flags)
    assert zlib.decompress(member, 31) == data
    assert tdef.gzip_decompress(member) == jdef.gzip_decompress(member) == data


def test_gzip_decompress_reads_the_standard_library_as_tpu7z(corpus):
    import gzip
    data = corpus[:50000]
    member = gzip.compress(data, 9)
    assert tdef.gzip_decompress(member) == jdef.gzip_decompress(member) == data


def test_corrupt_gzip_raises_as_tpu7z(corpus):
    member = jdef.gzip_compress(corpus[:4000])
    cases = [member[:17], member[:-1], b"\x1f\x8c" + member[2:], _member(b"abc", 8)[:13]]
    for at in (12, len(member) // 2, len(member) - 6, len(member) - 2):
        bad = bytearray(member)
        bad[at] ^= 0x40
        cases.append(bytes(bad))
    for bad in cases:
        assert _outcome(tdef.gzip_decompress, bad) == _outcome(jdef.gzip_decompress, bad)


def test_zip_runs_on_the_card_unless_told(monkeypatch, files):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        tzip.write_zip(files)
    with pytest.raises(RuntimeError, match="runs on a CUDA device"):
        tzip.read_zip(jzip.write_zip(files))
