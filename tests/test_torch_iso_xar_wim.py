"""The port's iso, xar and wim (tpu7z_torch/containers/{iso,xar,wim}.py)
against tpu7z's: the same image bytes from the same files, the same
files from each image (a xar's bzip2 entries through the port's bzip2,
its inverse BWT on the CPU here), and the same errors for corrupt and
unsupported images."""

import bz2
import struct
import zlib

import pytest

from tests.torch_parity import flipped, noise, same, text
from tpu7z.containers import iso as jiso
from tpu7z.containers import wim as jwim
from tpu7z.containers import xar as jxar
from tpu7z_torch.containers import iso as tiso
from tpu7z_torch.containers import wim as twim
from tpu7z_torch.containers import xar as txar

FILES = {
    "hello.txt": text(5000, 1),
    "data.bin": noise(5000, 2),
    "big.dat": text(90000, 3),
    "empty": b"",
}
NESTED = {"a.txt": text(5000, 4), "sub/b.bin": noise(3000, 5), "sub/deep/c": b"x",
          "empty/": b"", "sub/e.txt": b""}


@pytest.mark.parametrize("files", [FILES, {f"f{i:03d}.bin": bytes([i]) * (i * 37 + 1)
                                           for i in range(40)}], ids=["files", "forty"])
def test_iso_equals_tpu7z(files):
    img = same(jiso.write_iso, tiso.write_iso, files)[1]
    assert same(jiso.read_iso, tiso.read_iso, img)[1] == {k.upper(): v for k, v in files.items()}
    assert same(jiso.write_iso, tiso.write_iso, files, volume_id="OTHER")[0] == "ok"


def _xar(entries):
    """A xar of (name, stored bytes, size, encoding style) entries: the
    layout of tpu7z's write_xar, with the encoding chosen."""
    heap, items = bytearray(), []
    for fid, (name, blob, size, style) in enumerate(entries, 1):
        items.append(f'<file id="{fid}"><name>{name}</name><type>file</type>'
                     f"<data><offset>{len(heap)}</offset><length>{len(blob)}</length>"
                     f'<size>{size}</size><encoding style="{style}"/></data></file>')
        heap += blob
    items.append('<file id="99"><name>dir</name><type>directory</type>'
                 '<file id="100"><name>inner</name><type>file</type></file></file>')
    toc = ('<?xml version="1.0" encoding="UTF-8"?>'
           f"<xar><toc>{''.join(items)}</toc></xar>").encode()
    packed = zlib.compress(toc, 9)
    return b"xar!" + struct.pack(">HHQQI", 28, 1, len(packed), len(toc), 0) + packed + heap


def test_xar_writer_equals_tpu7z():
    blob = same(jxar.write_xar, txar.write_xar, FILES)[1]
    assert same(jxar.read_xar, txar.read_xar, blob, port_kw={"device": "cpu"}) == ("ok", FILES)


@pytest.mark.parametrize("style", ["application/x-bzip2", "application/zlib",
                                   "application/octet-stream", ""])
def test_xar_encodings_read_as_tpu7z(style):
    content = text(30000, 6)
    stored = {"application/x-bzip2": bz2.compress(content, 9),
              "application/zlib": zlib.compress(content)}.get(style, content)
    blob = _xar([("one.txt", stored, len(content), style), ("two", b"", 0, "")])
    got = same(jxar.read_xar, txar.read_xar, blob, port_kw={"device": "cpu"})
    assert got == ("ok", {"one.txt": content, "two": b"", "dir/inner": b""})


@pytest.mark.parametrize("case,error", [
    ("magic", "CorruptError"), ("header", "CorruptError"), ("toc", "CorruptError"),
    ("heap", "CorruptError"), ("size", "CorruptError"), ("encoding", "UnsupportedError"),
    ("bzip2", "CorruptError")])
def test_xar_corrupt_and_unsupported_as_tpu7z(case, error):
    content = text(4000, 7)
    bad = {"magic": lambda: flipped(txar.write_xar(FILES), 0),
           "header": lambda: flipped(txar.write_xar(FILES), 7, 0x04),
           "toc": lambda: flipped(txar.write_xar(FILES), 40),
           "heap": lambda: txar.write_xar(FILES)[:-100],
           "size": lambda: _xar([("a", content, len(content) + 1, "")]),
           "encoding": lambda: _xar([("a", content, len(content), "application/x-lzma")]),
           "bzip2": lambda: _xar([("a", flipped(bz2.compress(content), 20), len(content),
                                   "application/x-bzip2")])}[case]()
    assert same(jxar.read_xar, txar.read_xar, bad, port_kw={"device": "cpu"})[0] == error


@pytest.mark.parametrize("files", [FILES, NESTED], ids=["flat", "nested"])
def test_wim_equals_tpu7z(files):
    blob = same(jwim.write_wim, twim.write_wim, files)[1]
    got = same(jwim.read_wim, twim.read_wim, blob)
    assert got[0] == "ok" and all(got[1][k] == v for k, v in files.items())


@pytest.mark.parametrize("case,error", [
    ("magic", "CorruptError"), ("lookup_compressed", "UnsupportedError"),
    ("lookup_bounds", "CorruptError"), ("truncated", "CorruptError")])
def test_wim_corrupt_and_unsupported_as_tpu7z(case, error):
    blob = twim.write_wim(NESTED)
    bad = {"magic": lambda: flipped(blob, 0),
           "lookup_compressed": lambda: flipped(blob, 48 + 7, 0x04),
           "lookup_bounds": lambda: blob[:48] + b"\xff" * 7 + blob[55:],
           "truncated": lambda: blob[:len(blob) // 2]}[case]()
    assert same(jwim.read_wim, twim.read_wim, bad)[0] == error


@pytest.mark.parametrize("case", ["signature", "no_pvd", "root"])
def test_iso_corrupt_as_tpu7z(case):
    img = tiso.write_iso(FILES)
    pvd = 16 * 2048
    bad = {"signature": lambda: flipped(img, pvd + 1),
           "no_pvd": lambda: img[:pvd] + b"\xff" + img[pvd + 1:],
           "root": lambda: img[:pvd + 156 + 25] + b"\x00" + img[pvd + 156 + 26:]}[case]()
    assert same(jiso.read_iso, tiso.read_iso, bad)[0] == "CorruptError"
