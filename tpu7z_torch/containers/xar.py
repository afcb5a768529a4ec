"""XAR container: reader (+ minimal writer used for fixtures).

A copy of tpu7z/containers/xar.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/XarHandler.cpp — 28-byte
big-endian header {magic "xar!", headerSize u16, version u16, TOC
packed/unpacked u64 sizes, checksum algo u32} (:588-609), zlib-deflated
XML table of contents, then the heap; <file> elements carry nested
<file> children for directories and a <data> element with heap offset/
length/size and an encoding style where application/x-gzip means zlib
(:440-500).
"""

from __future__ import annotations

import struct
import zlib
import xml.etree.ElementTree as ET

from ..utils.errors import CorruptError, UnsupportedError

MAGIC = b"xar!"


def read_xar(raw: bytes, *, device=None) -> dict:
    """The archive's files; a bzip2 entry's inverse BWT runs on `device`
    (the card unless it names the CPU)."""
    if raw[:4] != MAGIC:
        raise CorruptError("xar: bad magic")
    header_size, version = struct.unpack_from(">HH", raw, 4)
    toc_packed, toc_size = struct.unpack_from(">QQ", raw, 8)
    if header_size < 28 or version > 1:
        raise CorruptError("xar: bad header")
    try:
        toc_xml = zlib.decompress(raw[header_size:header_size + toc_packed])
    except zlib.error as e:
        raise CorruptError(f"xar: toc inflate failed: {e}") from None
    if len(toc_xml) != toc_size:
        raise CorruptError("xar: toc size mismatch")
    heap = header_size + toc_packed
    try:
        root = ET.fromstring(toc_xml)
    except ET.ParseError as e:
        raise CorruptError(f"xar: bad toc xml: {e}") from None
    toc = root.find("toc")
    if root.tag != "xar" or toc is None:
        raise CorruptError("xar: bad toc structure")

    files: dict = {}

    def walk(elem, prefix: str):
        for f in elem.findall("file"):
            name = f.findtext("name", "")
            ftype = f.findtext("type", "file")
            path = f"{prefix}{name}"
            if ftype == "directory":
                walk(f, path + "/")
                continue
            data = f.find("data")
            if data is None:
                files[path] = b""
                continue
            offset = int(data.findtext("offset", "0"))
            length = int(data.findtext("length", "0"))
            size = int(data.findtext("size", "0"))
            enc = data.find("encoding")
            style = enc.get("style", "") if enc is not None else ""
            blob = raw[heap + offset:heap + offset + length]
            if len(blob) != length:
                raise CorruptError("xar: truncated heap data")
            if style in ("application/x-gzip", "application/zlib"):
                content = zlib.decompress(blob)
            elif style in ("", "application/octet-stream"):
                content = blob
            elif style == "application/x-bzip2":
                from ..models import bzip2
                content = bzip2.decompress(blob, device=device)
            else:
                raise UnsupportedError(f"xar: encoding {style}")
            if len(content) != size:
                raise CorruptError("xar: extracted size mismatch")
            files[path] = content

    walk(toc, "")
    return files


def write_xar(files: dict) -> bytes:
    heap = bytearray()
    entries = []
    for fid, name in enumerate(sorted(files), 1):
        content = files[name]
        comp = zlib.compress(content, 9)
        offset = len(heap)
        heap += comp
        entries.append((fid, name, offset, len(comp), len(content)))

    toc_items = []
    for fid, name, offset, length, size in entries:
        toc_items.append(
            f'<file id="{fid}"><name>{name}</name><type>file</type>'
            f"<data><offset>{offset}</offset><length>{length}</length>"
            f"<size>{size}</size>"
            f'<encoding style="application/x-gzip"/></data></file>')
    toc_xml = ("<?xml version=\"1.0\" encoding=\"UTF-8\"?>"
               f"<xar><toc>{''.join(toc_items)}</toc></xar>").encode()
    toc_comp = zlib.compress(toc_xml, 9)
    hdr = MAGIC + struct.pack(">HHQQI", 28, 1, len(toc_comp),
                              len(toc_xml), 0)  # cksum NONE
    return hdr + toc_comp + bytes(heap)
