"""TAR container (ustar, read/write), a copy of tpu7z/containers/tar.py:
the same archive bytes from the same files, on the host.

Behavioral reference: CPP/7zip/Archive/Tar/ — written from the POSIX
ustar specification. Usually stacked under a stream codec
(.tar.zst/.tar.lz4) which is the reference's main use as well.
"""

from __future__ import annotations

from ..utils.errors import CorruptError

BLOCK = 512


def _octal(value: int, width: int) -> bytes:
    s = f"{value:o}".encode()
    return s.rjust(width - 1, b"0")[: width - 1] + b"\x00"


def _read_octal(field: bytes) -> int:
    s = field.rstrip(b"\x00 ").lstrip()
    if not s:
        return 0
    if s[0] & 0x80:  # base-256 extension
        v = 0
        for b in field:
            v = (v << 8) | b
        return v & ((1 << (8 * len(field) - 1)) - 1)
    return int(s, 8)


def write_tar(files: dict[str, bytes]) -> bytes:
    out = bytearray()
    for name, data in files.items():
        nb = name.encode()
        prefix = b""
        if len(nb) > 100:
            cut = nb[:155].rfind(b"/")
            if cut <= 0 or len(nb) - cut - 1 > 100:
                raise CorruptError(f"tar: name too long: {name}")
            prefix, nb = nb[:cut], nb[cut + 1:]
        hdr = bytearray(BLOCK)
        hdr[0:len(nb)] = nb
        hdr[100:108] = _octal(0o644, 8)
        hdr[108:116] = _octal(0, 8)
        hdr[116:124] = _octal(0, 8)
        hdr[124:136] = _octal(len(data), 12)
        hdr[136:148] = _octal(0, 12)
        hdr[148:156] = b" " * 8  # checksum placeholder
        hdr[156] = ord("0")  # regular file
        hdr[257:263] = b"ustar\x00"
        hdr[263:265] = b"00"
        hdr[345:345 + len(prefix)] = prefix
        chk = sum(hdr)
        hdr[148:156] = _octal(chk, 7) + b" "
        out += hdr
        out += data
        pad = (-len(data)) % BLOCK
        out += b"\x00" * pad
    out += b"\x00" * (2 * BLOCK)
    return bytes(out)


def read_tar(data: bytes) -> dict[str, bytes]:
    files: dict[str, bytes] = {}
    pos = 0
    longname = None
    while pos + BLOCK <= len(data):
        hdr = data[pos:pos + BLOCK]
        if hdr == b"\x00" * BLOCK:
            break
        name = hdr[0:100].split(b"\x00")[0].decode(errors="replace")
        size = _read_octal(hdr[124:136])
        typeflag = chr(hdr[156])
        chk_stored = _read_octal(hdr[148:156])
        chk = sum(hdr[:148]) + 8 * 0x20 + sum(hdr[156:])
        if chk != chk_stored:
            raise CorruptError("tar: header checksum mismatch")
        prefix = hdr[345:500].split(b"\x00")[0].decode(errors="replace")
        if prefix:
            name = prefix + "/" + name
        pos += BLOCK
        content = data[pos:pos + size]
        pos += size + ((-size) % BLOCK)
        if typeflag == "L":  # GNU long name
            longname = content.rstrip(b"\x00").decode(errors="replace")
            continue
        if longname:
            name = longname
            longname = None
        if typeflag in ("0", "\x00"):
            files[name] = content
        # dirs ('5'), links etc. are recorded but carry no content
    return files
