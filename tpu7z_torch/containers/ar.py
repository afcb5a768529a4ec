"""Unix ar container (read incl. GNU // long-name table and BSD #1/N
names; write with GNU long names).

A copy of tpu7z/containers/ar.py, on the host: the same bytes, lines
and errors from the same input.

Behavioral reference: CPP/7zip/Archive/ArHandler.cpp — "!<arch>\\n"
signature (:58-64), 60-byte member header {name 16, mtime 12, uid 6,
gid 6, mode 8, size 10, "`\\n"}, data padded to even; GNU "//" member
holds "/offset"-referenced long names; "/" is the symbol index.
"""

from __future__ import annotations

from ..utils.errors import CorruptError

SIGNATURE = b"!<arch>\n"


def read_ar(data: bytes) -> dict:
    if data[:8] != SIGNATURE:
        raise CorruptError("ar: bad signature")
    files: dict = {}
    longnames = b""
    pos = 8
    while pos + 60 <= len(data):
        hdr = data[pos:pos + 60]
        if hdr[58:60] != b"`\n":
            raise CorruptError("ar: bad member terminator")
        name = hdr[0:16].decode("ascii", "replace").rstrip()
        try:
            size = int(hdr[48:58].split()[0])
        except (ValueError, IndexError):
            raise CorruptError("ar: bad member size") from None
        pos += 60
        content = bytes(data[pos:pos + size])
        if len(content) != size:
            raise CorruptError("ar: truncated member")
        pos += size + (size & 1)
        if name == "//":               # GNU long-name table
            longnames = content
            continue
        if name == "/" or name == "__.SYMDEF":  # symbol index
            continue
        if name.startswith("/") and name[1:].isdigit():
            off = int(name[1:])
            end = longnames.find(b"\n", off)
            name = longnames[off:end].decode("utf-8", "replace") \
                .rstrip("/")
        elif name.startswith("#1/"):   # BSD: name prepended to data
            nlen = int(name[3:])
            name = content[:nlen].rstrip(b"\x00").decode(
                "utf-8", "replace")
            content = content[nlen:]
        else:
            name = name.rstrip("/")
        files[name] = content
    return files


def write_ar(files: dict) -> bytes:
    out = bytearray(SIGNATURE)
    names = sorted(files)
    # GNU long-name table for names over 15 chars
    longtab = bytearray()
    refs = {}
    for name in names:
        stored = name + "/"
        if len(stored) > 16:
            refs[name] = f"/{len(longtab)}"
            longtab += (name + "/\n").encode()

    def member(name_field: str, content: bytes):
        hdr = (f"{name_field:<16}{0:<12}{0:<6}{0:<6}{0o644:<8}"
               f"{len(content):<10}`\n").encode("ascii")
        out.extend(hdr)
        out.extend(content)
        if len(content) & 1:
            out.extend(b"\n")

    if longtab:
        member("//", bytes(longtab))
    for name in names:
        member(refs.get(name, name + "/"), files[name])
    return bytes(out)
