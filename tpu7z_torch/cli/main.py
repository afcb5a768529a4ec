"""The port's command line, the whole of tpu7z's CLI: .7z, .zip, .tar,
the single streams, the bare codec streams, and tpu7z's containers:
squashfs, cpio, ar (.deb), rpm, iso, xar, lzh, wim, cab, ext, the disk
images (mbr, gpt, vhd, qcow, vdi, vmdk, vhdx), fat, udf, swf, flv, ihex,
base64, pe, elf, macho, arj, rar, chm, dmg, hfs, ntfs, apfs and nsis.

    python -m tpu7z_torch.cli a [-t7z] [-m0={method}] [-mx{N}] [-p{password}] [-mhe] archive.7z inputs...
    python -m tpu7z_torch.cli a -tzip [-m0={method}] [-mx{N}] archive.zip inputs...
    python -m tpu7z_torch.cli a -ttar|-twim|-tudf|-tfat|-tarj|-tcab archive inputs...
    python -m tpu7z_torch.cli a -trar [-m0=copy|-mx0] archive.rar inputs...
    python -m tpu7z_torch.cli a -tvhd|-tihex archive input
    python -m tpu7z_torch.cli a -tlz4 [-mdev] archive.lz4 input
    python -m tpu7z_torch.cli a -tzstd [-mx{N}] [-mmt{N}] [-m0=zstd:wlog=N] archive.zst input
    python -m tpu7z_torch.cli a -txz archive.xz input
    python -m tpu7z_torch.cli a -tgzip archive.gz input
    python -m tpu7z_torch.cli a -tbzip2 [-mx{N}] archive.bz2 input
    python -m tpu7z_torch.cli a -tbrotli|-tlz5|-tlizard|-tz|-tlzip [-mx{N}] archive input
    python -m tpu7z_torch.cli a -t{codec} [-m0={codec}] [-mx{N}] archive input
    python -m tpu7z_torch.cli u archive inputs...      (any type `a` writes)
    python -m tpu7z_torch.cli t archive [-t{type}] [-p{password}] [-mmt{N}] [-scrc[={hasher}|*]]
    python -m tpu7z_torch.cli x archive [-t{type}] [-o{dir}] [-p{password}] [-so] [-mmt{N}]
    python -m tpu7z_torch.cli l archive [-slt] [-p{password}]
    python -m tpu7z_torch.cli h files...
    python -m tpu7z_torch.cli i
    python -m tpu7z_torch.cli b [codec|hasher] [-md{size}] [-mx{N}]
  and with any verb: -i!{wildcard} -x!{wildcard} (a, u, t, x, e),
  -v{size} (a, u), -bb / -bd (x, e), -y, -r

The archive's type comes from -t, as typed, else from its name (tpu7z's
table of extensions), else, for `t`, `x` and `l`, from its first bytes
(tpu7z's magic tests, in its order); a name that says nothing is a .7z,
as in tpu7z. A type that is none of the containers names a codec of the
registry, in any case (models/registry.py: get_codec), and `a` writes, `t`
and `x` read, that codec's bare stream; -m0 names the codec of a single
stream (`a -tlz4 -m0=zstd` writes a zstd frame, as tpu7z does). `a` reads
its inputs as tpu7z's `cmd_add` does: each input file under its base name,
each file under an input directory under its path relative to the working
directory, or standard input with -si. The archive is written to a
temporary file and renamed over its name, or to standard output with -so.
  .7z (containers/sevenzip): every input, one solid folder; -m0= copy,
      lzma2 (the default), zstd, lz4, bcj2, deflate, bzip2, brotli or
      ppmd; -mx{N} (default 5, as is -mx0); -p{password} encrypts each
      folder with AES-256, -mhe the header too; -md{size}, -y and -r are
      read and ignored, as there.
      zstd folders run the tensor encoder, whose parse runs on the card;
  -tlz4 -mdev (also -m0=lz4:dev, or TPU7Z_DEVICE=1 in the environment):
      the device block encoder (parallel/sharded.py:
      shard_compress_lz4_device) on the CUDA card;
  -tlz4: the host encoder, tpu7z's frame of 4 MiB independent blocks
      with content size and checksum (models/lz4/frame.py:compress_frame);
  -tzstd: level -mx{N} (default 5, at most 22); -mmt{N} with N > 1 runs
      the zstdmt job model (parallel/zstd_jobs.py); -m0=zstd:wlog=N (or
      -m0=zstd:x{N} for the level) runs the tensor encoder, whose parse
      runs on the card (models/zstd/compressor.py); else the host encoder;
  -txz: one block of the host library's LZMA2, a CRC64 check
      (containers/xz.py); the level is ignored, as tpu7z ignores it;
  .zip (containers/zip.py): every input an entry, -m0= copy, deflate (the
      default; also any name tpu7z's table does not know), bzip2, lzma,
      zstd, xz or ppmd at -mx{N} (default 6), an entry stored where its
      codec does not shrink it; deflate's parse and bit packing and
      bzip2's block sort run on the card, zstd's parse too;
  .tar (containers/tar.py): ustar, every input a file;
  -twim, -tudf, -tfat (FAT16), -tarj: every input a file, stored, on the
      host; -tvhd: the one input as a fixed VHD disk; -tihex: the one
      input as Intel HEX records (containers/wim.py, udf.py, fat.py,
      misc.py, disk.py);
  -tcab (.cab): one MSZIP folder, every 32 KiB chunk a row of one deflate
      parse on the card (containers/cab.py); -trar (.rar): RAR5, each
      member LZ-coded on the host (models/rar5.py) or stored where that
      does not shrink it, every member stored with -m0=copy or -mx0;
  -tgzip: DEFLATE on the card in tpu7z's gzip member (the level ignored);
  -tbzip2: bzip2 at -mx{N} (default 5), its block sort on the card;
  -tbrotli (.br): the brotli-mt container at quality min(N, 11) (default
      5), its parse, histograms and bit packing on the card;
  -tlz5 (.lz5): tpu7z's LZ5 frame (the level ignored), its parse on the
      card; -tlizard (.liz, .lizard): level N, 1-9 meaning 20 + N
      (default 25), its parse on the card; -tz (.Z, .taz): LZW at
      max(9, min(N, 16)) bits (default 9), on the host; -tlzip (.lz, .tlz):
      one lzip member, its LZMA parse on the card;
  -tcopy, -tdeflate, -tlzma2 (any codec of the registry): its bare
      stream, deflate's parse on the card;
  -m0=ppmd: .7z folders of PPMd var.H (order 6, 16 MiB whatever the
      level) and .zip entries of var.I (method 98), on the host.
The single-stream types take one input; more are refused as in tpu7z.
The device flag (-mdev, dev in -m0, TPU7Z_DEVICE) selects lz4's device
coder (for -tlz4 as typed); with the other types, which have none, it is
ignored without a word, as in tpu7z (their tensor stages run on the card
all the same). -mmt takes tpu7z's grammar
(utils/methodprops.py: parse_mt).
`t` tests and `x`/`e` extract: an archive's files (a .7z's with their unix
modes, as tpu7z sets them) under -o{dir}, or every file's bytes to
standard output with -so; a .lz4 or .zst stream's frames and blocks in
parallel (parallel/decode.py), serially at -mmt1; any other stream in one
piece, on the host, but for bzip2's inverse BWT, which runs on the card.
The containers read on the host, through the codecs the port holds
(containers/*.py); the bzip2 payloads of an rpm and the bzip2 entries of
a xar and a .zip run their inverse BWT on the card. `x` names a stream's
output as tpu7z does: by default the archive's name with each known
extension stripped in turn, at -mmt1 for .lz4, .zst, .xz, .gz and .bz2
(tpu7z's streamed types) with one stripped or `.out` added; where that
name is the archive itself, `.out` is added (tpu7z would overwrite its
input). `t -scrc` also prints the content's hash: CRC32, the hasher named,
or with `*` every one (ops/hashers.py).
At -mmt1 `x` streams a .lz4, .zst, .gz, .bz2 or .xz into its file, unit by
unit from a memory map (utils/streamio.py: the host libraries for LZ4 and
zstd, the standard library for the others), as tpu7z does, but checking
a .lz4's checksums and content size and leaving no partial file where the
stream is found corrupt.
-i!{wildcard} keeps only the files it matches and -x!{wildcard} drops
those it matches (a name or its last part, fnmatch; excludes win), in
`a`, `u`, `t`, `x` and `e`. -v{size} has `a` write archive.001,
archive.002, ... of that size; a `.001` set is read whole (but for `l`
of a .7z, which reads the first volume, as tpu7z's does).
-bb shows `x`'s progress on standard error, -bd hides it (else it shows
on a tty). Codec plugins (utils/plugins.py: $TPU7Z_PLUGIN_DIR,
~/.tpu7z/plugins) are loaded before the verb runs. A switch the CLI does
not know is ignored with a warning, and a command it does not know exits
with 1, as in tpu7z.
`u` overlays the inputs on the archive's files, if it exists, and
rewrites it as `a` would. `l` lists a .7z's files, and with -slt their
technical lines, and any other archive's or stream's files with their
sizes, as tpu7z does. `h` prints every hasher's digest of each file; `i`
the codecs, hashers and types (the port's own banner); `b` benchmarks
every codec at its low, mid and high levels (-mx: one level) over
make_corpus(-md size, 4 MiB by default), each round trip checked, then
every hasher: tpu7z's lines, with this machine's rates.
The bytes written are tpu7z's. The .7z, .zip, .gz, .bz2, .br, .lz5, .liz,
.lz and .cab writes, the bzip2 payloads of the containers, BLAKE3 and
`b`'s tensor stages run on the card; lzh, chm and rar and the LZX cab are
host code.
"""

from __future__ import annotations

import fnmatch
import math
import os
import re
import sys
import time
from dataclasses import dataclass, field

from ..containers import (apfs, ar, cab, chm, cpio, disk, dmg, ext, fat, hfs, iso, lzh, misc,
                          nsis, ntfs, rar, rpm, squashfs, udf, wim, xar, xz)
from ..containers.sevenzip import SevenZipReader, write_archive
from ..containers.tar import read_tar, write_tar
from ..containers.zip import read_zip, write_zip
from ..models.lz4 import frame
from ..models.registry import CODECS, get_codec
from ..models.zstd import frame as zframe
from ..ops.hashers import HASHERS
from ..ops.hashing import crc32_native
from ..parallel import decode
from ..parallel.sharded import shard_compress_lz4_device
from ..utils import plugins, streamio
from ..utils.corpus import make_corpus
from ..utils.errors import TpuzError
from ..utils.methodprops import parse_method_spec, parse_mt, parse_size

BANNER = "tpu7z_torch (the PyTorch/CUDA port of tpu7z)"
# tpu7z's type names by extension (tpu7z/cli/main.py:25-43)
EXT_TYPES = {
    ".7z": "7z", ".zst": "zstd", ".lz4": "lz4", ".xz": "xz",
    ".bz2": "bzip2", ".gz": "gzip", ".tar": "tar", ".br": "brotli",
    ".lz5": "lz5", ".liz": "lizard", ".lizard": "lizard", ".zip": "zip",
    ".squashfs": "squashfs", ".sqfs": "squashfs", ".cpio": "cpio",
    ".a": "ar", ".ar": "ar", ".deb": "ar", ".lib": "ar", ".rpm": "rpm",
    ".iso": "iso", ".Z": "z", ".taz": "z", ".xar": "xar",
    ".pkg": "xar", ".lzh": "lzh", ".lha": "lzh", ".lz": "lzip",
    ".tlz": "lzip", ".wim": "wim", ".swm": "wim", ".cab": "cab",
    ".ext2": "ext", ".ext3": "ext", ".ext4": "ext",
    ".vhd": "vhd", ".swf": "swf", ".flv": "flv", ".hex": "ihex",
    ".ihex": "ihex", ".b64": "base64", ".exe": "pe", ".dll": "pe",
    ".sys": "pe", ".so": "elf", ".dylib": "macho", ".arj": "arj",
    ".fat": "fat", ".ntfs": "ntfs", ".udf": "udf", ".chm": "chm",
    ".qcow2": "qcow", ".qcow": "qcow", ".vdi": "vdi", ".vmdk": "vmdk",
    ".dmg": "dmg", ".hfs": "hfs",
    ".vhdx": "vhdx", ".rar": "rar", ".apfs": "apfs",
}
# where the content decides before the extension: an .exe may hold an
# NSIS installer or a 7z
AMBIGUOUS_EXTS = {".exe": "pe", ".dll": "pe", ".sys": "pe"}
# tpu7z's magic tests (tpu7z/cli/main.py:64-161), in its order
MAGICS = (
    ("7z", lambda d: d[:6] == b"7z\xbc\xaf\x27\x1c"),
    ("zstd", lambda d: d[:4] == zframe.MAGIC.to_bytes(4, "little")),
    ("lz4", lambda d: d[:4] == frame.MAGIC.to_bytes(4, "little")),
    ("xz", lambda d: d[:6] == xz.MAGIC),
    ("bzip2", lambda d: d[:3] == b"BZh"),
    ("gzip", lambda d: d[:2] == b"\x1f\x8b"),
    ("z", lambda d: d[:2] == b"\x1f\x9d"),
    ("lzip", lambda d: d[:4] == b"LZIP"),
    ("wim", lambda d: d[:8] == b"MSWIM\x00\x00\x00"),
    ("cab", lambda d: d[:4] == b"MSCF"),
    ("ext", lambda d: len(d) > 1082 and d[1080:1082] == b"\x53\xef"),
    ("xar", lambda d: d[:4] == b"xar!"),
    ("lzh", lambda d: len(d) > 7 and d[2:5] == b"-lh" and d[6:7] == b"-"),
    ("lz5", lambda d: d[:4] == b"\x05\x22\x4d\x18"),
    ("lizard", lambda d: d[:4] == b"\x06\x22\x4d\x18"),
    ("zip", lambda d: d[:4] in (b"PK\x03\x04", b"PK\x05\x06")),
    ("tar", lambda d: len(d) > 262 and d[257:262] == b"ustar"),
    ("squashfs", lambda d: d[:4] == b"hsqs"),
    ("cpio", lambda d: d[:6] in (b"070701", b"070702", b"070707")
     or d[:2] in (b"\xc7\x71", b"\x71\xc7")),
    ("ar", lambda d: d[:8] == b"!<arch>\n"),
    ("rpm", lambda d: d[:4] == b"\xed\xab\xee\xdb"),
    ("iso", lambda d: len(d) > 16 * 2048 + 6 and d[16 * 2048 + 1:16 * 2048 + 6] == b"CD001"),
    ("rar", lambda d: d[:8] in (b"Rar!\x1a\x07\x00\x00", b"Rar!\x1a\x07\x01\x00")
     or d[:7] == b"Rar!\x1a\x07\x00"),
    ("chm", lambda d: d[:4] == b"ITSF"),
    ("nsis", lambda d: len(d) > 512 and d[:2] == b"MZ" and nsis.is_nsis(d)),
    ("swf", lambda d: d[:3] in (b"FWS", b"CWS", b"ZWS")),
    ("flv", lambda d: d[:3] == b"FLV"),
    ("arj", lambda d: d[:2] == b"\x60\xea"),
    ("qcow", lambda d: d[:3] == b"QFI"),
    ("vhdx", lambda d: d[:8] == b"vhdxfile"),
    ("vmdk", lambda d: d[:4] == b"KDMV"),
    ("vdi", lambda d: d[64:68] == b"\x7f\x10\xda\xbe"),
    ("udf", lambda d: len(d) > 2048 * 17 and d[2048 * 16 + 1:2048 * 16 + 6] == b"BEA01"),
    ("elf", lambda d: d[:4] == b"\x7fELF"),
    ("dmg", lambda d: len(d) >= 512 and d[-512:-508] == b"koly"),
    ("hfs", lambda d: len(d) > 1536 and d[1024:1026] in (b"H+", b"HX")),
    ("macho", misc.is_macho),
    ("pe", misc.is_pe),
    ("fat", lambda d: len(d) > 512 and d[510:512] == b"\x55\xaa"
     and (d[54:62] in (b"FAT12   ", b"FAT16   ") or d[82:90] == b"FAT32   ")),
    ("ntfs", lambda d: len(d) > 512 and d[3:11] == b"NTFS    "),
    ("apfs", lambda d: d[32:36] == b"NXSB"),
    ("gpt", disk.is_gpt),
    ("vhd", disk.is_vhd),
    ("ihex", misc.is_ihex),
    ("mbr", disk.is_mbr),
)
# tpu7z's container readers (tpu7z/cli/main.py:446-523), each to {name:
# bytes}; those in ON_CARD_READERS run their codec's tensor stages on the
# device (zip's deflate and bzip2, rpm's and xar's bzip2)
READERS = {
    "zip": read_zip, "tar": read_tar, "squashfs": squashfs.read_squashfs,
    "cpio": cpio.read_cpio, "ar": ar.read_ar, "rpm": rpm.read_rpm, "iso": iso.read_iso,
    "xar": xar.read_xar, "wim": wim.read_wim, "ext": ext.read_ext,
    "mbr": disk.read_mbr, "gpt": disk.read_gpt, "vhd": disk.read_vhd, "qcow": disk.read_qcow,
    "vdi": disk.read_vdi, "vmdk": disk.read_vmdk, "vhdx": disk.read_vhdx,
    "swf": misc.read_swf, "flv": misc.read_flv, "ihex": misc.read_ihex,
    "base64": misc.read_base64, "pe": misc.read_pe, "elf": misc.read_elf,
    "macho": misc.read_macho, "arj": misc.read_arj, "fat": fat.read_fat,
    "ntfs": ntfs.read_ntfs, "udf": udf.read_udf, "dmg": dmg.read_dmg, "hfs": hfs.read_hfs,
    "nsis": nsis.read_nsis, "apfs": apfs.read_apfs, "lzh": lzh.read_lzh, "cab": cab.read_cab,
    "chm": chm.read_chm, "rar": rar.read_rar,
}
ON_CARD_READERS = ("zip", "rpm", "xar")
# tpu7z's container writers in `a` (tpu7z/cli/main.py:342-369); vhd and
# ihex take one input, with tpu7z's message for more
WRITERS = {"tar": write_tar, "wim": wim.write_wim, "udf": udf.write_udf,
           "fat": fat.write_fat16, "arj": misc.write_arj}
ONE_INPUT_WRITERS = {"vhd": ("single disk image expected", disk.write_vhd_fixed),
                     "ihex": ("single input expected", misc.write_ihex)}
ARCHIVES = ("7z", *READERS)      # many files, each under its own name
# `i`'s Formats line: tpu7z's (tpu7z/cli/main.py:689-690), then the other
# types the port serves, in tpu7z's sniff order
FORMATS = ("7z", "zstd", "lz4", "lz5", "lizard", "brotli", "xz", "bzip2", "gzip", "tar", "zip",
           "squashfs", "cpio", "ar", "rpm", "iso", "xar", "lzh", "Z", "lzip", "wim", "cab",
           "ext", "rar", "chm", "nsis", "swf", "flv", "arj", "qcow", "vhdx", "vmdk", "vdi", "udf",
           "elf", "dmg", "hfs", "macho", "pe", "fat", "ntfs", "apfs", "gpt", "vhd", "ihex", "mbr",
           "base64")
# the codecs whose compress takes the device for its tensor stages
ON_CARD = ("deflate", "gzip", "bzip2", "brotli", "lz5", "lizard", "lzip")
# tpu7z's .zip method names (tpu7z/cli/main.py:336-337); another is deflate
ZIP_METHODS = {"copy": 0, "deflate": 8, "bzip2": 12, "lzma": 14, "zstd": 93, "xz": 95,
               "ppmd": 98}
# the extensions tpu7z's extract strips from an output name: each in turn
# by default (tpu7z/cli/main.py:524), the first that matches at -mmt1
# (:553), where it adds `.out` if none does
STRIP_ALL = (".zst", ".lz4", ".xz", ".bz2", ".gz", ".Z", ".lz", ".br")
STRIP_ONE = (".zst", ".lz4", ".xz", ".bz2", ".gz")
MAX_THREADS = 8          # -mmt's ceiling, as tpu7z's parse_mt has it
DEFAULT_LEVEL = 5
FILETIME_EPOCH = 11644473600  # seconds between 1601 and 1970


class UsageError(Exception):
    """A request the CLI refuses before it reads an archive; exit code 2."""


@dataclass
class Options:
    type: str | None = None
    method: str | None = None
    props: dict = field(default_factory=dict)
    level: int | None = None
    threads: int | None = None
    password: str | None = None
    encrypt_header: bool = False
    # -mdev, also on when TPU7Z_DEVICE is set to anything but 0
    device: bool = field(default_factory=lambda: os.environ.get(
        "TPU7Z_DEVICE", "") not in ("", "0"))
    stdin: bool = False
    stdout: bool = False
    slt: bool = False
    scrc: str | None = None
    outdir: str = "."
    include: list = field(default_factory=list)    # -i! wildcards
    exclude: list = field(default_factory=list)    # -x! wildcards
    volume: int | None = None                      # -v{size}: volumes of this size
    progress: bool | None = None                   # -bb on, -bd off, else on a tty


def _parse(args) -> tuple[Options, list[str]]:
    """tpu7z's switches, in its order (tpu7z/cli/main.py:197-253): another
    is ignored with tpu7z's warning on standard error."""
    opts, rest = Options(), []
    for a in args:
        if a.startswith("-t"):
            opts.type = a[2:]
        elif a.startswith("-m0="):
            opts.method, opts.props = parse_method_spec(a[4:])
            if "x" in opts.props:
                opts.level = int(opts.props.pop("x"))
        elif a.startswith("-mx"):
            opts.level = int(a[3:].lstrip("="))
        elif a.startswith("-md") and len(a) > 3 and a[3].isdigit():
            # `b`'s buffer size, as tpu7z's; `a` and `u` ignore it, as there
            opts.props["d"] = parse_size(a[3:])
        elif a.startswith("-mhe"):
            opts.encrypt_header = a[4:] in ("", "=on", "on")
        elif a.startswith("-mdev"):
            opts.device = a[5:].lstrip("=") not in ("off", "0", "-")
        elif a.startswith("-mmt"):
            opts.threads = parse_mt(a[4:].lstrip("=") or "on", MAX_THREADS)
        elif a.startswith("-p"):
            opts.password = a[2:]
        elif a.startswith("-o"):
            opts.outdir = a[2:]
        elif a == "-si":
            opts.stdin = True
        elif a == "-so":
            opts.stdout = True
        elif a == "-y":
            pass
        elif a.startswith("-i!"):
            opts.include.append(a[3:])
        elif a.startswith("-x!"):
            opts.exclude.append(a[3:])
        elif a in ("-r", "-r0"):
            pass     # directories are always walked, as in tpu7z
        elif a == "-slt":
            opts.slt = True
        elif a.startswith("-bb"):
            opts.progress = True
        elif a == "-bd":
            opts.progress = False
        elif a.startswith("-v") and len(a) > 2 and a[2].isdigit():
            opts.volume = parse_size(a[2:])
        elif a.startswith("-scrc"):
            opts.scrc = a[5:].lstrip("=") or "CRC32"
        elif a.startswith("-"):
            print(f"warning: ignoring switch {a}", file=sys.stderr)
        else:
            rest.append(a)
    return opts, rest


def _sniff_type(path: str, data: bytes | None = None) -> str:
    """The archive type as tpu7z's `_sniff_type` gives it: the extension,
    else the first magic that matches, else a .7z; an .exe, .dll or .sys
    is read by its magic (an NSIS installer, a PE), else as a .7z if it
    holds a 7z signature after its stub."""
    fallback = next((t for ext, t in AMBIGUOUS_EXTS.items() if path.endswith(ext)), None)
    if fallback is None:
        for ext, t in EXT_TYPES.items():
            if path.endswith(ext):
                return t
    if data:
        for t, test in MAGICS:
            if test(data):
                return t
    if fallback is not None:
        if data and data[:2] == b"MZ" and data.find(b"7z\xbc\xaf\x27\x1c", 0, 1 << 22) > 0:
            return "7z"
        return fallback
    return "7z"


def _read_input(opts: Options, inputs) -> dict[str, bytes]:
    """{name: bytes} as tpu7z's `cmd_add` collects them: each input file
    under its base name, each file under an input directory under its
    path relative to the working directory."""
    if opts.stdin:
        if inputs:
            raise UsageError("a -si: no input files with -si")
        return {"stdin": sys.stdin.buffer.read()}
    files = {}
    for path in inputs:
        if os.path.isdir(path):
            for root, _dirs, names in os.walk(path):
                for name in names:
                    p = os.path.join(root, name)
                    with open(p, "rb") as f:
                        files[os.path.relpath(p)] = f.read()
        else:
            with open(path, "rb") as f:
                files[os.path.basename(path)] = f.read()
    return files


def _name_selected(opts: Options, name: str) -> bool:
    """tpu7z's -i!/-x! selection (tpu7z/cli/main.py:256-267): a name, or
    its last part, matched by fnmatch; excludes always win, includes
    narrow."""
    base = name.replace("\\", "/").split("/")[-1]
    for pat in opts.exclude:
        if fnmatch.fnmatch(name, pat) or fnmatch.fnmatch(base, pat):
            return False
    if opts.include:
        return any(fnmatch.fnmatch(name, pat) or fnmatch.fnmatch(base, pat)
                   for pat in opts.include)
    return True


class PercentPrinter:
    """tpu7z's live percent display (tpu7z/cli/main.py:270-294): on
    standard error, on a tty or with -bb, off with -bd."""

    def __init__(self, total: int, enabled: bool | None = None):
        self.total = max(total, 1)
        self.done = 0
        self.enabled = sys.stderr.isatty() if enabled is None else enabled
        self._last = -1

    def add(self, nbytes: int, name: str = "") -> None:
        self.done += nbytes
        pct = min(100 * self.done // self.total, 100)
        if self.enabled and pct != self._last:
            self._last = pct
            sys.stderr.write(f"\r{pct:3d}% {name[:60]:<60}")
            sys.stderr.flush()

    def finish(self) -> None:
        if self.enabled and self._last >= 0:
            sys.stderr.write("\r" + " " * 66 + "\r")
            sys.stderr.flush()


def _one_stream(files: dict, atype: str) -> bytes:
    if len(files) > 1:
        raise TpuzError(f"-t{atype}: single-stream format, got {len(files)} inputs")
    return next(iter(files.values()))


def _add(opts: Options, args, device, update: bool = False) -> int:
    """`a`, and `u` (update=True): as tpu7z's `cmd_add`, `u` overlays the
    new files on those of the archive it names, if there is one, and
    rewrites it with the same writer (tpu7z/cli/main.py:297-325)."""
    verb = "u" if update else "a"
    if not args:
        raise UsageError(f"{verb}: missing archive name")
    archive, inputs = args[0], args[1:]
    atype = opts.type or _sniff_type(archive)
    # tpu7z reads the device flag for `-tlz4` only, as typed, and says
    # nothing where it ignores it: lz4's device coder takes the stream
    # whatever -m0 names; the other types have no device coder
    dev = (opts.device or bool(opts.props.get("dev"))) and atype == "lz4"
    files = {k: v for k, v in _read_input(opts, inputs).items() if _name_selected(opts, k)}
    if update and os.path.exists(archive) and not opts.stdout:
        files = {**_open(opts, archive, device)[1], **files}
    if not files:
        raise TpuzError(f"{verb}: no input files")
    if atype == "7z":
        out = write_archive(files, method=opts.method or "lzma2",
                            level=opts.level or DEFAULT_LEVEL, password=opts.password,
                            encrypt_header=opts.encrypt_header, device=device)
    elif atype == "zip":
        out = write_zip(files, method=ZIP_METHODS.get(opts.method or "deflate", 8),
                        level=opts.level or 6, device=device)
    elif atype == "cab":
        # MSZIP: every 32 KiB chunk a row of one parse on the card
        out = cab.write_cab(files, device=device)
    elif atype == "rar":
        # RAR5, stored with -m0=copy or -mx0 (tpu7z/cli/main.py:370-373)
        out = rar.write_rar5(files, compress=opts.method != "copy" and opts.level != 0)
    elif atype in WRITERS:
        out = WRITERS[atype](files)
    elif atype in ONE_INPUT_WRITERS:
        message, write = ONE_INPUT_WRITERS[atype]
        if len(files) > 1:
            raise TpuzError(f"-t{atype}: {message}")
        out = write(next(iter(files.values())))
    else:
        data = _one_stream(files, atype)
        if dev:
            out = shard_compress_lz4_device(data, device=device)
        else:
            # a bare stream of the codec -m0 or the type names, through
            # the registry, as tpu7z's (lz4 and xz take no options)
            codec = get_codec(opts.method or atype)
            kw = {}
            if "wlog" in opts.props:
                kw["window_log"] = int(opts.props["wlog"])
                kw["device"] = device
            if opts.threads and codec.name == "zstd":
                kw["threads"] = opts.threads
            if codec.name in ON_CARD:
                kw["device"] = device
            out = codec.compress(data, level=opts.level or DEFAULT_LEVEL, **kw)
    if opts.stdout:
        sys.stdout.buffer.write(out)
        return 0
    if opts.volume:
        # -v{size}: archive.001, archive.002, ... each of that size but
        # the last (tpu7z/cli/main.py:395-405)
        nvol = 0
        for off in range(0, len(out), opts.volume):
            nvol += 1
            with open(f"{archive}.{nvol:03d}", "wb") as f:
                f.write(out[off:off + opts.volume])
        print(f"created {archive}.001..{archive}.{nvol:03d} ({len(out)} bytes in {nvol} volumes)")
        return 0
    # a temporary file renamed over the archive: a failed write never
    # leaves a partial archive under its name
    tmp = archive + ".tmp"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, archive)
    print(f"created {archive} ({len(out)} bytes)")
    return 0


def _streamed(opts: Options, path: str, atype: str) -> bool:
    """Whether `x` streams the file (tpu7z/cli/main.py:547-551): at -mmt1,
    a type of `streamio.STREAMABLE`, not a `.001` volume."""
    return opts.threads == 1 and atype in streamio.STREAMABLE and not path.endswith(".001")


def _output_name(opts: Options, path: str, atype: str) -> str:
    """The extracted file's name, as tpu7z's `x` gives it."""
    name = os.path.basename(path)
    if _streamed(opts, path, atype):
        ext = next((e for e in STRIP_ONE if name.endswith(e)), None)
        return name[:-len(ext)] if ext else name + ".out"
    name = _stream_name(path)
    dst = os.path.join(opts.outdir, name)
    if os.path.exists(dst) and os.path.samefile(dst, path):
        name += ".out"   # tpu7z would write over the archive it reads
    return name


def _stream_name(path: str | None) -> str:
    """A single stream's file name, as tpu7z's `_open_archive` gives it:
    the base name with each known extension stripped in turn."""
    name = os.path.basename(path or "stdin")
    for ext in STRIP_ALL:
        if name.endswith(ext):
            name = name[:-len(ext)]
    return name


def _metadata(rd: SevenZipReader) -> dict:
    """name -> (mtime in unix seconds or None, posix mode or None), as
    tpu7z's `_file_metadata` reads them (tpu7z/cli/main.py:620-634)."""
    meta = {}
    for fe in rd.files:
        mtime = fe.mtime / 10_000_000 - FILETIME_EPOCH if fe.mtime else None
        mode = (fe.attrib >> 16) & 0xFFFF if fe.attrib is not None and fe.attrib & 0x8000 \
            else None
        meta[fe.name] = (mtime, mode)
    return meta


def _destination(outdir: str, name: str) -> str:
    """name's path under outdir. A name that is absolute, has a `..`
    part or resolves outside outdir is refused: tpu7z writes it where it
    points (ROADMAP.md §3)."""
    rel = name.replace("\\", "/")
    dst = os.path.join(outdir, rel)
    root = os.path.realpath(outdir)
    if os.path.isabs(rel) or ".." in rel.split("/") or \
            os.path.commonpath([root, os.path.realpath(dst)]) != root:
        raise TpuzError(f"x: {name!r}: the name points outside {outdir!r}; refused")
    return dst


def _write_files(opts: Options, files: dict, meta: dict):
    """Each file under -o, with its mode (without the setuid, setgid and
    sticky bits) and mtime where the archive holds them, as tpu7z's
    `cmd_extract` writes them (:588-614), its progress on standard error
    with -bb. Every name is checked before the first file is written."""
    dsts = [_destination(opts.outdir, name) for name in files]
    os.makedirs(opts.outdir, exist_ok=True)
    prog = PercentPrinter(sum(len(v) for v in files.values()), enabled=opts.progress)
    for dst, (name, content) in zip(dsts, files.items()):
        prog.add(0, name)
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        with open(dst, "wb") as f:
            f.write(content)
        prog.add(len(content), name)
        mtime, mode = meta.get(name, (None, None))
        if mode is not None:
            try:
                os.chmod(dst, mode & 0o777)
            except OSError:
                pass
        if mtime is not None:
            try:
                os.utime(dst, (mtime, mtime))
            except OSError:
                pass
        print(f"extracted {name} ({len(content)} bytes)")
    prog.finish()


def _read_volumes(path: str) -> bytes:
    """The file at `path`, or where it is the first of a `.001`, `.002`,
    ... set (three or four digits), the set's volumes joined up to the
    first gap, as tpu7z's `_read_volumes` (tpu7z/cli/main.py:418-436)."""
    m = re.match(r"^(.*)\.(\d{3,4})$", path)
    if not m or int(m.group(2)) != 1:
        with open(path, "rb") as f:
            return f.read()
    base, digits = m.group(1), len(m.group(2))
    parts = []
    while os.path.exists(p := f"{base}.{len(parts) + 1:0{digits}d}"):
        with open(p, "rb") as f:
            parts.append(f.read())
    if not parts:
        raise TpuzError(f"cannot open {path}")
    return b"".join(parts)


def _open(opts: Options, path: str | None, device) -> tuple[str, dict, dict]:
    """(type, {name: bytes}, metadata) of the archive at `path` (or of a
    `.001` set's volumes, or on standard input with -si), as tpu7z's
    `_open_archive` reads it: a single stream's one file under
    `_stream_name`."""
    data = sys.stdin.buffer.read() if opts.stdin else _read_volumes(path)
    atype = opts.type or _sniff_type(path or "", data)
    if atype == "7z":
        rd = SevenZipReader(data, password=opts.password, device=device)
        return atype, rd.extract_all(), _metadata(rd)
    if atype in ON_CARD_READERS:
        return atype, READERS[atype](data, device=device), {}
    if atype in READERS:
        return atype, READERS[atype](data), {}
    # a single stream, of the codec the type names
    codec = get_codec(atype)
    # .zst and .lz4 frames and blocks decode in parallel; -mmt1 forces
    # the serial path
    if atype not in ("zstd", "lz4") or opts.threads == 1:
        content = codec.decompress(data, device=device)
    elif atype == "zstd":
        content = decode.decompress_zstd(data, threads=opts.threads)
    else:
        content = decode.decompress_lz4(data, threads=opts.threads)
    return atype, {_stream_name(path): content}, {}


def _stream_out(opts: Options, path: str, atype: str) -> int:
    """`x` at -mmt1 of a single stream, decoded unit by unit from a memory
    map into its output file (utils/streamio.py), as tpu7z's
    (tpu7z/cli/main.py:547-567), but for the .lz4 checks streamio adds
    and no partial file where it raises."""
    name = _output_name(opts, path, atype)
    os.makedirs(opts.outdir, exist_ok=True)
    prog = PercentPrinter(os.path.getsize(path) * 3, enabled=opts.progress)
    # a temporary file renamed over the output: a stream found corrupt
    # part way leaves no partial file under its name (tpu7z's does)
    dst = os.path.join(opts.outdir, name)
    try:
        with open(dst + ".tmp", "wb") as out:
            total = streamio.stream_extract(path, atype, out, prog)
    except BaseException:
        if os.path.exists(dst + ".tmp"):
            os.unlink(dst + ".tmp")
        raise
    os.replace(dst + ".tmp", dst)
    prog.finish()
    print(f"extracted {name} ({total} bytes)")
    return 0


def _decode(opts: Options, args, test_only: bool, device) -> int:
    if not args and not opts.stdin:
        raise UsageError("x: missing archive")
    path = None if opts.stdin else args[0]
    if path and not test_only and not opts.stdout and opts.threads == 1:
        with open(path, "rb") as f:
            head = f.read(64)
        stype = opts.type or _sniff_type(path, head)
        if _streamed(opts, path, stype):
            return _stream_out(opts, path, stype)
    atype, files, meta = _open(opts, path, device)
    files = {k: v for k, v in files.items() if _name_selected(opts, k)}
    if test_only:
        print(f"type={atype} files={len(files)}")
        if opts.scrc:
            # tpu7z's -scrc (:573-581): a name it does not know prints nothing
            names = [opts.scrc] if opts.scrc != "*" else sorted(HASHERS)
            for content in files.values():
                for hn in names:
                    fn = HASHERS.get(hn.upper()) or HASHERS.get(hn)
                    if fn:
                        print(f"{hn} for data: {fn(content, device=device)}")
        print("Everything is Ok")
        return 0
    if opts.stdout:
        for content in files.values():
            sys.stdout.buffer.write(content)
        return 0
    if atype not in ARCHIVES:
        files = {_output_name(opts, path, atype) if path else "stdin": content
                 for content in files.values()}
    _write_files(opts, files, meta)
    return 0


def _list(opts: Options, args, device) -> int:
    """`l`, as tpu7z's `cmd_list` (tpu7z/cli/main.py:637-667): a .7z's
    files (with -slt their technical lines), and any other archive's or
    stream's files with their sizes."""
    if not args:
        raise UsageError("l: missing archive")
    path = args[0]
    with open(path, "rb") as f:
        data = f.read()
    atype = opts.type or _sniff_type(path, data)
    print(f"Listing archive: {path}")
    print(f"Type = {atype}")
    if atype != "7z":
        for name, content in _open(opts, path, device)[1].items():
            print(f"{len(content):>10}  {'-':>8}  {name}")
        return 0
    rd = SevenZipReader(data, password=opts.password, device=device)
    if opts.slt:
        print("----------")
        for fe in rd.files:
            print(f"Path = {fe.name}")
            print(f"Size = {fe.size}")
            if fe.crc is not None:
                print(f"CRC = {fe.crc:08X}")
            print(f"Folder = {'-' if not fe.has_stream else '+'}")
            print()
        return 0
    print(f"{'Size':>10}  {'CRC':>8}  Name")
    for fe in rd.files:
        crc = f"{fe.crc:08x}" if fe.crc is not None else "-"
        print(f"{fe.size:>10}  {crc:>8}  {fe.name}")
    return 0


def _hash(opts: Options, args, device) -> int:
    """`h`, as tpu7z's `cmd_hash` (:669-676): every hasher of each file."""
    for path in args:
        with open(path, "rb") as f:
            data = f.read()
        print(f"-- {path} ({len(data)} bytes)")
        for name in sorted(HASHERS):
            print(f"{name:11s} {HASHERS[name](data, device=device)}")
    return 0


def _info(opts: Options, args, device) -> int:
    """`i`, as tpu7z's `cmd_info` (:679-691), but for the port's banner
    and its Formats line, which names the types the port serves."""
    print(BANNER)
    print("\nCodecs:")
    for name, ci in sorted(CODECS.items()):
        print(f"  {ci.method_id:>8X}  {name}  levels {ci.levels[0]}-{ci.levels[1]}")
    print("\nHashers:")
    for name in sorted(HASHERS):
        print(f"  {name}")
    print("\nFormats: " + " ".join(FORMATS))
    return 0


def _bench(opts: Options, args, device) -> int:
    """`b [codec|hasher]`, as tpu7z's `cmd_bench` (:694-760): every codec
    of the registry (or the one named) at its low, mid and high levels
    (the one level -mx names), over make_corpus(size) (-md{size}, 4 MiB
    by default), each round trip checked by bytes and CRC, then every
    hasher. The codecs' and BLAKE3's tensor stages run on `device`;
    zstd runs its host encoder, as tpu7z's `b` does. The rates are this
    machine's; the layout and the skip and failure lines are tpu7z's."""
    size = int(opts.props.get("d", 4 << 20) or (4 << 20))
    data = make_corpus(size)
    only = args[0].lower() if args else None

    def levels_for(info):
        lo, hi = info.levels
        if opts.level:
            return [max(lo, min(opts.level, hi))]
        return sorted({lo, (lo + hi) // 2, hi})

    names = [n for n in CODECS if n != "copy" and (only is None or n == only)]
    if names:
        print(f"{'method':12s} {'lvl':>3} {'enc MB/s':>9} {'dec MB/s':>9} "
              f"{'ratio':>6} {'rating':>7}")
    for name in sorted(names):
        codec = CODECS[name]
        # any keyword sends zstd to its tensor encoder; tpu7z's `b` runs
        # the host one
        kw = {} if name == "zstd" else {"device": device}
        for lvl in levels_for(codec):
            try:
                t0 = time.time()
                c = codec.compress(data, level=lvl, **kw)
                te = max(time.time() - t0, 1e-9)
                t0 = time.time()
                out = codec.decompress(c, device=device)
                td = max(time.time() - t0, 1e-9)
            except (TpuzError, TypeError, ValueError) as e:
                print(f"{name:12s} {lvl:>3} skip: {e}")
                continue
            if out != data or crc32_native(out) != crc32_native(data):
                print(f"{name:12s} {lvl:>3} ROUND-TRIP FAILED")
                continue
            ratio = size / len(c)
            rating = size / te / 1e6 * max(math.log2(ratio), 0.1)
            print(f"{name:12s} {lvl:>3} {size / te / 1e6:>9.1f} "
                  f"{size / td / 1e6:>9.1f} {ratio:>6.2f} {rating:>7.0f}")
    hnames = [h for h in sorted(HASHERS) if only is None or h.lower() == only]
    if only is not None and not names and not hnames:
        raise TpuzError(f"b: unknown codec/hasher {only!r}")
    if hnames and (only is None or not names):
        print(f"\n{'hasher':12s} {'MB/s':>9}")
        for h in hnames:
            t0 = time.time()
            HASHERS[h](data, device=device)
            dt = max(time.time() - t0, 1e-9)
            print(f"{h:12s} {size / dt / 1e6:>9.1f}")
    return 0


VERBS = {"a": _add, "u": lambda o, r, d: _add(o, r, d, update=True),
         "x": lambda o, r, d: _decode(o, r, False, d), "e": lambda o, r, d: _decode(o, r, False, d),
         "t": lambda o, r, d: _decode(o, r, True, d), "l": _list, "h": _hash, "i": _info,
         "b": _bench}


def main(argv=None, *, device=None) -> int:
    """Run one command; returns the exit code. The device encoders, the
    .7z, .zip, .gz, .bz2, .br, .lz5, .liz and .lz verbs, the containers'
    bzip2 payloads, BLAKE3 and `b`'s tensor stages run on the CUDA card
    unless `device` names another (the tests name the CPU)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 0
    cmd = argv[0]
    try:
        opts, rest = _parse(argv[1:])
        # codec plugins, before dispatch, so that -t and -m0 can name them
        # (tpu7z/cli/main.py:771-775)
        if plugins.plugin_dirs():
            plugins.load_plugins()
        if cmd not in VERBS:
            print(f"unknown command {cmd!r}", file=sys.stderr)
            return 1
        return VERBS[cmd](opts, rest, device)
    except (UsageError, TpuzError, OSError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
