"""The port's command line: tpu7z's CLI for .lz4, .zst and .xz.

    python -m tpu7z_torch.cli a -tlz4 [-mdev] archive.lz4 input
    python -m tpu7z_torch.cli a -tzstd [-mx{N}] [-mmt{N}] [-m0=zstd:wlog=N] archive.zst input
    python -m tpu7z_torch.cli a -txz archive.xz input
    python -m tpu7z_torch.cli t archive.{lz4,zst,xz} [-mmt{N}]
    python -m tpu7z_torch.cli x archive.{lz4,zst,xz} [-o{dir}] [-mmt{N}]

`a` compresses one input into one stream: a file, a directory that
holds one file (walked as tpu7z walks it; more than one file is refused
with tpu7z's message), or standard input with -si. The archive is written
to a temporary file and renamed over its name, or to standard output with
-so. The type comes from -t, else from the archive's extension.
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
      (containers/xz.py); the level is ignored, as tpu7z ignores it.
The device flag (-mdev, dev in -m0, TPU7Z_DEVICE) selects lz4's device
coder; with zstd and xz, which have none, it is ignored, as in tpu7z,
with a note on stderr.
`t` tests and `x`/`e` extract .lz4, .zst and .xz archives, known by -t,
their extension or their magic: frames and blocks decode in parallel
(parallel/decode.py), serially at -mmt1. `x` names its output as tpu7z
does: by default the archive's name with each known extension stripped
in turn, at -mmt1 with one stripped or `.out` added; where that name is
the archive itself, `.out` is added (tpu7z would overwrite its input).
The rest of tpu7z's CLI (other verbs, types, codecs and switches) is
`python -m tpu7z.cli`'s: asking the port for it exits with 2 and says
so. The bytes written are tpu7z's.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

from ..containers import xz
from ..models.lz4 import frame
from ..models.zstd import frame as zframe
from ..parallel import decode
from ..parallel.sharded import shard_compress_lz4_device
from ..utils.errors import TpuzError

ELSEWHERE = "use python -m tpu7z.cli"
LZ4_MAGICS = (frame.MAGIC.to_bytes(4, "little"),
              frame.MAGIC_SKIPPABLE_MIN.to_bytes(4, "little"))
ZSTD_MAGIC = zframe.MAGIC.to_bytes(4, "little")
EXTENSIONS = {".lz4": "lz4", ".zst": "zstd", ".xz": "xz"}
TYPES = {"lz4": "lz4", "zstd": "zstd", "zst": "zstd", "xz": "xz"}
SERVED = ("lz4", "zstd", "xz")
# the extensions tpu7z's extract strips from an output name: each in turn
# by default (tpu7z/cli/main.py:524), the first that matches at -mmt1
# (:553), where it adds `.out` if none does
STRIP_ALL = (".zst", ".lz4", ".xz", ".bz2", ".gz", ".Z", ".lz", ".br")
STRIP_ONE = (".zst", ".lz4", ".xz", ".bz2", ".gz")
MAX_THREADS = 8          # -mmt's ceiling, as tpu7z's parse_mt has it
DEFAULT_LEVEL = 5


class UsageError(Exception):
    """A request the port's CLI does not serve; exit code 2."""


@dataclass
class Options:
    type: str | None = None
    method: str | None = None
    props: dict = field(default_factory=dict)
    level: int | None = None
    threads: int | None = None
    # -mdev, also on when TPU7Z_DEVICE is set to anything but 0
    device: bool = field(default_factory=lambda: os.environ.get(
        "TPU7Z_DEVICE", "") not in ("", "0"))
    stdin: bool = False
    stdout: bool = False
    outdir: str = "."


def _method_spec(spec: str):
    """`zstd:x19:wlog=21:dev` -> ("zstd", {"x": 19, "wlog": 21, "dev":
    True}), as tpu7z's parse_method_spec reads it: `k=v`, or a name with
    a number after it, or a bare flag."""
    name, *parts = spec.split(":")
    props = {}
    for p in parts:
        if "=" in p:
            k, v = p.split("=", 1)
            props[k.lower()] = int(v) if v.lstrip("-").isdigit() else v
            continue
        i = 0
        while i < len(p) and not p[i].isdigit():
            i += 1
        if i in (0, len(p)):
            if p:
                props[p.lower()] = True
        else:
            props[p[:i].lower()] = int(p[i:])
    return name.lower(), props


def _threads(spec: str) -> int:
    """-mmt's value: a count (at most 8), on (8) or off (0)."""
    s = spec.lstrip("=").lower()
    if s in ("", "on"):
        return MAX_THREADS
    if s == "off":
        return 0
    if not s.isdigit():
        raise UsageError(f"-mmt{spec}: the port takes -mmt with a count, on or off; "
                         f"{ELSEWHERE}")
    return min(max(int(s), 1), MAX_THREADS)


def _parse(args) -> tuple[Options, list[str]]:
    opts, rest = Options(), []
    for a in args:
        if a.startswith("-t"):
            opts.type = a[2:].lower()
        elif a.startswith("-m0="):
            opts.method, opts.props = _method_spec(a[4:])
            if "x" in opts.props:
                opts.level = int(opts.props.pop("x"))
        elif a.startswith("-mx"):
            opts.level = int(a[3:].lstrip("="))
        elif a.startswith("-mmt"):
            opts.threads = _threads(a[4:])
        elif a.startswith("-mdev"):
            opts.device = a[5:].lstrip("=") not in ("off", "0", "-")
        elif a == "-si":
            opts.stdin = True
        elif a == "-so":
            opts.stdout = True
        elif a.startswith("-o"):
            opts.outdir = a[2:]
        elif a.startswith("-"):
            raise UsageError(f"switch {a} is not served by the port; {ELSEWHERE}")
        else:
            rest.append(a)
    return opts, rest


def _by_extension(path: str):
    for ext, t in EXTENSIONS.items():
        if path.endswith(ext):
            return t
    return None


def _read_input(opts: Options, inputs, atype: str) -> bytes:
    """The one stream to compress, as tpu7z's `cmd_add` collects it: each
    input file under its base name, each file under an input directory
    under its path relative to the working directory, every one read;
    none, or more than one, is refused as there."""
    if opts.stdin:
        if inputs:
            raise UsageError("a -si: no input files with -si")
        return sys.stdin.buffer.read()
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
    if not files:
        raise TpuzError("a: no input files")
    if len(files) > 1:
        raise TpuzError(f"-t{atype}: single-stream format, got {len(files)} inputs")
    return next(iter(files.values()))


def _add(opts: Options, args, device) -> int:
    if not args:
        raise UsageError("a: missing archive name")
    archive, inputs = args[0], args[1:]
    atype = TYPES.get(opts.type, opts.type) if opts.type else _by_extension(archive)
    method = TYPES.get(opts.method, opts.method) if opts.method else atype
    # tpu7z reads the device flag for lz4 only: lz4's device coder takes
    # the stream whatever -m0 names; zstd and xz have no device coder
    asked = opts.device or bool(opts.props.get("dev"))
    dev = asked and atype == "lz4"
    if not dev and (atype not in SERVED or method != atype):
        raise UsageError(f"-t{opts.type or atype or '?'}: the port writes only .lz4, .zst "
                         f"and .xz, each with its own codec; {ELSEWHERE}")
    if asked and not dev:
        print(f"note: -mdev: {atype} has no device coder; the host coder writes it",
              file=sys.stderr)
    data = _read_input(opts, inputs, opts.type or atype)
    if dev:
        out = shard_compress_lz4_device(data, device=device)
    elif atype == "lz4":
        out = frame.compress_frame(data)
    elif atype == "xz":
        out = xz.compress(data)
    else:
        kw = {}
        if "wlog" in opts.props:
            kw["window_log"] = int(opts.props["wlog"])
            kw["device"] = device
        if opts.threads:
            kw["threads"] = opts.threads
        out = zframe.compress(data, level=min(opts.level or DEFAULT_LEVEL, 22), **kw)
    if opts.stdout:
        sys.stdout.buffer.write(out)
        return 0
    # a temporary file renamed over the archive: a failed write never
    # leaves a partial archive under its name
    tmp = archive + ".tmp"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, archive)
    print(f"created {archive} ({len(out)} bytes)")
    return 0


def _output_name(opts: Options, path: str) -> str:
    """The extracted file's name, as tpu7z's `x` gives it (its -mmt1 path
    streams every type the port reads, except from a `.001` volume)."""
    name = os.path.basename(path)
    if opts.threads == 1 and not path.endswith(".001"):
        ext = next((e for e in STRIP_ONE if name.endswith(e)), None)
        return name[:-len(ext)] if ext else name + ".out"
    for ext in STRIP_ALL:
        if name.endswith(ext):
            name = name[:-len(ext)]
    dst = os.path.join(opts.outdir, name)
    if os.path.exists(dst) and os.path.samefile(dst, path):
        name += ".out"   # tpu7z would write over the archive it reads
    return name


def _decode(opts: Options, args, test_only: bool) -> int:
    if not args and not opts.stdin:
        raise UsageError("missing archive")
    path = None if opts.stdin else args[0]
    if path is None:
        data = sys.stdin.buffer.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    atype = TYPES.get(opts.type, opts.type) if opts.type else (
        _by_extension(path or "") or ("zstd" if data[:4] == ZSTD_MAGIC else
                                      "lz4" if data[:4] in LZ4_MAGICS else
                                      "xz" if data[:6] == xz.MAGIC else None))
    if atype not in SERVED:
        raise UsageError(f"{path or 'stdin'}: the port reads .lz4, .zst and .xz only; "
                         f"{ELSEWHERE}")
    # frames and blocks decode in parallel; -mmt1 forces the serial path
    if atype == "xz":
        content = xz.decompress(data)
    elif atype == "zstd":
        content = (zframe.decompress(data) if opts.threads == 1
                   else decode.decompress_zstd(data, threads=opts.threads))
    else:
        content = (frame.decompress(data) if opts.threads == 1
                   else decode.decompress_lz4(data, threads=opts.threads))
    if test_only:
        print(f"type={atype} files=1")
        print("Everything is Ok")
        return 0
    if opts.stdout:
        sys.stdout.buffer.write(content)
        return 0
    name = _output_name(opts, path) if path else "stdin"
    os.makedirs(opts.outdir, exist_ok=True)
    with open(os.path.join(opts.outdir, name), "wb") as f:
        f.write(content)
    print(f"extracted {name} ({len(content)} bytes)")
    return 0


def main(argv=None, *, device=None) -> int:
    """Run one command; returns the exit code. The device encoders run on
    the CUDA card unless `device` names another (the tests name the CPU)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 0
    cmd = argv[0]
    try:
        opts, rest = _parse(argv[1:])
        if cmd == "a":
            return _add(opts, rest, device)
        if cmd in ("x", "e"):
            return _decode(opts, rest, test_only=False)
        if cmd == "t":
            return _decode(opts, rest, test_only=True)
        raise UsageError(f"command {cmd!r} is not served by the port; {ELSEWHERE}")
    except (UsageError, TpuzError, OSError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
