"""The port's command line: the device verb of tpu7z's CLI.

    python -m tpu7z_torch.cli a -tlz4 -mdev archive.lz4 input
    python -m tpu7z_torch.cli t archive.lz4
    python -m tpu7z_torch.cli x archive.lz4 [-o{dir}]

`a -tlz4 -mdev` (also `-m0=lz4:dev`, or TPU7Z_DEVICE=1 in the
environment) compresses one input, a file or standard input with -si,
into one .lz4 frame with the device block encoder
(parallel/sharded.py:shard_compress_lz4_device) on the CUDA card; the
archive is written to a temporary file and renamed over its name, or to
standard output with -so. `t` tests and `x`/`e` extract .lz4 frames
(and the skippable container) with the port's decoder. The rest of
tpu7z's CLI (other verbs, types, codecs and switches, and LZ4 without
the device) is `python -m tpu7z.cli`'s: asking the port for it exits
with 2 and says so.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field

from ..models.lz4 import frame
from ..models.lz4.block import CorruptError
from ..parallel.sharded import shard_compress_lz4_device

ELSEWHERE = "use python -m tpu7z.cli"
LZ4_MAGICS = (frame.MAGIC.to_bytes(4, "little"),
              frame.MAGIC_SKIPPABLE_MIN.to_bytes(4, "little"))


class UsageError(Exception):
    """A request the port's CLI does not serve; exit code 2."""


@dataclass
class Options:
    type: str | None = None
    method: str | None = None
    props: set = field(default_factory=set)
    # -mdev, also on when TPU7Z_DEVICE is set to anything but 0
    device: bool = field(default_factory=lambda: os.environ.get(
        "TPU7Z_DEVICE", "") not in ("", "0"))
    stdin: bool = False
    stdout: bool = False
    outdir: str = "."


def _parse(args) -> tuple[Options, list[str]]:
    opts, rest = Options(), []
    for a in args:
        if a.startswith("-t"):
            opts.type = a[2:].lower()
        elif a.startswith("-m0="):
            name, *props = a[4:].split(":")
            opts.method, opts.props = name.lower(), {p.lower() for p in props if p}
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


def _add(opts: Options, args, device) -> int:
    if not args:
        raise UsageError("a: missing archive name")
    archive, inputs = args[0], args[1:]
    atype = opts.type or ("lz4" if archive.endswith(".lz4") else None)
    method = opts.method or atype
    dev = opts.device or "dev" in opts.props
    if opts.props - {"dev"}:
        raise UsageError(f"-m0={opts.method}:{':'.join(sorted(opts.props))}: the "
                         f"device coder takes no method properties; {ELSEWHERE}")
    if dev and (atype, method) != ("lz4", "lz4"):
        raise UsageError(f"-mdev: the device coder writes lz4 only, not "
                         f"{method or atype or 'this archive type'}; {ELSEWHERE}")
    if atype != "lz4":
        raise UsageError(f"-t{atype or '?'}: the port writes only .lz4, with "
                         f"-mdev; {ELSEWHERE}")
    if not dev:
        raise UsageError(f"-tlz4 without -mdev: the port's CLI encodes only "
                         f"with the device coder; add -mdev, or {ELSEWHERE}")
    if opts.stdin:
        if inputs:
            raise UsageError("a -si: no input files with -si")
        data = sys.stdin.buffer.read()
    elif len(inputs) != 1 or os.path.isdir(inputs[0]):
        raise UsageError(f"a -tlz4: one input file, as a frame holds one "
                         f"stream (got {len(inputs)}); for archives, {ELSEWHERE}")
    else:
        with open(inputs[0], "rb") as f:
            data = f.read()
    out = shard_compress_lz4_device(data, device=device)
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


def _decode(opts: Options, args, test_only: bool) -> int:
    if not args and not opts.stdin:
        raise UsageError("missing archive")
    path = None if opts.stdin else args[0]
    if path is None:
        data = sys.stdin.buffer.read()
    else:
        with open(path, "rb") as f:
            data = f.read()
    atype = opts.type or ("lz4" if (path or "").endswith(".lz4")
                          or data[:4] in LZ4_MAGICS else None)
    if atype != "lz4":
        raise UsageError(f"{path or 'stdin'}: the port reads .lz4 only; {ELSEWHERE}")
    content = frame.decompress(data)
    if test_only:
        print("type=lz4 files=1")
        print("Everything is Ok")
        return 0
    if opts.stdout:
        sys.stdout.buffer.write(content)
        return 0
    name = os.path.basename(path or "stdin")
    name = name[:-4] if name.endswith(".lz4") else name + ".out"
    os.makedirs(opts.outdir, exist_ok=True)
    with open(os.path.join(opts.outdir, name), "wb") as f:
        f.write(content)
    print(f"extracted {name} ({len(content)} bytes)")
    return 0


def main(argv=None, *, device=None) -> int:
    """Run one command; returns the exit code. The encoder runs on the CUDA
    card unless `device` names another (the tests name the CPU)."""
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
    except (UsageError, CorruptError, OSError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 2
