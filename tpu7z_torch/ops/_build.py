"""Build and load the port's CUDA kernels.

Each source `csrc/<name>.cu` becomes one shared library with a plain C
interface, compiled by `nvcc` for Hopper (`sm_90a`) into `_build/` inside
the package at first use, and loaded with ctypes. A library is rebuilt
when the hash of its source, the shared headers or the flags changes.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> list[Path]:
    """Compile the named sources (default: every `csrc/*.cu`) that are not
    built yet, one nvcc process each, all started together. Returns the
    library paths."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD.mkdir(exist_ok=True)
    todo = []
    for name in names:
        so = _target(name)
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            todo.append((so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for so, tmp, proc in todo:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{so.name}: nvcc exit {proc.returncode}\n"
                          + log.decode(errors="replace"))
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return [_target(name) for name in names]


def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu`, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
