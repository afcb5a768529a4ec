"""Build and load the port's native libraries.

Each source becomes one shared library with a plain C interface, built
into `_build/` inside the package at first use and loaded with ctypes:
`csrc/<name>.cu`, a CUDA kernel source, by `nvcc` for Hopper (`sm_90a`);
`csrc/<name>.cpp`, host code, by the host C++ compiler (`$CXX`, else
`c++`). A library is rebuilt when the hash of its source, the shared
headers (`*.cuh` of a kernel source, `*.h` of a host source) or the
flags changes. Nothing here runs at import time.
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
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

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


def cxx() -> str:
    name = os.environ.get("CXX") or "c++"
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found: set CXX or put c++ on PATH")
    return found


def _source(name: str) -> Path:
    for suffix in (".cu", ".cpp"):
        src = CSRC / f"{name}{suffix}"
        if src.exists():
            return src
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp")


def _target(name: str) -> Path:
    src = _source(name)
    cuda = src.suffix == ".cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS if cuda else CXX_FLAGS).encode())
    h.update(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh" if cuda else "*.h")):
        h.update(hdr.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _command(name: str, out: Path) -> list[str]:
    src = _source(name)
    if src.suffix == ".cu":
        return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]
    return [cxx(), *CXX_FLAGS, "-o", str(out), str(src)]


def build(names=None) -> list[Path]:
    """Compile the named sources (default: every `csrc/*.cu` and
    `csrc/*.cpp`) that are not built yet, one compiler process each, all
    started together. Returns the library paths."""
    if names is None:
        names = sorted(p.stem for p in [*CSRC.glob("*.cu"), *CSRC.glob("*.cpp")])
    BUILD.mkdir(exist_ok=True)
    todo = []
    for name in names:
        so = _target(name)
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = _command(name, tmp)
            todo.append((so, tmp, cmd[0], subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for so, tmp, compiler, proc in todo:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{so.name}: {compiler} exit {proc.returncode}\n"
                          + log.decode(errors="replace"))
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("native build failed:\n" + "\n".join(errors))
    return [_target(name) for name in names]


def load(name: str) -> ctypes.CDLL:
    """The library built from `csrc/<name>.cu` or `.cpp`, built if needed."""
    lib = _loaded.get(name)
    if lib is None:
        (path,) = build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
