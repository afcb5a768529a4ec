"""The port's one-device .lz4 frame against the JAX package, and the
port's package boundaries: no JAX or tpu7z import, no silent CPU."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tpu7z.models.lz4 import frame as jframe  # noqa: E402
from tpu7z.parallel.mesh import make_mesh  # noqa: E402
from tpu7z.parallel.sharded import (  # noqa: E402
    shard_compress_lz4_device as jax_frame)
from tpu7z.utils.corpus import make_corpus as jax_corpus  # noqa: E402
from tpu7z_torch.models.lz4 import frame as tframe  # noqa: E402
from tpu7z_torch.parallel import sharded  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
BLOCK = 1 << 16
PAYLOADS = {"three_blocks_short_tail": 3 * BLOCK + 1234,
            "one_block": BLOCK,
            "empty": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread each keeps PyTorch's thread pools from contending for the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("size", PAYLOADS.values(), ids=PAYLOADS.keys())
def test_frame_matches_jax_and_decodes(size):
    payload = make_corpus(3 * BLOCK + 1234)[:size]
    got = sharded.shard_compress_lz4_device(payload, W=16, device="cpu")
    assert got == jax_frame(payload, mesh=make_mesh(1), W=16)
    assert jframe.decompress(got) == payload
    assert tframe.decompress(got) == payload


def test_frame_stores_incompressible_blocks_raw():
    payload = bytes(range(256)) * 8 + make_corpus(BLOCK)[:100]
    payload += np.random.default_rng(3).integers(
        0, 256, BLOCK, dtype=np.uint8).tobytes()
    got = sharded.shard_compress_lz4_device(payload, W=0, device="cpu")
    stored = [s for s, _ in tframe.iter_blocks(got)]
    assert stored == [False, True]
    assert tframe.decompress(got) == payload == jframe.decompress(got)


@pytest.mark.parametrize("size", [0, 4096, 3 << 20])
def test_corpus_matches_tpu7z(size):
    """The port's corpus equals the JAX package's byte for byte; the 3 MiB
    case holds two text chunks, so it covers the port's zipf sampler.
    (tpu7z's corpus follows the installed numpy's zipf and the port's keeps
    numpy 2.0's, so this holds under numpy 2.0; numpy 2.3.5 differs.)"""
    assert make_corpus(size) == jax_corpus(size)


def test_decoder_rejects_bad_frames():
    good = sharded.shard_compress_lz4_device(b"hello " * 100, device="cpu")
    with pytest.raises(tframe.CorruptError):
        tframe.decompress(b"\0" + good[1:])          # magic
    with pytest.raises(tframe.CorruptError):
        tframe.decompress(good[:-2])                 # EndMark cut
    with pytest.raises(tframe.CorruptError):
        tframe.decompress(good + b"\0")              # trailing bytes


def _port_sources():
    files = sorted((REPO / "tpu7z_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_tpu7z():
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("jax", "jaxlib", "tpu7z"), (path, m)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, tpu7z_torch.parallel.sharded, "
            "tpu7z_torch.ops.lz4_cuda, tpu7z_torch.ops.match, "
            "tpu7z_torch.ops.sort_cuda, "
            "tpu7z_torch.models.lz4.torch_backend, tpu7z_torch.entry, "
            "tpu7z_torch.parallel.distributed, tpu7z_torch.parallel.progress, "
            "tpu7z_torch.cli.main, tpu7z_torch.utils.trace; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'tpu7z')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_silent_cpu(monkeypatch):
    """With no CUDA device and no device named, every entry point raises
    instead of running on the CPU."""
    from tpu7z_torch.entry import entry
    from tpu7z_torch.models.lz4 import torch_backend

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: sharded.shard_compress_lz4_device(b"x"),
                 lambda: torch_backend.compress_frame_device(b"x"),
                 lambda: sharded.shard_compress_lz4(b"x"),
                 entry):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
