"""The port's one-device .lz4 frame against the JAX package, its frame
decoder against tpu7z's on every kind of frame tpu7z writes or accepts,
and the port's package boundaries: no JAX or tpu7z import, no silent
CPU."""

import ast
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tpu7z.models.lz4 import frame as jframe  # noqa: E402
from tpu7z.ops.hashing import xxh32_fast  # noqa: E402
from tpu7z.parallel.mesh import make_mesh  # noqa: E402
from tpu7z.parallel.sharded import (  # noqa: E402
    shard_compress_lz4_device as jax_frame)
from tpu7z.utils.corpus import make_corpus as jax_corpus  # noqa: E402
from tpu7z.utils.errors import CorruptError as JCorruptError  # noqa: E402
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


MIXED = make_corpus(2 << 20)
MIXED = MIXED[700_000:1_000_000] + MIXED[1_500_000:1_800_000]
CONTENT = {"size_and_checksum": (True, True), "checksum": (True, False),
           "size": (False, True), "neither": (False, False)}


@functools.lru_cache(maxsize=None)
def _jax_frame(independent, block_checksum, content, block_size):
    checksum, size = CONTENT[content]
    return jframe.compress_frame(MIXED, block_size=block_size, content_checksum=checksum,
                                 content_size=size, block_checksum=block_checksum,
                                 block_independence=independent)


@pytest.mark.parametrize("verify", [True, False])
@pytest.mark.parametrize("block_size", [1 << 16, 1 << 18, 1 << 20, 1 << 22])
@pytest.mark.parametrize("content", CONTENT)
@pytest.mark.parametrize("block_checksum", [False, True], ids=["no_bc", "bc"])
@pytest.mark.parametrize("independent", [True, False], ids=["independent", "linked"])
def test_decoder_equals_tpu7z_on_its_frames(independent, block_checksum, content,
                                            block_size, verify):
    """Linked and independent blocks, block checksums, content checksum and
    size on and off, block sizes 64 KiB to 4 MiB: both decoders give the
    input, with and without verifying the checksums."""
    framed = _jax_frame(independent, block_checksum, content, block_size)
    want = jframe.decompress(framed, verify_checksums=verify)
    assert want == MIXED
    assert tframe.decompress(framed, verify_checksums=verify) == want


@pytest.mark.parametrize("block_size", [1000, 4096])
@pytest.mark.parametrize("data", ["repeat", "mixed"])
def test_decoder_equals_tpu7z_on_small_linked_blocks(data, block_size):
    """Linked blocks shorter than the 64 KiB window: a block's matches
    reach back over several blocks before it."""
    payload = b"abcdef" * 10000 if data == "repeat" else MIXED[:200_000]
    framed = jframe.compress_frame(payload, block_size=block_size, block_independence=False)
    assert tframe.decompress(framed) == jframe.decompress(framed) == payload


def _skippable(magic_low, payload):
    return ((tframe.MAGIC_SKIPPABLE_MIN + magic_low).to_bytes(4, "little")
            + len(payload).to_bytes(4, "little") + payload)


@pytest.mark.parametrize("verify", [True, False])
def test_decoder_equals_tpu7z_on_frames_between_skippable_ones(verify):
    """Several frames, linked and independent, with skippable frames between
    them and a skippable frame cut short at the end, which tpu7z takes as
    the end of the input."""
    linked = _jax_frame(False, True, "size_and_checksum", 1 << 16)
    plain = _jax_frame(True, False, "neither", 1 << 18)
    src = (_skippable(0, b"sizes") + linked + _skippable(15, b"") + plain
           + _skippable(7, bytes(300)) + linked)
    cut = src + _skippable(3, bytes(100))[:18]
    for data in (src, cut):
        want = jframe.decompress(data, verify_checksums=verify)
        assert want == MIXED * 3
        assert tframe.decompress(data, verify_checksums=verify) == want
    with pytest.raises(JCorruptError):
        jframe.decompress(src + cut[-18:-12], verify_checksums=verify)
    with pytest.raises(tframe.CorruptError):
        tframe.decompress(src + cut[-18:-12], verify_checksums=verify)


def _with_checksum_byte(framed, at):
    bad = bytearray(framed)
    bad[at] ^= 0x40
    return bytes(bad)


@pytest.mark.parametrize("where", ["block_checksum", "content_checksum", "header_checksum"])
def test_one_corrupt_checksum_byte_raises_in_both(where):
    framed = _jax_frame(False, True, "size_and_checksum", 1 << 16)
    if where == "block_checksum":
        first = int.from_bytes(framed[15:19], "little") & 0x7FFFFFFF
        bad = _with_checksum_byte(framed, 19 + first + 2)
    elif where == "content_checksum":
        bad = _with_checksum_byte(framed, len(framed) - 1)
    else:
        bad = _with_checksum_byte(framed, 14)
    name = where.replace("_", " ")
    with pytest.raises(JCorruptError, match=name):
        jframe.decompress(bad)
    with pytest.raises(tframe.CorruptError, match=name):
        tframe.decompress(bad)
    assert tframe.decompress(bad, verify_checksums=False) == MIXED
    assert jframe.decompress(bad, verify_checksums=False) == MIXED


def _descriptor(framed, flg_or=0, flg_and=0xFF, bd_or=0, bd_and=0xFF):
    """`framed` (a frame with content size) with its FLG and BD bits changed
    and its header checksum made anew."""
    desc = bytearray(framed[4:14])
    desc[0] = (desc[0] & flg_and) | flg_or
    desc[1] = (desc[1] & bd_and) | bd_or
    return framed[:4] + bytes(desc) + bytes([(xxh32_fast(bytes(desc)) >> 8) & 0xFF]) + framed[15:]


@pytest.mark.parametrize("bits,ok", [
    (dict(flg_or=0x02), True),                 # FLG reserved bit 1
    (dict(bd_or=0x80), True),                  # BD reserved bit 7
    (dict(bd_or=0x0F), True),                  # BD reserved bits 3-0
    (dict(flg_and=0x3F), False),               # version 00
    (dict(flg_or=0xC0), False),                # version 11
    (dict(flg_or=0x01), False),                # dictionary ID
    (dict(bd_and=0x8F, bd_or=0x30), False),    # block size code 3
    (dict(bd_and=0x8F), False),                # block size code 0
])
def test_descriptor_bits_as_in_tpu7z(bits, ok):
    framed = _descriptor(_jax_frame(True, False, "size_and_checksum", 1 << 16), **bits)
    if ok:
        assert tframe.decompress(framed) == jframe.decompress(framed) == MIXED
    else:
        with pytest.raises(JCorruptError):
            jframe.decompress(framed)
        with pytest.raises(tframe.CorruptError):
            tframe.decompress(framed)


def _port_sources():
    files = sorted((REPO / "tpu7z_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_tpu7z():
    names = {p.relative_to(REPO).as_posix() for p in _port_sources()}
    assert {"tpu7z_torch/models/zstd/compressor.py", "tpu7z_torch/ops/hash_chain.py",
            "tpu7z_torch/parallel/zstd_jobs.py", "tpu7z_torch/parallel/decode.py",
            "tpu7z_torch/utils/errors.py"} <= names
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
            "tpu7z_torch.ops.sort_cuda, tpu7z_torch.models.lz4.block, "
            "tpu7z_torch.models.lz4.torch_backend, tpu7z_torch.entry, "
            "tpu7z_torch.parallel.distributed, tpu7z_torch.parallel.progress, "
            "tpu7z_torch.cli.main, tpu7z_torch.utils.trace, "
            "tpu7z_torch.utils.errors, "
            "tpu7z_torch.ops.hash_chain, tpu7z_torch.ops.bitstream, "
            "tpu7z_torch.ops.bitchain, tpu7z_torch.ops.hashing, "
            "tpu7z_torch.models.zstd.frame, tpu7z_torch.models.zstd.compressor, "
            "tpu7z_torch.models.zstd.native, tpu7z_torch.parallel.zstd_jobs, "
            "tpu7z_torch.parallel.decode, chip_smoke; "
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
