"""The port's CLI (`python -m tpu7z_torch.cli`) against the JAX package's
device verb: `a -tlz4 -mdev` and its other spellings write the bytes of
tpu7z's `shard_compress_lz4_device` at make_mesh(1), which is what
`python -m tpu7z.cli a -tlz4 -mdev` writes; `t` and `x` read them back;
whatever the port does not serve exits with 2 and names tpu7z's CLI
(.zst and LZ4 without the device: test_torch_zstd_cli.py).
The commands run in this process on the CPU (`main(..., device="cpu")`);
run as a module with no card, the CLI fails instead of running on the CPU.
"""

import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.conftest import REF_7ZZ, have_ref  # noqa: E402
from tpu7z.models.lz4 import frame as jframe  # noqa: E402
from tpu7z.parallel.mesh import make_mesh  # noqa: E402
from tpu7z.parallel.sharded import (  # noqa: E402
    shard_compress_lz4_device as jax_frame)
from tpu7z_torch.cli.main import main  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _input() -> bytes:
    """The 70000 bytes of tests/test_cli_device.py, its random tail seeded."""
    tail = np.random.default_rng(8).integers(0, 256, 8192, np.uint8).tobytes()
    return (b"the quick brown fox jumps over the lazy dog " * 1500 + tail)[:70000]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def want():
    return jax_frame(_input(), mesh=make_mesh(1))


@pytest.fixture
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    (tmp_path / "input.bin").write_bytes(_input())
    return tmp_path


class _Stdin:
    def __init__(self, data):
        self.buffer = io.BytesIO(data)


@pytest.mark.parametrize("spelling", ["-mdev", "-m0=lz4:dev", "TPU7Z_DEVICE=1",
                                      "-so", "-si"])
def test_add_writes_the_device_frame_of_tpu7z(workdir, want, spelling,
                                             monkeypatch, capsysbinary):
    args = ["a", "-tlz4", "-mdev", "out.lz4", "input.bin"]
    if spelling == "-m0=lz4:dev":
        args[2] = spelling
    elif spelling == "TPU7Z_DEVICE=1":
        monkeypatch.setenv("TPU7Z_DEVICE", "1")
        del args[2]
    elif spelling == "-so":
        args.append("-so")
    elif spelling == "-si":
        monkeypatch.setattr(sys, "stdin", _Stdin(_input()))
        args = ["a", "-tlz4", "-mdev", "-si", "out.lz4"]
    assert main(args, device="cpu") == 0
    out = capsysbinary.readouterr().out
    if spelling == "-so":
        assert out == want
        assert not (workdir / "out.lz4").exists()
    else:
        assert (workdir / "out.lz4").read_bytes() == want
        assert out == f"created out.lz4 ({len(want)} bytes)\n".encode()
        assert not (workdir / "out.lz4.tmp").exists()


def test_add_replaces_an_existing_archive(workdir, want):
    (workdir / "out.lz4").write_bytes(b"an older archive")
    assert main(["a", "-tlz4", "-mdev", "out.lz4", "input.bin"], device="cpu") == 0
    assert (workdir / "out.lz4").read_bytes() == want
    assert sorted(p.name for p in workdir.iterdir()) == ["input.bin", "out.lz4"]


def test_test_and_extract_round_trip(workdir, want, capsys):
    (workdir / "out.lz4").write_bytes(want)
    assert main(["t", "out.lz4"]) == 0
    assert capsys.readouterr().out == "type=lz4 files=1\nEverything is Ok\n"
    assert main(["x", "out.lz4", "-odest"]) == 0
    assert (workdir / "dest" / "out").read_bytes() == _input()
    assert main(["e", "out.lz4"]) == 0
    assert (workdir / "out").read_bytes() == _input()


def test_test_and_extract_a_linked_block_archive(workdir, capsys):
    """A frame of linked blocks with block checksums, as tpu7z writes one
    (`compress_frame(block_independence=False, block_checksum=True)`)."""
    framed = jframe.compress_frame(_input(), block_size=1 << 16, block_checksum=True,
                                   block_independence=False)
    (workdir / "linked.lz4").write_bytes(framed)
    assert main(["t", "linked.lz4"]) == 0
    assert capsys.readouterr().out == "type=lz4 files=1\nEverything is Ok\n"
    assert main(["x", "linked.lz4", "-odest"]) == 0
    assert (workdir / "dest" / "linked").read_bytes() == _input()


def test_test_reports_a_corrupt_frame(workdir, want, capsys):
    bad = bytearray(want)
    bad[len(bad) // 2] ^= 0xFF
    (workdir / "bad.lz4").write_bytes(bytes(bad[:-9]))
    assert main(["t", "bad.lz4"]) == 2
    assert "ERROR: lz4 frame" in capsys.readouterr().err


@pytest.mark.parametrize("args,message", [
    (["a", "-tzstd", "-mdev", "out.zst", "input.bin"],
     "-mdev: the device coder writes lz4 only, not zstd"),
    (["a", "-tlz4", "-m0=zstd", "-mdev", "out.lz4", "input.bin"],
     "-mdev: the device coder writes lz4 only, not zstd"),
    (["a", "-t7z", "out.7z", "input.bin"], "-t7z: the port writes only .lz4"),
    (["u", "out.lz4", "input.bin"], "command 'u' is not served by the port"),
    (["a", "-tlz4", "-mdev", "-psecret", "out.lz4", "input.bin"],
     "switch -psecret is not served by the port"),
    (["a", "-tlz4", "-mdev", "out.lz4", "input.bin", "input.bin"],
     "one input file"),
    (["l", "out.lz4"], "command 'l' is not served by the port"),
    (["x", "input.bin"], "input.bin: the port reads .lz4 and .zst only"),
])
def test_what_the_port_does_not_serve_exits_2(workdir, capsys, args, message):
    assert main(args, device="cpu") == 2
    err = capsys.readouterr().err
    assert message in err and "use python -m tpu7z.cli" in err
    assert [p.name for p in workdir.iterdir()] == ["input.bin"]


def test_module_run_without_a_card_fails(workdir):
    """`python -m tpu7z_torch.cli` runs on the card: with none, it fails
    with resolve_device's message and writes nothing."""
    env = dict(os.environ, PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "tpu7z_torch.cli", "a", "-tlz4",
                        "-mdev", "out.lz4", "input.bin"], cwd=workdir, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "runs on a CUDA device and none is available" in r.stderr
    assert not (workdir / "out.lz4").exists()


def test_reference_7zz_decodes_the_frame(workdir, want):
    if not have_ref():
        pytest.skip("reference 7zz not built")
    (workdir / "out.lz4").write_bytes(want)
    r = subprocess.run([REF_7ZZ, "e", "-tlz4", "-so", "out.lz4"], cwd=workdir,
                       capture_output=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout == _input()
