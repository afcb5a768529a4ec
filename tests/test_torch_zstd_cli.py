"""The port's CLI (`tpu7z_torch.cli.main`) for .zst and for .lz4 without
the device, against tpu7z's CLI (`tpu7z.cli.main`) run in this process:
`a -tzstd` at its levels, with -mmt (the job model) and -m0=zstd:wlog=N
(the tensor encoder, here on the CPU), and `a -tlz4` write tpu7z's
archives byte for byte; `t` and `x` read them back, in parallel and at
-mmt1, and by magic where the extension says nothing."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.cli.main import main as jmain  # noqa: E402
from tests.test_torch_zstd_parse import CHUNKS, _chunk, corpus  # noqa: E402,F401
from tests.test_torch_zstd_decode import _lz4_corrupt  # noqa: E402
from tpu7z_torch.cli.main import main  # noqa: E402
from tpu7z_torch.models.lz4 import frame as tlz4  # noqa: E402


@pytest.fixture
def workdir(tmp_path, monkeypatch, corpus):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    data = np.concatenate([_chunk(corpus, k, 500000) for k in CHUNKS]).tobytes()
    (tmp_path / "input.bin").write_bytes(data)   # 2.4 MiB: two zstdmt jobs
    return tmp_path


@pytest.mark.parametrize("switches", [
    ["-tzstd"], ["-tzstd", "-mx1"], ["-tzstd", "-mx19"], ["-mx9"],
    ["-tzstd", "-mmt4"], ["-tzstd", "-mx3", "-mmt2"], ["-tzstd", "-m0=zstd:x7"],
    ["-tlz4"], ["-tlz4", "-mx9"]],
    ids=["default", "mx1", "mx19", "by_extension", "mmt4", "mx3_mmt2", "m0_x7",
         "lz4", "lz4_mx9"])
def test_add_writes_tpu7z_archives(workdir, capsys, switches):
    ext = ".lz4" if "-tlz4" in switches else ".zst"
    assert main(["a", *switches, "port" + ext, "input.bin"], device="cpu") == 0
    assert jmain(["a", *switches, "ref" + ext, "input.bin"]) == 0
    port = (workdir / ("port" + ext)).read_bytes()
    assert port == (workdir / ("ref" + ext)).read_bytes()
    capsys.readouterr()
    for mt in ([], ["-mmt1"], ["-mmt4"]):
        assert main(["t", "port" + ext, *mt]) == 0
        kind = "lz4" if ext == ".lz4" else "zstd"
        assert capsys.readouterr().out == f"type={kind} files=1\nEverything is Ok\n"
        assert main(["x", "port" + ext, "-oout", *mt]) == 0
        capsys.readouterr()
        assert (workdir / "out" / "port").read_bytes() == (workdir / "input.bin").read_bytes()


@pytest.mark.parametrize("level", [None, "-mx1", "-mx11", "-mx30", "-mx45"])
def test_lizard_once_refused_now_written_as_tpu7z(workdir, capsys, level):
    """`a -tlizard` (refused before the port served lizard): tpu7z's
    bytes and lines, at the default level 5 (lizard's 25) and at levels
    of each family, over 300000 bytes of the input; `t` and `x` read it."""
    (workdir / "small.bin").write_bytes((workdir / "input.bin").read_bytes()[:300000])
    sw = ["-tlizard"] + ([level] if level else [])
    assert jmain(["a", *sw, "ref.liz", "small.bin"]) == 0
    want = capsys.readouterr().out.replace("ref.liz", "out.liz")
    assert main(["a", *sw, "out.liz", "small.bin"], device="cpu") == 0
    assert capsys.readouterr().out == want
    assert (workdir / "out.liz").read_bytes() == (workdir / "ref.liz").read_bytes()
    assert main(["t", "out.liz"]) == 0
    assert capsys.readouterr().out == "type=lizard files=1\nEverything is Ok\n"
    assert main(["x", "out.liz", "-oout"]) == 0
    assert (workdir / "out" / "out.liz").read_bytes() == (workdir / "small.bin").read_bytes()


def test_ppmd_once_refused_now_written_as_tpu7z(workdir, capsys):
    """`a -t7z -mdev -m0=ppmd` (refused before the port served PPMd):
    tpu7z's bytes and line over 60000 bytes of the input, the device
    flag ignored without a word, as there; `t` and `x` read it."""
    (workdir / "small.bin").write_bytes((workdir / "input.bin").read_bytes()[:60000])
    assert jmain(["a", "-t7z", "-mdev", "-m0=ppmd", "ref.7z", "small.bin"]) == 0
    want = capsys.readouterr().out.replace("ref.7z", "out.7z")
    assert main(["a", "-t7z", "-mdev", "-m0=ppmd", "out.7z", "small.bin"], device="cpu") == 0
    said = capsys.readouterr()
    assert said.out == want and said.err == ""
    assert (workdir / "out.7z").read_bytes() == (workdir / "ref.7z").read_bytes()
    assert main(["t", "out.7z"], device="cpu") == 0
    assert capsys.readouterr().out == "type=7z files=1\nEverything is Ok\n"
    assert main(["x", "out.7z", "-oout"], device="cpu") == 0
    assert (workdir / "out" / "small.bin").read_bytes() == (workdir / "small.bin").read_bytes()


def test_window_log_runs_the_tensor_encoder(workdir):
    """-m0=zstd:wlog=N is tpu7z's route to its numpy encoder, and the
    port's to its tensor encoder; 200 KiB keeps tpu7z's side quick."""
    (workdir / "small.bin").write_bytes((workdir / "input.bin").read_bytes()[:200000])
    args = ["-tzstd", "-m0=zstd:wlog=18"]
    assert main(["a", *args, "port.zst", "small.bin"], device="cpu") == 0
    assert jmain(["a", *args, "ref.zst", "small.bin"]) == 0
    assert (workdir / "port.zst").read_bytes() == (workdir / "ref.zst").read_bytes()
    assert main(["x", "port.zst", "-mmt1", "-oout"]) == 0
    assert (workdir / "out" / "port").read_bytes() == (workdir / "small.bin").read_bytes()


def test_stdin_stdout_and_sniffing_by_magic(workdir, monkeypatch, capsysbinary):
    data = (workdir / "input.bin").read_bytes()[:300000]

    class _Stdin:
        buffer = __import__("io").BytesIO(data)
    monkeypatch.setattr("sys.stdin", _Stdin())
    assert main(["a", "-tzstd", "-si", "-so", "x.zst"]) == 0
    framed = capsysbinary.readouterr().out
    (workdir / "noext").write_bytes(framed)
    assert main(["e", "noext", "-so"]) == 0
    assert capsysbinary.readouterr().out == data
    assert main(["x", "noext"]) == 0
    assert (workdir / "noext.out").read_bytes() == data


def test_corrupt_zst_exits_2(workdir, capsys):
    assert main(["a", "-tzstd", "a.zst", "input.bin"]) == 0
    bad = bytearray((workdir / "a.zst").read_bytes())
    bad[len(bad) // 2] ^= 0xFF
    (workdir / "bad.zst").write_bytes(bytes(bad))
    capsys.readouterr()
    assert main(["t", "bad.zst"]) == 2
    assert "ERROR: zstd" in capsys.readouterr().err


@pytest.mark.parametrize("mt", [[], ["-mmt1"], ["-mmt4"]], ids=["default", "mmt1", "mmt4"])
@pytest.mark.parametrize("kind,message", [
    ("block_checksum", "block checksum mismatch"),
    ("content_size", "content size mismatch"),
])
def test_corrupt_lz4_exits_2(workdir, capsys, kind, message, mt):
    """`t` and `x` of a host-written .lz4 with block checksums refuse a
    flipped block checksum byte and a wrong content size, serially and
    block-parallel."""
    data = (workdir / "input.bin").read_bytes()[:300000]
    framed = tlz4.compress_frame(data, block_size=1 << 16, block_checksum=True)
    (workdir / "bad.lz4").write_bytes(_lz4_corrupt(framed, kind))
    capsys.readouterr()
    assert main(["t", "bad.lz4", *mt]) == 2
    assert message in capsys.readouterr().err
    assert main(["x", "bad.lz4", "-oout", *mt]) == 2
    assert message in capsys.readouterr().err
    assert not (workdir / "out" / "bad").exists()


@pytest.mark.parametrize("args,message", [
    (["a", "-tcpio", "out.cpio", "input.bin"],
     "ERROR: unknown codec 'cpio'; available: ['brotli', "),
    (["a", "-m0=lzma", "out.xz", "input.bin"],
     "ERROR: unknown codec 'lzma'; available: ['brotli', "),
    (["a", "-tzstd", "-i!*.txt", "out.zst", "input.bin"], "ERROR: a: no input files"),
])
def test_what_the_port_does_not_serve_exits_2(workdir, capsys, args, message):
    """A writer tpu7z lacks (cpio), a codec its registry lacks (lzma) and
    an -i! that keeps no input exit 2 with tpu7z's own message."""
    assert main(args, device="cpu") == 2
    err = capsys.readouterr().err
    assert message in err
    assert jmain(args) == 2 and capsys.readouterr().err == err
    assert [p.name for p in workdir.iterdir()] == ["input.bin"]
