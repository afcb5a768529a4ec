"""The port's CLI (`python -m tpu7z_torch.cli`) against the JAX package's
device verb: `a -tlz4 -mdev` and its other spellings write the bytes of
tpu7z's `shard_compress_lz4_device` at make_mesh(1), which is what
`python -m tpu7z.cli a -tlz4 -mdev` writes; `t` and `x` read them back;
every other verb, type and switch against `python -m tpu7z.cli`'s
outcome (.zst and LZ4 without the device: test_torch_zstd_cli.py; the
streaming extract and plugins: test_torch_streamio.py, test_torch_plugins.py).
The commands run in this process on the CPU (`main(..., device="cpu")`);
run as a module with no card, the CLI fails instead of running on the CPU.
"""

import io
import lzma as std_lzma
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests.conftest import REF_7ZZ, have_ref  # noqa: E402
from tpu7z.cli.main import main as jmain  # noqa: E402
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


@pytest.mark.parametrize("args", [
    ["a", "-tlz4", "-mdev", "-v10k", "out.lz4", "input.bin"],
    ["a", "-tcab", "out.cab", "input.bin"],
    ["a", "-trar", "out.rar", "input.bin"],
    ["l", "out.cab"],
    ["x", "-tlzh", "input.bin"],
    ["t", "-tchm", "input.bin"],
], ids=["v10k", "tcab", "trar", "l_missing_cab", "x_tlzh", "t_tchm"])
def test_once_refused_types_and_switches_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """The requests the port refused with exit 2 before it served lzh,
    cab, chm, rar and -v: tpu7z's exit code, standard output, last error
    line and files (`l` of no archive, lzh and chm read from other bytes:
    tpu7z's errors)."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary,
        lambda d: (d / "input.bin").write_bytes(_input()), args)
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
    assert rc == (0 if args[0] == "a" else 2)


@pytest.mark.parametrize("args", [
    ["a", "-tbrotli", "out.br", "input.bin"],
    ["a", "-t7z", "-m0=brotli", "out.7z", "input.bin"],
    ["a", "-tlzip", "-mdev", "out.lz", "input.bin"],
    ["a", "-t7z", "-m0=ppmd", "out.7z", "input.bin"],
    ["a", "-tzip", "-m0=ppmd", "out.zip", "input.bin"],
    ["a", "-twim", "-mdev", "out.wim", "input.bin"],
], ids=["brotli", "7z_brotli", "lzip_mdev", "7z_ppmd", "zip_ppmd", "wim_mdev"])
def test_once_refused_now_served_as_tpu7z(workdir, capsys, args):
    """Requests the port refused before it served brotli, lzip, PPMd, the
    and wim: tpu7z's exit code,
    output lines, error lines and bytes (-mdev: the host stream, and
    nothing said, as for every type without a device coder)."""
    name = args[-2]
    assert jmain([*args[:-2], "ref_" + name, "input.bin"]) == 0
    want = capsys.readouterr()
    assert main(args, device="cpu") == 0
    said = capsys.readouterr()
    assert said.out == want.out.replace("ref_" + name, name)
    assert said.err == want.err == ""
    assert (workdir / name).read_bytes() == (workdir / ("ref_" + name)).read_bytes()
    assert main(["t", name], device="cpu") == 0
    assert jmain(["t", name]) == 0
    port_t, ref_t = capsys.readouterr().out.split("Everything is Ok\n")[:2]
    assert port_t == ref_t


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


# --- tpu7z's behaviours the port now repeats, each against tpu7z.cli ---

def _both(tmp_path, monkeypatch, prepare, args, env=None):
    """Run `args` through tpu7z's CLI in one directory and the port's in
    another, each prepared by `prepare(dir)`; returns (exit codes, stdout,
    stderr, {relative path: bytes} of each directory after the run)."""
    runs = []
    for name, run in (("ref", lambda a: jmain(a)), ("port", lambda a: main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        prepare(d)
        monkeypatch.chdir(d)
        for k, v in (env or {}).items():
            monkeypatch.setenv(k, v)
        rc = run(list(args))
        files = {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*"))
                 if p.is_file()}
        runs.append((rc, files))
    return runs


@pytest.mark.parametrize("atype,archive", [("-tzstd", "o.zst"), ("-txz", "o.xz")])
@pytest.mark.parametrize("spelling", ["TPU7Z_DEVICE=1", "-mdev", "-m0=dev"])
def test_device_flag_without_a_device_coder_writes_the_host_stream(
        tmp_path, monkeypatch, capsys, atype, archive, spelling):
    """tpu7z reads the device flag for lz4 only: with zstd and xz it
    writes the host stream and says nothing, and so does the port."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    env, extra = ({"TPU7Z_DEVICE": "1"}, []) if spelling.startswith("TPU7Z") else (
        None, [spelling if spelling == "-mdev" else f"-m0={atype[2:]}:dev"])
    args = ["a", atype, *extra, archive, "input.bin"]
    (ref_rc, ref), (port_rc, port) = _both(
        tmp_path, monkeypatch, lambda d: (d / "input.bin").write_bytes(_input()[:20000]),
        args, env)
    assert port_rc == ref_rc == 0
    assert port == ref and archive in port
    assert capsys.readouterr().err == ""


def _tree(files):
    def prepare(d):
        for rel, data in files.items():
            (d / rel).parent.mkdir(parents=True, exist_ok=True)
            (d / rel).write_bytes(data)
    return prepare


@pytest.mark.parametrize("atype,archive", [("-tzstd", "o.zst"), ("-txz", "o.xz"),
                                           ("-tlz4", "o.lz4")])
@pytest.mark.parametrize("layout", ["one_file", "two_files", "nested_one", "empty"])
def test_directory_input_as_tpu7z(tmp_path, monkeypatch, capsys, atype, archive, layout):
    """A directory is walked: one file in it is the stream; more than one
    is refused with tpu7z's message and exit code, and so is none."""
    files = {"one_file": {"d/a.bin": _input()[:9000]},
             "two_files": {"d/a.bin": _input()[:9000], "d/b.bin": b"second"},
             "nested_one": {"d/e/f/a.bin": _input()[:9000]},
             "empty": {"d/e/.keep": b""}}[layout]
    if layout == "empty":
        files = {}
    prepare = _tree(files) if files else (lambda d: (d / "d").mkdir())
    (ref_rc, ref), (port_rc, port) = _both(tmp_path, monkeypatch, prepare,
                                           ["a", atype, archive, "d"])
    err = capsys.readouterr().err.splitlines()
    assert port_rc == ref_rc
    assert port == ref
    if layout in ("two_files", "empty"):
        assert port_rc == 2 and err[-1] == err[-2]
        assert err[-1] == (f"ERROR: {atype}: single-stream format, got 2 inputs"
                           if layout == "two_files" else "ERROR: a: no input files")


def test_two_input_files_as_tpu7z(tmp_path, monkeypatch, capsys):
    """Two inputs with one base name are one file to tpu7z (the later),
    two with two names are refused."""
    def prepare(d):
        (d / "x").mkdir()
        (d / "x" / "in.bin").write_bytes(b"first" * 300)
        (d / "in.bin").write_bytes(_input()[:5000])
        (d / "other.bin").write_bytes(b"other")
    for inputs, rc in ((["x/in.bin", "in.bin"], 0), (["in.bin", "other.bin"], 2)):
        sub = tmp_path / str(rc)
        sub.mkdir()
        (ref_rc, ref), (port_rc, port) = _both(sub, monkeypatch, prepare,
                                               ["a", "-tzstd", "o.zst", *inputs])
        assert port_rc == ref_rc == rc
        assert port == ref
    capsys.readouterr()


def _archives():
    """(name, its content's archive type) for the extract-name cases: a
    zstd frame under a.lz4.zst, an lz4 frame under a.zst.lz4, and .xz
    streams under NAME and NAME.xz (found by magic and by extension)."""
    from tpu7z_torch.containers import xz
    from tpu7z_torch.models.lz4 import frame as tframe
    from tpu7z_torch.models.zstd import frame as zframe
    data = _input()[:30000]
    return data, {"a.lz4.zst": zframe.compress(data), "a.zst.lz4": tframe.compress_frame(data),
                  "NAME": xz.compress(data), "NAME.xz": xz.compress(data)}


@pytest.mark.parametrize("mt", [[], ["-mmt1"], ["-mmt4"]], ids=["default", "mmt1", "mmt4"])
@pytest.mark.parametrize("archive", ["a.lz4.zst", "a.zst.lz4", "NAME", "NAME.xz"])
def test_extract_names_as_tpu7z(tmp_path, monkeypatch, capsys, archive, mt):
    """`x` names its output as tpu7z does: by default every known
    extension stripped in turn, at -mmt1 the first stripped or `.out`
    added; the archive sits beside the output directory."""
    data, archives = _archives()
    (ref_rc, ref), (port_rc, port) = _both(
        tmp_path, monkeypatch, lambda d: (d / archive).write_bytes(archives[archive]),
        ["x", archive, "-oout", *mt])
    assert port_rc == ref_rc == 0
    assert port == ref
    outs = [k for k in port if k.startswith("out")]
    assert len(outs) == 1 and port[outs[0]] == data
    capsys.readouterr()


@pytest.mark.parametrize("mt", [[], ["-mmt1"]], ids=["default", "mmt1"])
def test_extract_never_writes_over_its_archive(workdir, capsys, mt):
    """An archive with no known extension extracted into its own
    directory: tpu7z's default name is the archive's own path, and it
    would overwrite its input; the port adds `.out` there, the -mmt1
    name (a reference behaviour not reproduced, ROADMAP.md)."""
    data, archives = _archives()
    (workdir / "NAME").write_bytes(archives["NAME"])
    assert main(["x", "NAME", *mt]) == 0
    assert (workdir / "NAME").read_bytes() == archives["NAME"]
    assert (workdir / "NAME.out").read_bytes() == data
    assert capsys.readouterr().out == f"extracted NAME.out ({len(data)} bytes)\n"


@pytest.mark.parametrize("switches,archive", [
    (["-txz"], "o.xz"), ([], "o.xz"), (["-txz", "-mx9"], "o.xz"), (["-txz"], "o.bin"),
    (["-txz", "-mmt4"], "o.xz"), (["-txz", "-so"], "o.xz")],
    ids=["type", "extension", "level_ignored", "type_other_name", "mmt", "stdout"])
def test_add_xz_as_tpu7z(tmp_path, monkeypatch, capsysbinary, switches, archive):
    """`a -txz` or an .xz name: tpu7z's .xz bytes, one block of LZMA2 with
    a CRC64 check, whatever the level; `t` and `x` read it back by
    extension or by magic."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    data = _input()
    (ref_rc, ref), (port_rc, port) = _both(
        tmp_path, monkeypatch, lambda d: (d / "input.bin").write_bytes(data),
        ["a", *switches, archive, "input.bin"])
    outs = capsysbinary.readouterr().out
    assert port_rc == ref_rc == 0
    assert port == ref
    if "-so" in switches:
        half = len(outs) // 2
        assert outs[:half] == outs[half:]
        framed = outs[:half]
    else:
        framed = port[archive]
    assert std_lzma.decompress(framed) == data
    (tmp_path / "port" / archive).write_bytes(framed)
    for mt, name in (([], "o" if archive == "o.xz" else "o.bin"),
                     (["-mmt1"], "o" if archive == "o.xz" else "o.bin.out")):
        assert main(["t", archive, *mt]) == 0
        assert capsysbinary.readouterr().out == b"type=xz files=1\nEverything is Ok\n"
        assert main(["x", archive, "-oback", *mt]) == 0
        capsysbinary.readouterr()
        assert (tmp_path / "port" / "back" / name).read_bytes() == data


def test_corrupt_xz_exits_2(workdir, capsys):
    assert main(["a", "-txz", "o.xz", "input.bin"]) == 0
    bad = bytearray((workdir / "o.xz").read_bytes())
    bad[-30] ^= 0xFF
    (workdir / "bad.xz").write_bytes(bytes(bad))
    capsys.readouterr()
    for verb in ("t", "x"):
        assert main([verb, "bad.xz"]) == 2
        assert "ERROR: xz:" in capsys.readouterr().err
    assert not (workdir / "bad").exists()



# --- the .7z verbs, each against tpu7z.cli ---

def _run_both(tmp_path, monkeypatch, capsysbinary, prepare, args):
    """As `_both`, and each run's standard output and last line of
    standard error: [(exit code, stdout, last stderr line, files)] for
    tpu7z's CLI, then the port's."""
    runs = []
    for name, run in (("ref", jmain), ("port", lambda a: main(a, device="cpu"))):
        d = tmp_path / name
        d.mkdir()
        prepare(d)
        monkeypatch.chdir(d)
        capsysbinary.readouterr()
        rc = run(list(args))
        cap = capsysbinary.readouterr()
        err = cap.err.decode().strip().splitlines()
        files = {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*"))
                 if p.is_file()}
        runs.append((rc, cap.out, err[-1] if err else "", files))
    return runs


@pytest.fixture
def fixed_iv(monkeypatch):
    """Both writers draw their IVs from os.urandom(16)."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    monkeypatch.setattr(os, "urandom", lambda n: bytes(range(7, 7 + n)))


def _inputs(d):
    (d / "input.bin").write_bytes(_input()[:20000])
    (d / "d" / "e").mkdir(parents=True)
    (d / "d" / "e" / "ünï.txt").write_bytes(b"nested text " * 100)
    (d / "d" / "empty").write_bytes(b"")
    (d / "d" / "x.bin").write_bytes(_input()[30000:34000])


@pytest.mark.parametrize("args", [
    ["a", "-t7z", "o.7z", "input.bin"],
    ["a", "o.7z", "input.bin", "d"],
    ["a", "o.bin", "input.bin"],
    ["a", "-t7z", "-psecret", "o.7z", "input.bin", "d"],
    ["a", "-psecret", "-mhe", "o.7z", "d"],
    ["a", "-t7z", "-m0=zstd", "-mx3", "o.7z", "input.bin", "d"],
    ["a", "-t7z", "-m0=zstd:x9", "o.7z", "d"],
    ["a", "-t7z", "-m0=lz4", "-mx0", "-md24", "-y", "-r", "o.7z", "d"],
    ["a", "-t7z", "-m0=copy", "-mmt=p50", "o.7z", "d"],
    ["a", "-t7z", "-m0=bcj2", "o.7z", "input.bin"],
    ["a", "-t7z", "-mdev", "o.7z", "input.bin"],
    ["a", "-t7z", "-so", "o.7z", "input.bin", "d"],
    ["a", "-t7z", "-mhe", "o.7z", "input.bin"],
    ["a", "-t7z", "-m0=lzma", "o.7z", "input.bin"],
    ["a", "-t7z", "o.7z", "missing.bin"],
    ["a", "-t7z", "-m0=brotli", "-mx1", "o.7z", "input.bin", "d"],
    ["a", "-m0=brotli", "o.7z", "input.bin", "d"],
    ["a", "-t7z", "-m0=brotli", "-mx9", "o.7z", "d"],
    ["a", "-t7z", "-m0=brotli", "-mx5", "-psecret", "o.7z", "d"],
    ["a", "-m0=brotli", "-mx9", "-psecret", "-mhe", "o.7z", "d"],
], ids=["t7z", "by_name", "unknown_name", "password", "header_encrypted", "zstd_mx3",
        "zstd_x9", "lz4_mx0", "copy_mmt", "bcj2", "mdev_ignored", "stdout",
        "mhe_without_password", "unknown_method", "missing_input", "brotli_mx1",
        "brotli_mx5", "brotli_mx9", "brotli_password", "brotli_header_encrypted"])
def test_add_7z_as_tpu7z(tmp_path, monkeypatch, capsysbinary, fixed_iv, args):
    """`a` of a .7z: tpu7z's archive bytes, stdout and exit code, for its
    types, methods, levels, passwords and inputs; errors as tpu7z's."""
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _inputs, args)
    assert rc == ref_rc
    assert out == ref_out
    assert port == ref
    if rc:
        assert rc == 2 and err == ref_err
    else:
        archive = out if "-so" in args else next(v for k, v in port.items()
                                                 if k.startswith("o."))
        assert archive[:6] == b"7z\xbc\xaf\x27\x1c"


@pytest.fixture(scope="module")
def archive_kinds():
    """(files, {kind: tpu7z's archive of them}), written once: tpu7z's
    AES encrypt runs at about 5 KB/s."""
    from unittest import mock

    from tpu7z.containers.sevenzip import writer as jw
    rng = np.random.default_rng(5)
    files = {"input.bin": _input()[:20000], "d/e/ünï.txt": b"nested text " * 100,
             "d/x.bin": rng.integers(0, 256, 1500, np.uint8).tobytes(), "d/empty": b""}
    with mock.patch("os.urandom", lambda n: bytes(range(n))):
        return files, {
        "lzma2": jw.write_archive(files),
        "zstd_loose": jw.write_archive(files, method="zstd", solid=False),
        "password": jw.write_archive(files, password="secret"),
        "header_encrypted": jw.write_archive(files, method="lz4", password="secret",
                                             encrypt_header=True),
        "brotli_loose": jw.write_archive(files, method="brotli", level=3, solid=False),
        }


@pytest.mark.parametrize("verb", [
    ["t"], ["x", "-oout"], ["e"], ["x", "-so"], ["l"], ["l", "-slt"], ["x", "-mmt1", "-oout"]],
    ids=["t", "x", "e", "x_so", "l", "l_slt", "x_mmt1"])
@pytest.mark.parametrize("kind", ["lzma2", "zstd_loose", "password", "header_encrypted",
                                  "brotli_loose"])
def test_read_7z_as_tpu7z(tmp_path, monkeypatch, capsysbinary, archive_kinds, kind, verb):
    """`t`, `x`/`e` (files, or -so) and `l` (-slt) of tpu7z's archives:
    tpu7z's exit codes, stdout and extracted files, with the password and
    without it (exit 2, tpu7z's message)."""
    files, archives = archive_kinds
    pw = ["-psecret"] if kind in ("password", "header_encrypted") else []
    for extra in ([pw] if not pw else [pw, []]):
        sub = tmp_path / f"pw{len(extra)}"
        sub.mkdir()
        (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
            sub, monkeypatch, capsysbinary,
            lambda d: (d / "a.7z").write_bytes(archives[kind]),
            [verb[0], *extra, "a.7z", *verb[1:]])
        assert (rc, out, port) == (ref_rc, ref_out, ref)
        if extra or not pw:
            assert rc == 0
            if verb[0] in ("x", "e") and "-so" not in verb:
                where = "out/" if "-oout" in verb else ""
                assert {k[len(where):]: v for k, v in port.items()
                        if k.startswith(where) and k != "a.7z"} == files
            if "-so" in verb:
                assert out == b"".join(files.values())
        elif verb[0] != "l" or kind == "header_encrypted":
            assert rc == 2 and err == ref_err == \
                "ERROR: 7z: archive is encrypted (no password)"


@pytest.mark.parametrize("args", [["x", "input.bin"], ["t", "input.bin"],
                                  ["l", "input.bin"], ["x", "-t7z", "input.bin"]])
def test_bad_7z_exits_2_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """A name that says nothing is a .7z: its bad signature is tpu7z's
    error, after `l`'s first two lines."""
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, lambda d: (d / "input.bin").write_bytes(_input()),
        args)
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
    assert rc == 2 and err == "ERROR: 7z: bad signature"


def test_corrupt_7z_exits_2_as_tpu7z(tmp_path, monkeypatch, capsysbinary, archive_kinds):
    archives = archive_kinds[1]
    bad = bytearray(archives["lzma2"])
    bad[40] ^= 0xFF
    for verb in (["t"], ["x", "-oout"]):
        sub = tmp_path / verb[0]
        sub.mkdir()
        (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
            sub, monkeypatch, capsysbinary, lambda d: (d / "a.7z").write_bytes(bytes(bad)),
            [verb[0], "a.7z", *verb[1:]])
        assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
        assert rc == 2 and err.startswith("ERROR: ")


@pytest.mark.parametrize("verb", [["x", "-oout"], ["e", "-oout"], ["x"]], ids=["x", "e", "x_here"])
@pytest.mark.parametrize("kind", ["parent", "nested_parent", "absolute", "backslash"])
def test_extract_refuses_names_outside_o(tmp_path, monkeypatch, capsys, kind, verb):
    """A stored name that is absolute or climbs out of -o is refused with
    exit 2 before any file is written: tpu7z writes it where it points
    (a reference behaviour not reproduced, ROADMAP.md)."""
    from tpu7z_torch.containers.sevenzip import write_archive
    work = tmp_path / "work"
    work.mkdir()
    monkeypatch.chdir(work)
    target = tmp_path / "outside.txt"
    name = {"parent": "../outside.txt", "nested_parent": "out/../../outside.txt",
            "absolute": str(target), "backslash": "..\\outside.txt"}[kind]
    arc = write_archive({"fine.txt": b"kept in -o", name: b"escaped"}, method="copy",
                        device="cpu")
    (work / "a.7z").write_bytes(arc)
    capsys.readouterr()
    assert main([verb[0], "a.7z", *verb[1:]], device="cpu") == 2
    assert "points outside" in capsys.readouterr().err
    assert not target.exists()
    assert sorted(p.name for p in work.rglob("*")) == ["a.7z"]


def test_extract_drops_setuid_setgid_and_sticky_bits(tmp_path, monkeypatch):
    """A stored unix mode is applied without its 0o7000 bits."""
    from tpu7z_torch.cli import main as cli
    monkeypatch.chdir(tmp_path)
    opts = cli.Options()
    opts.outdir = "out"
    cli._write_files(opts, {"s": b"x", "d/t": b"y"}, {"s": (None, 0o6755), "d/t": (None, 0o1644)})
    assert (tmp_path / "out" / "s").stat().st_mode & 0o7777 == 0o755
    assert (tmp_path / "out" / "d" / "t").stat().st_mode & 0o7777 == 0o644


# --- .zip, .tar, .gz and .bz2, each against tpu7z.cli ---

@pytest.mark.parametrize("args", [
    ["a", "o.zip", "input.bin", "d"],
    ["a", "-tzip", "-m0=bzip2", "-mx1", "o.zip", "input.bin", "d"],
    ["a", "-tzip", "-m0=copy", "o.zip", "d"],
    ["a", "-tzip", "-m0=lzma", "o.zip", "input.bin"],
    ["a", "-tzip", "-m0=zstd", "-mx3", "o.zip", "d"],
    ["a", "-tzip", "-m0=xz", "o.zip", "d"],
    ["a", "-tzip", "-m0=nosuch", "o.zip", "input.bin"],
    ["a", "-tzip", "-so", "o.zip", "input.bin"],
    ["a", "o.tar", "input.bin", "d"],
    ["a", "-ttar", "o.bin", "input.bin"],
    ["a", "o.gz", "input.bin"],
    ["a", "-tgzip", "-mx9", "-mdev", "o.gz", "input.bin"],
    ["a", "o.bz2", "input.bin"],
    ["a", "-tbzip2", "-mx1", "-so", "o.bz2", "input.bin"],
    ["a", "o.gz", "input.bin", "d"],
], ids=["zip", "zip_bzip2", "zip_copy", "zip_lzma", "zip_zstd", "zip_xz",
        "zip_unknown_is_deflate", "zip_stdout", "tar", "tar_other_name", "gz",
        "gz_level_and_mdev_ignored", "bz2", "bz2_mx1_stdout", "gz_two_inputs"])
def test_add_zip_tar_gz_bz2_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """`a` of a .zip, .tar, .gz or .bz2: tpu7z's bytes, stdout and exit
    code for its methods, levels and names; errors as tpu7z's."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _inputs, args)
    assert (rc, out, port) == (ref_rc, ref_out, ref)
    if rc:
        assert rc == 2 and err == ref_err


@pytest.fixture(scope="module")
def stream_kinds():
    """(files, {name: tpu7z's archive of them}) for each type and method."""
    from tpu7z.containers import tar as jtar
    from tpu7z.containers import zip as jzip
    from tpu7z.models import bzip2 as jbz
    from tpu7z.models import deflate as jdef
    rng = np.random.default_rng(6)
    files = {"input.bin": _input()[:20000], "d/e/ünï.txt": b"nested text " * 100,
             "d/x.bin": rng.integers(0, 256, 1500, np.uint8).tobytes(), "d/empty": b""}
    one = files["input.bin"]
    return files, {
        "a.zip": jzip.write_zip(files), "b.zip": jzip.write_zip(files, method=12),
        "a.tar": jtar.write_tar(files), "in.bin.gz": jdef.gzip_compress(one),
        "in.bin.bz2": jbz.compress(one, level=2), "zipped": jzip.write_zip(files),
        "tarred": jtar.write_tar(files), "gzipped": jdef.gzip_compress(one),
        "bzipped": jbz.compress(one, level=1),
    }


@pytest.mark.parametrize("verb", [
    ["t"], ["x", "-oout"], ["e", "-oout"], ["x", "-so"], ["l"], ["x", "-mmt1", "-oout"]],
    ids=["t", "x", "e", "x_so", "l", "x_mmt1"])
@pytest.mark.parametrize("name", ["a.zip", "b.zip", "a.tar", "in.bin.gz", "in.bin.bz2",
                                  "zipped", "tarred", "gzipped", "bzipped"])
def test_read_zip_tar_gz_bz2_as_tpu7z(tmp_path, monkeypatch, capsysbinary, stream_kinds,
                                      name, verb):
    """`t`, `x`/`e` (files, or -so) and `l` of tpu7z's archives, by
    extension or by magic: tpu7z's exit codes, stdout and files (`l` of
    a .gz or .bz2 too)."""
    files, archives = stream_kinds
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, lambda d: (d / name).write_bytes(archives[name]),
        [verb[0], name, *verb[1:]])
    single = name.endswith((".gz", ".bz2")) or name in ("gzipped", "bzipped")
    assert (rc, out, port) == (ref_rc, ref_out, ref)
    assert rc == 0
    if verb[0] in ("x", "e") and "-so" not in verb and not single:
        assert {k[4:]: v for k, v in port.items() if k.startswith("out/")} == files


@pytest.mark.parametrize("name", ["in.bin.gz", "in.bin.bz2", "a.zip"])
def test_corrupt_zip_gz_bz2_exit_2_as_tpu7z(tmp_path, monkeypatch, capsysbinary,
                                            stream_kinds, name):
    bad = bytearray(stream_kinds[1][name])
    bad[-6] ^= 0x10
    for verb in (["t"], ["x", "-oout"]):
        sub = tmp_path / verb[0]
        sub.mkdir()
        (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
            sub, monkeypatch, capsysbinary, lambda d: (d / name).write_bytes(bytes(bad)),
            [verb[0], name, *verb[1:]])
        assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
        assert rc == 2 and err.startswith("ERROR: ")


# --- .br, .lz5, .liz, .Z and .lz, each against tpu7z.cli ---

@pytest.mark.parametrize("args", [
    ["a", "o.br", "input.bin"],
    ["a", "-tbrotli", "-mx9", "o.br", "input.bin"],
    ["a", "-tbrotli", "-mx1", "-so", "o.br", "input.bin"],
    ["a", "o.lz5", "input.bin"],
    ["a", "-tlz5", "-mx9", "-so", "o.lz5", "input.bin"],
    ["a", "-tlz5", "-mdev", "o.lz5", "input.bin"],
    ["a", "o.liz", "input.bin"],
    ["a", "-tlizard", "-mx45", "o.lizard", "input.bin"],
    ["a", "-tlizard", "-mx3", "o.liz", "input.bin"],
    ["a", "o.Z", "input.bin"],
    ["a", "-tz", "-mx16", "o.taz", "input.bin"],
    ["a", "o.lz", "input.bin"],
    ["a", "-tlzip", "-so", "o.tlz", "input.bin"],
    ["a", "o.br", "input.bin", "d"],
    ["a", "-tz", "o.Z", "d"],
], ids=["br", "br_mx9", "br_mx1_stdout", "lz5", "lz5_mx9_stdout", "lz5_mdev", "liz",
        "lizard_mx45", "liz_mx3", "Z", "taz_mx16", "lz", "tlz_stdout", "br_two_inputs",
        "Z_directory_of_three"])
def test_add_new_streams_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """`a` of a .br, .lz5, .liz, .Z or .lz: tpu7z's bytes, stdout and exit
    code at its levels, names and types; errors as tpu7z's."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _inputs, args)
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
    assert rc == 0 or (rc == 2 and err.startswith("ERROR: "))


@pytest.fixture(scope="module")
def new_streams():
    """{name: tpu7z's stream of `_input()`'s first 20000 bytes}: each new
    type under its extension and, where it has a magic, under none."""
    from tpu7z.containers import lzip as jlzip
    from tpu7z.models import brotli as jbr
    from tpu7z.models import lizard as jliz
    from tpu7z.models import lz5 as jlz5
    from tpu7z.models import z_lzw as jz
    one = _input()[:20000]
    made = {"br": jbr.compress_mt_container(one, 5), "lz5": jlz5.compress_frame(one),
            "liz": jliz.compress_frame(one, level=25), "Z": jz.compress(one, 9),
            "lz": jlzip.compress(one)}
    out = {f"in.bin.{ext}": v for ext, v in made.items()}
    out.update({f"sniffed_{ext}": v for ext, v in made.items() if ext != "br"})
    return one, out


@pytest.mark.parametrize("verb", [
    ["t"], ["x", "-oout"], ["e", "-oout"], ["x", "-so"], ["x", "-mmt1", "-oout"]],
    ids=["t", "x", "e", "x_so", "x_mmt1"])
@pytest.mark.parametrize("name", ["in.bin.br", "in.bin.lz5", "in.bin.liz", "in.bin.Z",
                                  "in.bin.lz", "sniffed_lz5", "sniffed_liz", "sniffed_Z",
                                  "sniffed_lz"])
def test_read_new_streams_as_tpu7z(tmp_path, monkeypatch, capsysbinary, new_streams, name,
                                   verb):
    """`t` and `x`/`e` (a file, or -so) of tpu7z's .br, .lz5, .liz, .Z and
    .lz streams, by extension or by magic: tpu7z's exit codes, stdout and
    files."""
    one, streams = new_streams
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, lambda d: (d / name).write_bytes(streams[name]),
        [verb[0], name, *verb[1:]])
    assert (rc, out, port) == (ref_rc, ref_out, ref)
    assert rc == 0
    if verb[0] in ("x", "e") and "-so" not in verb:
        assert [v for k, v in port.items() if k.startswith("out/")] == [one]


@pytest.mark.parametrize("name", ["in.bin.br", "in.bin.lz5", "in.bin.liz", "in.bin.Z",
                                  "in.bin.lz"])
def test_corrupt_new_streams_exit_2_as_tpu7z(tmp_path, monkeypatch, capsysbinary,
                                             new_streams, name):
    """A byte flipped and the end cut: tpu7z's exit code and message."""
    bad = bytearray(new_streams[1][name])
    bad[len(bad) // 2] ^= 0x24
    bad = bytes(bad[:-3])
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, lambda d: (d / name).write_bytes(bad), ["t", name])
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
    # .Z carries no check: its damage decodes to other bytes
    assert name.endswith(".Z") or (rc == 2 and err.startswith("ERROR: "))


@pytest.mark.parametrize("name", ["in.bin.br", "in.bin.lz5", "in.bin.liz", "in.bin.Z",
                                  "in.bin.lz", "sniffed_lz5", "sniffed_Z"])
def test_list_of_new_streams_as_tpu7z(tmp_path, monkeypatch, capsysbinary, new_streams, name):
    """`l` of a .br, .lz5, .liz, .Z or .lz stream, by extension or by
    magic: tpu7z's lines (the one file, its size and stripped name)."""
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary,
        lambda d: (d / name).write_bytes(new_streams[1][name]), ["l", name])
    assert (rc, out, port) == (ref_rc, ref_out, ref)
    assert rc == 0 and out.decode().splitlines()[-1].split()[0] == str(len(new_streams[0]))


# --- `l` of the first stream types, `u`, `h`, `i`, `b` and `t -scrc`, each
# against tpu7z.cli ---

@pytest.mark.parametrize("name", ["out.lz4", "out.zst", "out.xz", "sniffed_zst"])
def test_list_of_lz4_zst_xz_as_tpu7z(tmp_path, monkeypatch, capsysbinary, name):
    from tpu7z_torch.containers import xz
    from tpu7z_torch.models.lz4 import frame as tframe
    from tpu7z_torch.models.zstd import frame as zframe
    data = _input()[:30000]
    made = {"out.lz4": tframe.compress_frame(data), "out.zst": zframe.compress(data),
            "out.xz": xz.compress(data), "sniffed_zst": zframe.compress(data)}[name]
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, lambda d: (d / name).write_bytes(made), ["l", name])
    assert (rc, out, port) == (ref_rc, ref_out, ref)
    assert rc == 0 and out.decode().splitlines()[-1].split() == ["30000", "-", name.split(".")[0]]


def _old_archives(d):
    """`_inputs`, and beside them archives tpu7z wrote of other files:
    an `input.bin` of other bytes and a file the inputs do not name."""
    from tpu7z.containers import tar as jtar
    from tpu7z.containers import zip as jzip
    from tpu7z.containers.sevenzip import write_archive as jwrite
    from tpu7z.models import deflate as jdef
    _inputs(d)
    old = {"input.bin": b"older input " * 50, "kept.txt": b"kept through the update"}
    (d / "old.7z").write_bytes(jwrite(old))
    (d / "old.zip").write_bytes(jzip.write_zip(old))
    (d / "old.tar").write_bytes(jtar.write_tar(old))
    (d / "input.bin.gz").write_bytes(jdef.gzip_compress(old["input.bin"]))
    (d / "other.gz").write_bytes(jdef.gzip_compress(old["kept.txt"]))


@pytest.mark.parametrize("args", [
    ["u", "old.7z", "input.bin", "d"],
    ["u", "old.7z"],
    ["u", "-m0=zstd", "-mx3", "old.7z", "input.bin"],
    ["u", "-psecret", "old.7z", "d"],
    ["u", "old.zip", "input.bin"],
    ["u", "-tzip", "-m0=ppmd", "old.zip", "d"],
    ["u", "old.tar", "d"],
    ["u", "input.bin.gz", "input.bin"],
    ["u", "other.gz", "input.bin"],
    ["u", "new.7z", "input.bin"],
    ["u", "new.7z"],
    ["u"],
    ["u", "-so", "old.7z", "input.bin"],
], ids=["7z_add_and_replace", "7z_rewrite", "7z_zstd", "7z_password", "zip", "zip_ppmd",
        "tar", "gz_same_name", "gz_other_name", "absent_archive", "absent_no_inputs",
        "no_archive", "stdout_ignores_old"])
def test_update_as_tpu7z(tmp_path, monkeypatch, capsysbinary, fixed_iv, args):
    """`u`: the inputs overlaid on the archive's files and the archive
    rewritten by the same writer, as tpu7z's `cmd_add(update=True)`:
    its bytes, lines and exit codes (a single stream takes its stripped
    name, so an input of another name makes two and is refused)."""
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _old_archives, args)
    assert (rc, out, port) == (ref_rc, ref_out, ref)
    if rc:
        assert rc == 2 and err == ref_err


@pytest.mark.parametrize("args", [
    ["h", "input.bin", "d/x.bin", "d/empty"], ["h"], ["h", "missing.bin"]],
    ids=["three_files", "none", "missing"])
def test_hash_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """`h`: every hasher's digest of each file, sorted by name, tpu7z's
    lines and exit codes (BLAKE3's tensor code here on the CPU)."""
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _inputs, args)
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
    assert len(out.splitlines()) == 22 * len(args[1:]) * (rc == 0)


def test_info_as_tpu7z(workdir, capsys):
    """`i`: tpu7z's codecs (method IDs, levels) and hashers; the banner is
    the port's, and the Formats line is tpu7z's, then the other types the
    port serves, in tpu7z's sniff order (both recorded as not
    reproduced)."""
    assert jmain(["i"]) == 0
    ref = capsys.readouterr().out.splitlines()
    assert main(["i"], device="cpu") == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(ref) and got[1:-1] == ref[1:-1]
    assert got[0] == "tpu7z_torch (the PyTorch/CUDA port of tpu7z)"
    assert got[-1] == ("Formats: 7z zstd lz4 lz5 lizard brotli xz bzip2 gzip tar zip squashfs "
                       "cpio ar rpm iso xar lzh Z lzip wim cab ext rar chm nsis swf flv arj qcow "
                       "vhdx vmdk vdi udf elf dmg hfs macho pe fat ntfs apfs gpt vhd ihex mbr "
                       "base64")
    # tpu7z's line, whole and in its order, first
    assert got[-1].startswith(ref[-1] + " ")
    assert sum("  levels " in line for line in got) == 13


def _bench_lines(out: bytes):
    """`b`'s lines without its rates: a codec row as (method, level,
    ratio), a hasher row as its name; headers, skip and failure lines as
    they are."""
    lines = []
    for line in out.decode().splitlines():
        f = line.split()
        if len(f) == 6 and f[1].isdigit():
            lines.append((f[0], f[1], f[4]))
        elif len(f) == 2 and f[0] != "hasher":
            lines.append(f[0])
        else:
            lines.append(line)
    return lines


@pytest.mark.parametrize("args", [
    ["b", "-md64k"], ["b", "-md64k", "lz4"], ["b", "-md64k", "-mx3", "ZSTD"],
    ["b", "-md16k", "sha256"], ["b", "-md16k", "blake3"], ["b", "-md4k", "nosuch"]],
    ids=["all", "lz4", "zstd_mx3", "sha256", "blake3", "unknown"])
def test_bench_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """`b`: every codec at its levels (or the one named, or one level
    under -mx) over make_corpus(-md), each round trip checked, then the
    hashers: tpu7z's lines, ratios and exit codes, not its rates."""
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, lambda d: None, args)
    assert (rc, err, port) == (ref_rc, ref_err, ref)
    assert _bench_lines(out) == _bench_lines(ref_out)
    if args[-1] == "-md64k":
        lines = _bench_lines(out)
        assert len([x for x in lines if isinstance(x, tuple)]) == 36
        assert len([x for x in lines if isinstance(x, str) and x and x[0].isupper()]) == 21
        assert not any("FAILED" in str(x) or "skip" in str(x) for x in lines)


@pytest.fixture(scope="module")
def scrc_archives():
    from tpu7z.containers import zip as jzip
    from tpu7z.containers.sevenzip import write_archive as jwrite
    from tpu7z.models import deflate as jdef
    files = {"a.txt": _input()[:3000], "b.bin": _input()[-1500:], "e": b""}
    return {"s.7z": jwrite(files), "s.zip": jzip.write_zip(files),
            "s.gz": jdef.gzip_compress(files["a.txt"])}


@pytest.mark.parametrize("switch", ["-scrc", "-scrc=*", "-scrcSHA256", "-scrc=xxh3-64",
                                    "-scrc=blake2sp", "-scrc=nosuch"])
@pytest.mark.parametrize("name", ["s.7z", "s.zip", "s.gz"])
def test_test_scrc_as_tpu7z(tmp_path, monkeypatch, capsysbinary, scrc_archives, name, switch):
    """`t -scrc[=NAME|*]`: after the type line, each file's hash under
    the name given (CRC32 by default, every hasher for `*`); a name
    neither it nor its upper case names prints nothing, as in tpu7z."""
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary,
        lambda d: (d / name).write_bytes(scrc_archives[name]), ["t", name, switch])
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
    assert rc == 0 and out.decode().endswith("Everything is Ok\n")


# --- -t as typed and the bare codec streams, each against tpu7z.cli ---

def _zip_of_input(d):
    from tpu7z.containers import zip as jzip
    (d / "input.bin").write_bytes(_input()[:3000])
    (d / "o.zip").write_bytes(jzip.write_zip({"input.bin": _input()[:3000]}))
    (d / "o.7z").write_bytes(b"")
    (d / "o.tar").write_bytes(b"")


@pytest.mark.parametrize("args", [
    ["a", "-tZIP", "q.zip", "input.bin"], ["t", "-tZIP", "o.zip"], ["x", "-tZIP", "o.zip"],
    ["l", "-tZIP", "o.zip"], ["a", "-t7Z", "q.7z", "input.bin"], ["t", "-t7Z", "o.7z"],
    ["a", "-tTAR", "q.tar", "input.bin"], ["x", "-tTAR", "o.tar"],
    ["a", "-tzst", "q.zst", "input.bin"], ["t", "-tzst", "o.zip"],
    ["a", "-tzstd", "-m0=zst", "q.zst", "input.bin"], ["a", "-tLZ4", "-mdev", "q.lz4", "input.bin"],
    ["a", "-tLZ4", "q.lz4", "input.bin"], ["t", "-tWIM", "o.zip"],
    ["a", "-tlz4", "-m0=zstd", "q.lz4", "input.bin"], ["a", "-tlz4", "-m0=nosuch", "q.lz4",
                                                      "input.bin"],
], ids=["a_ZIP", "t_ZIP", "x_ZIP", "l_ZIP", "a_7Z", "t_7Z", "a_TAR", "x_TAR", "a_zst", "t_zst",
        "a_zstd_m0_zst", "a_LZ4_mdev", "a_LZ4", "t_WIM", "a_lz4_m0_zstd", "a_lz4_m0_nosuch"])
def test_type_as_typed_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """-t kept as typed: container names compare exactly, any other name
    is a codec of the registry, in any case; `-tLZ4 -mdev` writes the host
    frame, as tpu7z's device check is `-tlz4` alone; -m0 names a single
    stream's codec. tpu7z's exit code, stdout, stderr and bytes."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _zip_of_input, args)
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)


@pytest.mark.parametrize("codec", ["lzma2", "deflate", "copy", "LZMA2", "Deflate", "bzip2",
                                   "Zstd"])
def test_bare_codec_streams_as_tpu7z(tmp_path, monkeypatch, capsysbinary, codec):
    """`a -t<codec>` writes the codec's bare stream, `t`, `x` and `l -t<codec>`
    read it, the output named with tpu7z's extensions stripped: tpu7z's
    exit codes, lines and bytes, on 3000 bytes."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    name = f"in.bin.{codec}"
    runs = []
    for which, run in (("ref", jmain), ("port", lambda a: main(a, device="cpu"))):
        d = tmp_path / which
        d.mkdir()
        (d / "in.bin").write_bytes(_input()[:3000])
        monkeypatch.chdir(d)
        said = []
        for args in (["a", f"-t{codec}", name, "in.bin"], ["t", f"-t{codec}", name],
                     ["x", f"-t{codec}", name, "-oout"], ["l", f"-t{codec}", name],
                     ["x", f"-t{codec}", name, "-so"]):
            capsysbinary.readouterr()
            rc = run(args)
            cap = capsysbinary.readouterr()
            said.append((rc, cap.out, cap.err))
        runs.append((said, {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*"))
                            if p.is_file()}))
    assert runs[1] == runs[0]
    said, files = runs[1]
    assert [s[0] for s in said] == [0] * 5 and said[-1][1] == _input()[:3000]
    assert files[f"out/{name}"] == _input()[:3000]


# --- the containers over the port's codecs, each against tpu7z.cli ---

def _elf() -> bytes:
    import shutil as _sh
    path = _sh.which("true")
    data = open(path, "rb").read() if path else b""
    return data if data[:4] == b"\x7fELF" else b""


@pytest.fixture(scope="module")
def containers(tmp_path_factory):
    """{name: tpu7z's image} for every container type the port reads, each
    under its extension (or, where tpu7z has none for it, its magic)."""
    from tests.test_disk_misc import _mk_gpt, _mk_mbr, _mk_qcow2
    from tests.test_nsis import _mk_nonsolid_deflate, _mk_solid_lzma
    from tests.test_ntfs import _mk_volume
    from tests.test_torch_disk_misc import _flv, _macho, _pe, _vdi, _vhdx, _vmdk
    from tests.test_torch_unix_archives import _rpm
    from tests.test_rar import _mk_rar4
    from tpu7z.containers import (apfs, ar, cab, chm, cpio, disk, dmg, fat, hfs, iso, lzh, misc,
                                  rar, squashfs, udf, wim, xar)
    from tpu7z.containers.sevenzip import write_archive
    import base64
    import bz2
    rng = np.random.default_rng(16)
    files = {"a.txt": _input()[:9000], "b.bin": rng.integers(0, 256, 3000, np.uint8).tobytes(),
             "c": b"c" * 700}
    one = _input()[:20000]
    made = {
        "a.sqfs": squashfs.write_squashfs(files), "a.cpio": cpio.write_cpio(files),
        "a.deb": ar.write_ar(files), "a.a": ar.write_ar(files),
        "a.rpm": _rpm(bz2.compress(cpio.write_cpio({"./x/" + k: v for k, v in files.items()})),
                      b"bzip2"),
        "a.iso": iso.write_iso(files), "a.xar": xar.write_xar(files), "a.wim": wim.write_wim(files),
        "a.vhd": disk.write_vhd_fixed(fat.write_fat16(files)), "a.qcow2": _mk_qcow2(one[:5000]),
        "a.vdi": _vdi(one[:5000]), "a.vmdk": _vmdk(one[:5000]), "a.vhdx": _vhdx(one[:5000]),
        "a.fat": fat.write_fat16(files), "a.udf": udf.write_udf(files),
        "a.swf": misc.write_swf_cws(b"FWS\x06" + (8 + len(one)).to_bytes(4, "little") + one),
        "a.hex": misc.write_ihex(one), "a.b64": base64.encodebytes(one), "a.exe": _pe(),
        "a.dylib": _macho(), "a.arj": misc.write_arj(files), "a.dmg": dmg.write_dmg(files),
        "a.hfs": hfs.write_hfs(files), "a.ntfs": _mk_volume()[0], "a.apfs": apfs.write_apfs(files),
        "setup.exe": b"MZ" + _mk_nonsolid_deflate()[2:], "solid.exe": b"MZ" + _mk_solid_lzma()[2:],
        "sfx.exe": _pe() + write_archive(files, method="copy"),
        "mbr_image": _mk_mbr()[0], "gpt_image": _mk_gpt()[0], "a.flv": _flv(),
        "a.lzh": lzh.write_lzh(files), "a.cab": cab.write_cab(files),
        "lzx.cab": cab.write_cab(files, "lzx"), "stored.cab": cab.write_cab(files, "none"),
        "a.chm": chm.write_chm(files), "a.rar": rar.write_rar5(files),
        "store.rar": rar.write_rar5_store(files), "old.rar": _mk_rar4(files),
    }
    if _elf():
        made["a.so"] = _elf()
    ext_img = _ext_image(tmp_path_factory.mktemp("ext"), files)
    if ext_img:
        made["a.ext4"] = ext_img
    return made


def _ext_image(tmp, files):
    import shutil as _sh
    mke2fs = _sh.which("mke2fs") or "/usr/sbin/mke2fs"
    if not os.path.exists(mke2fs):
        return None
    for k, v in files.items():
        (tmp / "tree" / k).parent.mkdir(parents=True, exist_ok=True)
        (tmp / "tree" / k).write_bytes(v)
    r = subprocess.run([mke2fs, "-q", "-t", "ext4", "-b", "1024", "-d", str(tmp / "tree"), "-N",
                        "64", str(tmp / "img"), "2048"], capture_output=True)
    return (tmp / "img").read_bytes() if r.returncode == 0 else None


CONTAINER_NAMES = ["a.sqfs", "a.cpio", "a.deb", "a.a", "a.rpm", "a.iso", "a.xar", "a.wim",
                   "a.ext4", "a.vhd", "a.qcow2", "a.vdi", "a.vmdk", "a.vhdx", "a.fat", "a.udf",
                   "a.swf", "a.hex", "a.b64", "a.exe", "a.so", "a.dylib", "a.arj", "a.dmg",
                   "a.hfs", "a.ntfs", "a.apfs", "setup.exe", "solid.exe", "sfx.exe", "mbr_image",
                   "gpt_image", "a.flv", "a.lzh", "a.cab", "lzx.cab", "stored.cab", "a.chm",
                   "a.rar", "store.rar", "old.rar"]


@pytest.mark.parametrize("verb", [["t"], ["l"], ["x", "-oout"]], ids=["t", "l", "x"])
@pytest.mark.parametrize("name", CONTAINER_NAMES)
def test_read_containers_as_tpu7z(tmp_path, monkeypatch, capsysbinary, containers, name, verb):
    """`t`, `l` and `x` of each container type, by its extension (or, for
    the partition tables, by magic): tpu7z's exit code, stdout, stderr and
    files."""
    if name not in containers:
        pytest.skip(f"{name}: its maker is not on this machine")
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary,
        lambda d: (d / name).write_bytes(containers[name]), [verb[0], name, *verb[1:]])
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
    assert rc == 0


SNIFFED = ["a.sqfs", "a.cpio", "a.deb", "a.rpm", "a.iso", "a.xar", "a.wim", "a.ext4", "a.vhd",
           "a.qcow2", "a.vdi", "a.vmdk", "a.vhdx", "a.fat", "a.udf", "a.swf", "a.hex", "a.exe",
           "a.so", "a.dylib", "a.arj", "a.dmg", "a.hfs", "a.ntfs", "a.apfs", "setup.exe",
           "a.flv", "a.lzh", "a.cab", "lzx.cab", "a.chm", "a.rar", "old.rar"]


@pytest.mark.parametrize("name", SNIFFED)
def test_containers_found_by_magic_as_tpu7z(tmp_path, monkeypatch, capsysbinary, containers,
                                            name):
    """Each type with a magic, under a name that says nothing: `t` and `l`
    find it by tpu7z's magic tests, in tpu7z's order."""
    if name not in containers:
        pytest.skip(f"{name}: its maker is not on this machine")
    for verb in ("t", "l"):
        sub = tmp_path / verb
        sub.mkdir()
        (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
            sub, monkeypatch, capsysbinary,
            lambda d: (d / "noext").write_bytes(containers[name]), [verb, "noext"])
        assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
        assert rc == 0 and b"7z" not in out.split(b"\n")[1 if verb == "l" else 0]


@pytest.mark.parametrize("args", [
    ["a", "-twim", "o.wim", "input.bin", "d"], ["a", "o.wim", "input.bin"],
    ["a", "-tudf", "o.udf", "input.bin", "d"], ["a", "-tfat", "o.fat", "input.bin", "d"],
    ["a", "-tarj", "o.arj", "input.bin", "d"], ["a", "-tvhd", "o.vhd", "input.bin"],
    ["a", "-tvhd", "o.vhd", "input.bin", "d"], ["a", "-tihex", "o.hex", "input.bin"],
    ["a", "-tihex", "-so", "o.hex", "d"], ["a", "-tudf", "-so", "o.udf", "d"],
    ["a", "-tsquashfs", "o.sqfs", "input.bin"], ["a", "o.iso", "input.bin"],
    ["a", "-tlzh", "o.lzh", "input.bin"], ["a", "-tWIM", "o.wim", "input.bin"],
    ["a", "-tcab", "o.cab", "input.bin", "d"], ["a", "o.cab", "input.bin"],
    ["a", "-tcab", "-so", "o.cab", "d"], ["a", "-trar", "o.rar", "input.bin", "d"],
    ["a", "o.rar", "input.bin"], ["a", "-trar", "-m0=copy", "o.rar", "input.bin", "d"],
    ["a", "-trar", "-mx0", "o.rar", "input.bin"], ["a", "-trar", "-mx9", "-m0=lzma", "o.rar", "d"],
    ["a", "-tchm", "o.chm", "input.bin"], ["a", "-tCAB", "o.cab", "input.bin"],
], ids=["wim", "wim_by_name", "udf", "fat", "arj", "vhd", "vhd_many", "ihex", "ihex_many_so",
        "udf_so", "squashfs_none", "iso_none", "lzh_none", "WIM", "cab", "cab_by_name", "cab_so",
        "rar", "rar_by_name", "rar_copy", "rar_mx0", "rar_other_method", "chm_none", "CAB"])
def test_add_containers_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """`a` of each type tpu7z's `a` writes (wim, udf, fat, arj, vhd, ihex,
    cab with MSZIP, rar: RAR5, stored with -m0=copy or -mx0), and of types
    it does not (squashfs, iso, lzh, chm, -tCAB: its unknown-codec error):
    tpu7z's exit code, stdout, stderr and bytes; then `t` of the port's
    archive, as tpu7z tests it."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    monkeypatch.setattr("time.time", lambda: 1_700_000_000.5)   # arj stamps its headers
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _inputs, args)
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)
    if rc == 0 and "-so" not in args:
        name = next(a for a in args[1:] if not a.startswith("-"))
        capsysbinary.readouterr()
        assert main(["t", name], device="cpu") == 0
        assert jmain(["t", name]) == 0
        outs = capsysbinary.readouterr().out.split(b"Everything is Ok\n")
        assert outs[0] == outs[1]


def test_update_wim_as_tpu7z(tmp_path, monkeypatch, capsysbinary):
    """`u` of a .wim: tpu7z's files overlaid on the archive's, rewritten."""
    from tpu7z.containers import wim

    def prepare(d):
        _inputs(d)
        (d / "o.wim").write_bytes(wim.write_wim({"old": b"o" * 99, "input.bin": b"older"}))
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, prepare, ["u", "o.wim", "input.bin", "d"])
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref) and rc == 0


def test_zws_swf_exits_2_where_tpu7z_raises(workdir, capsys):
    """A ZWS (LZMA) swf: tpu7z's reader imports a module its package lacks
    and raises ImportError out of its CLI; the port exits 2."""
    body = b"\x78\x00" + _input()[:500]
    zws = (b"ZWS\x0d" + (8 + len(body)).to_bytes(4, "little") + (40).to_bytes(4, "little")
           + b"\x5d\x00\x00\x10\x00" + bytes(40))
    (workdir / "m.swf").write_bytes(zws)
    with pytest.raises(ImportError):
        jmain(["t", "m.swf"])
    capsys.readouterr()
    assert main(["t", "m.swf"], device="cpu") == 2
    assert capsys.readouterr().err == "ERROR: swf: ZWS (LZMA) body\n"


# --- the rest of tpu7z's CLI: volumes, selection, progress, parsing ---

@pytest.mark.parametrize("args", [
    ["a", "-v10k", "o.7z", "input.bin", "d"], ["a", "-tzip", "-v3000b", "o.zip", "input.bin"],
    ["a", "-v1m", "o.zst", "input.bin"], ["a", "-tcab", "-v4k", "o.cab", "input.bin", "d"],
    ["a", "-v0", "o.zst", "input.bin"], ["a", "-v10k", "-so", "o.7z", "input.bin"],
], ids=["7z", "zip", "one_volume", "cab", "v0", "so_wins"])
def test_add_volumes_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """-v{size}: archive.001, .002, ... of that size but the last, and
    tpu7z's line; -v0 writes one archive, -so writes to standard output."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _inputs, args)
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref) and rc == 0


def test_bad_volume_size_exits_2_where_tpu7z_raises(workdir, capsys):
    """A bare -v number is a log size, as -md's: over 63, tpu7z's switch
    parser raises out of its CLI (a traceback, as for a bad -mmt); the
    port exits 2 with the same message."""
    from tpu7z.utils.errors import TpuzError as JErr
    with pytest.raises(JErr, match="log size 3000 out of range"):
        jmain(["a", "-v3000", "o.7z", "input.bin"])
    capsys.readouterr()
    assert main(["a", "-v3000", "o.7z", "input.bin"], device="cpu") == 2
    assert capsys.readouterr().err == "ERROR: log size 3000 out of range\n"
    assert not list(workdir.glob("o.7z*"))


def _volumes(d):
    from tpu7z.containers import cab as jcab
    from tpu7z.containers.sevenzip import write_archive as jwrite
    from tpu7z.models.zstd import frame as jzst
    files = {"a.txt": _input()[:9000], "b.bin": _input()[-6000:]}
    for name, blob in (("s.7z", jwrite(files)), ("s.cab", jcab.write_cab(files)),
                       ("s.zst", jzst.compress(_input()))):
        for i, off in enumerate(range(0, len(blob), 4000)):
            (d / f"{name}.{i + 1:03d}").write_bytes(blob[off:off + 4000])
    (d / "gap.cab.001").write_bytes(jcab.write_cab(files)[:4000])
    (d / "gap.cab.003").write_bytes(b"never read")


@pytest.mark.parametrize("args", [
    ["t", "s.7z.001"], ["x", "s.7z.001", "-oout"], ["l", "s.7z.001"], ["t", "s.cab.001"],
    ["x", "s.cab.001", "-oout"], ["l", "s.cab.001"], ["x", "s.zst.001", "-oout"],
    ["x", "s.zst.001", "-mmt1", "-oout"], ["t", "s.cab.002"], ["t", "gap.cab.001"],
    ["t", "missing.001"]],
    ids=["t_7z", "x_7z", "l_7z", "t_cab", "x_cab", "l_cab", "x_zst", "x_zst_mmt1", "t_second",
         "t_gap", "t_missing"])
def test_read_volumes_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """A `.001` name opens the whole set (up to its first gap): tpu7z's
    exit codes, lines and files; `l` of a .7z reads the first volume only,
    as tpu7z's does, and a `.001` stream is not streamed at -mmt1."""
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _volumes, args)
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)


@pytest.mark.parametrize("args", [
    ["a", "-i!*.txt", "o.7z", "input.bin", "d"], ["a", "-x!*.bin", "o.zip", "input.bin", "d"],
    ["a", "-i!d/*", "-x!*empty", "o.tar", "d"], ["a", "-x!*", "o.7z", "input.bin"],
    ["a", "-i!input.bin", "-r", "o.cab", "input.bin", "d"],
    ["a", "-i!*.bin", "-x!input.bin", "o.zst", "input.bin", "d"],
], ids=["include_txt", "exclude_bin", "include_and_exclude", "exclude_all", "include_one",
        "exclude_wins"])
def test_add_selection_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """-i! keeps the inputs it matches, by name or last part, and -x!
    drops them, excludes first: tpu7z's archive, lines and exit code."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _inputs, args)
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref)


def _selection_archives(d):
    from tpu7z.containers import rar as jrar
    from tpu7z.containers import zip as jzip
    from tpu7z.containers.sevenzip import write_archive as jwrite
    from tpu7z.models.zstd import frame as jzst
    files = {"a.txt": b"text " * 300, "sub/b.log": b"log line\n" * 90, "c.bin": _input()[:3000],
             "sub/deep/d.txt": b"deeper " * 40}
    (d / "s.7z").write_bytes(jwrite(files))
    (d / "s.zip").write_bytes(jzip.write_zip(files))
    (d / "s.rar").write_bytes(jrar.write_rar5(files))
    (d / "s.txt.zst").write_bytes(jzst.compress(b"one stream " * 100))


@pytest.mark.parametrize("verb", [["t"], ["x", "-oout"], ["e", "-oout"], ["x", "-so"], ["l"]],
                         ids=["t", "x", "e", "x_so", "l"])
@pytest.mark.parametrize("switches", [["-i!*.txt"], ["-x!*.log"], ["-i!sub/*", "-x!*.log"],
                                      ["-i!*.txt", "-i!c.*"], ["-x!*"]],
                         ids=["include", "exclude", "both", "two_includes", "exclude_all"])
@pytest.mark.parametrize("name", ["s.7z", "s.zip", "s.rar", "s.txt.zst"])
def test_read_selection_as_tpu7z(tmp_path, monkeypatch, capsysbinary, name, switches, verb):
    """-i!/-x! in `t`, `x`, `e` and -so (`l` lists every file, as tpu7z's
    does): tpu7z's counts, lines and files."""
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, _selection_archives,
        [verb[0], name, *switches, *verb[1:]])
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref) and rc == 0


@pytest.mark.parametrize("switch", ["-bb", "-bb3", "-bd", "-bb -bd", "-bd -bb"])
@pytest.mark.parametrize("name", ["s.7z", "s.zip", "s.rar", "s.txt.zst"])
def test_progress_as_tpu7z(tmp_path, monkeypatch, capsys, name, switch):
    """`x` with -bb writes tpu7z's percent lines to standard error, with
    -bd nothing; the later switch wins."""
    said = []
    for which, run in (("ref", jmain), ("port", lambda a: main(a, device="cpu"))):
        d = tmp_path / which
        d.mkdir()
        _selection_archives(d)
        monkeypatch.chdir(d)
        capsys.readouterr()
        rc = run(["x", name, "-oout", *switch.split()])
        cap = capsys.readouterr()
        said.append((rc, cap.out, cap.err))
    assert said[0] == said[1]
    assert ("%" in said[1][2]) == switch.split()[-1].startswith("-bb")


@pytest.mark.parametrize("args", [
    ["a", "-q", "-tzstd", "o.zst", "input.bin"], ["t", "-bt", "-zz", "o.zst"],
    ["a", "-v", "-vx", "o.7z", "input.bin"], ["a", "-m1=lzma", "-mfb=64", "o.7z", "input.bin"],
    ["a", "-sdel", "-sccUTF-8", "o.zip", "input.bin"], ["z", "o.zst"], ["z", "-q", "o.zst"],
    ["help"], ["A", "o.7z", "input.bin"], ["x"], ["t"], ["l"], ["a"],
], ids=["q", "bt_zz", "v_without_size", "m1_mfb", "sdel_scc", "z", "z_with_switch", "help",
        "A", "x_no_archive", "t_no_archive", "l_no_archive", "a_no_archive"])
def test_parse_as_tpu7z(tmp_path, monkeypatch, capsysbinary, args):
    """A switch the CLI does not know: tpu7z's warning on standard error,
    the switch ignored; a command it does not know: `unknown command`,
    exit 1; a verb without its archive: tpu7z's error, exit 2."""
    monkeypatch.delenv("TPU7Z_DEVICE", raising=False)

    def prepare(d):
        _inputs(d)
        from tpu7z.models.zstd import frame as jzst
        (d / "o.zst").write_bytes(jzst.compress(b"z" * 1000))
    runs = []
    for which, run in (("ref", jmain), ("port", lambda a: main(a, device="cpu"))):
        d = tmp_path / which
        d.mkdir()
        prepare(d)
        monkeypatch.chdir(d)
        capsysbinary.readouterr()
        rc = run(list(args))
        cap = capsysbinary.readouterr()
        runs.append((rc, cap.out, cap.err, {str(p.relative_to(d)): p.read_bytes()
                                            for p in sorted(d.rglob("*")) if p.is_file()}))
    assert runs[0] == runs[1]
    rc, out, err, _ = runs[1]
    if args[0] in ("z", "help", "A"):
        assert rc == 1 and err.decode().endswith(f"unknown command {args[0]!r}\n")
    for a in args[1:]:
        if a.startswith("-") and a not in ("-tzstd",):
            assert f"warning: ignoring switch {a}\n".encode() in err


@pytest.mark.parametrize("name,write", [("o.cab", "cab"), ("o.rar", "rar")])
def test_update_cab_and_rar_as_tpu7z(tmp_path, monkeypatch, capsysbinary, name, write):
    """`u` of a .cab and a .rar: the inputs overlaid on the archive's
    files and the whole rewritten, as tpu7z's."""
    from tpu7z.containers import cab as jcab
    from tpu7z.containers import rar as jrar

    def prepare(d):
        _inputs(d)
        old = {"old.txt": b"o" * 99, "input.bin": b"older"}
        (d / name).write_bytes(jcab.write_cab(old) if write == "cab" else jrar.write_rar5(old))
    (ref_rc, ref_out, ref_err, ref), (rc, out, err, port) = _run_both(
        tmp_path, monkeypatch, capsysbinary, prepare, ["u", name, "input.bin", "d"])
    assert (rc, out, err, port) == (ref_rc, ref_out, ref_err, ref) and rc == 0
