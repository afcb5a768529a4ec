"""The port's codec plugins (tpu7z_torch/utils/plugins.py) against tpu7z's
(tests/test_plugins_trace.py's cases, held against tpu7z): the same
directories, the same table, the same errors, each codec registered in
the port's own registry; and the CLI loading them before its verb runs,
as tpu7z's does."""

import os
import textwrap

import pytest

from tests.torch_parity import same
from tpu7z.cli.main import main as jmain
from tpu7z.models import registry as jreg
from tpu7z.utils import plugins as jplug
from tpu7z_torch.cli.main import main as tmain
from tpu7z_torch.models import registry as treg
from tpu7z_torch.utils import plugins as tplug


def _write_plugin(d, name="myplug.py", codec="revcodec", extra=""):
    p = d / name
    p.write_text(textwrap.dedent(f"""
        def _c(data, level=5, **kw):
            return bytes(reversed(data))
        def _d(data, **kw):
            return bytes(reversed(data))
        TPU7Z_CODECS = [{{"name": "{codec}", "method_id": 0x7F0001,
                          "compress": _c, "decompress": _d,
                          "levels": (1, 1)}}]
    """) + extra)
    return str(p)


@pytest.fixture(autouse=True)
def _registries():
    """Each test's plugin codecs leave both registries as they were."""
    before = (set(jreg.CODECS), set(treg.CODECS))
    yield
    for reg, names in ((jreg.CODECS, before[0]), (treg.CODECS, before[1])):
        for name in set(reg) - names:
            del reg[name]


def test_plugin_loads_and_registers_as_tpu7z(tmp_path):
    path = _write_plugin(tmp_path)
    assert same(jplug.load_plugin_file, tplug.load_plugin_file, path) == ("ok", ["revcodec"])
    c = treg.get_codec("revcodec")
    assert c.decompress(c.compress(b"abc")) == b"abc" and c.levels == (1, 1)
    assert c.method_id == 0x7F0001


def test_plugin_dir_scan_as_tpu7z(tmp_path):
    _write_plugin(tmp_path, "one.py", "plugscan")
    (tmp_path / "broken.py").write_text("raise RuntimeError('boom')")
    (tmp_path / "_private.py").write_text("raise RuntimeError('never loaded')")
    (tmp_path / "notes.txt").write_text("not a module")
    ref = jplug.load_plugins([str(tmp_path)])
    got = tplug.load_plugins([str(tmp_path)])
    assert got == ref
    assert [v for v in got.values() if isinstance(v, list)] == [["plugscan"]]
    bad = [v for v in got.values() if isinstance(v, str)]
    assert len(bad) == 1 and "boom" in bad[0]


@pytest.mark.parametrize("case", ["duplicate", "no_table", "missing_key", "not_callable",
                                  "empty_name", "bad_method_id"])
def test_plugin_errors_as_tpu7z(tmp_path, case):
    if case == "duplicate":
        path = _write_plugin(tmp_path, codec="zstd")
    elif case == "no_table":
        path = str(tmp_path / "none.py")
        (tmp_path / "none.py").write_text("X = 1\n")
    else:
        entry = {"missing_key": '{"name": "k", "method_id": 1, "compress": len}',
                 "not_callable": '{"name": "k", "method_id": 1, "compress": 1, "decompress": 2}',
                 "empty_name": '{"name": "", "method_id": 1, "compress": len, "decompress": len}',
                 "bad_method_id": '{"name": "k2", "method_id": "x", "compress": len, '
                                  '"decompress": len}'}[case]
        path = str(tmp_path / "e.py")
        (tmp_path / "e.py").write_text(f"TPU7Z_CODECS = [{entry}]\n")
    kind, message = same(jplug.load_plugin_file, tplug.load_plugin_file, path)
    assert kind in ("TpuzError", "ValueError") and message


def test_plugin_dirs_as_tpu7z(tmp_path, monkeypatch):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("TPU7Z_PLUGIN_DIR", os.pathsep.join([str(a), str(tmp_path / "gone"), str(b)]))
    assert tplug.plugin_dirs() == jplug.plugin_dirs() == [str(a), str(b)]
    (tmp_path / "home" / ".tpu7z" / "plugins").mkdir(parents=True)
    monkeypatch.delenv("TPU7Z_PLUGIN_DIR")
    assert tplug.plugin_dirs() == jplug.plugin_dirs() == [str(tmp_path / "home/.tpu7z/plugins")]


@pytest.mark.parametrize("verbs", [
    [["a", "-trevcodec", "o.rev", "in.txt"], ["t", "-trevcodec", "o.rev"],
     ["x", "-trevcodec", "o.rev", "-oout"], ["l", "-trevcodec", "o.rev"]],
    [["i"]],
    [["a", "-t7z", "-m0=revcodec", "o.7z", "in.txt"]],
], ids=["a_t_x_l", "i", "7z_folder"])
def test_cli_loads_plugins_as_tpu7z(tmp_path, monkeypatch, capsysbinary, verbs):
    """TPU7Z_PLUGIN_DIR names a plugin: each CLI loads it before its verb,
    so -t and -m0 can name its codec: tpu7z's exit codes, lines and files
    (`i` lists the codec; a .7z folder refuses a codec it has no coder
    for, in the same words)."""
    plugdir = tmp_path / "plugins"
    plugdir.mkdir()
    _write_plugin(plugdir)
    monkeypatch.setenv("TPU7Z_PLUGIN_DIR", str(plugdir))
    runs = []
    for which, run in (("ref", jmain), ("port", lambda a: tmain(a, device="cpu"))):
        d = tmp_path / which
        d.mkdir()
        (d / "in.txt").write_bytes(b"plugin payload " * 50)
        monkeypatch.chdir(d)
        said = []
        for args in verbs:
            capsysbinary.readouterr()
            rc = run(args)
            cap = capsysbinary.readouterr()
            # `i`: the banner and the Formats line are the port's own
            said.append((rc, cap.out if args != ["i"] else cap.out.split(b"\n")[1:-2], cap.err))
        runs.append((said, {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*"))
                            if p.is_file()}))
    assert runs[0] == runs[1]
    if verbs[0][0] == "a" and verbs[0][1] == "-trevcodec":
        assert [s[0] for s in runs[1][0]] == [0] * 4
        assert runs[1][1]["o.rev"] == bytes(reversed(b"plugin payload " * 50))
    if verbs == [["i"]]:
        assert b"    7F0001  revcodec  levels 1-1" in runs[1][0][0][1]


def test_a_broken_plugin_does_not_stop_the_cli_as_tpu7z(tmp_path, monkeypatch, capsysbinary):
    plugdir = tmp_path / "plugins"
    plugdir.mkdir()
    (plugdir / "broken.py").write_text("raise RuntimeError('boom')")
    monkeypatch.setenv("TPU7Z_PLUGIN_DIR", str(plugdir))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "in.txt").write_bytes(b"abc" * 100)
    assert jmain(["a", "-tzstd", "ref.zst", "in.txt"]) == 0
    assert tmain(["a", "-tzstd", "port.zst", "in.txt"], device="cpu") == 0
    assert (tmp_path / "ref.zst").read_bytes() == (tmp_path / "port.zst").read_bytes()
