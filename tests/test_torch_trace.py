"""The port's trace hooks against tpu7z.utils.trace: host spans emit the
same events through callbacks, records and TPU7Z_TRACE; `profile` writes
a torch.profiler trace that holds an `annotate`d region."""

import json

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tpu7z.utils import trace as jtrace  # noqa: E402
from tpu7z_torch.utils import trace  # noqa: E402

MODULES = {"tpu7z": jtrace, "tpu7z_torch": trace}


@pytest.fixture(autouse=True)
def _detached(monkeypatch):
    monkeypatch.delenv("TPU7Z_TRACE", raising=False)
    for mod in MODULES.values():
        mod.detach()
        mod.clear()
    yield
    for mod in MODULES.values():
        mod.detach()
        mod.clear()


def _untimed(event):
    return {k: v for k, v in event.items() if k not in ("seconds", "MBps")}


def _run(mod, fail=False):
    """Events of one span through a callback, and the kept records."""
    seen = []
    mod.attach(seen.append, keep_records=True)
    with pytest.raises(ValueError) if fail else _nothing():
        with mod.span("lz4.compress", size=4096, level=3):
            sum(range(1000))
            if fail:
                raise ValueError("bad block")
    return seen, mod.records()


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.mark.parametrize("fail", [False, True], ids=["ok", "error"])
def test_span_emits_what_tpu7z_emits(fail):
    (jseen, jrec), (seen, rec) = (_run(m, fail) for m in MODULES.values())
    assert [_untimed(e) for e in seen] == [_untimed(e) for e in jseen]
    assert rec == seen and jrec == jseen and len(seen) == 1
    ev = seen[0]
    assert ev["seconds"] > 0 and sorted(ev) == sorted(jseen[0])
    assert ev["MBps"] == pytest.approx(4096 / ev["seconds"] / 1e6)
    assert ("error" in ev) == fail


def test_detached_span_emits_nothing():
    for mod in MODULES.values():
        assert not mod.enabled()
        with mod.span("lz4.compress", size=1):
            pass
        assert mod.records() == []


def test_environment_prints_each_event(monkeypatch, capsys):
    monkeypatch.setenv("TPU7Z_TRACE", "1")
    lines = []
    for mod in MODULES.values():
        assert mod.enabled()
        with mod.span("lz4.compress"):
            pass
        lines.append(capsys.readouterr().err)
    assert all(line.startswith("[tpu7z-trace] {'name': 'lz4.compress'")
               for line in lines)
    assert [mod.records() for mod in MODULES.values()] == [[], []]


def test_profile_writes_the_annotated_region(tmp_path):
    x = torch.arange(1 << 16, dtype=torch.int64)
    with trace.profile(tmp_path, device="cpu"):
        with trace.annotate("tpu7z_torch.test_region"):
            torch.sort(x * 2654435761 % 65536)
    files = list(tmp_path.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    region = [e for e in events if e.get("name") == "tpu7z_torch.test_region"]
    assert len(region) == 1 and region[0]["dur"] > 0


def test_profile_runs_on_the_card_unless_told(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace.profile(tmp_path):
            pass
