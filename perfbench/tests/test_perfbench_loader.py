"""Every piece found by its name, and BENCHMARK.json within the rules the
benchmark was defined under."""

import json
import re

import pytest

from pb import loader

BENCH = loader.benchmark()
HELD = str(loader.HERE / "tests" / "held_cells.json")
WITH_HELD = loader.benchmark(HELD)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in WITH_HELD["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_finds_its_pieces(cell):
    c = loader.Cell(cell, WITH_HELD)
    assert c.config["name"] == c.spec["config"]
    assert c.config["chips"] == c.chips
    loader.module("entries", c.config["entry"]).Entry
    ref = loader.module("reference", c.config["reference"])
    assert callable(ref.compress) and callable(ref.compare)
    assert set(c.config["checks"]) and all("limit" in v for v in c.config["checks"].values())
    assert c.run["check"]["sample"] >= 1 and c.run["trace"]["requests"] >= 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in WITH_HELD["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(loader.module("metrics", metric).read)


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        loader.Cell("no.such.cell", BENCH)


def test_held_cells_are_not_run_by_default():
    held = {w["name"] for w in WITH_HELD["workloads"]} - {w["name"] for w in BENCH["workloads"]}
    assert held
    for cell in held:
        with pytest.raises(KeyError):
            loader.Cell(cell, BENCH)


@pytest.mark.parametrize("bench", [BENCH, WITH_HELD], ids=["benchmark", "with_held"])
def test_contract_shape(bench):
    BENCH = bench  # noqa: N806
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert json.load(open(loader.ROOT / c["file"]))["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in loader.Cell(cell, BENCH).end_to_end}
    for c in BENCH["configs"]:
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len(json.dumps(BENCH)) < 64 * 1024
