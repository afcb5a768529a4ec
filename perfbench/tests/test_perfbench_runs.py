"""Whole runs on the CPU at a small size: past the look for a card, the
rest of a run as `run.py` makes it, with the program's CPU path. Sound
runs come out correct; the control and each fault the cell can have come
out not correct. On the card: one short run of each one-chip cell."""

import json
import os
import subprocess
import sys

import pytest

RUN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "run.py")
ROOT = os.path.dirname(os.path.dirname(RUN))
HELD = os.path.join(os.path.dirname(RUN), "tests", "held_cells.json")
POOL = {"lz4dev.bulk32m": 1 << 20, "gzip6.bulk4m": 1 << 21, "lz4dev.kafka16k": 1 << 21,
        "lz4dev4.bulk64m": 1 << 19}


def run(cell, *extra, seed=2**31 + 5, seconds=1.0, trace=0, device="cpu"):
    argv = [sys.executable, RUN, "--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    if device == "cpu":
        argv += ["--device", "cpu", "--pool-bytes", str(POOL[cell]), "--extra-cells", HELD]
    p = subprocess.run([*argv, *extra], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    return line


@pytest.mark.parametrize("cell", list(POOL))
def test_sound_run_is_correct(cell):
    line = run(cell)
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert {"setup_s", "compress_MBps", "ratio"} <= set(line["metrics"])
    assert line["device"]["count"] == (4 if cell.startswith("lz4dev4") else 1)


def test_traced_run_reports_per_layer_metrics():
    line = run("gzip6.bulk4m", trace=1, seconds=6.0)
    assert line["correct"] is True
    assert {"deflate.header_ms", "lz.match_lengths_ms"} <= set(line["metrics"])
    assert "breakdown" in line and line["device"]["window_s"] > 0


@pytest.mark.parametrize("cell,fault", [
    ("lz4dev.bulk32m", "stored"),
    ("lz4dev.bulk32m", "half_batch"),
    ("lz4dev.bulk32m", "altered_lz4"),
    ("lz4dev.kafka16k", "altered_lz4"),
    ("gzip6.bulk4m", "altered_deflate"),
    ("lz4dev4.bulk64m", "no_exchange"),
    ("lz4dev4.bulk64m", "altered_lz4"),
])
def test_fault_is_not_correct(cell, fault):
    line = run(cell, "--fault", fault)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
    if fault == "altered_lz4":
        assert line["checks"]["frames_not_decoding"]["value"] >= 1


@pytest.mark.parametrize("cell", ["lz4dev.bulk32m", "gzip6.bulk4m"])
def test_control_is_not_correct(cell):
    p = subprocess.run([sys.executable, os.path.join(os.path.dirname(RUN), "calibrate.py"),
                        "--workload", cell, "--seeds", "11", "--control-seeds", "12,13",
                        "--seconds", "1", "--device", "cpu", "--pool-bytes", str(POOL[cell])],
                       cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert all(r["correct"] for r in out["program"])
    assert not any(r["correct"] for r in out["control"])


def test_no_card_prints_no_result():
    p = subprocess.run([sys.executable, RUN, "--workload", "lz4dev.bulk32m", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.card
@pytest.mark.parametrize("cell", ["lz4dev.bulk32m", "gzip6.bulk4m", "lz4dev.kafka16k"])
def test_cell_on_the_card(card, cell):
    line = run(cell, seconds=2.0, device="cuda")
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
