"""bench_torch.py, the port's benchmark, run here on the CPU (`--device
cpu`, which exists for these tests): one JSON result line with every key,
its comp_total and device_ratio equal to bench.py's formula over tpu7z's
plane encoder on the same blocks, a corrupted block refused, and no
result without a card when no device is named."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from tpu7z.ops import lz4_plane as JP  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
MB = 1
DETAIL_KEYS = {
    # bench.py's
    "corpus_MB", "headline_tier", "verified", "device_MBps", "device_ratio",
    "device_platform", "device", "matcher_W", "timing", "ref_MBps_same_run", "ref_csize",
    "ref_ratio", "baseline_source", "host_native_MBps", "host_native_ratio",
    # the port's
    "power_limit_W", "comp_total", "encode_ms", "stages_ms", "idle_share", "run_s"}
STAGES = {"candidates", "lz4_match", "lz4_parse", "lz4_geometry", "lz4_emit"}


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "TPU7Z_REF_7ZZ"}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", **extra)
    return env


def _run(args, code=None, **env):
    cmd = [sys.executable, *(["-c", code] if code else ["bench_torch.py"]), *args]
    return subprocess.run(cmd, cwd=REPO, env=_env(**env), capture_output=True, text=True,
                          timeout=600)


@pytest.fixture(scope="module")
def result():
    r = _run(["--device", "cpu", "--mb", str(MB)])
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    assert len(lines) == 1, r.stdout
    return json.loads(lines[0])


def test_one_line_with_every_key(result):
    assert set(result) == {"metric", "value", "unit", "vs_baseline", "detail"}
    assert result["metric"] == "lz4_encode_MBps_per_chip"
    assert result["unit"] == "MB/s"
    assert set(result["detail"]) == DETAIL_KEYS
    d = result["detail"]
    assert set(d["stages_ms"]) == STAGES
    assert all(v > 0 for v in d["stages_ms"].values())
    assert d["encode_ms"]["min"] <= d["encode_ms"]["median"] <= d["encode_ms"]["max"]
    assert result["value"] == d["device_MBps"] > 0


def test_cpu_run_names_no_card(result):
    d = result["detail"]
    assert (d["device"], d["device_platform"], d["headline_tier"]) == ("cpu", "cpu", "cpu")
    assert d["power_limit_W"] is None and d["idle_share"] is None
    assert d["corpus_MB"] == MB and d["matcher_W"] == 0
    assert d["verified"] == f"all {MB * 16} blocks bit-exact round-trip"


def test_host_tier_and_no_reference(result):
    d = result["detail"]
    assert d["host_native_MBps"] > 0 and d["host_native_ratio"] > 1
    assert result["vs_baseline"] is None and d["ref_MBps_same_run"] is None
    assert d["ref_csize"] is None and d["ref_ratio"] is None
    assert "no 7zz binary found in-run" in d["baseline_source"]


def test_ratio_equals_bench_py_formula_on_tpu7z(result):
    """bench.py's CPU child on the same 16 blocks: tpu7z's plane encoder
    mapped over them at W = 0, comp_total = sum(min(used, N + 4))."""
    data = make_corpus(32 << 20)[:MB << 20]
    N = JP.BLOCK
    B = len(data) // N
    blocks = jnp.asarray(np.frombuffer(data, np.uint8).reshape(B, N))
    planes = blocks.reshape(B, JP.NROWS, JP.ROW).astype(jnp.int32)
    ns = jnp.full((B,), N, jnp.int32)

    @jax.jit
    def encode(planes, ns):
        outs, useds = jax.lax.map(lambda a: JP.encode_block_planes(a[0], a[1], W=0),
                                  (planes, ns))
        return outs.reshape(B, -1), useds

    _, used = encode(planes, ns)
    comp_total = int(np.minimum(np.asarray(used), N + 4).sum())
    assert result["detail"]["comp_total"] == comp_total
    assert result["detail"]["device_ratio"] == round(len(data) / comp_total, 3)


CORRUPT = """
import sys
import bench_torch
from tpu7z_torch.ops import lz4_cuda

encode = lz4_cuda.encode_blocks

def corrupted(*args, **kwargs):
    out, used = encode(*args, **kwargs)
    out[5, 100] ^= 0x20
    return out, used

lz4_cuda.encode_blocks = corrupted
sys.exit(bench_torch.main(sys.argv[1:]))
"""


def test_a_corrupted_block_fails_the_run():
    r = _run(["--device", "cpu", "--mb", str(MB)], code=CORRUPT)
    assert r.returncode != 0
    assert "round-trip mismatch block 5" in r.stderr
    assert r.stdout == ""


def test_no_card_and_no_device_prints_no_result():
    r = _run([], CUDA_VISIBLE_DEVICES="")
    assert r.returncode != 0
    assert "torch.cuda.is_available() is false" in r.stderr
    assert r.stdout == ""
