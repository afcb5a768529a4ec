#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port: prints ONE JSON line on stdout.

    python3 bench_torch.py [--mb 32]

The port's counterpart of bench.py. The headline is the device LZ4 block
encoder, `tpu7z_torch.ops.lz4_cuda.encode_blocks` (the candidate stage
as lz4_keys, one `sort_rows` launch and lz4_probe, then lz4_match,
lz4_parse, lz4_geometry and lz4_emit), at W = 0 over the first `--mb`
MiB (32 by default) of the deterministic corpus, as 64 KiB blocks
already resident on the card. It is timed with CUDA events, one warm-up
and then the median of 5 calls (min and max beside it); the wrapper's
host reads of the block lengths are inside the window, as a caller pays
them.

Untimed, every block is decoded by the port's native host decoder and
compared with its input; `device_ratio` is bytes / sum(min(used, 65540))
as bench.py computes it, and must read 1.818 over 32 MiB. In the same run:
the reference `7zz a -mmt=1 -m0=lz4:x1` (best of 3, host clock) when a
binary is found ($TPU7Z_REF_7ZZ, else `7zz` on PATH; else `vs_baseline`
is null); the host tier, `compress_block_native` over the whole prefix as
one block (best of 3, host clock), decoded back; each encoder stage
through its wrapper with its inputs precomputed (`stages_ms`, CUDA
events, median of 5); and the card's idle share over one traced
`encode_blocks` call.

It runs on the card, and with no card it exits non-zero. `--device cpu`
runs the plain PyTorch versions on the host clock (idle_share null); it
exists for the tests, and measures nothing of the card. Progress goes to
stderr. Imports nothing of JAX or tpu7z.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch

METRIC = "lz4_encode_MBps_per_chip"
W = 0  # tier-B4 subsumes the tier-A window


def progress(msg):
    print(f"[bench_torch] {msg}", file=sys.stderr, flush=True)


def reference_binary():
    """The reference 7zz: $TPU7Z_REF_7ZZ if it names an executable, else
    `7zz` on PATH, else None."""
    path = os.environ.get("TPU7Z_REF_7ZZ", "")
    if path and os.path.isfile(path) and os.access(path, os.X_OK):
        return path
    return shutil.which("7zz")


def measure_reference(data: bytes, binary: str, workdir):
    """`7zz a -mmt=1 -m0=lz4:x1` on `data`, best of 3 on the host clock:
    (MB/s, archive size), or None if it fails."""
    with tempfile.TemporaryDirectory(dir=workdir) as td:
        src = os.path.join(td, "corpus.bin")
        with open(src, "wb") as f:
            f.write(data)
        best = csize = None
        for _ in range(3):
            arc = os.path.join(td, "out.7z")
            if os.path.exists(arc):
                os.unlink(arc)
            t = time.perf_counter()
            r = subprocess.run([binary, "a", "-mmt=1", "-m0=lz4:x1", "-bd", arc, src],
                               capture_output=True, timeout=600)
            dt = time.perf_counter() - t
            if r.returncode != 0 or not os.path.exists(arc):
                return None
            csize = os.path.getsize(arc)
            best = max(best or 0.0, len(data) / dt / 1e6)
        return best, csize


def verify_blocks(data: bytes, out, used, N):
    """Decode every block with the native decoder and compare it with its
    input; returns sum(min(used, N + 4)). A mismatch raises."""
    from tpu7z_torch.models.lz4 import block
    outh, usedh = out.cpu().numpy(), used.cpu().numpy()
    comp_total = 0
    for b in range(usedh.size):
        comp = outh[b, :usedh[b]].tobytes()
        comp_total += min(len(comp), N + 4)
        try:
            ok = block.decompress_block(comp, dst_size=N) == data[b * N:(b + 1) * N]
        except block.CorruptError:
            ok = False
        if not ok:
            raise RuntimeError(f"round-trip mismatch block {b}")
    return comp_total


def stage_times(cb, cn, device):
    """Median ms of each encoder stage through its wrapper, its inputs
    computed beforehand by the stages before it."""
    from tpu7z_torch.ops import lz4_cuda as K
    from tpu7z_torch.utils.timing import sample_ms
    cand = K.candidates(cb, cn)
    mlen, moff = K.match_lengths(cb, cn, *cand, W)
    st = K.parse(mlen)
    geo = K.geometry(mlen, moff, st, cn)
    calls = {"candidates": lambda: K.candidates(cb, cn),
             "lz4_match": lambda: K.match_lengths(cb, cn, *cand, W),
             "lz4_parse": lambda: K.parse(mlen),
             "lz4_geometry": lambda: K.geometry(mlen, moff, st, cn),
             "lz4_emit": lambda: K.emit(cb, moff, geo)}
    return {name: statistics.median(sample_ms(fn, device=device))
            for name, fn in calls.items()}


def main(argv=None) -> int:
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=int, default=32,
                    help="MiB of the 32 MiB corpus to encode (default 32)")
    ap.add_argument("--device", default=None,
                    help="'cpu' runs the plain versions on the host clock (tests only)")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        progress("torch.cuda.is_available() is false: bench_torch.py runs on a CUDA card")
        return 1
    if not 1 <= args.mb <= 32:
        progress(f"--mb {args.mb}: the corpus holds 1 to 32 MiB")
        return 1

    from tpu7z_torch.device import resolve_device
    from tpu7z_torch.models.lz4 import block
    from tpu7z_torch.ops import _build
    from tpu7z_torch.ops import lz4_cuda as K
    from tpu7z_torch.parallel.sharded import split_blocks
    from tpu7z_torch.utils import timing
    from tpu7z_torch.utils.corpus import CORPUS_RATIO, CORPUS_SHA256, make_corpus

    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    if on_card:
        name, power = timing.card()
        power_limit_w = float(power.split()[0])
    else:
        name, power_limit_w = "cpu", None
    progress(f"device {name}, power limit {power_limit_w} W")
    t = time.perf_counter()
    block._library()
    progress(f"host LZ4 library ready in {time.perf_counter() - t:.1f} s")

    corpus = make_corpus(32 << 20)
    sha = hashlib.sha256(corpus).hexdigest()
    if sha != CORPUS_SHA256:
        raise RuntimeError(f"corpus sha256 {sha} != {CORPUS_SHA256}")
    data = corpus[:args.mb << 20]
    N = K.BLOCK
    cb, cn = split_blocks(data, dev)
    B = cb.shape[0]

    # the output of the first (warm-up) call is the one verified
    out, used = K.encode_blocks(cb, cn, W)
    comp_total = verify_blocks(data, out, used, N)
    ratio = round(len(data) / comp_total, 3)
    progress(f"{B} blocks verified bit-exact, comp_total {comp_total}, device_ratio {ratio}")
    if len(data) == len(corpus) and ratio != CORPUS_RATIO:
        raise RuntimeError(f"device_ratio {ratio} != {CORPUS_RATIO} over the whole corpus")

    times = timing.sample_ms(lambda: K.encode_blocks(cb, cn, W), device=dev)
    enc_ms = statistics.median(times)
    enc_mbs = len(data) / enc_ms / 1e3
    progress(f"encode_blocks: median {enc_ms:.3f} ms ({min(times):.3f}-{max(times):.3f}), "
             f"{enc_mbs:.1f} MB/s")
    stages = stage_times(cb, cn, dev)
    progress(f"stages_ms {stages}")
    idle = None
    if on_card:
        (out_t, used_t), share, _ = timing.traced_encode(cb, cn, W, _build.BUILD)
        if not (torch.equal(out_t, out) and torch.equal(used_t, used)):
            raise RuntimeError("the traced encode_blocks differs from the untimed one")
        idle = share["idle_share"]
        progress(f"idle share {idle:.4f} over a {share['window_ms']:.3f} ms window; "
                 f"longest idle gaps (start, ms) {share['idle_gaps_ms']}; "
                 f"{share['segments_allocated']} device segments allocated in it")

    host_times = []
    for _ in range(3):
        t = time.perf_counter()
        comp = block.compress_block_native(data)
        host_times.append(time.perf_counter() - t)
    if block.decompress_block(comp, dst_size=len(data)) != data:
        raise RuntimeError("compress_block_native's block does not decode to its input")
    host_mbs, host_ratio = len(data) / min(host_times) / 1e6, len(data) / len(comp)
    progress(f"host tier: {host_mbs:.1f} MB/s, ratio {host_ratio:.3f}")

    ref_mbs = ref_csize = None
    binary = reference_binary()
    if binary is None:
        baseline_source = "no 7zz binary found in-run ($TPU7Z_REF_7ZZ, PATH)"
    else:
        _build.BUILD.mkdir(exist_ok=True)
        ref = measure_reference(data, binary, _build.BUILD)
        if ref is None:
            baseline_source = f"7zz failed in-run: {binary}"
        else:
            ref_mbs, ref_csize = ref
            baseline_source = f"measured in-run: {binary}"
    progress(f"reference: {baseline_source}, {ref_mbs} MB/s")

    print(json.dumps({
        "metric": METRIC,
        "value": enc_mbs,
        "unit": "MB/s",
        "vs_baseline": enc_mbs / ref_mbs if ref_mbs else None,
        "detail": {
            "corpus_MB": args.mb,
            "headline_tier": "cuda" if on_card else "cpu",
            "verified": f"all {B} blocks bit-exact round-trip",
            "device_MBps": enc_mbs,
            "device_ratio": ratio,
            "comp_total": comp_total,
            "device_platform": "gpu" if on_card else "cpu",
            "device": name,
            "power_limit_W": power_limit_w,
            "matcher_W": W,
            "timing": ("CUDA events around each encode_blocks call, one warm-up, median of 5"
                       if on_card else "host clock, one warm-up, median of 5"),
            "encode_ms": {"median": enc_ms, "min": min(times), "max": max(times)},
            "ref_MBps_same_run": ref_mbs,
            "ref_csize": ref_csize,
            "ref_ratio": len(data) / ref_csize if ref_csize else None,
            "baseline_source": baseline_source,
            "host_native_MBps": host_mbs,
            "host_native_ratio": host_ratio,
            "stages_ms": stages,
            "idle_share": idle,
            "run_s": time.perf_counter() - t_start,
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
