#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit; build the kernels from
     tpu7z_torch/csrc with nvcc;
  2. each of the five kernels against its plain PyTorch version on the
     card, exact equality, on test patterns, a short block, the first
     2 MiB of the corpus (W = 0 and 16) and the whole 32 MiB corpus
     (W = 0, the main path's shapes);
  3. the main path: `shard_compress_lz4_device` over the 32 MiB corpus on
     the card, launch counts per kernel, the frame decoded by the port's
     decoder, and the compression ratio checked;
  4. times on the card (CUDA events, median of 5 after a warm-up) for the
     whole encoder, each kernel, its plain version and the candidate
     sorts.
The line before the last is the per-kernel JSON; the last line is the
device JSON. Imports nothing of JAX or tpu7z.
"""

from __future__ import annotations

import hashlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
EXPECTED_RATIO = 1.818        # device_ratio of the 32 MiB corpus at W=0
# sha256 of make_corpus(32 MiB), the bytes that ratio was measured on
CORPUS_SHA256 = "05224620a507811d6a855ddf98cc7f0a4a1ede748fba0f6f8747ddb639b6cb2a"
SOURCE = "tpu7z_torch/csrc/lz4_stages.cu"
REPLACES = {
    "lz4_match": "tpu7z/ops/lz4_pallas.py:58",
    "lz4_parse": "tpu7z/ops/lz4_pallas.py:72",
    "lz4_geometry": "tpu7z/ops/lz4_pallas.py:77",
    "lz4_emit_core": "tpu7z/ops/lz4_pallas.py:108,120",
    "lz4_expand": "tpu7z/ops/lz4_pallas.py:127",
}


def log(msg):
    print(msg, flush=True)


def timed(fn, reps=5):
    """Median milliseconds of `fn` on the card, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def patterns(block):
    """Blocks that exercise every phase: text, a long zero run, a far
    match, random bytes, a short text block and an all-zero block."""
    rng = np.random.default_rng(7)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"zstd ", b"tpu "]
    text = b"".join(words[i] for i in rng.integers(0, 6, 14000))[:block]
    zeros_mid = bytearray(rng.integers(0, 256, block, dtype=np.uint8))
    zeros_mid[1000:9000] = bytes(8000)
    far = bytearray(rng.integers(0, 256, block, dtype=np.uint8))
    far[40000:40600] = far[2000:2600]
    rand = rng.integers(0, 256, block, dtype=np.uint8).tobytes()
    pats = [(text.ljust(block, b" "), block), (bytes(zeros_mid), block),
            (bytes(far), block), (rand, block),
            (text[:50000].ljust(block, b"\0"), 50000), (bytes(block), block)]
    blocks = np.stack([np.frombuffer(d, np.uint8) for d, _ in pats])
    return blocks, np.array([n for _, n in pats], np.int32)


class Stages:
    """The plain chain's intermediates on the card (the expected output of
    every kernel) and, per kernel, its wrapper and its plain version as
    calls on the same inputs."""

    def __init__(self, P, K, blocks, ns, W):
        self.P, self.W = P, W
        self.blocks = blocks
        cand = P.candidates(P.phase0_words(blocks), ns)
        mlen, moff = P.match_lengths_ref(blocks, ns, *cand, W)
        st = P.phase3_parse(mlen)
        geo = P.phase4_geometry(mlen, moff, st, ns)
        core = P.phase5_core(blocks, moff, geo)
        out, used = P.phase6_expand(core, geo)
        self.mlen, self.st, self.geo = mlen, st, geo
        names = P.GEO_NAMES + ("core_used", "used")
        # the kernels after geometry read its stacked planes
        kgeo = K.geometry(mlen, moff, st, ns)
        self.want = {"lz4_match": [mlen, moff], "lz4_parse": [st],
                     "lz4_geometry": [geo[k] for k in names],
                     "lz4_emit_core": [core], "lz4_expand": [out, used]}
        self.calls = {
            "lz4_match": (lambda: K.match_lengths(blocks, ns, *cand, W),
                          lambda: P.match_lengths_ref(blocks, ns, *cand, W),
                          list),
            "lz4_parse": (lambda: K.parse(mlen), lambda: P.phase3_parse(mlen),
                          lambda r: [r]),
            "lz4_geometry": (lambda: K.geometry(mlen, moff, st, ns),
                             lambda: P.phase4_geometry(mlen, moff, st, ns),
                             lambda g: [g[k] for k in names]),
            "lz4_emit_core": (lambda: K.emit_core(blocks, moff, kgeo),
                              lambda: P.phase5_core(blocks, moff, geo),
                              lambda r: [r]),
            "lz4_expand": (lambda: K.expand(core, kgeo),
                           lambda: P.phase6_expand(core, geo), list),
        }

    def bytes_moved(self):
        """Bytes each kernel's function must move for these inputs: each
        input element it needs read once, each output written once. Where
        the data decides which elements are needed (the cursor's steps,
        the fields of a sequence), only those count."""
        P, B = self.P, self.blocks.shape[0]
        BLOCK, ROW = P.BLOCK, P.ROW
        g = {k: self.geo[k] > 0 for k in ("glen", "anchor", "kept", "mstart",
                                           "ml_ext", "long_run")}
        e1 = g["anchor"] & (self.geo["e"] >= 1)

        def count(mask):
            return int(mask.sum())

        # parse: mlen at each cursor position and the one after it; the
        # cursor skips the inside of every match it takes
        lane = torch.arange(BLOCK, device=self.st.device) % ROW
        reach = torch.where(self.st, lane + self.mlen, 0).view(B, -1, ROW)
        covered = lane.view(-1, ROW) < torch.cummax(reach, dim=2).values
        cursor = (self.st.view(B, -1, ROW) | ~covered)
        after = torch.zeros_like(cursor)
        after[:, :, 1:] = cursor[:, :, :-1]
        scal = 4 * B
        return {
            # three candidate planes (and the block for the W window) in;
            # mlen and moff out
            "lz4_match": 4 * 3 * B * BLOCK + (B * BLOCK if self.W else 0)
                         + scal + 4 * 2 * B * BLOCK,
            "lz4_parse": 4 * count(cursor | after) + B * BLOCK,
            # is_start everywhere, mlen and moff at the starts; planes out
            "lz4_geometry": B * BLOCK + 4 * 2 * count(self.st) + scal
                            + 4 * len(P.GEO_NAMES) * B * BLOCK + 2 * scal,
            # glen everywhere; the fields each sequence part needs; the core
            "lz4_emit_core": 4 * B * BLOCK + 4 * 4 * count(g["glen"])
                             + 4 * 2 * count(g["anchor"]) + 4 * count(e1)
                             + count(g["kept"]) + 4 * 2 * count(g["mstart"])
                             + 4 * count(g["ml_ext"]) + scal + B * P.CORE_CAP,
            # glen everywhere; where, and how far, each position's bytes
            # move; the live core bytes; the output
            "lz4_expand": 4 * B * BLOCK + 4 * 3 * count(g["glen"])
                          + 4 * count(g["long_run"])
                          + int(self.geo["core_used"].sum()) + scal
                          + B * P.OUT_CAP,
        }


def max_abs_err(got, want):
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from tpu7z_torch.device import resolve_device
    from tpu7z_torch.models.lz4 import frame
    from tpu7z_torch.ops import _build
    from tpu7z_torch.ops import lz4_cuda as K
    from tpu7z_torch.ops import lz4_plane as P
    from tpu7z_torch.parallel import sharded
    from tpu7z_torch.utils.corpus import make_corpus

    dev = resolve_device()
    t_start = time.time()

    # 1. card and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t = time.time()
    libs = _build.build()
    log(f"build: {time.time() - t:.1f} s -> {[p.name for p in libs]}")

    t = time.time()
    corpus = make_corpus(32 << 20)
    sha = hashlib.sha256(corpus).hexdigest()
    log(f"corpus: {len(corpus)} bytes in {time.time() - t:.1f} s, sha256 {sha}")
    if sha != CORPUS_SHA256:
        raise AssertionError(f"corpus sha256 {sha} != {CORPUS_SHA256}")

    # 2. every kernel against its plain version, exact
    pb, pn = patterns(P.BLOCK)
    cb, cn = sharded.split_blocks(corpus, dev)
    inputs = [("patterns", torch.from_numpy(pb).to(dev), torch.from_numpy(pn).to(dev)),
              ("corpus_2MiB", cb[:32].contiguous(), cn[:32].contiguous())]
    runs = [(name, b, n, W) for name, b, n in inputs for W in (0, 16)]
    runs.append(("corpus_32MiB", cb, cn, 0))
    errs = {k: 0 for k in K.KERNELS}
    full = None
    for name, b, n, W in runs:
        s = Stages(P, K, b, n, W)
        for kname, (kern, _plain, outs) in s.calls.items():
            got = outs(kern())
            torch.cuda.synchronize()
            e = max_abs_err(got, s.want[kname])
            errs[kname] = max(errs[kname], e)
            if e:
                raise AssertionError(f"{kname} differs from its plain version on "
                                     f"{name} W={W}: max abs err {e}")
        out, used = K.encode_blocks(b, n, W)
        torch.cuda.synchronize()
        want_out, want_used = s.want["lz4_expand"]
        if not (torch.equal(used, want_used) and torch.equal(out, want_out)):
            raise AssertionError(f"encode_blocks differs from the plain chain on {name} W={W}")
        log(f"check {name} W={W}: {b.shape[0]} blocks, 5 kernels and the chain equal")
        if name == "corpus_32MiB":
            full = s
    for k in K.KERNELS:
        if K.LAUNCHES[k] == 0:
            raise AssertionError(f"{k} was never launched in the checks")

    # 3. the main path, counted
    K.reset_launches()
    t = time.time()
    framed = sharded.shard_compress_lz4_device(corpus, W=0)
    torch.cuda.synchronize()
    t_main = time.time() - t
    launches = dict(K.LAUNCHES)
    log(f"main path: shard_compress_lz4_device({len(corpus)} bytes, W=0) -> {len(framed)} bytes "
        f"in {t_main:.2f} s (first call), launches {launches}")
    for k, c in launches.items():
        if c == 0:
            raise AssertionError(f"main path never launched {k}")
    t = time.time()
    if frame.decompress(framed) != corpus:
        raise AssertionError("the frame does not decode to the input")
    log(f"frame decoded by the port's decoder in {time.time() - t:.1f} s: equal")
    # device_ratio as bench.py computes it: bytes / sum of min(used, BLOCK + 4)
    out, used = K.encode_blocks(cb, cn, 0)
    comp_total = int(torch.clamp(used.to(torch.int64), max=P.BLOCK + 4).sum())
    ratio = len(corpus) / comp_total
    sizes = [len(p) for s_, p in frame.iter_blocks(framed) if not s_]
    if sizes != [u for u, n_ in zip(used.tolist(), cn.tolist()) if u < n_]:
        raise AssertionError("frame block sizes disagree with encode_blocks")
    log(f"device_ratio {ratio:.6f} ({len(corpus)} / {comp_total})")
    if round(ratio, 3) != EXPECTED_RATIO:
        raise AssertionError(f"device_ratio {ratio:.4f} != {EXPECTED_RATIO}")

    # 4. times on the card
    enc_ms = timed(lambda: K.encode_blocks(cb, cn, 0))
    log(f"encode_blocks {len(corpus) / 2**20:.0f} MiB ({cb.shape[0]} blocks, W=0): {enc_ms:.3f} ms, "
        f"{len(corpus) / enc_ms / 1e3:.1f} MB/s")
    words = P.phase0_words(cb)
    cand_ms = timed(lambda: P.candidates(words, cn))
    keys = (P.tier_b_key(words), P.tier_b4_key(words))
    sort_ms = [timed(lambda k=k: torch.sort(k, dim=1, stable=True)) for k in keys]
    log(f"candidates (tiers B and B4, plain PyTorch): {cand_ms:.3f} ms; "
        f"torch.sort of the tier-B keys {sort_ms[0]:.3f} ms, tier-B4 keys {sort_ms[1]:.3f} ms")

    moved = full.bytes_moved()
    kernels = []
    for k, (kern, plain, _outs) in full.calls.items():
        ms = timed(kern)
        plain_ms = timed(plain)
        bound_ms = moved[k] / HBM_BYTES_PER_S * 1e3
        log(f"{k}: {ms:.3f} ms ({ms / cb.shape[0] * 1e3:.2f} us/block), "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
            f"({moved[k] / 1e6:.1f} MB)")
        kernels.append({"name": k, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[k], "launches": launches[k],
                        "max_abs_err": errs[k], "equal": errs[k] == 0,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": "bytes", "library_ms": None})
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
