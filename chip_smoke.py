#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:
  1. the card's name and power limit; build the native libraries from
     tpu7z_torch/csrc (the kernels with nvcc, the host libraries with
     c++: xxh32, XXH3, CRC, AES, the LZ4, zstd and LZMA codecs), one process per
     source, all at once;
  2. each of the six encoder kernels against its plain PyTorch version
     on the card, exact equality, on test patterns, short blocks, the
     edge blocks of the row kernels' joins, of lz4_emit's row spans and
     of the candidate stage (text cut to 0, 11, 12 and 13 bytes, an
     all-zero block, a block whose last 8 bytes are non-zero),
     the first 2 MiB of the corpus (W = 0 and 16) and the whole 32 MiB
     corpus (W = 0, the main path's shapes); lz4_parse also on synthetic
     mlen planes (random capped and uncapped values, defer chains, 4 and 0
     everywhere, a take only at position 127, matches that end at the row
     end, alternating 0/4, int32 extremes), with no spills and no shared
     memory, and refusing an mlen off a 16-byte boundary; the row-sort kernel against
     its plain version, exactly, on its contract (int32 keys, no payload
     or one int32 payload): random matcher keys with a payload, fully
     random unique keys (N = 16384 and 65536, 0 and 1 payload), ragged
     rows (N = 1000 and 12345), the corpus's tier-B and tier-B4 keys
     (each tier alone, and both tiers' keys as one set of rows, as the
     path sorts them) and the match finder's keys (sentinels, short
     rows); and the
     tile-parallel design's edges: a short last tile (N = 1, 4095, 4096,
     4097, 12345, 65535) without and with a payload of all-ones and
     NaN-pattern bits, every begin_bit (0, 8, 16, 24) with 0 and 1
     payload, an all-zero block's tier-B4 keys (one digit in every pass),
     and 1 and 513 rows; rows longer than 65536 keys (N = 65537, 1 << 18,
     1 << 22) with duplicate keys and an int32 payload at every
     begin_bit, and the match finder's keys for 4 MiB rows at hashlog 12,
     20 and 31;
  3. the main path: `shard_compress_lz4_device` over the 32 MiB corpus on
     the card, launch counts per kernel (each encoder kernel once, one
     row sort; one lz4_keys, sort_rows and lz4_probe an `encode_blocks`
     call with the sorted tiers, none without), the frame decoded by the
     port's decoder (its blocks by
     the native host decoder, csrc/lz4_host.cpp; every 16th block also by
     its numpy twin `decompress_block_ref`, and the two compared), and the
     compression ratio checked; the decode timed serially, block-parallel
     in 8 threads (`decompress_lz4`) and as the library's calls alone;
     the bound of the path's copies (`copy_rates`): 32 MiB each way
     from and into pinned and pageable memory (CUDA events), and the
     host's fill of pinned memory and `bytes` out of it;
  4. the match-finder path, each part with the counts set to 0 before it:
     `find_matches` over the corpus with the kernel against the same with
     the plain sort, as 512 rows of 64 KiB and as 8 rows of 4 MiB at
     hashlog 20; `compress_frame_device(corpus)` at 64 KiB and 4 MiB
     blocks, each decoded with its checksums verified;
     `shard_compress_lz4` over the first 2 MiB; `entry()` against its
     CPU run;
  5. times on the card (CUDA events, median of 5 after a warm-up) for the
     whole encoder, each kernel through its wrapper and as its launch
     alone (outputs preallocated, 10 launches between the events), its
     plain version, each kernel's bound by `launch_bytes` for lz4_keys
     and lz4_probe, the row sort (as the path calls it, both tiers'
     int32 keys as 2B rows, and as its launches alone; and at 8 rows of 4 MiB
     with a payload, as `find_matches` calls it at hashlog 20) beside
     `torch.sort`, the sort order `find_matches` takes at 64 KiB rows,
     `find_matches` with either sort at both row lengths; registers,
     spills and resident CTAs per SM of every encoder kernel and of the
     sort's kernels, and each sort kernel's device time from a
     torch.profiler trace;
  6. past one device: a one-rank NCCL process group, over which
     `shard_compress_lz4_device(corpus, group)` equals phase 3's frame
     (its launches counted), `sharded_find_matches` and
     `shard_compress_lz4` over the first 2 MiB equal their group-less
     results, and `reduce_progress` runs on card tensors;
     `dryrun_multichip` at one rank a card (spawned NCCL ranks); `python -m
     tpu7z_torch.cli a -tlz4 -mdev` on the first 2 MiB equal to
     `shard_compress_lz4_device`, and `t` on its archive; the native xxh32
     against the Python one (lengths 0-33, the first 2 MiB), both timed,
     and the parts of `compress_frame_device(corpus)` (host clock);
  (no phase 7: phases 8-15 keep the numbers the README and PERF.md cite);
  8. zstd: the host tier (csrc/zstd_enc.cpp, zstd_dec.cpp) over the corpus
     at levels 3 and 5, one call and the job model at 4 workers (the
     frame equal to 1 worker's and to `frame.compress(threads=4)`), every
     frame decoded serially and by `decompress_zstd`, and eight 4 MiB
     frames decoded serially and in 8 threads; the tensor parse
     (`find_sequences_windowed`, hashlog 17, window_log 21, depth 3, lazy
     1; 3 MiB in 1 MiB segments, and 8 MiB in the 4 MiB segments the
     encoder below uses) on the card equal to its CPU run; the
     corpus through the tensor encoder on the card (level 5, window_log
     21: what `a -tzstd -m0=zstd:wlog=21` runs), one row sort a segment
     counted, its stages traced, its frame decoded; and `sort_rows` at
     this path's row shape against its plain version, timed;
  9. the shared LZ matcher as tensor code on the card: LZ4's parse
     (`compress_block(accel=2)` on the first 1 MiB equal to its CPU run;
     `compress_frame(corpus, accel=2)`, one row sort a 4 MiB block,
     decoded with its checksums), LZMA's fast parse (each 64 KiB chunk of
     the first 1 MiB and a 10-byte tail equal to the CPU run and to the
     one-pass matcher; `lzma2.compress_chunks` over 8 MiB, one row sort,
     decoded by the port and the standard library), both with their spans
     timed, and `sort_rows` at the LZMA row (8 Mi int32 keys, a payload)
     against its plain version, timed; the host tier: `xz.compress` over
     the corpus and its decode (the standard library's of its LZMA2
     stream), `lzma2.compress(shard_size=4 MiB)` over 16 MiB decoded
     serially, in 8 threads and by the standard library, the native CRCs against
     the Python forms and zlib, and the CLI's `a -txz`, `t` and `x`;
 10. the .7z container on the card: the corpus as eight 4 MiB files in
     one solid zstd .7z at level 5 (the tensor encoder, one row sort a
     segment counted; its pack stream equal to phase 8's frame), the same
     with a password and the header encrypted (the KDF timed, the native
     CBC encrypt timed and equal to the archive's folder, the card's
     `decrypt_cbc` of the folder against the same tensor code on the CPU,
     exactly; the corpus decrypted on the card in two passes, its peak
     allocation checked), the default LZMA2 .7z of the first 8 MiB as two files, 4
     MiB as two non-solid zstd folders written on the card and on the CPU
     (equal), the native encrypt against its Python twin on 64 KiB, and
     the CLI's `a -t7z -m0=zstd -p -mhe`, `t` and `x`, and every tensor
     branch filter and delta on the card against the CPU, with an ARM and
     a delta folder read back; every archive read back on the card;
 11. DEFLATE, gzip, .zip, .tar and bzip2 on the card: `sort_rows` at this
     slice's shapes against its plain version (deflate's rows, 256 x
     131069 hashes at hashlog 15 with a position payload, and a short last
     row; a bzip2 doubling pass of 900004 keys below 2**20; the 8-bit
     occurrence sort), timed; deflate's parse and stream of the first 2
     MiB on the card equal to its CPU run; the corpus as one .gz on the
     card (one row sort counted, spans `deflate.parse`, `deflate.header`,
     `deflate.pack`), read back by zlib; the port's `gzip_decompress` of
     the first 4 MiB's .gz (cut: the host inflate); the corpus as a
     deflate .zip of eight 4 MiB files read back by zipfile, two of them
     by the port's `read_zip` (cut: the host inflate); a .zip of each
     method the port writes; a .tar of the eight files both ways with
     tarfile; bzip2 of the first 4 MiB at level 9 (cut: the host RLE1,
     MTF and Huffman coding), read back by bz2 and by the port (the
     inverse BWT on the card), the first block's BWT equal to its CPU run,
     both ways by span; deflate and bzip2 .7z folders of 2 MiB; the CLI's
     `a`, `t`, `x` (and `l`) of a .zip, .tar, .gz and .bz2 of 2 MiB;
 12. Brotli, LZ5, Lizard, .Z and lzip: `sort_rows` at this slice's shapes
     against its plain version, timed (Brotli's last segment, one row of
     20 Mi hashes; LZ5's eight 4 MiB rows; Lizard's 256 rows of 128 KiB);
     the corpus's brotli-mt container at quality 5 on the card by span
     (`brotli.parse`, `.commands`, `.histograms`, `.header`, `.pack`), its
     row sorts counted, decoded by the port, the first 4 MiB's stream equal
     to its CPU run; the corpus's LZ5 frame (one row sort), decoded, its
     first block equal to the CPU run's; Lizard at 25 over the corpus and
     at 11, 31 and 41 over 4 MiB (one row sort each), decoded, each level
     equal to its CPU run on 1 MiB; .Z of 4 MiB (host) and lzip of 2 MiB
     (its parse on the card), decoded; a 2 MiB .7z of brotli folders,
     solid and not, read back; the CLI's `a`, `t` and `x` of a .br, .lz5,
     .liz, .Z and .lz of 2 MiB, equal to the API's;
 13. PPMd, the hashers and the verbs: the first 1 MiB of the corpus as a
     .7z PPMd folder and a .zip method-98 entry, written and read back
     (host clock), the CLI's `a -t7z -m0=ppmd`, `t` and `x` on 256 KiB;
     BLAKE3 on the card against its plain version at 11 lengths (0 to
     1 MiB + 7) and against its CPU run over the corpus, exactly, its time
     over the corpus (CUDA events, median of 5); the native XXH3's GB/s
     over the corpus and the empty input's public digests; the CLI's `h`
     and `t -scrc=*` of 1 MiB (the same 21 digests), and `b -md1m` on the
     card (36 codec rows, 21 hashers, every round trip checked, its row
     sorts counted);
 14. the containers over the port's codecs (host code but for the bzip2
     payloads' inverse BWT): the corpus as eight 4 MiB files in squashfs
     images of zstd, LZ4 and zlib blocks, a .wim, .iso, UDF and FAT16
     image (the FAT image also in a .vhd), cpio and ar, each written and
     read back; an .rpm of their cpio as a gzip payload, and an .rpm and a
     xar of the first 4 MiB as bzip2, each decoded on the card (its row
     sorts counted) and on the CPU, equal; a xar of zlib entries; NSIS
     (solid LZMA, non-solid deflate), NTFS with a 1 MiB LZNT1 $DATA (a
     29-byte period: the Python LZNT1 matcher is too slow for text at
     this size), HFS+, APFS and DMG at the tests' shapes, and ext4 through
     `mke2fs -d` where the machine has it; the CLI's a, l, t and x of a
     .wim, .udf, .fat, .vhd, .hex and .arj of 2 MiB. Each write and read
     prints its seconds (host clock), bytes and row sorts;
 15. the containers with their own codecs and the rest of the CLI:
     `sort_rows` at MSZIP's rows (1024 x 32765 hashes) against its plain
     version, timed; the corpus as an MSZIP cabinet on the card (one row
     sort, every CFDATA inflated by zlib with the previous 32 KiB as its
     dictionary, the first 128 equal to the CPU run's, read back by
     `read_cab`); an LZX cabinet and a CHM of 256 KiB, an lh5 .lzh of
     1 MiB and a RAR5 of 4 MiB, each read back (host); the CLI's a, l, t
     and x of a .cab, a .rar and a stored .rar of 512 KiB, `x -mmt1`
     streaming the corpus's .lz4, .zst, .gz, .bz2 and .xz, `a -v8m` and
     `x` of the `.001`, `-i!`, `-x!` and `-bb`. Each step prints its
     seconds (host clock), bytes and row sorts;
 16. the shared LZ matcher's exact lengths (csrc/lz_match.cu through
     `hash_chain.match_lengths`): (a) the arguments of the matcher's call
     at each caller's shape (the gzip writer over 4 MiB of text, lengths
     up to 258; LZMA's fast parse over the same 4 MiB, MATCH_MAX 273;
     LZ4's tensor parse over 4 MiB of zeros and of random bytes, limits to
     the end): one call and one launch in the caller's own run, the
     kernel equal to its plain version `match_lengths_ref`, exactly; one
     call of each (CUDA events, median of 5) beside the kernel alone (10
     launches back to back into buffers from `buffers`, CUDA events, the
     last launch's lengths checked again), its bound (`launch_bytes` at
     3.35 TB/s) and the work's own (pos, cand and limit read, the lengths
     written, s read once), and the plain version's call, which is the
     code the matcher ran on the card before the kernel; the kernel's
     registers, spills and CTAs per SM; (b) the matcher's callers with the
     kernel and with the plain version in its place, in turns (plain,
     kernel, kernel, plain): gzip of 4 MiB of text,
     `lzma2.compress_chunks` over 8 MiB, LZ4's `compress_frame(corpus,
     accel=2)`, LZ5's frame of the corpus, Lizard's at level 11 (its
     greedy parse) of 4 MiB, the MSZIP cabinet of the corpus's eight 4 MiB
     files; each with its bytes equal on every run, one launch for each of
     its calls of the matcher with entries (none on the plain runs), its
     seconds and its `lz.match_lengths` span's (host clock, tracing on).
The timing helpers (`card`, `sample_ms`, `timed`, `timed_launches`)
are this script's own. The line before the last is the per-kernel JSON;
the last line is the device JSON. Imports nothing of JAX or tpu7z.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
SOURCE = "tpu7z_torch/csrc/lz4_stages.cu"
SORT_SOURCE = "tpu7z_torch/csrc/sort.cu"
REPLACES = {
    "lz4_keys": "none: tpu7z/ops/lz4_plane.py:174-248, XLA's lax.sort tiers",
    "lz4_probe": "none: tpu7z/ops/lz4_plane.py:174-248, XLA's lax.sort tiers",
    "lz4_match": "tpu7z/ops/lz4_pallas.py:58",
    "lz4_parse": "tpu7z/ops/lz4_pallas.py:72",
    "lz4_geometry": "tpu7z/ops/lz4_pallas.py:77",
    "lz4_emit": "tpu7z/ops/lz4_pallas.py:108,120,127",
    "sort_rows": "tpu7z/ops/sort_pallas.py:76",
    "lz_match_lengths": "none: tpu7z/models/lz4/block.py:195 _match_lengths is numpy",
}
ODD = 2654435761
TEXT = 696156                 # the corpus's first byte past its sparse chunk


def log(msg):
    print(msg, flush=True)


def card():
    """(name, power limit) of the first card, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    name, power = out.splitlines()[0].rsplit(",", 1)
    return name.strip(), power.strip()


def sample_ms(fn, reps=5, launches=1, device="cuda"):
    """`reps` samples, in milliseconds, of one call of `fn` after one
    warm-up call; each sample the mean over `launches` calls back to back.
    CUDA events on a CUDA device, the host clock on any other."""
    fn()
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(reps):
            t = time.perf_counter()
            for _ in range(launches):
                fn()
            times.append((time.perf_counter() - t) * 1e3 / launches)
        return times
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return times


def timed(fn, reps=5):
    """Median milliseconds of `fn` on the card, after one warm-up run."""
    return statistics.median(sample_ms(fn, reps))


def timed_launches(fn, launches=10, reps=5):
    """Median milliseconds of one call of `fn` on the card, from events
    around `launches` calls back to back, after one warm-up call."""
    return statistics.median(sample_ms(fn, reps, launches))


def patterns(block):
    """Blocks that exercise every phase: text, a long zero run, a far
    match, random bytes, a short text block and an all-zero block; then
    the edges of the row kernels' row and lane joins: a 128-byte period
    (every row's match ends at the row end, so odd rows continue; n is no
    multiple of 4), a 384-byte period (runs across many rows), text cut
    to 129 and to 3 bytes, and an empty block."""
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
    r2 = np.random.default_rng(3)
    p128 = np.tile(r2.integers(0, 256, 128, dtype=np.uint8), block // 128).tobytes()
    p384 = np.tile(r2.integers(0, 256, 384, dtype=np.uint8), block // 384 + 1).tobytes()
    pats += [(d[:n].ljust(block, b"\0"), n)
             for d, n in ((p128, 65533), (p384, 4099), (text, 129), (text, 3), (b"", 0))]
    blocks = np.stack([np.frombuffer(d, np.uint8) for d, _ in pats])
    return blocks, np.array([n for _, n in pats], np.int32)


def emit_edges(block):
    """Blocks on the edges of lz4_emit's row spans: a 128-byte period broken
    by 400 random bytes at the last 4 positions of four rows (a long
    literal run whose token ends a row, one at each lane offset); the same
    period for 255 bytes, then random bytes to the end (a 255-run of 255
    bytes after the last token of row 1); an all-random block (its 255-run
    of 256 bytes on row 0); text of 0, 1, 13 and 1000 bytes (`used` ends
    inside a 16-byte word in most of them)."""
    rng = np.random.default_rng(9)
    period = np.tile(rng.integers(0, 256, 128, dtype=np.uint8), block // 128)
    row_ends = period.copy()
    for i, row in enumerate((10, 50, 90, 130)):
        at = row * 128 + 124 + i
        row_ends[at:at + 400] = rng.integers(0, 256, 400, dtype=np.uint8)
    spill = rng.integers(0, 256, block, dtype=np.uint8)
    spill[:255] = period[:255]
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"zstd ", b"tpu "]
    text = np.frombuffer(b"".join(words[i] for i in rng.integers(0, 6, 400)), np.uint8)
    blocks = [row_ends, spill, rng.integers(0, 256, block, dtype=np.uint8)]
    ns = [block] * 3
    for n in (0, 1, 13, 1000):
        b = np.zeros(block, np.uint8)
        b[:n] = text[:n]
        blocks.append(b)
        ns.append(n)
    return np.stack(blocks), np.array(ns, np.int32)


def candidate_edges(block):
    """Blocks on the edges of the candidate stage: text cut to lengths about
    the tail guard (0, 11, 12, 13) and a whole text block, an all-zero
    block (every hash ties, so the order is by position alone) and a block
    whose last 8 bytes are non-zero (its last windows reach the zero words
    past the end)."""
    rng = np.random.default_rng(7)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"zstd ", b"tpu "]
    text = b"".join(words[i] for i in rng.integers(0, 6, 14000))[:block].ljust(block, b" ")
    tail = bytearray(text)
    tail[1000:1008] = b"abcd\0\0\0\0"
    tail[2000:2008] = b"abcdabcd"
    tail[-8:] = b"abcdabcd"
    pats = [(text[:n].ljust(block, b"\0"), n) for n in (0, 11, 12, 13, block)]
    pats += [(bytes(block), block), (bytes(tail), block)]
    blocks = np.stack([np.frombuffer(d, np.uint8) for d, _ in pats])
    return blocks, np.array([n for _, n in pats], np.int32)


def check_emit_edges(geo):
    """The edge blocks do what they are for: long runs start at each of the
    last 4 positions of a row, one after row 1's last position, and `used`
    ends inside a 16-byte word."""
    lr = (geo["long_run"] > 0).nonzero().tolist()
    ends = sorted(p % 128 for b, p in lr if b == 0)
    if ends != [124, 125, 126, 127]:
        raise AssertionError(f"emit_edges: long runs at row offsets {ends}, expected 124-127")
    if [p for b, p in lr if b == 1] != [255]:
        raise AssertionError("emit_edges: no long run after row 1's last position")
    if not bool((geo["used"] % 16 != 0).any()):
        raise AssertionError("emit_edges: every used ends on a 16-byte boundary")


class Stages:
    """The plain chain's intermediates on the card (the expected output of
    every kernel) and, per kernel, its wrapper and its plain version as
    calls on the same inputs."""

    def __init__(self, P, K, blocks, ns, W):
        self.P, self.K, self.W = P, K, W
        self.blocks = blocks
        keys = P.candidate_keys(blocks)
        skeys = P.sort_keys(keys.view(-1, P.BLOCK)).view(keys.shape)
        cand = P.candidate_probe(blocks, skeys, ns)
        mlen, moff = P.match_lengths_ref(blocks, ns, *cand, W)
        st = P.phase3_parse(mlen)
        geo = P.phase4_geometry(mlen, moff, st, ns)
        out, used = P.emit_ref(blocks, moff, geo)
        self.mlen, self.st, self.geo = mlen, st, geo
        names = P.GEO_NAMES + ("core_used", "used")
        # the kernels after geometry read its stacked planes
        kgeo = K.geometry(mlen, moff, st, ns)
        B = blocks.shape[0]
        planes = K._planes(kgeo, B, blocks.device)
        # each kernel's launch with its outputs preallocated
        self.launch_args = {
            "lz4_keys": (blocks, torch.empty_like(keys), B),
            "lz4_probe": (blocks, skeys, ns, torch.empty((3, *blocks.shape), dtype=torch.int32,
                                                          device=blocks.device), B),
            "lz4_match": (blocks, ns, *cand, torch.empty_like(mlen),
                          torch.empty_like(moff), B, W),
            "lz4_parse": (mlen, torch.empty_like(st, dtype=torch.uint8), B),
            "lz4_geometry": (mlen, moff, st.view(torch.uint8), ns,
                             torch.empty_like(planes),
                             torch.empty_like(kgeo["core_used"]),
                             torch.empty_like(kgeo["used"]), B),
            "lz4_emit": (blocks, moff, planes, kgeo["used"],
                         torch.empty_like(out), B),
        }
        self.want = {"lz4_keys": [keys], "lz4_probe": list(cand),
                     "lz4_match": [mlen, moff], "lz4_parse": [st],
                     "lz4_geometry": [geo[k] for k in names],
                     "lz4_emit": [out, used]}
        self.calls = {
            "lz4_keys": (lambda: K.candidate_keys(blocks), lambda: P.candidate_keys(blocks),
                         lambda r: [r]),
            "lz4_probe": (lambda: K.candidate_probe(blocks, skeys, ns),
                          lambda: P.candidate_probe(blocks, skeys, ns), list),
            "lz4_match": (lambda: K.match_lengths(blocks, ns, *cand, W),
                          lambda: P.match_lengths_ref(blocks, ns, *cand, W),
                          list),
            "lz4_parse": (lambda: K.parse(mlen), lambda: P.phase3_parse(mlen),
                          lambda r: [r]),
            "lz4_geometry": (lambda: K.geometry(mlen, moff, st, ns),
                             lambda: P.phase4_geometry(mlen, moff, st, ns),
                             lambda g: [g[k] for k in names]),
            "lz4_emit": (lambda: K.emit(blocks, moff, kgeo),
                         lambda: P.emit_ref(blocks, moff, geo), list),
        }

    def bytes_moved(self):
        """Bytes each kernel's function must move for these inputs: each
        input element it needs read once, each output written once. Where
        the data decides which elements are needed (the cursor's steps,
        the fields of a sequence), only those count."""
        P, B = self.P, self.blocks.shape[0]
        BLOCK, ROW = P.BLOCK, P.ROW
        K = self.K
        g = {k: self.geo[k] > 0 for k in ("glen", "anchor", "kept", "mstart",
                                           "ml_ext")}
        e1 = g["anchor"] & (self.geo["e"] >= 1)
        # kept is needed where a position or the one after it emits
        kept_read = g["glen"].clone()
        kept_read[:, :-1] |= g["glen"][:, 1:]

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
            # the candidate kernels by their contract (launch_bytes): the
            # block in, both tiers' keys out; the block, the sorted keys
            # and ns in, three planes out
            "lz4_keys": K.launch_bytes("lz4_keys", B),
            "lz4_probe": K.launch_bytes("lz4_probe", B),
            # three candidate planes (and the block for the W window) in;
            # mlen and moff out
            "lz4_match": 4 * 3 * B * BLOCK + (B * BLOCK if self.W else 0)
                         + scal + 4 * 2 * B * BLOCK,
            "lz4_parse": 4 * count(cursor | after) + B * BLOCK,
            # what lz4_parse's design moves: the whole of mlen, and is_start
            "lz4_parse_floor": (4 + 1) * B * BLOCK,
            # is_start everywhere, mlen and moff at the starts; planes out
            "lz4_geometry": B * BLOCK + 4 * 2 * count(self.st) + scal
                            + 4 * len(P.GEO_NAMES) * B * BLOCK + 2 * scal,
            # glen everywhere and kept where it or the next position emits
            # (the flags follow from the two); the field each sequence part
            # needs (token at an anchor, litrem where e >= 1, the literal,
            # moff at a match start, mlc where ml_ext); core_pos and
            # gap_before at each row's start (the offsets within a row and
            # the 255-run follow from glen); used; the output
            "lz4_emit": 4 * B * BLOCK + 4 * count(kept_read)
                        + 4 * count(g["anchor"]) + 4 * count(e1)
                        + count(g["kept"]) + 4 * count(g["mstart"])
                        + 4 * count(g["ml_ext"]) + 4 * 2 * B * P.NROWS
                        + scal + B * P.OUT_CAP,
        }


def copy_rates(dev, nbytes=32 << 20):
    """The bound of the LZ4 path's copies on this card: `nbytes` to the
    card and back, from and into pinned and pageable host memory (CUDA
    events around ten copies, median of 5 after a warm-up; pinned copies
    asynchronous, pageable ones as `.to` and `.cpu()` make them), and the
    host's own copy of the same bytes into pinned memory and out of it as
    `bytes` (host clock). {name: (ms, GB/s)}, each also logged."""
    src = np.random.default_rng(0).integers(0, 256, nbytes, np.uint8)
    onto = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    pinned.numpy()[:] = src
    hosts = {"pinned": pinned, "pageable": torch.from_numpy(src.copy())}
    rates = {}

    def note(name, ms):
        rates[name] = (ms, nbytes / ms / 1e6)

    for kind, host in hosts.items():
        asynchronous = kind == "pinned"
        note(f"h2d_{kind}", timed_launches(lambda: onto.copy_(host, non_blocking=asynchronous)))
        note(f"d2h_{kind}", timed_launches(lambda: host.copy_(onto, non_blocking=asynchronous)))
    flat = pinned.numpy()
    note("host_fill_pinned",
         statistics.median(sample_ms(lambda: flat.__setitem__(slice(None), src), device="cpu")))
    note("host_tobytes_pinned", statistics.median(sample_ms(flat.tobytes, device="cpu")))
    for name, (ms, gbs) in rates.items():
        log(f"copies: {name}, {nbytes} bytes: {ms:.4f} ms, {gbs:.3f} GB/s")
    return rates


def best(fn, reps=3):
    """(result, least host seconds) of `reps` calls of `fn`."""
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t)
    return out, min(times)


def lz4_decode_times(framed, corpus, frame, block, block_size):
    """The main path's frame decoded serially (`frame.decompress`) and block
    by block in 8 threads (`decompress_lz4`), each checked; and the
    library's decode calls alone over the same blocks, sliced beforehand,
    which leaves the Python around them (host clock, best of 3)."""
    from tpu7z_torch.parallel import decode

    got, serial_s = best(lambda: frame.decompress(framed))
    if got != corpus:
        raise AssertionError("the frame does not decode to the input")
    got, threads_s = best(lambda: decode.decompress_lz4(framed, threads=8))
    if got != corpus:
        raise AssertionError("decompress_lz4 (8 threads) does not decode the frame to the input")
    payloads = [p for stored, p in frame.iter_blocks(framed) if not stored]
    _, library_s = best(lambda: [block._decode_native(p, b"", block_size) for p in payloads])
    log(f"32 MiB frame decoded (host clock, best of 3): serially by frame.decompress "
        f"{serial_s:.4f} s, by decompress_lz4 in 8 threads {threads_s:.4f} s; the library's "
        f"{len(payloads)} block decodes alone {library_s:.4f} s, so the Python around them "
        f"{serial_s - library_s:.4f} s: equal")
    return {"serial_s": serial_s, "threads8_s": threads_s, "library_s": library_s}


def spans_of(fn):
    """(fn's result, seconds by trace span name) of one call of fn with
    tracing on (each device stage synchronizes the card at its ends)."""
    from tpu7z_torch.utils import trace

    trace.attach(keep_records=True)
    trace.clear()
    try:
        out = fn()
        spans = {}
        for r in trace.records():
            spans[r["name"]] = spans.get(r["name"], 0.0) + r["seconds"]
    finally:
        trace.detach()
        trace.clear()
    return out, spans


def zstd_phase(corpus, dev, S, M, card_label):
    """Phase 8, zstd: (a) the host tier over the corpus, (b) the tensor
    parse on the card against the port's CPU run, (c) the corpus through
    the tensor encoder on the card, its launches counted and its stages
    timed, and the row sort at this path's shape against its plain
    version. Returns the numbers for the kernels line and the log."""
    from tpu7z_torch.models.zstd import compressor as ZC
    from tpu7z_torch.models.zstd import frame as ZF
    from tpu7z_torch.ops import hash_chain as HC
    from tpu7z_torch.parallel import decode as PD
    from tpu7z_torch.parallel import zstd_jobs as ZJ

    mb = len(corpus) / 1e6

    # (a) the host tier: one frame at levels 3 and 5, by one call and by
    # the job model at 4 workers, each decoded serially and frame-parallel
    for level in (3, 5):
        one, t_one = best(lambda: ZF.compress(corpus, level=level))
        jobs4, t_jobs4 = best(lambda: ZJ.compress_sharded(corpus, level=level, workers=4))
        jobs1, t_jobs1 = best(lambda: ZJ.compress_sharded(corpus, level=level, workers=1), 1)
        if jobs4 != jobs1:
            raise AssertionError(f"zstd level {level}: the job model's frame at 4 workers "
                                 f"differs from 1 worker's")
        if ZF.compress(corpus, level=level, threads=4) != jobs4:
            raise AssertionError(f"zstd level {level}: frame.compress(threads=4) differs from "
                                 f"compress_sharded(workers=4)")
        for name, framed in (("one call", one), ("4 jobs", jobs4)):
            got, t_dec = best(lambda: ZF.decompress(framed))
            if got != corpus or PD.decompress_zstd(framed) != corpus:
                raise AssertionError(f"zstd level {level} ({name}) does not decode to the input")
            log(f"zstd host tier, level {level}, {name}: {len(framed)} bytes, ratio "
                f"{len(corpus) / len(framed):.6f}; decoded {t_dec:.4f} s "
                f"({mb / t_dec:.1f} MB/s), decompress_zstd equal")
        log(f"zstd host tier, level {level} (host clock, best of 3; {card_label}): one call "
            f"{t_one:.3f} s ({mb / t_one:.1f} MB/s, ratio {len(corpus) / len(one):.6f}); "
            f"job model 4 workers {t_jobs4:.3f} s ({mb / t_jobs4:.1f} MB/s, ratio "
            f"{len(corpus) / len(jobs4):.6f}), 1 worker {t_jobs1:.3f} s, same frame")
    # frame-parallel decode: eight frames of 4 MiB back to back
    frames = b"".join(ZF.compress(corpus[a:a + (4 << 20)], level=3)
                      for a in range(0, len(corpus), 4 << 20))
    got, t_serial = best(lambda: ZF.decompress(frames))
    got8, t_par = best(lambda: PD.decompress_zstd(frames, threads=8))
    if got != corpus or got8 != corpus:
        raise AssertionError("eight concatenated zstd frames do not decode to the input")
    log(f"zstd decode of 8 frames of 4 MiB ({len(frames)} bytes; host clock, best of 3): "
        f"serial {t_serial:.4f} s ({mb / t_serial:.1f} MB/s), decompress_zstd 8 threads "
        f"{t_par:.4f} s ({mb / t_par:.1f} MB/s)")

    # (b) the tensor parse on the card against the port's CPU run: 3 MiB
    # in 1 MiB segments (history crosses each join), and 8 MiB at (c)'s
    # shape, 4 MiB segments behind 2 MiB of history (level 5's parameters)
    for mib, seg_mib in ((3, 1), (8, 4)):
        head = corpus[:mib << 20]
        kw = dict(hashlog=17, window_log=21, depth=3, lazy=1, seg_size=seg_mib << 20)
        t = time.perf_counter()
        card = ZC.find_sequences_windowed(head, device=dev, **kw)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t
        t = time.perf_counter()
        cpu = ZC.find_sequences_windowed(head, device="cpu", **kw)
        t_cpu = time.perf_counter() - t
        for g, w, what in zip(card, cpu, ("mpos", "mlen", "moff")):
            if g.device.type != "cuda" or not torch.equal(g.cpu(), w):
                raise AssertionError(f"find_sequences_windowed {what} on the card differs "
                                     f"from the CPU run ({mib} MiB, {seg_mib} MiB segments)")
        log(f"find_sequences_windowed({mib} MiB, hashlog 17, window_log 21, depth 3, lazy 1, "
            f"segments of {seg_mib} MiB): card {t_card:.3f} s, CPU {t_cpu:.3f} s (host "
            f"clock); {card[0].numel()} matches, (mpos, mlen, moff) equal")
        del card, cpu

    # (c) the whole corpus through the tensor encoder on the card, what
    # `a -tzstd -m0=zstd:wlog=21` runs: launches counted, stages traced
    S.reset_launches()
    HC.reset_steps()
    t = time.perf_counter()
    framed, spans = spans_of(lambda: ZC.compress(corpus, level=5, window_log=21, device=dev))
    t_enc = time.perf_counter() - t
    launches = S.LAUNCHES["sort_rows"]
    steps = dict(HC.STEPS)
    segments = -(-len(corpus) // (1 << 22))
    if launches != segments:
        raise AssertionError(f"zstd tensor encoder: {launches} row sorts, expected one per "
                             f"segment ({segments})")
    t = time.perf_counter()
    if ZF.decompress(framed) != corpus:
        raise AssertionError("the tensor encoder's frame does not decode to the input")
    t_dec = time.perf_counter() - t
    log(f"zstd tensor encoder, corpus, level 5, window_log 21, on the card: {len(framed)} "
        f"bytes, ratio {len(corpus) / len(framed):.6f}, {t_enc:.3f} s host clock "
        f"({mb / t_enc:.2f} MB/s), {launches} sort_rows launches, probe steps {steps}; "
        f"decoded natively in {t_dec:.4f} s: equal")
    log(f"zstd tensor encoder stages (s, card synchronized at each span's ends): "
        f"{ {k: round(v, 4) for k, v in sorted(spans.items())} }")

    # the row sort at this path's shape: the segment at 4 MiB behind 2 MiB
    # of history, hashlog 17, int32 keys and an int32 position payload
    row = torch.from_numpy(np.frombuffer(corpus, np.uint8)[2 << 20:8 << 20].copy()).to(dev)
    h = HC.hashes(HC.u32_at(row), 17)[None]
    key, bb = M.hash_key(h, 17)
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=dev)[None].contiguous()
    got = S.sort_rows(key, pos, begin_bit=bb)
    want = S.sort_rows_ref(key, pos, begin_bit=bb)
    err = max_abs_err([bits64(g) for g in got], [bits64(w) for w in want])
    if err:
        raise AssertionError(f"sort_rows differs from its plain version on the zstd path's "
                             f"row: max abs err {err}")
    ms = timed(lambda: S.sort_rows(key, pos, begin_bit=bb))
    order_ms = timed(lambda: M.sort_order(h, 17))
    outs, scratch = S.buffers(key, (pos,), bb)
    kernel_ms = timed_launches(lambda: S._launch(key, (pos,), outs, scratch, bb))
    plain_ms = timed(lambda: S.sort_rows_ref(key, pos, begin_bit=bb))
    k64 = key.to(torch.int64) & 0xFFFFFFFF
    lib_ms = timed(lambda: torch.sort(k64, dim=1, stable=True))
    bound_ms = 2 * 2 * key.numel() * 4 / HBM_BYTES_PER_S * 1e3
    log(f"sort_rows on the zstd path's row {tuple(key.shape)} (int32 keys h << 14, int32 "
        f"position payload, begin_bit {bb}): equal to its plain version; {ms:.3f} ms through "
        f"the wrapper, {order_ms:.3f} ms as sort_order, launches alone {kernel_ms:.3f} ms, "
        f"bound {bound_ms:.3f} ms; plain {plain_ms:.3f} ms, torch.sort (int64, stable) "
        f"{lib_ms:.3f} ms")
    return {"launches": launches, "shape": list(key.shape), "begin_bit": bb, "ms": ms,
            "sort_order_ms": order_ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "max_abs_err": err,
            "encoder_s": t_enc, "stages_s": spans, "probe_steps": steps, "frame": framed}


def lz_phase(corpus, dev, S, M, card_label):
    """Phase 9, the shared LZ matcher on the card and the .xz host tier:
    (a) LZ4's tensor parse, (b) LZMA's fast parse, each counted and
    checked against its CPU run, and the row sort at the LZMA row's shape
    against its plain version; (c) the host tier of .xz and LZMA2, the
    native CRCs and the CLI's .xz verbs. Returns the numbers for the
    kernels line and the log."""
    import lzma as stdlzma
    import zlib

    from tpu7z_torch.containers import xz
    from tpu7z_torch.models.lz4 import block as LB
    from tpu7z_torch.models.lz4 import frame as LF
    from tpu7z_torch.models.lzma import encoder as LE
    from tpu7z_torch.models.lzma import lzma2 as L2
    from tpu7z_torch.ops import hash_chain as HC
    from tpu7z_torch.ops.hashing import crc32, crc32_native, crc64, crc64_native
    from tpu7z_torch.parallel import decode as PD

    mb = len(corpus) / 1e6
    raw2 = [{"id": stdlzma.FILTER_LZMA2, "dict_size": 1 << 24}]
    out = {}

    # (a) LZ4's tensor parse: the corpus as 4 MiB blocks at accel 2, one
    # row sort a block; the card's block equal to the CPU's on 1 MiB
    head = corpus[:1 << 20]
    card_block = LB.compress_block(head, accel=2, device=dev)
    cpu_block = LB.compress_block(head, accel=2, device="cpu")
    if card_block != cpu_block:
        raise AssertionError("compress_block(accel=2) on the card differs from its CPU run")
    log(f"compress_block(first 1 MiB, accel 2): card and CPU {len(card_block)} bytes, equal")
    S.reset_launches()
    t = time.perf_counter()
    framed, spans = spans_of(lambda: LF.compress_frame(corpus, accel=2, device=dev))
    t_lz4 = time.perf_counter() - t
    launches = S.LAUNCHES["sort_rows"]
    blocks = -(-len(corpus) // (4 << 20))
    if launches != blocks:
        raise AssertionError(f"compress_frame(accel=2): {launches} row sorts, expected one "
                             f"a block ({blocks})")
    if LF.decompress(framed, verify_checksums=True) != corpus:
        raise AssertionError("compress_frame(accel=2)'s frame does not decode to the input")
    if framed == LF.compress_frame(corpus):
        raise AssertionError("compress_frame(accel=2) gave the host library's frame")
    log(f"compress_frame(corpus, accel=2) on the card ({card_label}): {len(framed)} bytes, "
        f"ratio {len(corpus) / len(framed):.6f}, {t_lz4:.3f} s host clock with tracing "
        f"({mb / t_lz4:.2f} MB/s), {launches} sort_rows launches (one a 4 MiB block); "
        f"decoded with checksums verified: equal; spans (s) "
        f"{ {k: round(v, 4) for k, v in sorted(spans.items())} }")
    out["lz4_accel"] = {"launches": launches, "seconds": t_lz4, "spans_s": spans,
                        "ratio": len(corpus) / len(framed)}

    # (b) LZMA's fast parse: each 64 KiB chunk of the first 1 MiB and a
    # 10-byte tail as tpu7z finds them (over the prefix to the chunk's
    # end), on the card against the CPU, and from one matcher over the
    # whole prefix; then 8 MiB through compress_chunks on the card
    w = np.frombuffer(corpus[:(1 << 20) + 10], np.uint8)
    chunks = [(a, min(a + (1 << 16), w.size)) for a in range(0, 1 << 20, 1 << 16)]
    chunks.append((1 << 20, w.size))
    whole = LE.WindowMatcher(w, device=dev)
    found = 0
    for a, b in chunks:
        card = LE._find_matches_window(w, a, b, device=dev)
        cpu = LE._find_matches_window(w, a, b, device="cpu")
        once = whole.matches(a, b)
        for g, o, c, what in zip(card, once, cpu, ("mpos", "mlen", "mdist")):
            if g.device.type != dev.type or not (torch.equal(g.cpu(), c)
                                               and torch.equal(o.cpu(), c)):
                raise AssertionError(f"_find_matches_window {what} on the card differs from "
                                     f"the CPU run on [{a}, {b})")
        found += int(cpu[0].numel())
    log(f"_find_matches_window on the card equals its CPU run and the one-pass matcher on "
        f"the first 1 MiB's {len(chunks) - 1} chunks of 64 KiB and a 10-byte tail "
        f"({found} matches)")
    lz = corpus[:8 << 20]
    S.reset_launches()
    t = time.perf_counter()
    stream, spans = spans_of(lambda: L2.compress_chunks(lz, device=dev))
    t_lzma = time.perf_counter() - t
    launches = S.LAUNCHES["sort_rows"]
    if launches != 1:
        raise AssertionError(f"compress_chunks: {launches} row sorts, expected 1")
    if L2.decompress(stream + b"\x00") != lz:
        raise AssertionError("compress_chunks' stream does not decode to the input (port)")
    if stdlzma.decompress(stream + b"\x00", format=stdlzma.FORMAT_RAW, filters=raw2) != lz:
        raise AssertionError("compress_chunks' stream does not decode to the input (stdlib)")
    log(f"lzma2.compress_chunks(8 MiB) on the card ({card_label}): {len(stream)} bytes, ratio "
        f"{len(lz) / len(stream):.6f}, {t_lzma:.3f} s host clock with tracing "
        f"({len(lz) / 1e6 / t_lzma:.3f} MB/s), {launches} sort_rows launch; decoded by "
        f"lzma2.decompress and the standard library: equal; spans (s) "
        f"{ {k: round(v, 4) for k, v in sorted(spans.items())} }")
    out["lzma_fast_parse"] = {"launches": launches, "seconds": t_lzma, "spans_s": spans,
                              "ratio": len(lz) / len(stream)}

    # the row sort at this path's shape: one row of 8 Mi int32 keys h << 15
    # (hashlog 16) with an int32 position payload, begin_bit 8
    row = torch.from_numpy(np.frombuffer(lz, np.uint8).copy()).to(dev)
    h = HC.hashes(HC.u32_at(row), 16)[None]
    key, bb = M.hash_key(h, 16)
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=dev)[None].contiguous()
    got = S.sort_rows(key, pos, begin_bit=bb)
    want = S.sort_rows_ref(key, pos, begin_bit=bb)
    err = max_abs_err([bits64(g) for g in got], [bits64(w_) for w_ in want])
    if err:
        raise AssertionError(f"sort_rows differs from its plain version on the LZMA row: "
                             f"max abs err {err}")
    ms = timed(lambda: S.sort_rows(key, pos, begin_bit=bb))
    outs, scratch = S.buffers(key, (pos,), bb)
    kernel_ms = timed_launches(lambda: S._launch(key, (pos,), outs, scratch, bb))
    plain_ms = timed(lambda: S.sort_rows_ref(key, pos, begin_bit=bb))
    k64 = key.to(torch.int64) & 0xFFFFFFFF
    lib_ms = timed(lambda: torch.sort(k64, dim=1, stable=True))
    bound_ms = 2 * 2 * key.numel() * 4 / HBM_BYTES_PER_S * 1e3
    log(f"sort_rows on the LZMA row {tuple(key.shape)} (int32 keys h << 15, int32 position "
        f"payload, begin_bit {bb}): equal to its plain version; {ms:.3f} ms through the "
        f"wrapper, launches alone {kernel_ms:.3f} ms, bound {bound_ms:.3f} ms; plain "
        f"{plain_ms:.3f} ms, torch.sort (int64, stable) {lib_ms:.3f} ms ({card_label})")
    out["sort"] = {"shape": list(key.shape), "begin_bit": bb, "ms": ms, "kernel_ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
                   "max_abs_err": err}
    del row, h, key, pos, got, want, outs, scratch, k64

    # (c) the host tier: .xz over the corpus, LZMA2 shards decoded in
    # threads, the native CRCs, the CLI's .xz verbs
    t = time.perf_counter()
    framed = xz.compress(corpus)
    t_xz = time.perf_counter() - t
    back, t_dec = best(lambda: xz.decompress(framed), 1)
    if back != corpus:
        raise AssertionError("xz.compress's stream does not decode to the input")
    # tpu7z's block header declares a 16 MiB dictionary whatever the
    # input's size, and its encoder's matches reach across the whole
    # input: the standard library decodes the block's LZMA2 stream given
    # a dictionary of the input's size, and may refuse the container
    payload = framed[12 + (framed[12] + 1) * 4:]
    std_dec = stdlzma.LZMADecompressor(stdlzma.FORMAT_RAW, filters=[
        {"id": stdlzma.FILTER_LZMA2, "dict_size": 1 << 25}])
    if std_dec.decompress(payload) != corpus or not std_dec.eof:
        raise AssertionError("the standard library does not decode xz.compress's LZMA2 stream")
    try:
        container = "decodes it" if stdlzma.decompress(framed) == corpus else "differs"
    except stdlzma.LZMAError as exc:
        container = f"refuses it ({exc}), as it refuses tpu7z's"
    log(f"xz.compress(corpus) ({card_label}, host clock): {len(framed)} bytes, ratio "
        f"{len(corpus) / len(framed):.6f}, {t_xz:.3f} s ({mb / t_xz:.2f} MB/s); "
        f"xz.decompress {t_dec:.3f} s ({mb / t_dec:.1f} MB/s): equal; the standard library "
        f"decodes its LZMA2 stream with a 32 MiB dictionary: equal; the .xz as written "
        f"(a 16 MiB dictionary declared): the standard library {container}")
    sh = corpus[:16 << 20]
    t = time.perf_counter()
    sharded = L2.compress(sh, shard_size=4 << 20)
    t_sh = time.perf_counter() - t
    groups = PD.scan_lzma2_groups(sharded)
    serial, t_serial = best(lambda: L2.decompress(sharded))
    par, t_par = best(lambda: PD.decompress_lzma2(sharded, threads=8))
    if serial != sh or par != sh or len(groups) != 4:
        raise AssertionError(f"lzma2.compress(shard_size=4 MiB): {len(groups)} groups, "
                             f"decoded serially and in 8 threads not equal to the input")
    if stdlzma.decompress(sharded, format=stdlzma.FORMAT_RAW, filters=raw2) != sh:
        raise AssertionError("the standard library does not decode the sharded LZMA2 stream")
    log(f"lzma2.compress(16 MiB, shard_size=4 MiB) (host clock): {len(sharded)} bytes, ratio "
        f"{len(sh) / len(sharded):.6f}, {t_sh:.3f} s; {len(groups)} groups decoded serially "
        f"{t_serial:.4f} s, by decompress_lzma2 in 8 threads {t_par:.4f} s (best of 3), and by "
        f"the standard library: equal")
    part = corpus[:1 << 20]
    if crc32_native(part) != crc32(part) or crc64_native(part) != crc64(part):
        raise AssertionError("the native CRCs differ from the Python ones on the first 1 MiB")
    c32, t32 = best(lambda: crc32_native(corpus))
    c64, t64 = best(lambda: crc64_native(corpus))
    if c32 != zlib.crc32(corpus):
        raise AssertionError("crc32_native differs from zlib.crc32 over the corpus")
    _, tz = best(lambda: zlib.crc32(corpus))
    log(f"crc32_native and crc64_native equal the Python forms on the first 1 MiB, "
        f"crc32_native zlib.crc32 over the corpus (crc64_native's check of the corpus is the "
        f"one the standard library verified above); host clock, best of 3: crc32_native "
        f"{t32 * 1e3:.3f} ms ({len(corpus) / t32 / 1e9:.2f} GB/s), crc64_native "
        f"{t64 * 1e3:.3f} ms ({len(corpus) / t64 / 1e9:.2f} GB/s), zlib.crc32 {tz * 1e3:.3f} ms")
    root = Path(__file__).resolve().parent
    from tpu7z_torch.ops import _build
    work = Path(tempfile.mkdtemp(dir=_build.BUILD))
    try:
        head2 = corpus[:2 << 20]
        (work / "head.bin").write_bytes(head2)
        env = dict(os.environ, PYTHONPATH=str(root))
        for args in (["a", "-txz", "head.xz", "head.bin"], ["t", "head.xz"],
                     ["x", "head.xz", "-oout"]):
            t = time.time()
            r = subprocess.run([sys.executable, "-m", "tpu7z_torch.cli", *args], cwd=work,
                               env=env, capture_output=True, text=True, timeout=300)
            log(f"python -m tpu7z_torch.cli {' '.join(args)}: exit {r.returncode} in "
                f"{time.time() - t:.1f} s: {r.stdout.strip()!r}")
            if r.returncode != 0:
                raise AssertionError(f"the CLI failed:\n{r.stdout}\n{r.stderr}")
        if (work / "out" / "head").read_bytes() != head2:
            raise AssertionError("the CLI's .xz does not extract to its input")
        if (work / "head.xz").read_bytes() != xz.compress(head2):
            raise AssertionError("the CLI's .xz differs from xz.compress's")
        log("the CLI's .xz equals xz.compress's and extracts to its input")
    finally:
        shutil.rmtree(work)
    out["host"] = {"xz_s": t_xz, "xz_ratio": len(corpus) / len(framed), "xz_decode_s": t_dec,
                   "shards_s": t_sh, "shards_serial_s": t_serial, "shards_threads8_s": t_par,
                   "crc32_ms": t32 * 1e3, "crc64_ms": t64 * 1e3}
    return out


def sevenzip_phase(corpus, dev, S, card_label, zstd_frame):
    """Phase 10, the .7z container: (a) the corpus as eight 4 MiB files in
    one solid zstd .7z at level 5 (the tensor encoder, one row sort a 4
    MiB segment), its pack stream equal to phase 8's frame; (b) the same
    with a password and the header encrypted, the KDF, the native encrypt
    and the card's decrypt of the packed folder against the same tensor
    code on the CPU, and (a2) the corpus decrypted on the card in two
    passes; (c) the default LZMA2 .7z of the first 8 MiB as two
    files; (d) 4 MiB as two non-solid zstd folders written on the card and
    on the CPU, equal; (e) the native encrypt against its Python twin on
    64 KiB; (f) the CLI's `a -t7z -m0=zstd -p -mhe`, `t` and `x`; (g) the
    tensor filters on the card against the CPU. Every archive is read
    back by SevenZipReader on the card. Returns the
    numbers for the log and the kernels line."""
    from tpu7z_torch.containers.sevenzip import SevenZipReader, aes7z, write_archive
    from tpu7z_torch.ops import _build

    password = "chip smoke"
    out = {}

    def archive(name, files, **kw):
        """Write, count the row sorts, read back on the card, check."""
        size = sum(len(v) for v in files.values())
        S.reset_launches()
        t = time.perf_counter()
        arc = write_archive(files, device=dev, **kw)
        torch.cuda.synchronize()
        t_write = time.perf_counter() - t
        launches = S.LAUNCHES["sort_rows"]
        t = time.perf_counter()
        rd = SevenZipReader(arc, password=kw.get("password"), device=dev)
        back = rd.extract_all()
        t_read = time.perf_counter() - t
        if back != files:
            raise AssertionError(f".7z {name}: extract_all differs from the files written")
        log(f".7z {name} ({card_label}, host clock): {size} bytes in {len(files)} files -> "
            f"{len(arc)} bytes, ratio {size / len(arc):.6f}; written in {t_write:.3f} s "
            f"({size / 1e6 / t_write:.2f} MB/s), {launches} sort_rows launches; read back on "
            f"the card in {t_read:.3f} s ({size / 1e6 / t_read:.1f} MB/s): equal")
        out[name] = {"bytes": size, "archive_bytes": len(arc), "ratio": size / len(arc),
                     "write_s": t_write, "read_s": t_read, "sort_rows_launches": launches}
        return arc, rd

    files = {f"corpus/{i}.bin": corpus[i << 22:(i + 1) << 22] for i in range(8)}
    # (a) solid zstd at the CLI's default level: one folder, the corpus
    # through the tensor encoder; its pack stream is phase 8's frame
    arc, _ = archive("zstd_solid", files, method="zstd", level=5)
    if out["zstd_solid"]["sort_rows_launches"] != 8:
        raise AssertionError(f"solid zstd .7z: {out['zstd_solid']['sort_rows_launches']} row "
                             f"sorts, expected one a 4 MiB segment (8)")
    if arc[32:32 + len(zstd_frame)] != zstd_frame:
        raise AssertionError("solid zstd .7z: its pack stream differs from phase 8's frame")
    log("solid zstd .7z: its pack stream equals phase 8's tensor-encoder frame")

    # (b) the same, encrypted, header too
    arc, rd = archive("zstd_solid_aes", files, method="zstd", level=5, password=password,
                      encrypt_header=True)
    folder = rd.streams.folders[0]
    props = folder.coders[1].props
    packed = arc[32:32 + rd.streams.pack_sizes[0]]
    cycles, salt, iv = aes7z.parse_props(props)
    t = time.perf_counter()
    key = aes7z.derive_key(password, salt, cycles)
    t_kdf = time.perf_counter() - t
    padded = zstd_frame + b"\x00" * ((-len(zstd_frame)) % 16)
    enc, t_enc = best(lambda: aes7z.encrypt_cbc(padded, key, iv))
    if enc != packed:
        raise AssertionError("encrypt_cbc of phase 8's frame differs from the archive's folder")
    ct = torch.frombuffer(bytearray(packed), dtype=torch.uint8).view(-1, 16)
    ct_card = ct.to(dev)
    plain_card = aes7z.decrypt_cbc(ct_card, key, iv)
    torch.cuda.synchronize()
    plain_cpu, t_cpu = best(lambda: aes7z.decrypt_cbc(ct, key, iv), 1)
    if not torch.equal(plain_card.cpu(), plain_cpu):
        raise AssertionError("decrypt_cbc on the card differs from its CPU run")
    if plain_cpu.numpy().tobytes()[:len(zstd_frame)] != zstd_frame:
        raise AssertionError("decrypt_cbc does not give the frame back")
    dec_ms = timed(lambda: aes7z.decrypt_cbc(ct_card, key, iv))
    mb = len(packed) / 1e6
    log(f"AES-256 ({card_label}): KDF (2^{cycles} SHA-256 rounds) {t_kdf:.3f} s host clock; "
        f"native CBC encrypt of the {len(packed)}-byte folder {t_enc:.4f} s ({mb / t_enc:.1f} "
        f"MB/s, best of 3), equal to the archive's; decrypt_cbc on the card {dec_ms:.3f} ms "
        f"({mb / dec_ms * 1e3:.1f} MB/s, CUDA events, median of 5), the same tensor code on "
        f"the CPU {t_cpu:.3f} s ({mb / t_cpu:.1f} MB/s): equal")
    out["aes"] = {"folder_bytes": len(packed), "kdf_s": t_kdf, "encrypt_s": t_enc,
                  "encrypt_MBps": mb / t_enc, "decrypt_card_ms": dec_ms,
                  "decrypt_cpu_s": t_cpu}
    del ct, ct_card, plain_card, plain_cpu
    out["aes"].update(aes_passes(corpus, key, iv, dev, card_label))

    # (c) the default method, LZMA2, over the first 8 MiB as two files
    archive("lzma2_solid", {"a.bin": corpus[:4 << 20], "b.bin": corpus[4 << 20:8 << 20]})

    # (d) 4 MiB as two non-solid zstd folders, on the card and on the CPU
    two = {"a.bin": corpus[:2 << 20], "b.bin": corpus[2 << 20:4 << 20]}
    arc, _ = archive("zstd_non_solid", two, method="zstd", level=5, solid=False)
    t = time.perf_counter()
    if write_archive(two, method="zstd", level=5, solid=False, device="cpu") != arc:
        raise AssertionError("non-solid zstd .7z on the card differs from the CPU's")
    log(f"non-solid zstd .7z of 4 MiB: the CPU's is equal byte for byte "
        f"({time.perf_counter() - t:.3f} s on the CPU)")

    # (e) the native encrypt against its Python twin
    head = corpus[:1 << 16]
    aprops = bytes([19 | 0x40, 0x0F]) + bytes(range(16))
    t = time.perf_counter()
    if aes7z.aes_encrypt(head, aprops, password) != aes7z.aes_encrypt_ref(head, aprops, password):
        raise AssertionError("aes_encrypt differs from aes_encrypt_ref on 64 KiB")
    log(f"aes_encrypt equals its Python twin on 64 KiB ({time.perf_counter() - t:.2f} s)")

    # (f) the CLI's .7z verbs, each in a process of its own, on the card
    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(dir=_build.BUILD))
    try:
        head = corpus[:2 << 20]
        (work / "head.bin").write_bytes(head)
        env = dict(os.environ, PYTHONPATH=str(root))
        for args in (["a", "-t7z", "-m0=zstd", f"-p{password}", "-mhe", "head.7z", "head.bin"],
                     ["t", f"-p{password}", "head.7z"],
                     ["x", f"-p{password}", "head.7z", "-oout"]):
            t = time.time()
            r = subprocess.run([sys.executable, "-m", "tpu7z_torch.cli", *args], cwd=work,
                               env=env, capture_output=True, text=True, timeout=300)
            log(f"python -m tpu7z_torch.cli {' '.join(args)}: exit {r.returncode} in "
                f"{time.time() - t:.1f} s: {r.stdout.strip()!r}")
            if r.returncode != 0:
                raise AssertionError(f"the CLI failed:\n{r.stdout}\n{r.stderr}")
        if (work / "out" / "head.bin").read_bytes() != head:
            raise AssertionError("the CLI's .7z does not extract to its input")
        back = SevenZipReader((work / "head.7z").read_bytes(), password=password,
                              device=dev).extract_all()
        if back != {"head.bin": head}:
            raise AssertionError("the CLI's .7z does not read back to its input")
        log("the CLI's encrypted zstd .7z extracts to its input")
    finally:
        shutil.rmtree(work)

    # (g) the branch converters and delta on the card
    out["filters"] = filter_checks(dev, card_label)
    return out


def sort_shape(S, key, payloads, bb, what, card_label, time_it=True):
    """`sort_rows` on (key, *payloads) against its plain version, exactly;
    with `time_it`, its time through the wrapper and as its launches alone,
    the plain version's, `torch.sort`'s (int64, stable) and the bound (each
    operand read once and written once at 3.35 TB/s)."""
    got = S.sort_rows(key, *payloads, begin_bit=bb)
    want = S.sort_rows_ref(key, *payloads, begin_bit=bb)
    err = max_abs_err([bits64(g) for g in got], [bits64(w) for w in want])
    if err:
        raise AssertionError(f"sort_rows differs from its plain version on {what}: "
                             f"max abs err {err}")
    out = {"shape": list(key.shape), "begin_bit": bb, "payloads": len(payloads),
           "max_abs_err": err}
    if not time_it:
        log(f"sort_rows on {what} {tuple(key.shape)}, begin_bit {bb}: equal to its plain "
            f"version")
        return out
    outs, scratch = S.buffers(key, payloads, bb)
    k64 = key.to(torch.int64) & 0xFFFFFFFF
    out.update(
        ms=timed(lambda: S.sort_rows(key, *payloads, begin_bit=bb)),
        kernel_ms=timed_launches(lambda: S._launch(key, payloads, outs, scratch, bb)),
        plain_ms=timed(lambda: S.sort_rows_ref(key, *payloads, begin_bit=bb)),
        library_ms=timed(lambda: torch.sort(k64, dim=1, stable=True)),
        bound_ms=2 * (1 + len(payloads)) * key.numel() * 4 / HBM_BYTES_PER_S * 1e3)
    log(f"sort_rows on {what} {tuple(key.shape)}, begin_bit {bb}: equal to its plain version; "
        f"{out['ms']:.3f} ms through the wrapper, launches alone {out['kernel_ms']:.3f} ms, "
        f"bound {out['bound_ms']:.3f} ms; plain {out['plain_ms']:.3f} ms, torch.sort (int64, "
        f"stable) {out['library_ms']:.3f} ms ({card_label})")
    return out


def cli_run(args, device):
    """(exit code, stdout) of the port's CLI run in this process on `device`."""
    import contextlib
    import io

    from tpu7z_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(args, device=device)
    return rc, buf.getvalue()


def deflate_bzip2_phase(corpus, dev, S, M, card_label):
    """Phase 11, DEFLATE, gzip, .zip, .tar and bzip2 on the card: (a)
    `sort_rows` at this slice's shapes against its plain version; (b)
    deflate's parse and stream on the card against its CPU run; (c) the
    corpus as one .gz (the full-size path), read by zlib; (d) the port's
    gzip_decompress; (e) the corpus as a deflate .zip of eight 4 MiB files,
    read by zipfile; (f) the port's read_zip; (g) a .zip a method; (h) a
    .tar of the eight files, both ways with tarfile; (i) bzip2 at level 9,
    read by bz2 and by the port (inverse BWT on the card), the first
    block's BWT against its CPU run, and a run across a block cut; (j)
    deflate and bzip2 .7z folders; (k) the CLI's a, t, x and l. Returns
    the numbers for the log and the kernels line."""
    import bz2
    import io
    import tarfile
    import zipfile
    import zlib

    from tpu7z_torch.containers import tar as TAR
    from tpu7z_torch.containers import zip as ZIP
    from tpu7z_torch.containers.sevenzip import SevenZipReader, write_archive
    from tpu7z_torch.models import bzip2 as BZ
    from tpu7z_torch.models import deflate as DF
    from tpu7z_torch.models.bzip2 import bwt as BWT
    from tpu7z_torch.models.bzip2 import codec as BZC
    from tpu7z_torch.models.deflate import codec as DFC
    from tpu7z_torch.ops import _build
    from tpu7z_torch.ops import hash_chain as HC

    mib = 1 << 20
    mb = len(corpus) / 1e6
    out = {"sort": {}}

    # (a) sort_rows at this slice's shapes: deflate's rows (every 128 KiB
    # block of the corpus a row of hashes at hashlog 15, key h << 16, a
    # position payload) and a short last row; a bzip2 doubling pass (900004
    # keys below 2**20 with duplicates, key << 12) and the 8-bit
    # occurrence sort (key << 24)
    rng = np.random.default_rng(13)
    s_all = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).to(dev)
    for name, row, time_it in (("deflate_rows", s_all.view(-1, DFC.BLOCK), True),
                               ("deflate_short_row", s_all[-45056:][None], False)):
        h = HC.hashes(HC.u32_at(row), DFC.HASHLOG)
        key, bb = M.hash_key(h, DFC.HASHLOG)
        pos = torch.arange(h.shape[1], dtype=torch.int32, device=dev).expand(h.shape).contiguous()
        out["sort"][name] = sort_shape(S, key, (pos,), bb, f"deflate's {name}", card_label,
                                       time_it)
    n_bz = 900004
    idx = torch.arange(n_bz, dtype=torch.int32, device=dev)[None].contiguous()
    ranks = torch.from_numpy(rng.integers(0, 1 << 20, n_bz)).to(dev)[None]
    key, bb = M.hash_key(ranks, 19)
    out["sort"]["bzip2_pass"] = sort_shape(S, key, (idx,), bb, "a bzip2 doubling pass",
                                           card_label)
    key, bb = M.hash_key(s_all[TEXT:TEXT + n_bz].to(torch.int64)[None], 7)
    out["sort"]["bzip2_occurrence"] = sort_shape(S, key, (idx,), bb,
                                                 "bzip2's occurrence sort", card_label, False)
    del s_all, key, idx, ranks
    out["max_abs_err"] = max(v["max_abs_err"] for v in out["sort"].values())

    # (b) deflate's parse and stream on the card against its CPU run
    head = corpus[:2 * mib]
    t_head = torch.from_numpy(np.frombuffer(head, np.uint8).copy())
    card_parse = DFC._find_matches(t_head.to(dev), DFC.BLOCK)
    cpu_parse = DFC._find_matches(t_head, DFC.BLOCK)
    for g, c, what in zip(card_parse, cpu_parse, ("take", "mlen", "off")):
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"deflate's parse on the card differs from its CPU run ({what})")
    if DF.compress(head, device=dev) != DF.compress(head, device="cpu"):
        raise AssertionError("deflate.compress on the card differs from its CPU run")
    log(f"deflate's parse of the first 2 MiB on the card equals its CPU run "
        f"({int(cpu_parse[0].sum())} matches), and so does its stream")

    # (c) the corpus as one .gz on the card: the slice's full-size path
    S.reset_launches()
    t = time.perf_counter()
    gz, spans = spans_of(lambda: DF.gzip_compress(corpus, device=dev))
    t_gz = time.perf_counter() - t
    launches = S.LAUNCHES["sort_rows"]
    if launches != 1:
        raise AssertionError(f"gzip_compress(corpus): {launches} row sorts, expected 1 (every "
                             f"128 KiB block a row)")
    if zlib.decompress(gz, 31) != corpus:
        raise AssertionError("zlib does not read gzip_compress(corpus) back to the corpus")
    log(f"gzip_compress(corpus) on the card ({card_label}): {len(gz)} bytes, ratio "
        f"{len(corpus) / len(gz):.6f}, {t_gz:.3f} s host clock with tracing "
        f"({mb / t_gz:.2f} MB/s), {launches} sort_rows launch; zlib reads it back: equal; "
        f"spans (s) { {k: round(v, 4) for k, v in sorted(spans.items())} }")
    out["deflate"] = {"launches": launches, "seconds": t_gz, "spans_s": spans,
                      "ratio": len(corpus) / len(gz)}

    # (d) the port's gzip_decompress (host inflate) of the first 4 MiB's .gz
    gz4 = DF.gzip_compress(corpus[:4 * mib], device=dev)
    back, t_inf = best(lambda: DF.gzip_decompress(gz4), 1)
    if back != corpus[:4 * mib]:
        raise AssertionError("gzip_decompress does not read the first 4 MiB's .gz back")
    log(f"gzip_decompress of the first 4 MiB's .gz (host clock): {t_inf:.3f} s "
        f"({4 * mib / 1e6 / t_inf:.3f} MB/s): equal")
    out["inflate_s_4MiB"] = t_inf

    # (e) the corpus as a deflate .zip of eight 4 MiB files on the card
    files = {f"part{i}.bin": corpus[i * 4 * mib:(i + 1) * 4 * mib] for i in range(8)}
    S.reset_launches()
    t = time.perf_counter()
    z8 = ZIP.write_zip(files, device=dev)
    t_zip = time.perf_counter() - t
    zip_launches = S.LAUNCHES["sort_rows"]
    with zipfile.ZipFile(io.BytesIO(z8)) as zf:
        if {n: zf.read(n) for n in zf.namelist()} != files:
            raise AssertionError("zipfile does not read the deflate .zip back")
    log(f"write_zip(8 x 4 MiB, deflate) on the card: {len(z8)} bytes, {t_zip:.3f} s host clock "
        f"({mb / t_zip:.2f} MB/s), {zip_launches} sort_rows launches (one a file); zipfile "
        f"reads it back: equal")
    # (f) the port's read_zip of two of those files
    two = {k: files[k] for k in ("part0.bin", "part1.bin")}
    z2 = ZIP.write_zip(two, device=dev)
    got, t_unzip = best(lambda: ZIP.read_zip(z2, device=dev), 1)
    if got != two:
        raise AssertionError("read_zip does not read the two-file .zip back")
    log(f"read_zip of two 4 MiB deflate entries (host inflate): {t_unzip:.3f} s: equal")
    # (g) one .zip a method, 256 KiB of text each, read back by the port
    # (and by zipfile where it has the method)
    piece = {"m.bin": corpus[TEXT:TEXT + (256 << 10)]}
    for method in (ZIP.M_STORE, ZIP.M_DEFLATE, ZIP.M_BZIP2, ZIP.M_LZMA, ZIP.M_ZSTD, ZIP.M_XZ):
        zm = ZIP.write_zip(piece, method=method, device=dev)
        if ZIP.read_zip(zm, device=dev) != piece:
            raise AssertionError(f"read_zip does not read the method-{method} .zip back")
        if method in (ZIP.M_STORE, ZIP.M_DEFLATE, ZIP.M_BZIP2, ZIP.M_LZMA):
            with zipfile.ZipFile(io.BytesIO(zm)) as zf:
                if zf.read("m.bin") != piece["m.bin"]:
                    raise AssertionError(f"zipfile does not read the method-{method} .zip")
    log("a .zip of each method (store, deflate, bzip2, LZMA, zstd, xz) written on the card "
        "reads back by the port, and by zipfile for store, deflate, bzip2 and LZMA: equal")
    out["zip"] = {"launches": zip_launches, "write_s": t_zip, "read2_s": t_unzip,
                  "ratio": len(corpus) / len(z8)}

    # (h) .tar both ways with tarfile
    tb = TAR.write_tar(files)
    with tarfile.open(fileobj=io.BytesIO(tb)) as tf:
        if {m.name: tf.extractfile(m).read() for m in tf.getmembers()} != files:
            raise AssertionError("tarfile does not read write_tar's archive back")
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w", format=tarfile.USTAR_FORMAT) as tf:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    if TAR.read_tar(tb) != files or TAR.read_tar(buf.getvalue()) != files:
        raise AssertionError("read_tar does not read the .tar back")
    log("write_tar(8 x 4 MiB) reads back by tarfile and read_tar, and read_tar reads "
        "tarfile's: equal")

    # (i) bzip2 at level 9 over the first 4 MiB: five blocks
    bz_in = corpus[:4 * mib]
    S.reset_launches()
    t = time.perf_counter()
    bz, bz_spans = spans_of(lambda: BZ.compress(bz_in, level=9, device=dev))
    t_bz = time.perf_counter() - t
    bz_launches = S.LAUNCHES["sort_rows"]
    if bz2.decompress(bz) != bz_in:
        raise AssertionError("bz2 does not read bzip2.compress's stream back")
    t = time.perf_counter()
    back, unbz_spans = spans_of(lambda: BZ.decompress(bz, device=dev))
    t_unbz = time.perf_counter() - t
    if back != bz_in:
        raise AssertionError("bzip2.decompress does not read the stream back")
    first = BZC._blocks(bz_in, 900000)[0][0]
    if BWT.bwt_forward(first, device=dev) != BWT.bwt_forward(first, device="cpu"):
        raise AssertionError("bwt_forward on the card differs from its CPU run (first block)")
    log(f"bzip2.compress(first 4 MiB, level 9) on the card ({card_label}): {len(bz)} bytes, "
        f"ratio {len(bz_in) / len(bz):.6f}, {t_bz:.3f} s host clock with tracing, "
        f"{bz_launches} sort_rows launches; bz2 reads it back: equal; spans (s) "
        f"{ {k: round(v, 4) for k, v in sorted(bz_spans.items())} }; bzip2.decompress "
        f"{t_unbz:.3f} s: equal, spans (s) "
        f"{ {k: round(v, 4) for k, v in sorted(unbz_spans.items())} }; the first block's "
        f"BWT ({len(first)} bytes) on the card equals its CPU run")
    out["bzip2"] = {"launches": bz_launches, "seconds": t_bz, "spans_s": bz_spans,
                    "decode_s": t_unbz, "decode_spans_s": unbz_spans,
                    "ratio": len(bz_in) / len(bz)}
    # a run of nine bytes across the level-1 cut, after its second byte:
    # tpu7z's split would leave the group's count byte to start the next
    # block; the port carries the run's head, and bz2 reads it back
    cut = bytearray(corpus[TEXT:TEXT + 101000])
    cut[99998:100007] = b"\xff" * 9
    cut = bytes(cut)
    rle = BZC._rle1_encode(cut)
    if rle[:100000] != cut[:100000]:
        raise AssertionError("the cut check's text holds a run before the cut")
    if bz2.decompress(BZ.compress(cut, level=1, device=dev)) != cut:
        raise AssertionError("bz2 does not read back a run placed across a block cut")
    log("bzip2 at level 1 of a run placed across the block cut: bz2 reads it back equal")

    # (j) deflate and bzip2 .7z folders, 2 MiB, written and read on the card
    files2 = {"a.bin": corpus[:mib], "b.bin": corpus[mib:2 * mib]}
    for method in ("deflate", "bzip2"):
        t = time.perf_counter()
        arc = write_archive(files2, method=method, device=dev)
        t_w = time.perf_counter() - t
        rd, t_r = best(lambda: SevenZipReader(arc, device=dev).extract_all(), 1)
        if rd != files2:
            raise AssertionError(f"the {method} .7z does not read back")
        log(f"{method} .7z of 2 MiB on the card: {len(arc)} bytes, written {t_w:.3f} s, "
            f"read {t_r:.3f} s: equal")

    # (k) the CLI's a, t, x (and l of .zip and .tar) on the first 2 MiB
    work = Path(tempfile.mkdtemp(dir=_build.BUILD))
    try:
        src = work / "head.bin"
        src.write_bytes(head)
        want = {"zip": ZIP.write_zip({"head.bin": head}, device=dev),
                "tar": TAR.write_tar({"head.bin": head}),
                "gz": DF.gzip_compress(head, device=dev),
                "bz2": BZ.compress(head, level=5, device=dev)}
        for ext, made in want.items():
            arc = str(work / f"head.{ext}")
            verbs = [["a", arc, str(src)], ["t", arc], ["x", arc, f"-o{work / ext}"]]
            if ext in ("zip", "tar"):
                verbs.append(["l", arc])
            for args in verbs:
                t = time.time()
                rc, said = cli_run(args, dev)
                log(f"cli {args[0]} head.{ext}: exit {rc} in {time.time() - t:.1f} s: "
                    f"{said.strip().splitlines()[-1]!r}")
                if rc != 0:
                    raise AssertionError(f"the CLI's {args[0]} of head.{ext} exited {rc}")
            if Path(arc).read_bytes() != made:
                raise AssertionError(f"the CLI's head.{ext} differs from the API's")
            if (work / ext / ("head.bin" if ext in ("zip", "tar") else "head")).read_bytes() \
                    != head:
                raise AssertionError(f"the CLI's head.{ext} does not extract to its input")
        log("the CLI's .zip, .tar, .gz and .bz2 equal the API's and extract to their input")
    finally:
        shutil.rmtree(work)
    return out


def first_block(frame_bytes):
    """The first block's payload of an LZ4-style frame (LZ5, Lizard) with
    content size: magic, FLG, BD, 8-byte size, header checksum, then the
    block's u32 header."""
    size = int.from_bytes(frame_bytes[15:19], "little") & 0x7FFFFFFF
    return frame_bytes[19:19 + size]


def brotli_lz_phase(corpus, dev, S, M, card_label):
    """Phase 12, Brotli, LZ5, Lizard, .Z and lzip: (a) `sort_rows` at this
    slice's shapes against its plain version, timed; (b) Brotli's brotli-mt
    container of the corpus at quality 5 on the card by span, decoded by
    the port's decoder, the first 4 MiB's stream equal to its CPU run; (c)
    the corpus's LZ5 frame, round trip, the first block equal to the CPU
    run; (d) Lizard at 25 over the corpus and at 11, 31 and 41 over 4 MiB,
    round trips, the card equal to the CPU on 1 MiB; (e) .Z of 4 MiB on
    the host and lzip of 2 MiB on the card, round trips; (f) a 2 MiB .7z
    of brotli folders, and the CLI's a, t and x of each new type on 2 MiB.
    Returns the numbers for the log and the kernels line."""
    from tpu7z_torch.containers import lzip as LZIP
    from tpu7z_torch.containers.sevenzip import SevenZipReader, write_archive
    from tpu7z_torch.models import brotli as BR
    from tpu7z_torch.models import lizard as LIZ
    from tpu7z_torch.models import lz5 as LZ5
    from tpu7z_torch.models import z_lzw as Z
    from tpu7z_torch.models.lizard import codec as LIZC
    from tpu7z_torch.ops import _build
    from tpu7z_torch.ops import hash_chain as HC

    mib = 1 << 20
    n = len(corpus)
    out = {"sort": {}}

    # (a) sort_rows at the new shapes: Brotli's last segment (4 MiB behind
    # 16 MiB of history, one row of hashes at hashlog 16), LZ5's eight
    # 4 MiB blocks and Lizard's 256 chunks of 128 KiB, each keyed
    # h << 15 with a position payload, as the matcher sorts them
    s_all = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).to(dev)
    for name, row, time_it in (("brotli_segment", s_all[n - 20 * mib:][None], True),
                               ("lz5_rows", s_all.view(8, -1), True),
                               ("lizard_rows", s_all.view(-1, LIZC.BLOCK_SIZE), True)):
        h = HC.hashes(HC.u32_at(row), 16)
        key, bb = M.hash_key(h, 16)
        pos = torch.arange(h.shape[1], dtype=torch.int32, device=dev).expand(h.shape).contiguous()
        out["sort"][name] = sort_shape(S, key, (pos,), bb, f"{name}", card_label, time_it)
        del h, key, pos
    del s_all
    out["max_abs_err"] = max(v["max_abs_err"] for v in out["sort"].values())

    # (b) Brotli: the corpus in the brotli-mt container at quality 5
    S.reset_launches()
    t = time.perf_counter()
    br, spans = spans_of(lambda: BR.compress_mt_container(corpus, 5, device=dev))
    t_br = time.perf_counter() - t
    launches = S.LAUNCHES["sort_rows"]
    if launches == 0:
        raise AssertionError("brotli compress_mt_container(corpus) never launched sort_rows")
    back, t_unbr = best(lambda: BR.decompress_mt_container(br), 1)
    if back != corpus:
        raise AssertionError("the port's brotli decoder does not read the corpus's stream back")
    head4 = corpus[:4 * mib]
    if BR.compress(head4, 5, device=dev) != BR.compress(head4, 5, device="cpu"):
        raise AssertionError("brotli.compress(first 4 MiB) on the card differs from its CPU run")
    log(f"brotli compress_mt_container(corpus, quality 5) on the card ({card_label}): "
        f"{len(br)} bytes, ratio {n / len(br):.6f}, {t_br:.3f} s host clock with tracing "
        f"({n / 1e6 / t_br:.2f} MB/s), {launches} sort_rows launches; spans (s) "
        f"{ {k: round(v, 4) for k, v in sorted(spans.items())} }; decoded by the port in "
        f"{t_unbr:.3f} s ({n / 1e6 / t_unbr:.2f} MB/s): equal; the first 4 MiB's stream on the "
        f"card equals its CPU run")
    out["brotli"] = {"launches": launches, "seconds": t_br, "spans_s": spans,
                     "decode_s": t_unbr, "ratio": n / len(br)}
    del br, back

    # (c) LZ5: the corpus's frame, eight 4 MiB blocks, one row sort
    S.reset_launches()
    t = time.perf_counter()
    l5, l5_spans = spans_of(lambda: LZ5.compress_frame(corpus, device=dev))
    t_l5 = time.perf_counter() - t
    l5_launches = S.LAUNCHES["sort_rows"]
    if l5_launches != 1:
        raise AssertionError(f"lz5 compress_frame(corpus): {l5_launches} row sorts, expected 1")
    back, t_unl5 = best(lambda: LZ5.decompress(l5), 1)
    if back != corpus:
        raise AssertionError("the port's LZ5 decoder does not read the corpus's frame back")
    cpu4 = LZ5.compress_frame(head4, device="cpu")
    if LZ5.compress_frame(head4, device=dev) != cpu4 or first_block(l5) != first_block(cpu4):
        raise AssertionError("LZ5's first 4 MiB block on the card differs from its CPU run")
    log(f"lz5 compress_frame(corpus) on the card: {len(l5)} bytes, ratio {n / len(l5):.6f}, "
        f"{t_l5:.3f} s with tracing ({n / 1e6 / t_l5:.2f} MB/s), {l5_launches} sort_rows "
        f"launch; spans (s) { {k: round(v, 4) for k, v in sorted(l5_spans.items())} }; decoded "
        f"in {t_unl5:.3f} s: equal; its first block equals the CPU run's")
    out["lz5"] = {"launches": l5_launches, "seconds": t_l5, "spans_s": l5_spans,
                  "decode_s": t_unl5, "ratio": n / len(l5)}
    del l5, back

    # (d) Lizard at 25 (the CLI's default) over the corpus, 11, 31 and 41
    # over 4 MiB; the card against the CPU on 1 MiB at each level
    out["lizard"] = {}
    for level, data in ((25, corpus), (11, head4), (31, head4), (41, head4)):
        S.reset_launches()
        t = time.perf_counter()
        lz, lz_spans = spans_of(lambda: LIZ.compress_frame(data, level=level, device=dev))
        t_lz = time.perf_counter() - t
        lz_launches = S.LAUNCHES["sort_rows"]
        if lz_launches != 1:
            raise AssertionError(f"lizard at {level}: {lz_launches} row sorts, expected 1")
        back, t_unlz = best(lambda: LIZ.decompress(lz), 1)
        if back != data:
            raise AssertionError(f"the port's lizard decoder does not read level {level} back")
        one = corpus[:mib]
        if LIZ.compress_frame(one, level=level, device=dev) != \
                LIZ.compress_frame(one, level=level, device="cpu"):
            raise AssertionError(f"lizard at {level} on the card differs from its CPU run")
        log(f"lizard compress_frame({len(data) // mib} MiB, level {level}) on the card: "
            f"{len(lz)} bytes, ratio {len(data) / len(lz):.6f}, {t_lz:.3f} s with tracing, "
            f"{lz_launches} sort_rows launch; spans (s) "
            f"{ {k: round(v, 4) for k, v in sorted(lz_spans.items())} }; decoded in "
            f"{t_unlz:.3f} s: equal; 1 MiB on the card equals the CPU run")
        out["lizard"][level] = {"launches": lz_launches, "seconds": t_lz, "spans_s": lz_spans,
                                "decode_s": t_unlz, "ratio": len(data) / len(lz),
                                "mib": len(data) // mib}
        del lz, back

    # (e) .Z of 4 MiB on the host, lzip of 2 MiB (its parse on the card)
    zz, t_z = best(lambda: Z.compress(head4, 16), 1)
    back, t_unz = best(lambda: Z.decompress(zz), 1)
    if back != head4:
        raise AssertionError("the port's .Z decoder does not read the 4 MiB stream back")
    head = corpus[:2 * mib]
    S.reset_launches()
    lz_, lzip_spans = spans_of(lambda: LZIP.compress(head, device=dev))
    lzip_launches = S.LAUNCHES["sort_rows"]
    back, t_unlzip = best(lambda: LZIP.decompress(lz_), 1)
    if back != head or lzip_launches != 1:
        raise AssertionError(f"lzip of 2 MiB: launches {lzip_launches}, round trip "
                             f"{back == head}")
    log(f".Z of 4 MiB (maxbits 16, host): {len(zz)} bytes, ratio {len(head4) / len(zz):.6f}, "
        f"{t_z:.3f} s, decoded in {t_unz:.3f} s: equal; lzip of 2 MiB on the card: {len(lz_)} "
        f"bytes, ratio {len(head) / len(lz_):.6f}, {lzip_launches} sort_rows launch, spans (s) "
        f"{ {k: round(v, 4) for k, v in sorted(lzip_spans.items())} }, decoded in "
        f"{t_unlzip:.3f} s: equal")
    out["z"] = {"seconds": t_z, "decode_s": t_unz, "ratio": len(head4) / len(zz)}
    out["lzip"] = {"launches": lzip_launches, "spans_s": lzip_spans, "decode_s": t_unlzip,
                   "ratio": len(head) / len(lz_)}

    # (f) a 2 MiB .7z of brotli folders, solid and not, and the CLI
    files2 = {"a.bin": corpus[:mib], "b.bin": corpus[mib:2 * mib]}
    for solid in (True, False):
        t = time.perf_counter()
        arc = write_archive(files2, method="brotli", level=5, solid=solid, device=dev)
        t_w = time.perf_counter() - t
        rd, t_r = best(lambda: SevenZipReader(arc, device=dev).extract_all(), 1)
        if rd != files2:
            raise AssertionError("the brotli .7z does not read back")
        log(f"brotli .7z of 2 MiB ({'solid' if solid else 'two folders'}) on the card: "
            f"{len(arc)} bytes, written {t_w:.3f} s, read {t_r:.3f} s: equal")
    work = Path(tempfile.mkdtemp(dir=_build.BUILD))
    try:
        src = work / "head.bin"
        src.write_bytes(head)
        want = {"br": BR.compress_mt_container(head, 5, device=dev),
                "lz5": LZ5.compress_frame(head, device=dev),
                "liz": LIZ.compress_frame(head, level=25, device=dev),
                "Z": Z.compress(head, 9), "lz": LZIP.compress(head, device=dev)}
        for ext, made in want.items():
            arc = str(work / f"head.{ext}")
            for args in (["a", arc, str(src)], ["t", arc], ["x", arc, f"-o{work / ext}"]):
                t = time.time()
                rc, said = cli_run(args, dev)
                log(f"cli {args[0]} head.{ext}: exit {rc} in {time.time() - t:.1f} s: "
                    f"{said.strip().splitlines()[-1]!r}")
                if rc != 0:
                    raise AssertionError(f"the CLI's {args[0]} of head.{ext} exited {rc}")
            if Path(arc).read_bytes() != made:
                raise AssertionError(f"the CLI's head.{ext} differs from the API's")
            got = next((work / ext).iterdir()).read_bytes()
            if got != head:
                raise AssertionError(f"the CLI's head.{ext} does not extract to its input")
        log("the CLI's .br, .lz5, .liz, .Z and .lz equal the API's and extract to their input")
    finally:
        shutil.rmtree(work)
    return out


# lengths at which BLAKE3 on the card is held against its plain version:
# the empty input, short and full blocks, one chunk and its edges, odd
# chunk counts, and a long input whose last chunk is short
BLAKE3_LENGTHS = (0, 1, 64, 1023, 1024, 1025, 2048, 3073, 65535, 65537, (1 << 20) + 7)
# XXH3-64 and XXH3-128 of the empty input (seed 0, the default secret)
XXH3_EMPTY = (0x2D06800538D394C2, 0x99AA06D3014798D86001C324468D497F)
PPMD_CODER = b"\x23\x03\x04\x01\x05"   # a .7z coder record: ID 03 04 01, 5 props bytes


def ppmd_hash_phase(corpus, dev, S, card_label):
    """Phase 13, PPMd, the hashers and the verbs: (a) the first 1 MiB of
    the corpus as a .7z PPMd folder and as a .zip method-98 entry, each
    written and read back equal (host clock), and the CLI's `a -t7z
    -m0=ppmd`, `t` and `x` on 256 KiB; (b) BLAKE3 on the card against its
    plain version at BLAKE3_LENGTHS, the corpus on the card against the
    same tensor code on the CPU, and the card's time for the corpus (CUDA
    events, median of 5); (c) the native XXH3 over the corpus and the
    empty input's digests; (d) `h` and `t -scrc=*` of 1 MiB of text, and
    `b -md1m`, on the card, its row sorts counted. Returns the numbers
    for the log and the kernels line."""
    import hashlib
    import zlib

    from tpu7z_torch.containers import zip as ZIP
    from tpu7z_torch.containers.sevenzip import SevenZipReader, write_archive
    from tpu7z_torch.ops import _build
    from tpu7z_torch.ops import hashers as H

    mib = 1 << 20
    head = corpus[:mib]
    text = corpus[TEXT:TEXT + mib]
    out = {}

    # (a) PPMd: var.H in a .7z folder, var.I in a .zip entry, on the host
    for kind, write, read in (
            ("7z", lambda f: write_archive(f, method="ppmd", device=dev),
             lambda a: SevenZipReader(a, device=dev).extract_all()),
            ("zip", lambda f: ZIP.write_zip(f, method=ZIP.M_PPMD, device=dev),
             lambda a: ZIP.read_zip(a, device=dev))):
        t = time.perf_counter()
        arc = write({"head.bin": head})
        t_w = time.perf_counter() - t
        t = time.perf_counter()
        back = read(arc)
        t_r = time.perf_counter() - t
        ppmd = PPMD_CODER in arc if kind == "7z" else arc[8:10] == b"\x62\x00"
        equal = back == {"head.bin": head}
        if not (equal and ppmd):
            raise AssertionError(f"the PPMd {kind} of 1 MiB: read back equal {equal}, a PPMd "
                                 f"{'folder' if kind == '7z' else 'entry'} {ppmd}")
        log(f"PPMd .{kind} of 1 MiB (host): {len(arc)} bytes, ratio {mib / len(arc):.6f}, written "
            f"in {t_w:.3f} s ({mib / t_w / 1e6:.3f} MB/s), read in {t_r:.3f} s "
            f"({mib / t_r / 1e6:.3f} MB/s): equal")
        out[f"ppmd_{kind}"] = {"bytes": len(arc), "write_s": t_w, "read_s": t_r}
    work = Path(tempfile.mkdtemp(dir=_build.BUILD))
    try:
        src = work / "q.bin"
        src.write_bytes(corpus[TEXT:TEXT + (256 << 10)])
        arc = work / "q.7z"
        for args in (["a", "-t7z", "-m0=ppmd", str(arc), str(src)], ["t", str(arc)],
                     ["x", str(arc), f"-o{work / 'out'}"]):
            t = time.time()
            rc, said = cli_run(args, dev)
            log(f"cli {args[0]} q.7z (PPMd): exit {rc} in {time.time() - t:.1f} s: "
                f"{said.strip().splitlines()[-1]!r}")
            if rc != 0:
                raise AssertionError(f"the CLI's {args[0]} of the PPMd .7z exited {rc}")
        if arc.read_bytes() != write_archive({"q.bin": src.read_bytes()}, method="ppmd",
                                             device=dev):
            raise AssertionError("the CLI's PPMd .7z differs from the API's")
        if (work / "out" / "q.bin").read_bytes() != src.read_bytes():
            raise AssertionError("the CLI's PPMd .7z does not extract to its input")
        log("the CLI's PPMd .7z of 256 KiB equals the API's and extracts to its input")

        # (b) BLAKE3 on the card: exact against the plain version and the CPU
        for n in BLAKE3_LENGTHS:
            piece = corpus[TEXT:TEXT + n]
            got, want = H.blake3(piece, device=dev), H.blake3_ref(piece)
            if got != want:
                raise AssertionError(f"BLAKE3 on the card differs from its plain version at "
                                     f"{n} bytes")
        t = time.perf_counter()
        on_cpu = H.blake3(corpus, device="cpu")
        t_cpu = time.perf_counter() - t
        if H.blake3(corpus, device=dev) != on_cpu:
            raise AssertionError("BLAKE3 of the corpus on the card differs from its CPU run")
        b3_ms = timed(lambda: H.blake3(corpus, device=dev))
        log(f"BLAKE3 on the card equals its plain version at {len(BLAKE3_LENGTHS)} lengths "
            f"({BLAKE3_LENGTHS[0]}-{BLAKE3_LENGTHS[-1]}) and its CPU run over the corpus "
            f"({t_cpu:.3f} s there); the card over {len(corpus)} bytes {b3_ms:.3f} ms "
            f"(CUDA events, median of 5; {len(corpus) / b3_ms / 1e3:.1f} MB/s; {card_label})")
        out["blake3"] = {"lengths": len(BLAKE3_LENGTHS), "ms": b3_ms, "cpu_s": t_cpu}

        # (c) XXH3 from csrc/xxh3.cpp
        if (H.xxh3_64(b""), H.xxh3_128(b"")) != XXH3_EMPTY:
            raise AssertionError("XXH3 of the empty input is not the public digest")
        xxh = {}
        for name, fn in (("xxh3_64", H.xxh3_64), ("xxh3_128", H.xxh3_128)):
            times = []
            for _ in range(5):
                t = time.perf_counter()
                fn(corpus)
                times.append(time.perf_counter() - t)
            xxh[name] = len(corpus) / statistics.median(times) / 1e9
        log(f"XXH3 of the empty input: the public digests; native over {len(corpus)} bytes "
            f"(host clock, median of 5): XXH3-64 {xxh['xxh3_64']:.2f} GB/s, XXH3-128 "
            f"{xxh['xxh3_128']:.2f} GB/s")
        out["xxh3_gb_s"] = xxh

        # (d) the verbs: h and t -scrc=* of 1 MiB of text, b at 1 MiB
        src = work / "m.bin"
        src.write_bytes(text)
        t = time.time()
        rc, said = cli_run(["h", str(src)], dev)
        t_h = time.time() - t
        digests = dict(line.split() for line in said.splitlines()[1:])
        if rc != 0 or len(digests) != 21 or \
                digests["CRC32"] != f"{zlib.crc32(text):08x}" or \
                digests["SHA256"] != hashlib.sha256(text).hexdigest() or \
                digests["BLAKE3"] != H.blake3_ref(text).hex():
            raise AssertionError(f"`h` of 1 MiB: exit {rc}, {len(digests)} hashers, or a "
                                 f"digest differs from zlib's, hashlib's or the plain BLAKE3")
        zst = work / "m.bin.zst"
        if cli_run(["a", "-tzstd", str(zst), str(src)], dev)[0] != 0:
            raise AssertionError("`a -tzstd` of 1 MiB failed")
        t = time.time()
        rc, said = cli_run(["t", str(zst), "-scrc=*"], dev)
        t_t = time.time() - t
        scrc = dict(line.split(" for data: ") for line in said.splitlines()
                    if " for data: " in line)
        if rc != 0 or scrc != digests:
            raise AssertionError(f"`t -scrc=*` of 1 MiB: exit {rc}, its digests equal `h`'s: "
                                 f"{scrc == digests}")
        log(f"cli h of 1 MiB: 21 hashers in {t_h:.1f} s, CRC32, SHA256 and BLAKE3 as zlib, "
            f"hashlib and the plain version; t -scrc=*: the same 21 digests in {t_t:.1f} s")
        S.reset_launches()
        t = time.time()
        rc, said = cli_run(["b", "-md1m"], dev)
        t_b = time.time() - t
        launches = S.LAUNCHES["sort_rows"]
        rows = [line.split() for line in said.splitlines()]
        codecs = [r for r in rows if len(r) == 6 and r[1].isdigit()]
        hashers = [r for r in rows if len(r) == 2 and r[0] != "hasher"]
        bad = [" ".join(r) for r in rows if "FAILED" in r or "skip:" in r]
        if rc != 0 or len(codecs) != 36 or len(hashers) != 21 or bad or launches == 0:
            raise AssertionError(f"`b -md1m`: exit {rc}, {len(codecs)} codec rows, "
                                 f"{len(hashers)} hasher rows, failures {bad}, {launches} "
                                 f"sort_rows launches")
        log(f"cli b -md1m in {t_b:.1f} s: 36 codec rows and 21 hashers, every round trip "
            f"checked, {launches} sort_rows launches; its lines:")
        for line in said.splitlines():
            log(f"  {line}")
        out["cli"] = {"h_s": t_h, "t_scrc_s": t_t, "b_s": t_b}
        out["b"] = {"sort_rows_launches": launches, "rows": codecs + hashers}
    finally:
        shutil.rmtree(work)
    return out


# --- phase 14: the containers over the port's codecs ---

NTFS_BPS, NTFS_SPC, NTFS_REC = 512, 8, 1024
NTFS_CB = NTFS_BPS * NTFS_SPC


def ntfs_volume(resident: bytes, packed: bytes) -> bytes:
    """An NTFS volume as tests/test_ntfs.py builds one (4 KiB clusters, 1 KiB
    records, the MFT at cluster 2): `resident` as a resident $DATA and
    `packed` as an LZNT1-compressed $DATA in 64 KiB units, each unit's
    stream followed by a sparse run, as NTFS stores them."""
    import struct

    from tpu7z_torch.containers import ntfs as NT

    def record(attrs, flags=1):
        rec = bytearray(0x38)
        rec[0:4] = b"FILE"
        struct.pack_into("<HH", rec, 20, 0x38, flags)
        rec = bytearray((bytes(rec) + b"".join(attrs) + b"\xff\xff\xff\xff\0\0\0\0")
                        .ljust(NTFS_REC, b"\0"))
        count = 1 + NTFS_REC // NTFS_BPS
        struct.pack_into("<HH", rec, 4, 0x30, count)
        rec[0x30:0x32] = b"\x99\x99"
        for k in range(1, count):
            end = k * NTFS_BPS - 2
            rec[0x30 + 2 * k:0x32 + 2 * k] = rec[end:end + 2]
            rec[end:end + 2] = b"\x99\x99"
        return bytes(rec)

    def resident_attr(atype, value):
        a = bytearray((24 + len(value) + 7) & ~7)
        struct.pack_into("<II", a, 0, atype, len(a))
        struct.pack_into("<IH", a, 16, len(value), 24)
        a[24:24 + len(value)] = value
        return bytes(a)

    def nonresident_attr(atype, runs, vcns, real, unit_log=0):
        a = bytearray((0x40 + len(runs) + 7) & ~7)
        struct.pack_into("<II", a, 0, atype, len(a))
        a[8] = 1
        struct.pack_into("<H", a, 12, 1 if unit_log else 0)      # compressed
        struct.pack_into("<QQHH", a, 16, 0, vcns - 1, 0x40, unit_log)
        struct.pack_into("<QQQ", a, 40, vcns * NTFS_CB, real, real)
        a[0x40:0x40 + len(runs)] = runs
        return bytes(a)

    def name(parent, text):
        enc = text.encode("utf-16-le")
        return struct.pack("<Q", parent) + bytes(56) + bytes([len(text), 1]) + enc

    unit = 16 * NTFS_CB
    data_lcn = 4
    body, runs, lcn = bytearray(), bytearray(), 0
    for u in range(0, len(packed), unit):
        chunk = NT.lznt1_compress(packed[u:u + unit].ljust(unit, b"\0"))
        nc = -(-len(chunk) // NTFS_CB)
        if nc >= 16:
            raise AssertionError("ntfs: a compression unit does not shrink")
        at = data_lcn + len(body) // NTFS_CB
        runs += bytes([0x41, nc]) + struct.pack("<i", at - lcn) + bytes([0x01, 16 - nc])
        lcn = at
        body += chunk.ljust(nc * NTFS_CB, b"\0")
    runs += b"\0"
    files = [record([resident_attr(0x30, name(5, "$Meta"))]) for _ in range(4)]
    files += [record([resident_attr(0x30, name(5, "."))], flags=3),
              record([resident_attr(0x30, name(5, "hello.txt")), resident_attr(0x80, resident)]),
              record([resident_attr(0x30, name(5, "packed.bin")),
                      nonresident_attr(0x80, bytes(runs), len(packed) // NTFS_CB, len(packed),
                                       unit_log=4)])]
    mft_runs = bytes([0x11, 2, 2, 0])
    mft = record([resident_attr(0x30, name(5, "$MFT")),
                  nonresident_attr(0x80, mft_runs, 2, 8 * NTFS_REC)]) + b"".join(files)
    img = bytearray(data_lcn * NTFS_CB) + body
    img[3:11] = b"NTFS    "
    struct.pack_into("<HB", img, 11, NTFS_BPS, NTFS_SPC)
    struct.pack_into("<QQ", img, 40, len(img) // NTFS_BPS, 2)   # sectors, the MFT's cluster
    struct.pack_into("<b", img, 64, -10)                         # 2**10-byte records
    img[510:512] = b"\x55\xaa"
    img[2 * NTFS_CB:2 * NTFS_CB + len(mft)] = mft
    return bytes(img)


def nsis_installer(header: bytes, blocks, solid: bool, dev) -> bytes:
    """An NSIS installer as tests/test_nsis.py builds one, behind an MZ
    stub: a solid LZMA stream (the fast parse on the card, an end marker)
    or non-solid deflate blocks (the parse on the card)."""
    import struct

    from tpu7z_torch.models import deflate as DF
    from tpu7z_torch.models.lzma.encoder import compress_raw

    if solid:
        blob = b"".join(struct.pack("<I", len(b)) + b for b in (header, *blocks))
        stream, props = compress_raw(blob, end_marker=True, device=dev)
        body, stub = props + stream, 1024
    else:
        body = b"".join(struct.pack("<I", len(c) | 0x80000000) + c
                        for c in (DF.compress(b, device=dev) for b in (header, *blocks)))
        stub = 512
    first = (struct.pack("<I", 0) + b"\xef\xbe\xad\xdeNullsoftInst"
             + struct.pack("<II", len(header), 28 + len(body)))
    return b"MZ" + bytes(stub - 2) + first + body


def rpm_package(payload: bytes, compressor: bytes) -> bytes:
    """An rpm as tests/test_unix_archives.py:39 `_make_rpm` builds one, with
    the payload's compressor named."""
    import struct

    def header(entries):
        idx, store = b"", b""
        for tag, typ, data, count in entries:
            idx += struct.pack(">IIII", tag, typ, len(store), count)
            store += data
        return struct.pack(">IIII", 0x8EADE801, 0, len(entries), len(store)) + idx + store

    lead = (struct.pack(">IBBHH", 0xEDABEEDB, 3, 0, 0, 1) + b"t-1.0\x00".ljust(66, b"\x00")
            + struct.pack(">HH", 1, 5) + bytes(16))
    out = bytearray(lead) + header([(1000, 4, struct.pack(">I", 0), 1)])
    out += bytes((-len(out)) % 8)
    out += header([(1125, 6, compressor + b"\x00", 1), (1124, 6, b"cpio\x00", 1)])
    return bytes(out) + payload


def xar_bzip2(name: str, data: bytes) -> bytes:
    """A xar of one bzip2 entry, in write_xar's layout."""
    import bz2
    import struct
    import zlib

    packed = bz2.compress(data, 9)
    toc = ('<?xml version="1.0" encoding="UTF-8"?><xar><toc><file id="1"><name>'
           f"{name}</name><type>file</type><data><offset>0</offset><length>{len(packed)}"
           f"</length><size>{len(data)}</size>"
           '<encoding style="application/x-bzip2"/></data></file></toc></xar>').encode()
    ztoc = zlib.compress(toc, 9)
    return b"xar!" + struct.pack(">HHQQI", 28, 1, len(ztoc), len(toc), 0) + ztoc + packed


def containers_phase(corpus, dev, S, card_label):
    """Phase 14, the containers over the port's codecs: (a) squashfs of the
    corpus as eight 4 MiB files with zstd, LZ4 and zlib blocks; (b) .wim,
    .iso, UDF and FAT16 of the eight files, and the FAT image in a .vhd;
    (c) cpio and ar of them; (d) an .rpm of their cpio as a gzip payload,
    and of the first 4 MiB's as a bzip2 payload decoded on the card; (e) a
    xar of zlib entries, and one of a bzip2 entry of the first 4 MiB
    decoded on the card; each bzip2 payload held against its CPU run; (f)
    the reader-only types at the tests' shapes: NSIS (solid LZMA,
    non-solid deflate), NTFS with a 1 MiB LZNT1 $DATA, HFS+, APFS, DMG and
    ext (mke2fs -d, where the machine has it); (g) the CLI's a, l, t and x
    of each type its `a` writes, over 2 MiB. Every write and read prints
    its seconds (host clock), bytes and sort_rows launches. Returns the
    numbers for the log and the kernels line."""
    import bz2
    import zlib

    from tpu7z_torch.containers import (apfs, ar, cpio, disk, dmg, ext, fat, hfs, iso, nsis,
                                        ntfs, rpm, squashfs, udf, wim, xar)
    from tpu7z_torch.models import bzip2 as BZ
    from tpu7z_torch.ops import _build

    mib = 1 << 20
    files = {f"part{i}.bin": corpus[i * 4 * mib:(i + 1) * 4 * mib] for i in range(8)}
    out = {"rows": []}

    def step(what, fn, want=None, check=None):
        """Run fn once on the host clock, its sort_rows launches counted;
        check its result; log and keep seconds, bytes and launches."""
        S.reset_launches()
        t = time.perf_counter()
        got = fn()
        seconds = time.perf_counter() - t
        launches = S.LAUNCHES["sort_rows"]
        if want is not None and got != want:
            raise AssertionError(f"{what}: the result differs from what was written")
        if check is not None and not check(got):
            raise AssertionError(f"{what}: the result fails its check")
        size = len(got) if isinstance(got, (bytes, bytearray)) else \
            sum(len(v) for v in got.values())
        log(f"{what}: {seconds:.3f} s (host clock), {size} bytes, {launches} sort_rows "
            f"launches ({card_label})")
        out["rows"].append({"what": what, "seconds": seconds, "bytes": size,
                            "sort_rows_launches": launches})
        return got

    # (a) squashfs, the writer's three block codecs
    for method, label in ((squashfs.M_ZSTD, "zstd"), (squashfs.M_LZ4, "lz4"),
                          (squashfs.M_ZLIB, "zlib")):
        img = step(f"squashfs write, {label} blocks, 8 x 4 MiB",
                   lambda: squashfs.write_squashfs(files, method=method))
        step(f"squashfs read, {label} blocks", lambda: squashfs.read_squashfs(img), files)
    # (b) .wim, .iso, UDF and FAT16, and the FAT image in a .vhd
    upper = {k.upper(): v for k, v in files.items()}
    for label, write, read, want in (("wim", wim.write_wim, wim.read_wim, files),
                                     ("iso", iso.write_iso, iso.read_iso, upper),
                                     ("udf", udf.write_udf, udf.read_udf, files),
                                     ("fat16", fat.write_fat16, fat.read_fat, upper)):
        img = step(f"{label} write, 8 x 4 MiB", lambda: write(files))
        step(f"{label} read", lambda: read(img), want)
    vhd = step("vhd write of the FAT16 image", lambda: disk.write_vhd_fixed(img))
    step("vhd read, then its FAT16", lambda: fat.read_fat(disk.read_vhd(vhd)["disk.img"]), upper)
    # (c) cpio and ar
    for label, write, read in (("cpio", cpio.write_cpio, cpio.read_cpio),
                               ("ar", ar.write_ar, ar.read_ar)):
        img = step(f"{label} write, 8 x 4 MiB", lambda: write(files))
        step(f"{label} read", lambda: read(img), files)
    # (d) .rpm: the eight files' cpio as a gzip payload; the first 4 MiB's
    # as a bzip2 payload, decoded on the card and on the CPU
    inner = {"./" + k: v for k, v in files.items()}
    gz = zlib.compressobj(6, zlib.DEFLATED, 31)
    pkg = rpm_package(gz.compress(cpio.write_cpio(inner)) + gz.flush(), b"gzip")
    step(f"rpm read, gzip payload of 8 x 4 MiB ({len(pkg)} bytes)",
         lambda: rpm.read_rpm(pkg, device=dev), files)
    first = {"part0.bin": files["part0.bin"]}
    pkg = rpm_package(bz2.compress(cpio.write_cpio({"./part0.bin": files["part0.bin"]}), 9),
                      b"bzip2")
    on_card = step(f"rpm read, bzip2 payload of 4 MiB ({len(pkg)} bytes), on the card",
                   lambda: rpm.read_rpm(pkg, device=dev), first)
    out["rpm_bzip2_launches"] = out["rows"][-1]["sort_rows_launches"]
    step("rpm read, the same bzip2 payload, on the CPU", lambda: rpm.read_rpm(pkg, device="cpu"),
         on_card)
    # (e) xar: zlib entries over the eight files; one bzip2 entry
    img = step("xar write, zlib entries, 8 x 4 MiB", lambda: xar.write_xar(files))
    step("xar read", lambda: xar.read_xar(img, device=dev), files)
    img = xar_bzip2("part0.bin", files["part0.bin"])
    on_card = step(f"xar read, one bzip2 entry of 4 MiB ({len(img)} bytes), on the card",
                   lambda: xar.read_xar(img, device=dev), first)
    out["xar_bzip2_launches"] = out["rows"][-1]["sort_rows_launches"]
    step("xar read, the same entry, on the CPU", lambda: xar.read_xar(img, device="cpu"), on_card)
    for key in ("rpm_bzip2_launches", "xar_bzip2_launches"):
        if out[key] == 0:
            raise AssertionError(f"{key}: the bzip2 payload's decode launched no sort_rows")
    # (f) the reader-only types at the tests' shapes
    text = corpus[TEXT:TEXT + 3 * mib]
    header, blocks = text[:720], [text[720:1670], text[2000:3000]]
    for solid in (True, False):
        exe = nsis_installer(header, blocks, solid, dev)
        got = step(f"nsis read, {'solid LZMA' if solid else 'non-solid deflate'} "
                   f"({len(exe)} bytes)", lambda: nsis.read_nsis(exe))
        if [got["[NSIS].nsi-header"], got["data_0000.bin"], got["data_0001.bin"]] != \
                [header, *blocks]:
            raise AssertionError("nsis: the installer's blocks differ from what was written")
    # LZNT1 in Python: 1 MiB of a 29-byte period (its greedy matcher scans
    # every distance of each 4 KiB chunk; text at this size takes minutes)
    period = (b"ntfs compressed payload line\n" * (mib // 29 + 1))[:mib]
    vol = step("ntfs volume with a 1 MiB LZNT1 $DATA, built (lznt1_compress)",
               lambda: ntfs_volume(text[:300], period))
    step("ntfs read", lambda: ntfs.read_ntfs(vol), {"hello.txt": text[:300], "packed.bin": period})
    small = {"readme.txt": text[:8500], "empty.bin": b"", "rand.dat": corpus[-30000:]}
    img = step("hfs+ write", lambda: hfs.write_hfs(small))
    step("hfs+ read", lambda: hfs.read_hfs(img), small)
    img = step("apfs write", lambda: apfs.write_apfs(small))
    step("apfs read", lambda: apfs.read_apfs(img), small)
    parts = {"Apple_HFS": text[:200000], "rand": corpus[-90000:]}
    img = step("dmg write", lambda: dmg.write_dmg(parts))
    step("dmg read", lambda: dmg.read_dmg(img),
         check=lambda g: all(g[k][:len(v)] == v for k, v in parts.items()))
    mke2fs = shutil.which("mke2fs") or "/usr/sbin/mke2fs"
    work = Path(tempfile.mkdtemp(dir=_build.BUILD))
    try:
        if os.path.exists(mke2fs):
            tree = {"a.txt": text[:10000], "d1/d2/deep.bin": corpus[-50000:],
                    "sparse": bytes(80000)}
            for rel, data in tree.items():
                (work / "tree" / rel).parent.mkdir(parents=True, exist_ok=True)
                (work / "tree" / rel).write_bytes(data)
            subprocess.run([mke2fs, "-q", "-t", "ext4", "-b", "4096", "-d", str(work / "tree"),
                            "-N", "64", str(work / "img.ext4"), "512"], check=True,
                           capture_output=True)
            img = (work / "img.ext4").read_bytes()
            step(f"ext4 read (mke2fs -d, {len(img)} bytes)", lambda: ext.read_ext(img),
                 check=lambda g: {k: v for k, v in g.items() if not k.endswith("/")} == tree)
        else:
            log("ext: no mke2fs on this machine; the ext image is not built or read here")
        # (g) the CLI's a, l, t and x of each type `a` writes, over 2 MiB
        head = corpus[:2 * mib]
        src = work / "head.bin"
        src.write_bytes(head)
        for atype, ext_ in (("wim", "wim"), ("udf", "udf"), ("fat", "fat"), ("vhd", "vhd"),
                            ("ihex", "hex"), ("arj", "arj")):
            arc = str(work / f"head.{ext_}")
            dest = work / f"out_{atype}"
            for args in (["a", f"-t{atype}", arc, str(src)], ["l", arc], ["t", arc],
                         ["x", arc, f"-o{dest}"]):
                S.reset_launches()
                t = time.time()
                rc, said = cli_run(args, dev)
                log(f"cli {args[0]} head.{ext_}: exit {rc} in {time.time() - t:.3f} s, "
                    f"{S.LAUNCHES['sort_rows']} sort_rows launches: "
                    f"{said.strip().splitlines()[-1]!r}")
                if rc != 0:
                    raise AssertionError(f"the CLI's {args[0]} of head.{ext_} exited {rc}")
            back = [p.read_bytes() for p in dest.iterdir()]
            if len(back) != 1 or back[0][:len(head)] != head:
                raise AssertionError(f"the CLI's head.{ext_} does not extract to its input")
        log("the CLI's a, l, t and x of a .wim, .udf, .fat, .vhd, .hex and .arj of 2 MiB "
            "extract to their input")
    finally:
        shutil.rmtree(work)
    return out


# --- phase 15: the containers with their own codecs, and the rest of the CLI ---

def cfdata(cabinet: bytes):
    """[(payload, uncompressed size)] of a one-folder cabinet's CFDATA."""
    import struct

    coff, count = struct.unpack_from("<IH", cabinet, 36)
    out = []
    for _ in range(count):
        cb, cu = struct.unpack_from("<HH", cabinet, coff + 4)
        out.append((cabinet[coff + 8:coff + 8 + cb], cu))
        coff += 8 + cb
    return out


def codecs_cli_phase(corpus, dev, S, card_label, time_sort=True):
    """Phase 15, the containers with their own codecs and the rest of the
    CLI: (a) `sort_rows` at MSZIP's rows against its plain version, timed;
    the corpus as eight 4 MiB files in an MSZIP cabinet on the card (one
    row sort), every CFDATA inflated by zlib with the previous 32 KiB as
    its dictionary, the first 128 equal to the CPU run's cabinet of the
    first 4 MiB, which `read_cab` reads back; (b) round trips through the
    port's readers: an LZX cabinet and a CHM of 256 KiB, an lh5 .lzh of
    1 MiB, a RAR5 of 4 MiB; (c) the CLI: `a -tcab`, `a -trar`, `a -trar
    -m0=copy` of 512 KiB with `x`, `l` and `t` of each; `x -mmt1`
    streaming the corpus's .lz4, .zst, .gz, .bz2 and .xz; `a -v8m` of the
    corpus and `x` of its `.001`; `a -i!*.txt` and `x -x!*.log -bb`. Every
    step prints its seconds (host clock), bytes and sort_rows launches.
    Returns the numbers for the log and the kernels line."""
    import bz2
    import contextlib
    import io
    import lzma
    import zlib

    from tpu7z_torch.containers import cab, chm, lzh, rar
    from tpu7z_torch.models.deflate import codec as DFC
    from tpu7z_torch.models.lz4 import frame as LZ4F
    from tpu7z_torch.models.zstd import frame as ZF
    from tpu7z_torch.ops import _build
    from tpu7z_torch.ops import hash_chain as HC
    from tpu7z_torch.ops import match as M

    mib = 1 << 20
    files = {f"part{i}.bin": corpus[i * 4 * mib:(i + 1) * 4 * mib]
             for i in range(len(corpus) // (4 * mib))}
    out = {"rows": [], "sort": {}}

    def step(what, fn, want=None, check=None):
        """Run fn once on the host clock, its sort_rows launches counted;
        check its result; log and keep seconds, bytes and launches."""
        S.reset_launches()
        t = time.perf_counter()
        got = fn()
        seconds = time.perf_counter() - t
        launches = S.LAUNCHES["sort_rows"]
        if want is not None and got != want:
            raise AssertionError(f"{what}: the result differs from what was written")
        if check is not None and not check(got):
            raise AssertionError(f"{what}: the result fails its check")
        size = len(got) if isinstance(got, (bytes, bytearray)) else \
            sum(len(v) for v in got.values()) if isinstance(got, dict) else len(got[0])
        log(f"{what}: {seconds:.3f} s (host clock), {size} bytes, {launches} sort_rows "
            f"launches ({card_label})")
        out["rows"].append({"what": what, "seconds": seconds, "bytes": size,
                            "sort_rows_launches": launches})
        return got

    # (a) MSZIP: sort_rows at its rows, then the cabinet of the corpus
    rows = torch.from_numpy(np.frombuffer(corpus, np.uint8).copy()).to(dev).view(
        -1, cab.CFDATA_MAX)
    h = HC.hashes(HC.u32_at(rows), DFC.HASHLOG)
    key, bb = M.hash_key(h, DFC.HASHLOG)
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=dev).expand(h.shape).contiguous()
    out["sort"]["cab_mszip_rows"] = sort_shape(S, key, (pos,), bb, "MSZIP's rows", card_label,
                                               time_sort)
    del rows, h, key, pos
    big, spans = step(f"cab write, MSZIP, {len(files)} x 4 MiB, on the card, traced",
                      lambda: spans_of(lambda: cab.write_cab(files, device=dev)))
    out["cab_mszip_launches"] = out["rows"][-1]["sort_rows_launches"]
    out["cab_mszip_spans_s"] = spans
    log(f"cab write spans (s): { {k: round(v, 4) for k, v in sorted(spans.items())} }")
    if out["cab_mszip_launches"] != 1:
        raise AssertionError(f"cab write: {out['cab_mszip_launches']} row sorts, expected 1")
    blocks = cfdata(big)
    if len(blocks) != len(corpus) // cab.CFDATA_MAX:
        raise AssertionError(f"cab write: {len(blocks)} CFDATA, expected "
                             f"{len(corpus) // cab.CFDATA_MAX}")

    def inflate_all():
        done = bytearray()
        for payload, cu in blocks:
            z = zlib.decompressobj(-15, zdict=bytes(done[-cab.CFDATA_MAX:]))
            piece = z.decompress(payload[2:]) + z.flush()
            if payload[:2] != b"CK" or len(piece) != cu or not z.eof:
                raise AssertionError(f"cab: CFDATA {len(done) // cab.CFDATA_MAX} does not "
                                     f"inflate to its {cu} bytes under zlib")
            done += piece
        return bytes(done)
    step(f"zlib's raw inflate of its {len(blocks)} CFDATA", inflate_all, corpus)
    head = {"part0.bin": files["part0.bin"]}
    small = step("cab write, MSZIP, the first 4 MiB, on the CPU",
                 lambda: cab.write_cab(head, device="cpu"))
    if cfdata(small) != blocks[:len(cfdata(small))]:
        raise AssertionError("cab: the first 128 CFDATA on the card differ from the CPU run's")
    log(f"cab: the card's first {len(cfdata(small))} CFDATA equal the CPU run's, byte for byte")
    step("cab read (the port's host inflate), the first 4 MiB", lambda: cab.read_cab(small), head)
    out["cab_bytes"] = len(big)
    del big, blocks, small

    # (b) round trips through the port's own readers
    sample = {"sample.bin": b"".join(corpus[i * mib:i * mib + 32768] for i in range(8))}
    arc = step("cab write, LZX, 256 KiB (host)", lambda: cab.write_cab(sample, "lzx", device=dev))
    step("cab read, LZX", lambda: cab.read_cab(arc), sample)
    arc = step("chm write, LZX, 256 KiB (host)", lambda: chm.write_chm(sample))
    step("chm read", lambda: chm.read_chm(arc), sample)
    one = {"one.bin": corpus[:mib]}
    arc = step("lzh write, lh5, 1 MiB (host)", lambda: lzh.write_lzh(one))
    step("lzh read", lambda: lzh.read_lzh(arc), one)
    four = {"four.bin": corpus[:4 * mib]}
    arc = step("rar write, RAR5, 4 MiB (host)", lambda: rar.write_rar5(four))
    step("rar read", lambda: rar.read_rar(arc), four)

    # (c) the CLI
    work = Path(tempfile.mkdtemp(dir=_build.BUILD))

    def cli(args, expect=0):
        S.reset_launches()
        err = io.StringIO()
        t = time.perf_counter()
        with contextlib.redirect_stderr(err):
            rc, said = cli_run(args, dev)
        seconds = time.perf_counter() - t
        last = said.strip().splitlines()[-1] if said.strip() else ""
        log(f"cli {' '.join(a.replace(str(work) + '/', '') for a in args)}: exit {rc} in "
            f"{seconds:.3f} s (host clock), {S.LAUNCHES['sort_rows']} sort_rows launches: "
            f"{last!r}")
        out["rows"].append({"what": "cli " + " ".join(args[:2]), "seconds": seconds,
                            "sort_rows_launches": S.LAUNCHES["sort_rows"]})
        if rc != expect:
            raise AssertionError(f"the CLI's {args} exited {rc}: {err.getvalue()[-300:]!r}")
        return said, err.getvalue()

    try:
        part = corpus[:mib // 2]
        src = work / "half.bin"
        src.write_bytes(part)
        for label, extra, name in (("cab", ["-tcab"], "half.cab"), ("rar", ["-trar"], "half.rar"),
                                   ("rar stored", ["-trar", "-m0=copy"], "copy.rar")):
            arc = str(work / name)
            dest = work / f"out_{name}"
            cli(["a", *extra, arc, str(src)])
            said, _ = cli(["l", arc])
            if f"{len(part):>10}  {'-':>8}  half.bin" not in said:
                raise AssertionError(f"the CLI's l of {name} does not list half.bin")
            said, _ = cli(["t", arc])
            if not said.endswith("Everything is Ok\n"):
                raise AssertionError(f"the CLI's t of {name} does not end in Everything is Ok")
            cli(["x", arc, f"-o{dest}"])
            if (dest / "half.bin").read_bytes() != part:
                raise AssertionError(f"the CLI's {name} does not extract to its input")
        if (work / "copy.rar").stat().st_size < len(part):
            raise AssertionError("a -trar -m0=copy: the archive is smaller than its input")
        # x -mmt1 streams each single-stream type of the corpus
        streams = {
            "corpus.lz4": lambda: LZ4F.compress_frame(corpus),
            "corpus.zst": lambda: ZF.compress(corpus, level=3),
            "corpus.gz": lambda: DFC.gzip_compress(corpus, device=dev),
            "corpus.bz2": lambda: bz2.compress(corpus, 9),
            "corpus.xz": lambda: lzma.compress(corpus, preset=1),
        }
        for name, make in streams.items():
            (work / name).write_bytes(step(f"{name} made", make))
            dest = work / "streamed"
            cli(["x", "-mmt1", str(work / name), f"-o{dest}"])
            if (dest / "corpus").read_bytes() != corpus:
                raise AssertionError(f"x -mmt1 of {name} does not stream the corpus back")
            (dest / "corpus").unlink()
            (work / name).unlink()
        # -v8m: volumes of 8 MiB, read back from the .001
        (work / "corpus").write_bytes(corpus)
        said, _ = cli(["a", "-tzstd", "-mx3", "-v8m", str(work / "vol.zst"), str(work / "corpus")])
        nvol = len(list(work.glob("vol.zst.0*")))
        cli(["x", str(work / "vol.zst.001"), f"-o{work / 'vols'}"])
        # tpu7z names the output after the .001 name, no extension stripped
        if (work / "vols" / "vol.zst.001").read_bytes() != corpus:
            raise AssertionError("x of vol.zst.001 does not give the corpus")
        log(f"a -v8m wrote {nvol} volumes; x of the .001 gives the corpus")
        # -i!, -x! and -bb
        sel = work / "sel"
        sel.mkdir()
        for name, off in (("a.txt", 0), ("b.log", 1), ("c.bin", 2), ("d.txt", 3)):
            (sel / name).write_bytes(corpus[off * 256 * 1024:(off + 1) * 256 * 1024])
        cwd = os.getcwd()
        os.chdir(sel)
        try:
            cli(["a", "-ttar", "-i!*.txt", "-i!*.log", "sel.tar", "a.txt", "b.log", "c.bin",
                 "d.txt"])
            said, _ = cli(["l", "sel.tar"])
            if "c.bin" in said or "b.log" not in said:
                raise AssertionError("a -i!*.txt -i!*.log: the archive holds other files")
            _, err = cli(["x", "sel.tar", "-x!*.log", "-bb", "-oout"])
            if sorted(p.name for p in (sel / "out").iterdir()) != ["a.txt", "d.txt"] \
                    or "%" not in err:
                raise AssertionError("x -x!*.log -bb: other files, or no progress on stderr")
        finally:
            os.chdir(cwd)
        log("the CLI's -i!, -x! and -bb select and show as tpu7z's")
    finally:
        shutil.rmtree(work)
    return out


def aes_passes(corpus, key, iv, dev, card_label):
    """The card's decrypt_cbc over more than one pass of CHUNK_BLOCKS
    blocks: the corpus encrypted natively (held to its Python twin in
    (e)) and decrypted on the card, equal to the corpus. Its allocations
    over 16 MiB (one pass) and over 32 MiB (two) differ by the extra
    output alone, since the temporaries are a pass's."""
    from tpu7z_torch.containers.sevenzip import aes7z

    chunk_bytes = aes7z.CHUNK_BLOCKS * 16
    if len(corpus) != 2 * chunk_bytes:
        raise AssertionError(f"the corpus is not two passes of {chunk_bytes} bytes")
    t = time.perf_counter()
    ct = torch.frombuffer(bytearray(aes7z.encrypt_cbc(corpus, key, iv)),
                          dtype=torch.uint8).view(-1, 16).to(dev)
    t_enc = time.perf_counter() - t
    peaks = {}
    for n in (chunk_bytes, 2 * chunk_bytes):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        plain = aes7z.decrypt_cbc(ct[:n // 16], key, iv)
        torch.cuda.synchronize()
        peaks[n] = torch.cuda.max_memory_allocated() - base
        if plain.cpu().numpy().tobytes() != corpus[:n]:
            raise AssertionError(f"decrypt_cbc of {n} bytes on the card does not give the "
                                 f"corpus back")
        del plain
    grew = peaks[2 * chunk_bytes] - peaks[chunk_bytes]
    if grew > chunk_bytes * 3 // 2:
        raise AssertionError(f"decrypt_cbc: 16 MiB more ciphertext took {grew} bytes more "
                             f"of the card's memory; a pass's temporaries should not grow")
    ms = timed(lambda: aes7z.decrypt_cbc(ct, key, iv))
    log(f"AES-256 over two passes ({card_label}): the 32 MiB corpus encrypted natively in "
        f"{t_enc:.3f} s, decrypt_cbc on the card {ms:.3f} ms ({len(corpus) / 1e3 / ms:.1f} "
        f"MB/s, CUDA events, median of 5): equal to the corpus; allocated at its peak "
        f"{peaks[chunk_bytes]} bytes over 16 MiB, {peaks[2 * chunk_bytes]} over 32 MiB")
    return {"decrypt_32MiB_ms": ms, "peak_bytes_16MiB": peaks[chunk_bytes],
            "peak_bytes_32MiB": peaks[2 * chunk_bytes]}


def filter_checks(dev, card_label):
    """The whole-array branch converters, the swaps and delta on the card,
    over 3 MiB and 3 bytes (an unaligned tail) with branch opcodes planted
    and an ip whose addresses wrap past 2^32: each equal to the same
    function on the CPU, exactly. Then an ARM folder and a delta folder,
    built by the writer's own header code, read back by SevenZipReader on
    the card."""
    from tpu7z_torch.containers.sevenzip import SevenZipReader
    from tpu7z_torch.containers.sevenzip import format as F
    from tpu7z_torch.containers.sevenzip import writer as W
    from tpu7z_torch.models.filters import bcj, delta
    from tpu7z_torch.ops.hashing import crc32_native

    rng = np.random.default_rng(0xBC7)
    n = (3 << 20) + 3
    b = rng.integers(0, 256, n, dtype=np.uint8)
    for start, step, byte, share in ((3, 4, 0xEB, 0.2), (0, 4, 0x94, 0.2), (3, 4, 0x94, 0.1),
                                     (0, 4, 0x48, 0.2), (0, 4, 0x40, 0.2), (1, 2, 0xF0, 0.2)):
        lane = b[start::step]
        lane[rng.random(lane.size) < share] = byte
    data = b.tobytes()
    ip = 0xFFF00000
    cases = {}
    for name in ("arm", "arm64", "ppc", "sparc", "armt"):
        enc, dec = bcj.FILTERS[name]
        cases[f"{name}_encode"] = lambda d, f=enc: f(data, ip, device=d)
        cases[f"{name}_decode"] = lambda d, f=dec: f(data, ip, device=d)
    cases["swap2"] = lambda d: bcj.swap2(data, device=d)
    cases["swap4"] = lambda d: bcj.swap4(data, device=d)
    for dist in (1, 4, 256):
        cases[f"delta{dist}_encode"] = lambda d, k=dist: delta.delta_encode(data, k, device=d)
        cases[f"delta{dist}_decode"] = lambda d, k=dist: delta.delta_decode(data, k, device=d)
    times = {}
    for name, fn in cases.items():
        t = time.perf_counter()
        got = fn(dev)
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        if got != fn("cpu") or len(got) != n:
            raise AssertionError(f"filter {name} on the card differs from its CPU run")
        if got == data:
            raise AssertionError(f"filter {name} left the planted input as it was")
    log(f"filters ({card_label}): {len(cases)} converters over {n} bytes at ip {ip:#x} on "
        f"the card equal their CPU runs; host clock with the copies, slowest "
        f"{max(times, key=times.get)} {max(times.values()):.3f} s")

    files = {"arm.bin": data, "delta.bin": data[:1 << 20]}
    packs = [bcj.bcj_arm_encode(data, device=dev),
             delta.delta_encode(files["delta.bin"], 4, device=dev)]
    folders = [{"coders": [(mid, props, 1, 1)], "bind": [], "packed_indices": [0],
                "sizes": [len(files[name])], "crc": crc32_native(files[name])}
               for name, mid, props in (("arm.bin", F.M_ARM, b""),
                                        ("delta.bin", F.M_DELTA, bytes([3])))]
    header = W._build_header(list(files), files, [], folders, packs, [1, 1],
                             [len(v) for v in files.values()],
                             [crc32_native(v) for v in files.values()])
    arc = W._archive_bytes(header, packs)
    t = time.perf_counter()
    back = SevenZipReader(arc, device=dev).extract_all()
    t_read = time.perf_counter() - t
    if back != files:
        raise AssertionError("the ARM and delta folders do not read back on the card")
    log(f"an ARM folder and a delta folder read back on the card in {t_read:.3f} s: equal")
    return {"bytes": n, "ip": ip, "seconds": times, "folders_read_s": t_read}


def sort_inputs(dev, corpus_blocks, corpus_ns, P, M, S):
    """(name, key, payloads, begin_bit) cases for the row sort, all int32
    keys with no payload or one int32 payload: random matcher keys
    (hash16 << 16 | pos) with a payload; fully random unique keys with 0
    and 1 payload; ragged rows; the corpus's tier-B and tier-B4 keys; the
    match finder's keys over the corpus with some rows cut short
    (sentinel tails), at hashlog 16 and 12; the edges of the
    tile-parallel design; rows over 65536 keys with duplicate keys and a
    position payload; the match finder's keys for the corpus as 8 rows of
    4 MiB at hashlog 12, 20 and 31."""
    rng = np.random.default_rng(11)
    B, N = 64, P.BLOCK

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(dev)

    h = rng.integers(0, 1 << 16, (B, N), dtype=np.uint32)
    probe = i32((h << 16) | np.arange(N, dtype=np.uint32))
    pi = i32(rng.integers(0, 1 << 32, (B, N), dtype=np.uint32))
    cases = [("probe_pay", probe, (pi,), 0), ("probe_pay", probe, (pi,), 16)]
    for n in (16384, 65536):
        c = rng.integers(0, 1 << 32, (B, 1), dtype=np.uint64)
        k = (np.arange(n, dtype=np.uint64) * ODD + c) % (1 << 32)
        key = i32(rng.permuted(k, axis=1).astype(np.uint32))
        pay = i32(rng.integers(0, 1 << 32, (B, n), dtype=np.uint32))
        cases += [(f"random_{n}", key, (), 0), (f"random_{n}_pay", key, (pay,), 0)]
    # rows that end inside a tile and inside a warp's step
    for n, bb in ((1000, 0), (12345, 8)):
        key = i32(rng.integers(0, 1 << 32, (3, n), dtype=np.uint32))
        pay = i32(rng.integers(0, 1 << 32, (3, n), dtype=np.uint32))
        cases.append((f"ragged_{n}_pay", key, (pay,), bb))
    words = P.phase0_words(corpus_blocks)
    for name, key in (("tier_b", P.tier_b_key(words)), ("tier_b4", P.tier_b4_key(words))):
        key = S.raw_bits(key)
        cases += [(name, key, (), 16), (name, key, (), 0)]
    # the main path's sort: both tiers' int32 keys as one set of 2B rows
    cases.append(("both_tiers_int32", P.candidate_keys(corpus_blocks).view(-1, P.BLOCK), (), 16))
    short = corpus_ns.clone()
    short[::7] = torch.arange(0, short.shape[0], 7, device=dev, dtype=torch.int32) * 97 % P.BLOCK
    pos = torch.arange(P.BLOCK, dtype=torch.int32, device=dev).expand(short.shape[0], -1)
    for hashlog in (16, 12):
        _, hm, _ = M.hashes(corpus_blocks, short, hashlog)
        key, bb = M.hash_key(hm, hashlog)
        cases += [(f"find_matches_h{hashlog}", key, (pos.contiguous(),), bb)]

    # the tile-parallel design's edges: a short last tile and rows shorter
    # than a tile (keys >= 2**31 read negative), without a payload at
    # begin_bit 0 and with one at 16 whose bits include all-ones and NaN
    # patterns, moved untouched
    def unique(rows, n):
        c = rng.integers(0, 1 << 32, (rows, 1), dtype=np.uint64)
        k = (np.arange(n, dtype=np.uint64) * ODD + c) % (1 << 32)
        return rng.permuted(k, axis=1).astype(np.uint32)

    def nan_bits(rows, n):
        bits = rng.integers(0, 1 << 32, (rows, n), dtype=np.uint32)
        nans = np.array([0x7FC00000, 0xFFC00001, 0x7F800001, 0xFFFFFFFF], np.uint32)
        bits[:, ::3] = nans[rng.integers(0, 4, bits[:, ::3].shape)]
        return i32(bits)

    for n in (1, 4095, 4096, 4097, 12345, 65535):
        u = unique(3, n)
        if n > 1 and not (u >= 1 << 31).any():
            raise AssertionError("no key >= 2**31")
        k32 = i32(u)
        cases += [(f"ragged_{n}", k32, (), 0), (f"ragged_{n}_nan_pay", k32, (nan_bits(3, n),), 16)]
    # every begin_bit, so every parity of the ping-pong lands in out
    k32 = i32(unique(4, 20000))
    pay = nan_bits(4, 20000)
    for bb in (0, 8, 16, 24):
        cases += [("random_20000_pay", k32, (pay,), bb), ("random_20000", k32, (), bb)]
    # skewed digits: an all-zero block's tier-B4 keys share one hash, so a
    # row's 65536 keys (16 tiles of 4096) have one digit in each pass
    zero_words = P.phase0_words(torch.zeros((2, P.BLOCK), dtype=torch.uint8, device=dev))
    zkey = P.tier_b4_key(zero_words)
    if not bool((zkey >> 16 == zkey[0, 0] >> 16).all()):
        raise AssertionError("an all-zero block's tier-B4 keys differ in their hash")
    zkey = S.raw_bits(zkey)
    cases += [("zero_block_tier_b4", zkey, (), 16), ("zero_block_tier_b4", zkey, (), 0)]
    # grid edges: one row, and one row more than the corpus
    tb = S.raw_bits(P.tier_b_key(words))
    cases += [("tier_b_1_row", tb[:1].contiguous(), (), 16),
              ("tier_b_513_rows", torch.cat([tb, tb[:1]]), (), 16)]
    # rows over 65536 keys (17, 64 and 1024 tiles) of duplicate keys (each
    # row draws from 512 values): the position payload must keep its input
    # order among equal keys, at every begin_bit
    for n, rows in ((65537, 3), (1 << 18, 2), (1 << 22, 2)):
        vals = rng.integers(0, 1 << 32, (rows, 512), dtype=np.uint32)
        k32 = i32(np.take_along_axis(vals, rng.integers(0, 512, (rows, n)), 1))
        pos = torch.arange(n, dtype=torch.int32, device=dev).expand(rows, n).contiguous()
        for bb in (0, 8, 16, 24):
            cases.append((f"dup_{n}_pos", k32, (pos,), bb))
    # the match finder's keys for 4 MiB rows, one with a sentinel tail
    big, big_n = rows_of_4mib(corpus_blocks)
    big_n[-1] -= 12345
    pos = torch.arange(big.shape[1], dtype=torch.int32, device=dev).expand(big.shape).contiguous()
    for hashlog in (12, 20, 31):
        _, hm, _ = M.hashes(big, big_n, hashlog)
        key, bb = M.hash_key(hm, hashlog)
        cases.append((f"find_matches_4MiB_h{hashlog}", key, (pos,), bb))
    return cases


def rows_of_4mib(corpus_blocks):
    """(blocks, lengths): the 32 MiB corpus as 8 rows of 4 MiB."""
    big = corpus_blocks.reshape(8, -1)
    return big, torch.full((8,), big.shape[1], dtype=torch.int32, device=big.device)


def profile_kernels(fn, reps=10):
    """Device time of each kernel `fn` launches, from a torch.profiler trace
    of `reps` calls after a warm-up: kernel name -> (launches traced, ms a
    launch). Empty where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: (e.count, e.device_time_total / e.count / 1e3)
            for e in prof.key_averages() if getattr(e, "device_time_total", 0) > 0}


def sort_kernel_times(S, key):
    """Device time of each of the sort's kernels, from a torch.profiler
    trace of ten launches as the main path makes them (both tiers' int32
    keys, begin_bit 16): name -> {"launches", "ms" a launch, "gb_s"} with
    the bytes each kernel must move for these keys (count reads the keys,
    scatter reads and writes them, scan reads and writes the count
    table). Empty where the trace shows no device time."""
    names = {"count_kernel": "count", "scan_kernel": "scan", "scatter_kernel<0>": "scatter_0pay"}
    outs, scratch = S.buffers(key, (), 16)
    n = key.numel()
    moved = {"count": 4 * n, "scatter_0pay": 8 * n, "scan": 2 * 4 * scratch[1].numel()}
    times = {}
    for full, (count, ms) in profile_kernels(lambda: S._launch(key, (), outs, scratch, 16)).items():
        name = next((v for k, v in names.items() if k in full), None)
        if name:
            times[name] = {"launches": count, "ms": ms, "gb_s": moved[name] / ms / 1e6}
    return times


def bits64(t):
    """The 32-bit pattern of each int32 element as int64, so that keys
    >= 2**31 compare and subtract as unsigned."""
    return t.to(torch.int64) & 0xFFFFFFFF


def max_abs_err(got, want):
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            raise AssertionError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return err


def lz_match_phase(corpus, dev, card_label):
    """Phase 16, the shared LZ matcher's exact lengths on the card: (a) the
    kernel against its plain version at each caller's shape, timed beside
    its bound and the plain version; (b) the callers with the kernel and
    with the plain version in its place, in turns. Returns the numbers for
    the log."""
    from tpu7z_torch.containers import cab
    from tpu7z_torch.models import lizard as LIZ
    from tpu7z_torch.models import lz5 as LZ5
    from tpu7z_torch.models.deflate import codec as DFC
    from tpu7z_torch.models.lz4 import block as LB
    from tpu7z_torch.models.lz4 import frame as LF
    from tpu7z_torch.models.lzma import encoder as LE
    from tpu7z_torch.models.lzma import lzma2 as L2
    from tpu7z_torch.ops import hash_chain as HC
    from tpu7z_torch.utils import trace

    mib = 1 << 20
    kernel = HC.match_lengths

    def plain(s, pos, cand, limit):
        """The matcher as it ran on the card before the kernel."""
        with trace.stage("lz.match_lengths", s.device):
            return HC.match_lengths_ref(s, pos, cand, limit)

    def with_matcher(fn, run):
        HC.match_lengths = fn
        try:
            return run()
        finally:
            HC.match_lengths = kernel

    info = HC.kernel_info()
    log(f"lz_match_kernel: {info}")
    if info["local_bytes"]:
        raise AssertionError(f"lz_match_kernel spills {info['local_bytes']} bytes a thread")
    out = {"kernel_info": info, "shapes": {}, "callers": {}, "launches_by_path": {}}

    # (a) each caller's arguments, captured from its run on the card
    text = corpus[TEXT:TEXT + 4 * mib]
    noise = np.random.default_rng(16).integers(0, 256, 4 * mib, np.uint8).tobytes()
    shapes = {
        "gzip": lambda: DFC.gzip_compress(text, device=dev),
        "lzma": lambda: LE.WindowMatcher(text, device=dev),
        "lz4_zeros": lambda: LB.compress_block(bytes(4 * mib), accel=2, device=dev),
        "lz4_random": lambda: LB.compress_block(noise, accel=2, device=dev),
    }
    for name, run in shapes.items():
        seen = []

        def record(*args):
            seen.append(args)
            return kernel(*args)

        HC.reset_launches()
        with_matcher(record, run)
        launches = HC.LAUNCHES["lz_match_lengths"]
        if len(seen) != 1 or launches != 1:
            raise AssertionError(f"{name}: {len(seen)} calls of match_lengths and {launches} "
                                 f"launches in the caller's run, expected 1 and 1")
        out["launches_by_path"][name] = launches
        s = seen[0][0]
        pos, cand, limit = (t.to(torch.int64).contiguous() for t in seen[0][1:])
        args = (s, pos, cand, limit)
        got = kernel(*args)
        want = HC.match_lengths_ref(*args)
        if not torch.equal(got, want):
            raise AssertionError(f"match_lengths at {name}'s shape differs from its plain version")
        n, m = s.numel(), pos.numel()
        ms = timed(lambda: kernel(*args))
        bufs = HC.buffers(n, m, dev)
        alone_ms = timed_launches(lambda: HC._launch(*args, *bufs))
        if not torch.equal(bufs[0], want):
            raise AssertionError(f"the kernel's back-to-back launches at {name}'s shape differ "
                                 f"from its plain version")
        plain_ms = timed(lambda: HC.match_lengths_ref(*args))
        bound_ms = HC.launch_bytes(n, m) / HBM_BYTES_PER_S * 1e3
        work_bound_ms = (32 * m + n) / HBM_BYTES_PER_S * 1e3
        log(f"match_lengths at {name}'s shape (n {n}, {m} entries, limits {int(limit.min())}-"
            f"{int(limit.max())}, lengths to {int(got.max())}): 1 launch in the caller's run, "
            f"equal to its plain version; the call {ms:.4f} ms, the kernel alone {alone_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms with its scratch planes and {work_bound_ms:.4f} ms "
            f"without them; the plain version {plain_ms:.3f} ms ({card_label})")
        out["shapes"][name] = {"n": n, "m": m, "ms": ms, "alone_ms": alone_ms,
                               "bound_ms": bound_ms, "work_bound_ms": work_bound_ms,
                               "plain_ms": plain_ms}
        del seen, args, got, want, bufs

    # (b) the callers with either matcher, in turns
    files = {f"part{i}.bin": corpus[i * 4 * mib:(i + 1) * 4 * mib]
             for i in range(len(corpus) // (4 * mib))}
    callers = {
        "gzip 4 MiB": lambda: DFC.gzip_compress(text, device=dev),
        "lzma2.compress_chunks 8 MiB": lambda: L2.compress_chunks(corpus[:8 * mib], device=dev),
        "lz4 compress_frame(corpus, accel=2)": lambda: LF.compress_frame(corpus, accel=2,
                                                                         device=dev),
        "lz5 compress_frame(corpus)": lambda: LZ5.compress_frame(corpus, device=dev),
        "lizard compress_frame(4 MiB, 11)": lambda: LIZ.compress_frame(corpus[:4 * mib],
                                                                       level=11, device=dev),
        "cab MSZIP of the corpus": lambda: cab.write_cab(files, device=dev),
    }
    for what, run in callers.items():
        runs = {"plain": [], "kernel": []}
        digests = set()
        for side, fn in (("plain", plain), ("kernel", kernel), ("kernel", kernel),
                         ("plain", plain)):
            calls = []

            def counted(s, pos, cand, limit, fn=fn, calls=calls):
                calls.append(pos.numel())
                return fn(s, pos, cand, limit)

            HC.reset_launches()
            t = time.perf_counter()
            got, spans = with_matcher(counted, lambda: spans_of(run))
            seconds = time.perf_counter() - t
            launches = HC.LAUNCHES["lz_match_lengths"]
            want = sum(1 for m in calls if m) if side == "kernel" else 0
            if not calls or launches != want:
                raise AssertionError(f"{what}, {side}: {launches} launches for {len(calls)} "
                                     f"calls of match_lengths, expected {want}")
            digests.add(hashlib.sha256(got).hexdigest())
            runs[side].append({"seconds": seconds, "bytes": len(got), "calls": len(calls),
                               "launches": launches,
                               "match_lengths_s": spans.get("lz.match_lengths", 0.0)})
        if len(digests) != 1:
            raise AssertionError(f"{what}: the bytes differ between the kernel and the plain "
                                 f"version")
        out["launches_by_path"][what] = runs["kernel"][0]["launches"]
        log(f"{what} ({card_label}): {runs['kernel'][0]['bytes']} bytes on every run; "
            f"the kernel's runs {[r['launches'] for r in runs['kernel']]} launches for "
            f"{[r['calls'] for r in runs['kernel']]} calls of match_lengths; "
            f"seconds plain {[round(r['seconds'], 4) for r in runs['plain']]}, kernel "
            f"{[round(r['seconds'], 4) for r in runs['kernel']]}; lz.match_lengths s plain "
            f"{[round(r['match_lengths_s'], 5) for r in runs['plain']]}, kernel "
            f"{[round(r['match_lengths_s'], 5) for r in runs['kernel']]}")
        out["callers"][what] = runs
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from tpu7z_torch.device import resolve_device
    from tpu7z_torch.entry import entry
    from tpu7z_torch.models.lz4 import block, frame
    from tpu7z_torch.models.lz4 import torch_backend as TB
    from tpu7z_torch.ops import _build
    from tpu7z_torch.ops import lz4_cuda as K
    from tpu7z_torch.ops import lz4_plane as P
    from tpu7z_torch.ops import match as M
    from tpu7z_torch.ops import sort_cuda as S
    from tpu7z_torch.entry import dryrun_multichip
    from tpu7z_torch.ops.hashing import xxh32, xxh32_native
    from tpu7z_torch.parallel import distributed, progress, sharded
    from tpu7z_torch.utils.corpus import CORPUS_RATIO, CORPUS_SHA256, make_corpus
    from tpu7z_torch.utils.parse_planes import parse_planes

    dev = resolve_device()
    t_start = time.time()

    # 1. card and build
    card_name, power_limit = card()
    log(f"{card_name}, {power_limit}")
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
    eb, en = emit_edges(P.BLOCK)
    kb, kn = candidate_edges(P.BLOCK)
    cb, cn = sharded.split_blocks(corpus, dev)
    inputs = [("patterns", torch.from_numpy(pb).to(dev), torch.from_numpy(pn).to(dev)),
              ("emit_edges", torch.from_numpy(eb).to(dev), torch.from_numpy(en).to(dev)),
              ("candidate_edges", torch.from_numpy(kb).to(dev), torch.from_numpy(kn).to(dev)),
              ("corpus_2MiB", cb[:32].contiguous(), cn[:32].contiguous())]
    runs = [(name, b, n, W) for name, b, n in inputs for W in (0, 16)]
    runs.append(("corpus_32MiB", cb, cn, 0))
    errs = {k: 0 for k in K.KERNELS}
    full = None
    for name, b, n, W in runs:
        s = Stages(P, K, b, n, W)
        if name == "emit_edges":
            check_emit_edges(s.geo)
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
        want_out, want_used = s.want["lz4_emit"]
        if not (torch.equal(used, want_used) and torch.equal(out, want_out)):
            raise AssertionError(f"encode_blocks differs from the plain chain on {name} W={W}")
        log(f"check {name} W={W}: {b.shape[0]} blocks, {len(s.calls)} kernels and the chain "
            f"equal")
        if name == "corpus_32MiB":
            full = s
    # lz4_parse's walk on synthetic planes; no spills, no shared memory;
    # an mlen off a 16-byte boundary is refused before any launch
    for name, plane in parse_planes().items():
        mlen = torch.from_numpy(plane).to(dev)
        got = K.parse(mlen)
        torch.cuda.synchronize()
        e = max_abs_err([got], [P.phase3_parse(mlen)])
        errs["lz4_parse"] = max(errs["lz4_parse"], e)
        if e:
            raise AssertionError(f"lz4_parse differs from its plain version on the {name} "
                                 f"plane: max abs err {e}")
        log(f"check lz4_parse {name}: {tuple(mlen.shape)}, {int(got.sum())} starts, equal")
    info = K.kernel_info("lz4_parse")
    if info["local_bytes"] or info["shared_bytes"]:
        raise AssertionError(f"lz4_parse uses local or shared memory: {info}")
    n_before = K.LAUNCHES["lz4_parse"]
    off = torch.zeros(2 * P.BLOCK + 1, dtype=torch.int32, device=dev)[1:].view(2, P.BLOCK)
    try:
        K.parse(off)
    except ValueError as exc:
        log(f"lz4_parse refuses an mlen 4 bytes off a 16-byte boundary: {exc}")
    else:
        raise AssertionError("lz4_parse took an mlen off a 16-byte boundary")
    if K.LAUNCHES["lz4_parse"] != n_before:
        raise AssertionError("lz4_parse launched on a refused mlen")
    for k in K.KERNELS:
        if K.LAUNCHES[k] == 0:
            raise AssertionError(f"{k} was never launched in the checks")

    errs["sort_rows"] = 0
    for name, key, pays, bb in sort_inputs(dev, cb, cn, P, M, S):
        got = S.sort_rows(key, *pays, begin_bit=bb)
        torch.cuda.synchronize()
        want = S.sort_rows_ref(key, *pays, begin_bit=bb)
        if [g.dtype for g in got] != [w.dtype for w in want]:
            raise AssertionError(f"sort_rows changed a dtype on {name}")
        e = max_abs_err([bits64(g) for g in got], [bits64(w) for w in want])
        errs["sort_rows"] = max(errs["sort_rows"], e)
        if e:
            raise AssertionError(f"sort_rows differs from its plain version on {name} "
                                 f"begin_bit={bb}: max abs err {e}")
        log(f"check sort_rows {name} begin_bit={bb}: {tuple(key.shape)} {key.dtype}, "
            f"{len(pays)} payloads, equal")

    def reset_counts():
        K.reset_launches()
        S.reset_launches()

    def counts():
        return {**K.LAUNCHES, **S.LAUNCHES}

    # 3. the main path, counted
    reset_counts()
    t = time.time()
    framed = sharded.shard_compress_lz4_device(corpus, W=0)
    torch.cuda.synchronize()
    t_main = time.time() - t
    launches = counts()
    log(f"main path: shard_compress_lz4_device({len(corpus)} bytes, W=0) -> {len(framed)} bytes "
        f"in {t_main:.2f} s (first call), launches {launches}")
    for k in K.KERNELS:
        if launches[k] != 1:
            raise AssertionError(f"main path: {launches[k]} launches of {k}, expected 1")
    if launches["sort_rows"] != 1:
        raise AssertionError(f"main path: {launches['sort_rows']} row sorts, expected 1")
    # the candidate stage: one lz4_keys, one sort_rows and one lz4_probe an
    # encode_blocks call with the sorted tiers, none without
    for tier_b, want in ((True, 1), (False, 0)):
        reset_counts()
        K.encode_blocks(cb[:3], cn[:3], 0, tier_b=tier_b)
        torch.cuda.synchronize()
        c = counts()
        if [c["lz4_keys"], c["sort_rows"], c["lz4_probe"]] != [want] * 3:
            raise AssertionError(f"encode_blocks(tier_b={tier_b}): launches {c}, expected "
                                 f"{want} of lz4_keys, sort_rows and lz4_probe")
        log(f"encode_blocks(3 blocks, tier_b={tier_b}): launches {c}")
    lz4_decode = lz4_decode_times(framed, corpus, frame, block, P.BLOCK)
    # the native decoder against its numpy twin on every 16th block
    checked = 0
    for i, (stored, payload) in enumerate(frame.iter_blocks(framed)):
        if i % 16 or stored:
            continue
        got = block.decompress_block(payload, dst_size=P.BLOCK)
        if got != block.decompress_block_ref(payload, dst_size=P.BLOCK):
            raise AssertionError(f"the native decoder differs from decompress_block_ref on "
                                 f"block {i}")
        checked += 1
    log(f"native decoder equals decompress_block_ref on {checked} blocks (every 16th)")
    # device_ratio as bench.py computes it: bytes / sum of min(used, BLOCK + 4)
    out, used = K.encode_blocks(cb, cn, 0)
    comp_total = int(torch.clamp(used.to(torch.int64), max=P.BLOCK + 4).sum())
    ratio = len(corpus) / comp_total
    sizes = [len(p) for s_, p in frame.iter_blocks(framed) if not s_]
    if sizes != [u for u, n_ in zip(used.tolist(), cn.tolist()) if u < n_]:
        raise AssertionError("frame block sizes disagree with encode_blocks")
    log(f"device_ratio {ratio:.6f} ({len(corpus)} / {comp_total})")
    if round(ratio, 3) != CORPUS_RATIO:
        raise AssertionError(f"device_ratio {ratio:.4f} != {CORPUS_RATIO}")

    copy_rates(dev)

    # 4. the match-finder path, each part counted on its own
    def counted(name, fn):
        reset_counts()
        t = time.time()
        r = fn()
        torch.cuda.synchronize()
        c = counts()
        log(f"{name}: {time.time() - t:.2f} s (host clock), launches {c}")
        if c["sort_rows"] == 0:
            raise AssertionError(f"{name} never launched sort_rows")
        return r

    fm = counted("find_matches over the corpus", lambda: M.find_matches(cb, cn))
    fm_plain = M.find_matches(cb, cn, sort=S.sort_rows_ref)
    for g, w, what in zip(fm, fm_plain, ("selected", "mlen", "moff")):
        if not torch.equal(g, w):
            raise AssertionError(f"find_matches {what} differs with the plain sort")
    log(f"find_matches ({cb.shape[0]} blocks) with the kernel equals it with the plain "
        f"sort: {int(fm[0].sum())} matches selected")
    big, big_n = rows_of_4mib(cb)
    fm = counted("find_matches over the corpus as 8 rows of 4 MiB, hashlog 20",
                 lambda: M.find_matches(big, big_n, hashlog=20))
    fm_plain = M.find_matches(big, big_n, hashlog=20, sort=S.sort_rows_ref)
    for g, w, what in zip(fm, fm_plain, ("selected", "mlen", "moff")):
        if not torch.equal(g, w):
            raise AssertionError(f"find_matches (4 MiB rows) {what} differs with the plain sort")
    log(f"find_matches (8 rows of 4 MiB, hashlog 20) with the kernel equals it with the plain "
        f"sort: {int(fm[0].sum())} matches selected")
    del fm, fm_plain
    for bs in (1 << 16, 1 << 22):
        fm_frame = counted(f"compress_frame_device(corpus, block_size={bs})",
                           lambda: TB.compress_frame_device(corpus, block_size=bs))
        t = time.time()
        if frame.decompress(fm_frame) != corpus:
            raise AssertionError(f"compress_frame_device's frame (block_size={bs}) does not "
                                 f"decode to the input")
        log(f"compress_frame_device(block_size={bs}): {len(fm_frame)} bytes, ratio "
            f"{len(corpus) / len(fm_frame):.6f}; decoded with checksum and content size "
            f"verified in {time.time() - t:.1f} s: equal")
    head = corpus[:2 << 20]
    box = counted("shard_compress_lz4(2 MiB)", lambda: sharded.shard_compress_lz4(head))
    if frame.decompress(box) != head:
        raise AssertionError("shard_compress_lz4's container does not decode to the input")
    log(f"shard_compress_lz4: {len(box)} bytes in the skippable container, decoded: equal")
    fn, args = entry()
    got = counted("entry()", lambda: fn(*args))
    cfn, cargs = entry(device="cpu")
    for g, w in zip(got, cfn(*cargs)):
        if not torch.equal(g.cpu(), w):
            raise AssertionError("entry() on the card differs from its CPU run")
    log("entry(): equal to its CPU run")

    # 5. times on the card
    enc_ms = timed(lambda: K.encode_blocks(cb, cn, 0))
    log(f"encode_blocks {len(corpus) / 2**20:.0f} MiB ({cb.shape[0]} blocks, W=0): {enc_ms:.3f} ms, "
        f"{len(corpus) / enc_ms / 1e3:.1f} MB/s")
    cand_ms = timed(lambda: K.candidates(cb, cn))
    cand_plain_ms = timed(lambda: P.candidates(cb, cn))
    log(f"candidates (tiers B and B4): {cand_ms:.3f} ms through lz4_keys, sort_rows and "
        f"lz4_probe, {cand_plain_ms:.3f} ms plain (torch.sort)")
    sort_row = {}
    # the sort as the path calls it (both tiers' int32 keys, 2B rows,
    # through the wrapper) and as its launches alone (outputs and scratch
    # preallocated)
    key = K.candidate_keys(cb).view(-1, P.BLOCK)
    path_ms = timed(lambda: S.sort_rows(key, begin_bit=16))
    outs, scratch = S.buffers(key, (), 16)
    kernel_ms = timed_launches(lambda: S._launch(key, (), outs, scratch, 16))
    plain_ms = timed(lambda: S.sort_rows_ref(key, begin_bit=16))
    k64 = key.to(torch.int64) & 0xFFFFFFFF
    lib_ms = timed(lambda: torch.sort(k64, dim=1, stable=True))
    # each key read once and written once
    bound_ms = 2 * key.numel() * 4 / HBM_BYTES_PER_S * 1e3
    log(f"sort_rows both tiers' keys {tuple(key.shape)} int32, begin_bit=16: as the path calls "
        f"it {path_ms:.3f} ms, launches alone {kernel_ms:.3f} ms, bound {bound_ms:.3f} ms; "
        f"plain {plain_ms:.3f} ms, torch.sort (int64, stable) {lib_ms:.3f} ms")
    sort_row["tiers"] = {"shape": list(key.shape), "ms": path_ms, "path_ms": path_ms,
                         "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "library_ms": lib_ms}
    del outs, scratch, k64
    sort_info = S.kernel_info()
    for name, info in sort_info.items():
        log(f"sort_rows {name}: {info['regs']} registers a thread, {info['local_bytes']} local "
            f"(spill) bytes, {info['shared_bytes']} shared bytes and {info['threads']} threads "
            f"a CTA, {info['ctas_per_sm']} CTAs per SM")
    sort_device_ms = sort_kernel_times(S, key)
    for name, dt in sort_device_ms.items():
        log(f"sort_rows {name} as the path launches it: {dt['ms']:.4f} ms a launch on the "
            f"device ({dt['launches']} launches traced), {dt['gb_s']:.1f} GB/s")
    if not sort_device_ms:
        log("sort_rows kernels' device times: not measured (the trace shows no device time)")
    sort_row["tiers"]["device"] = sort_device_ms
    fm_ms = timed(lambda: M.find_matches(cb, cn))
    fm_plain_ms = timed(lambda: M.find_matches(cb, cn, sort=S.sort_rows_ref))
    log(f"find_matches ({cb.shape[0]} blocks): {fm_ms:.3f} ms with the row-sort kernel, "
        f"{fm_plain_ms:.3f} ms with the plain sort")
    _, h, _ = M.hashes(cb, cn, 16)
    order_ms = timed(lambda: M.sort_order(h, 16))
    log(f"sort_order as find_matches ({cb.shape[0]} blocks) calls it: int32 keys h << 15, "
        f"int32 position payload, begin_bit 8: {order_ms:.3f} ms")
    sort_row["tiers"]["find_matches_order_ms"] = order_ms
    # rows of 4 MiB: the sort as find_matches calls it at hashlog 20 (int32
    # keys, an int32 position payload, begin_bit 8), and find_matches
    _, h, _ = M.hashes(big, big_n, 20)
    key, bb = M.hash_key(h, 20)
    pos = torch.arange(big.shape[1], dtype=torch.int32, device=dev).expand(big.shape).contiguous()
    long_ms = timed(lambda: S.sort_rows(key, pos, begin_bit=bb))
    outs, scratch = S.buffers(key, (pos,), bb)
    long_kernel_ms = timed_launches(lambda: S._launch(key, (pos,), outs, scratch, bb))
    long_plain_ms = timed(lambda: S.sort_rows_ref(key, pos, begin_bit=bb))
    # the unsigned key as int64; its bits below begin_bit are zero
    k64 = key.to(torch.int64) & 0xFFFFFFFF
    long_lib_ms = timed(lambda: torch.sort(k64, dim=1, stable=True))
    long_bound_ms = 2 * 2 * key.numel() * 4 / HBM_BYTES_PER_S * 1e3
    log(f"sort_rows 8 rows of 4 MiB (match keys at hashlog 20, int32 position payload, "
        f"begin_bit={bb}): {long_ms:.3f} ms through the wrapper, launches alone "
        f"{long_kernel_ms:.3f} ms, bound {long_bound_ms:.3f} ms; plain {long_plain_ms:.3f} ms, "
        f"torch.sort (int64, stable) {long_lib_ms:.3f} ms")
    long_device = profile_kernels(lambda: S._launch(key, (pos,), outs, scratch, bb))
    for name, (n, ms) in long_device.items():
        log(f"sort_rows 8 rows of 4 MiB, {name}: {ms:.4f} ms a launch on the device "
            f"({n} launches traced)")
    del outs, scratch, h, key, k64, pos
    sort_row["tiers"]["long_rows"] = {
        "shape": list(big.shape), "begin_bit": bb, "payloads": 1, "ms": long_ms,
        "kernel_ms": long_kernel_ms, "plain_ms": long_plain_ms, "library_ms": long_lib_ms,
        "bound_ms": long_bound_ms, "device_ms": {k: v[1] for k, v in long_device.items()}}
    fm_big_ms = timed(lambda: M.find_matches(big, big_n, hashlog=20))
    fm_big_plain_ms = timed(lambda: M.find_matches(big, big_n, hashlog=20,
                                                   sort=S.sort_rows_ref))
    log(f"find_matches (8 rows of 4 MiB, hashlog 20): {fm_big_ms:.3f} ms with the row-sort "
        f"kernel, {fm_big_plain_ms:.3f} ms with the plain sort")
    moved = full.bytes_moved()
    kernels = []
    for k, (kern, plain, _outs) in full.calls.items():
        ms = timed(kern)
        args = full.launch_args[k]
        kernel_ms = timed_launches(lambda: K._launch(k, *args))
        plain_ms = timed(plain)
        bound_ms = moved[k] / HBM_BYTES_PER_S * 1e3
        log(f"{k}: {ms:.3f} ms through the wrapper ({ms / cb.shape[0] * 1e3:.2f} us/block), "
            f"kernel alone {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({moved[k] / 1e6:.1f} MB)")
        row = {"name": k, "route": "cuda", "source": SOURCE,
               "replaces": REPLACES[k], "launches": launches[k],
               "max_abs_err": errs[k], "equal": errs[k] == 0,
               "ms": ms, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None}
        if k + "_floor" in moved:
            log(f"{k}: the design's floor (the whole plane read) "
                f"{moved[k + '_floor'] / HBM_BYTES_PER_S * 1e3:.3f} ms")
        info = K.kernel_info(k)
        log(f"{k}: {info['regs']} registers a thread, {info['local_bytes']} local "
            f"(spill) bytes, {info['shared_bytes']} shared bytes and {info['threads']} "
            f"threads a CTA, {info['ctas_per_sm']} CTAs per SM")
        row.update(info)
        kernels.append(row)
    kernels.append({"name": "sort_rows", "route": "cuda", "source": SORT_SOURCE,
                    "replaces": REPLACES["sort_rows"], "launches": launches["sort_rows"],
                    "max_abs_err": errs["sort_rows"], "equal": errs["sort_rows"] == 0,
                    **sort_row["tiers"], "bound_by": "bytes", "kernels": sort_info})

    # 6. past one device: a process group, the CLI and the native xxh32
    import torch.distributed as dist
    distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0)
    group = distributed.global_mesh()
    log(f"process group: {dist.get_backend(group)}, {distributed.process_info()}")
    reset_counts()
    t = time.time()
    framed_g = sharded.shard_compress_lz4_device(corpus, group, W=0)
    torch.cuda.synchronize()
    c = counts()
    log(f"shard_compress_lz4_device({len(corpus)} bytes, one-rank NCCL group, W=0): "
        f"{len(framed_g)} bytes in {time.time() - t:.2f} s (host clock), launches {c}")
    if any(c[k] != 1 for k in K.KERNELS) or c["sort_rows"] != 1:
        raise AssertionError(f"one-rank group: launches {c}, expected each encoder kernel "
                             f"once and one row sort")
    if framed_g != framed:
        raise AssertionError("the one-rank group's frame differs from the group-less frame")
    log("one-rank group's frame equals the group-less frame byte for byte (which phase 3 "
        "decoded)")
    blocks_np, lengths_np = TB.pad_blocks(head, P.BLOCK)
    got = sharded.sharded_find_matches(blocks_np, lengths_np, group)
    want = sharded.sharded_find_matches(blocks_np, lengths_np)
    if not all(np.array_equal(g, w) for g, w in zip(got[:3], want[:3])) or got[3] != want[3]:
        raise AssertionError("sharded_find_matches with the group differs from without")
    if sharded.shard_compress_lz4(head, group) != box:
        raise AssertionError("shard_compress_lz4 with the group differs from without")
    log(f"sharded_find_matches ({blocks_np.shape[0]} blocks, {got[3]} bytes covered) and "
        f"shard_compress_lz4 over the first 2 MiB with the group: equal to without")
    used_c = used.to(torch.int64)
    errors = torch.zeros_like(used_c)
    errors[7] = 3
    tot = progress.reduce_progress(cn.to(torch.int64), used_c, errors, group)
    if any(t_.device.type != "cuda" for t_ in tot) or [int(t_) for t_ in tot] != [
            len(corpus), int(used_c.sum()), 3]:
        raise AssertionError(f"reduce_progress on the card gave {tot}")
    log(f"reduce_progress on card tensors over the group: {[int(t_) for t_ in tot]}")
    n_cards = torch.cuda.device_count()
    t = time.time()
    dryrun_multichip(n_cards)
    log(f"dryrun_multichip({n_cards}): {n_cards} spawned NCCL rank(s), frame equal to one "
        f"rank's and decoded, in {time.time() - t:.1f} s (host clock)")
    if n_cards == 1:
        log("one card: more than one rank was exercised only by the CPU tests (gloo)")
    dist.destroy_process_group()

    root = Path(__file__).resolve().parent
    work = Path(tempfile.mkdtemp(dir=_build.BUILD))
    try:
        (work / "head.bin").write_bytes(head)
        env = dict(os.environ, PYTHONPATH=str(root))
        for args in (["a", "-tlz4", "-mdev", "head.lz4", "head.bin"], ["t", "head.lz4"]):
            t = time.time()
            r = subprocess.run([sys.executable, "-m", "tpu7z_torch.cli", *args], cwd=work,
                               env=env, capture_output=True, text=True, timeout=300)
            log(f"python -m tpu7z_torch.cli {' '.join(args)}: exit {r.returncode} in "
                f"{time.time() - t:.1f} s: {r.stdout.strip()!r}")
            if r.returncode != 0:
                raise AssertionError(f"the CLI failed:\n{r.stdout}\n{r.stderr}")
        if (work / "head.lz4").read_bytes() != sharded.shard_compress_lz4_device(head):
            raise AssertionError("the CLI's frame differs from shard_compress_lz4_device's")
        log("the CLI's frame equals shard_compress_lz4_device's")
    finally:
        shutil.rmtree(work)

    for n in range(34):
        if xxh32_native(head[:n]) != xxh32(head[:n]):
            raise AssertionError(f"xxh32_native differs from xxh32 on {n} bytes")
    t = time.perf_counter()
    py_head = xxh32(head)
    t_py = time.perf_counter() - t
    if xxh32_native(head) != py_head:
        raise AssertionError("xxh32_native differs from xxh32 on the first 2 MiB")
    xxh_times = []
    for _ in range(5):
        t = time.perf_counter()
        xxh32_native(corpus)
        xxh_times.append(time.perf_counter() - t)
    t_xxh = statistics.median(xxh_times)
    log(f"xxh32_native equals xxh32 on lengths 0-33 and the first 2 MiB; host clock: native "
        f"over {len(corpus)} bytes {t_xxh * 1e3:.3f} ms (median of 5, "
        f"{len(corpus) / t_xxh / 1e9:.2f} GB/s), Python over {len(head)} bytes {t_py:.3f} s")
    blocks_np, lengths_np = TB.pad_blocks(corpus, P.BLOCK)
    t = time.perf_counter()
    sel, mlen, moff = TB.find_matches_host(blocks_np, lengths_np)
    t_dev = time.perf_counter() - t
    t = time.perf_counter()
    for b in range(blocks_np.shape[0]):
        TB.emit_block(blocks_np[b, :int(lengths_np[b])], sel[b], mlen[b], moff[b])
    t_emit = time.perf_counter() - t
    del sel, mlen, moff
    t = time.perf_counter()
    TB.compress_frame_device(corpus)
    t_call = time.perf_counter() - t
    log(f"compress_frame_device({len(corpus)} bytes) (host clock): the call {t_call:.3f} s; "
        f"its parts: device match finding with copies {t_dev:.3f} s, host emission "
        f"{t_emit:.3f} s, xxh32_native {t_xxh:.4f} s")

    # 8. zstd: the host tier, the tensor parse and the tensor encoder
    zstd = zstd_phase(corpus, dev, S, M, f"{card_name}, {power_limit}")
    sort_entry = next(k for k in kernels if k["name"] == "sort_rows")
    sort_entry["max_abs_err"] = max(sort_entry["max_abs_err"], zstd["max_abs_err"])
    sort_entry["launches_by_path"] = {"lz4_device": launches["sort_rows"],
                                      "zstd_tensor": zstd["launches"]}
    sort_entry["zstd_path"] = {k: zstd[k] for k in (
        "shape", "begin_bit", "ms", "sort_order_ms", "kernel_ms", "plain_ms", "library_ms",
        "bound_ms")}
    # 9. the shared LZ matcher on the card (LZ4 at accel 2, LZMA's fast
    # parse) and the .xz host tier
    t = time.time()
    lz = lz_phase(corpus, dev, S, M, f"{card_name}, {power_limit}")
    log(f"phase 9 in {time.time() - t:.1f} s")
    sort_entry["max_abs_err"] = max(sort_entry["max_abs_err"], lz["sort"]["max_abs_err"])
    sort_entry["launches_by_path"].update(lz4_accel=lz["lz4_accel"]["launches"],
                                          lzma_fast_parse=lz["lzma_fast_parse"]["launches"])
    sort_entry["lzma_path"] = {k: v for k, v in lz["sort"].items() if k != "max_abs_err"}
    # 10. the .7z container on the card
    t = time.time()
    sz = sevenzip_phase(corpus, dev, S, f"{card_name}, {power_limit}", zstd["frame"])
    log(f"phase 10 in {time.time() - t:.1f} s")
    sort_entry["launches_by_path"].update(
        sevenzip_zstd=sz["zstd_solid"]["sort_rows_launches"],
        sevenzip_zstd_aes=sz["zstd_solid_aes"]["sort_rows_launches"])
    # 11. DEFLATE, gzip, .zip, .tar and bzip2 on the card
    t = time.time()
    df = deflate_bzip2_phase(corpus, dev, S, M, f"{card_name}, {power_limit}")
    log(f"phase 11 in {time.time() - t:.1f} s")
    sort_entry["max_abs_err"] = max(sort_entry["max_abs_err"], df["max_abs_err"])
    sort_entry["launches_by_path"].update(deflate=df["deflate"]["launches"],
                                          bzip2=df["bzip2"]["launches"])
    sort_entry["deflate_path"] = df["sort"]["deflate_rows"]
    sort_entry["bzip2_path"] = df["sort"]["bzip2_pass"]
    # 12. Brotli, LZ5, Lizard, .Z and lzip on the card
    t = time.time()
    bl = brotli_lz_phase(corpus, dev, S, M, f"{card_name}, {power_limit}")
    log(f"phase 12 in {time.time() - t:.1f} s")
    sort_entry["max_abs_err"] = max(sort_entry["max_abs_err"], bl["max_abs_err"])
    sort_entry["launches_by_path"].update(brotli=bl["brotli"]["launches"],
                                          lz5=bl["lz5"]["launches"],
                                          lizard_25=bl["lizard"][25]["launches"],
                                          lzip=bl["lzip"]["launches"])
    for name, shape in bl["sort"].items():
        sort_entry[name] = shape
    # 13. PPMd, the hashers (BLAKE3 on the card, the native XXH3) and the
    # verbs h, t -scrc and b
    t = time.time()
    ph = ppmd_hash_phase(corpus, dev, S, f"{card_name}, {power_limit}")
    log(f"phase 13 in {time.time() - t:.1f} s")
    sort_entry["launches_by_path"].update(cli_b=ph["b"]["sort_rows_launches"])
    # 14. the containers over the port's codecs
    t = time.time()
    ct = containers_phase(corpus, dev, S, f"{card_name}, {power_limit}")
    log(f"phase 14 in {time.time() - t:.1f} s")
    sort_entry["launches_by_path"].update(rpm_bzip2=ct["rpm_bzip2_launches"],
                                          xar_bzip2=ct["xar_bzip2_launches"])
    # 15. the containers with their own codecs (MSZIP's parse on the card)
    # and the rest of the CLI
    t = time.time()
    cc = codecs_cli_phase(corpus, dev, S, f"{card_name}, {power_limit}")
    log(f"phase 15 in {time.time() - t:.1f} s")
    sort_entry["max_abs_err"] = max(sort_entry["max_abs_err"],
                                    cc["sort"]["cab_mszip_rows"]["max_abs_err"])
    sort_entry["launches_by_path"].update(cab_mszip=cc["cab_mszip_launches"])
    sort_entry["cab_mszip_rows"] = cc["sort"]["cab_mszip_rows"]

    # 16. the shared LZ matcher's exact lengths on the card, and its callers
    t = time.time()
    lm = lz_match_phase(corpus, dev, f"{card_name}, {power_limit}")
    log(f"phase 16 in {time.time() - t:.1f} s")
    kernels.append({"name": "lz_match_lengths", "replaces": REPLACES["lz_match_lengths"],
                    **lm["kernel_info"], "launches": lm["launches_by_path"]["gzip"],
                    "launches_by_path": lm["launches_by_path"], "shapes": lm["shapes"]})

    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
