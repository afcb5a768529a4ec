"""Brotli encoder (RFC 7932), a port of tpu7z/models/brotli/encoder.py:
the same bytes from the same input and quality.

Qualities 0-1 emit uncompressed meta-blocks. Qualities 2-11 emit
entropy-coded meta-blocks of 4 MiB: one command, literal and distance
prefix code set per meta-block (a few literal trees over UTF-8 contexts
at quality >= 10), serialized as RFC 7932 3.5 complex codes, and the
RFC 4 distance ring. compress_mt_container wraps the stream in the
zstdmt "BR" skippable frame the reference's 7z brotli coder writes
(C/zstdmt/brotli-mt_compress.c:301).

The data-parallel stages run as tensor code on the device of the
caller's choice (the CUDA card unless `device` names the CPU):

  parse        the zstd tensor encoder's windowed parse
               (models/zstd/compressor.py `find_sequences_windowed`,
               `sort_rows` on the card) at tpu7z's (hashlog, depth, lazy)
               for the quality; the window filter, the split at the
               meta-block boundaries and the stable sort on the host
  commands     each match's insert and copy codes and its distance code
               against the ring of the last four distances. A distance
               enters the ring unless it equals the last one, so the ring
               before a command is the last four entries of the
               distances so far with repeats in a row dropped: a prefix
               count, not a serial loop
  histograms   the literal mask and the command, distance and literal
               counts; at quality >= 10 each literal's UTF-8 context and
               the (64, 256) context histogram
  body         three fields a command (its code with the insert extra
               bits, the copy extra bits, the distance code with its
               extra bits) and one a literal, placed by prefix sums
  bit packing  the whole stream, host fields and body fields alike, in
               one `pack_bits_lsb_tensor` (ops/bitstream.py)

On the host: the code lengths (package-merge, models/zstd/huffman.py),
the context clustering and the prefix-code headers, tpu7z's code. Spans
`brotli.parse`, `brotli.commands`, `brotli.histograms`, `brotli.header`
and `brotli.pack` when tracing is on.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...ops import hash_chain
from ...ops.bitstream import pack_bits_lsb_tensor
from ...utils import trace
from ..zstd import compressor as zc
from ..zstd.huffman import _package_merge
from .decoder import (COPY_BASE, COPY_EXTRA, INSERT_BASE, INSERT_EXTRA,
                      _CMD_CELLS, _CONTEXT_LUT)

_CTX_LUT = np.frombuffer(_CONTEXT_LUT, np.uint8)

# the command cell of (insert offset // 8, copy offset // 8, implicit
# distance 0); the cells RFC 7932 has no symbol for stay -1
_CELLS = np.full((3, 3, 2), -1, np.int64)
for _i, (_io, _co, _imp) in enumerate(_CMD_CELLS):
    _CELLS[_io // 8, _co // 8, int(_imp)] = _i

# static code-length-code: value -> (lsb-first bits, nbits)
# (inverse of the decoder's 4-bit peek table)
_CL_STATIC = {0: (0, 2), 1: (7, 4), 2: (3, 3), 3: (2, 2), 4: (1, 2),
              5: (15, 4)}
_CL_ORDER = (1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15)
MB_SIZE = 1 << 22     # a meta-block's bytes
CTX_LITERALS = 4096   # context modelling needs more literals than this


class _Sink:
    """(value, nbits) fields in stream order, packed LSB-first at close:
    host fields (`put`) and device tensors of fields (`put_tensor`) alike,
    in one `pack_bits_lsb_tensor` on `dev`. `bits` is the running bit
    length, which `align` and the stored meta-block's choice read."""

    __slots__ = ("dev", "parts", "vals", "nbits", "bits")

    def __init__(self, dev):
        self.dev = dev
        self.parts = []
        self.vals = []
        self.nbits = []
        self.bits = 0

    def put(self, value: int, nbits: int):
        if nbits:
            self.vals.append(int(value))
            self.nbits.append(int(nbits))
            self.bits += int(nbits)

    def _flush(self):
        if self.vals:
            self.parts.append((torch.tensor(self.vals, dtype=torch.int64),
                               torch.tensor(self.nbits, dtype=torch.int64)))
            self.vals, self.nbits = [], []

    def put_tensor(self, vals, nbits, total: int):
        """Fields on the device; `total` is the sum of `nbits`."""
        self._flush()
        self.parts.append((vals, nbits))
        self.bits += total

    def align(self):
        pad = (-self.bits) % 8
        if pad:
            self.put(0, pad)

    def raw(self, data):
        """The uint8 tensor `data` as whole bytes after an alignment."""
        self.align()
        if data.numel():
            self.put_tensor(data.to(torch.int64),
                            torch.full((data.numel(),), 8, dtype=torch.int64,
                                       device=data.device), 8 * data.numel())

    def extend(self, other: "_Sink"):
        self._flush()
        other._flush()
        self.parts.extend(other.parts)
        self.bits += other.bits

    def close(self) -> bytes:
        self._flush()
        if not self.parts:
            return b""
        vals = torch.cat([v.to(self.dev) for v, _ in self.parts])
        nbits = torch.cat([b.to(self.dev) for _, b in self.parts])
        return pack_bits_lsb_tensor(vals, nbits).cpu().numpy().tobytes()


# ------------------------------------------------------ prefix codes ---

def _huffman_lengths(freqs: np.ndarray, max_bits: int = 15) -> np.ndarray:
    """Optimal length-limited code lengths (0 = unused symbol)."""
    used = np.flatnonzero(freqs)
    lengths = np.zeros(freqs.size, np.int64)
    if used.size == 0:
        return lengths
    if used.size == 1:
        lengths[used[0]] = 1
        return lengths
    lengths[used] = _package_merge(freqs[used].astype(np.int64), max_bits)
    return lengths


def _canonical_rev(lengths: np.ndarray):
    """Canonical codes matching the decoder's (len, sym) ordering,
    bit-reversed so an LSB-first write emits the code MSB-first."""
    codes = np.zeros(lengths.size, np.int64)
    pairs = sorted((int(ln), s) for s, ln in enumerate(lengths) if ln > 0)
    code = 0
    prev = 0
    for ln, sym in pairs:
        code <<= (ln - prev)
        prev = ln
        codes[sym] = int(f"{code:0{ln}b}"[::-1], 2)
        code += 1
    return codes


def _rle_digits(run: int, base: int):
    """Digit expansion for repeat codes 16 (base 4) / 17 (base 8):
    offsets o1=3, o_k = base*o_{k-1} - (2*base-3); the k-digit range is
    [o_k, o_k + base^k - 1], contiguous, so greedy fit is exact."""
    offsets = [3]
    while offsets[-1] + base ** len(offsets) - 1 < run:
        offsets.append(base * offsets[-1] - (2 * base - 3))
    d = run - offsets[-1]
    digits = []
    for _ in range(len(offsets)):
        digits.append(d % base)
        d //= base
    return digits[::-1]


def _length_seq(lengths: np.ndarray):
    """Code-length sequence with RLE 16/17, up to last nonzero symbol.
    Yields (clsym, extra_value, extra_bits)."""
    nz = np.flatnonzero(lengths)
    if nz.size == 0:
        return []
    out = []
    end = int(nz[-1]) + 1
    i = 0
    ls = lengths[:end]
    prev_nonzero = 8
    while i < end:
        v = int(ls[i])
        run = 1
        while i + run < end and int(ls[i + run]) == v:
            run += 1
        if v == 0:
            if run < 3:
                out.extend([(0, 0, 0)] * run)
            else:
                for d in _rle_digits(run, 8):
                    out.append((17, d, 3))
        else:
            if v == prev_nonzero:
                first = 0
            else:
                out.append((v, 0, 0))
                first = 1
            rep = run - first
            if rep:
                if rep < 3:
                    out.extend([(v, 0, 0)] * rep)
                else:
                    for d in _rle_digits(rep, 4):
                        out.append((16, d, 2))
            prev_nonzero = v
        i += run
    return out


def _emit_prefix_code(sink: _Sink, lengths: np.ndarray, freqs: np.ndarray,
                      alphabet_size: int) -> np.ndarray:
    """Serialize one prefix code (RFC 7932 3.4/3.5). Returns the
    *effective* code lengths the decoder will reconstruct: for the
    simple-code path these follow the decoder's fixed tree shapes, not
    the optimal lengths."""
    used = np.flatnonzero(lengths)
    nbits_sym = max(1, (alphabet_size - 1).bit_length())
    if used.size <= 4:
        # simple code (hskip = 1)
        sink.put(1, 2)
        eff = np.zeros(alphabet_size, np.int64)
        if used.size == 0:
            sink.put(0, 2)       # NSYM = 1
            sink.put(0, nbits_sym)
            return eff
        syms = sorted(int(s) for s in used)
        # most frequent first: gets the shortest code in the 3/4-symbol
        # tree shapes the decoder builds
        syms.sort(key=lambda s: -int(freqs[s]))
        nsym = len(syms)
        sink.put(nsym - 1, 2)
        if nsym == 1:
            sink.put(syms[0], nbits_sym)
            # zero-bit code: eff stays 0
        elif nsym == 2:
            for s in syms:
                sink.put(s, nbits_sym)
            eff[syms] = 1
        elif nsym == 3:
            for s in syms:
                sink.put(s, nbits_sym)
            eff[syms[0]] = 1
            eff[syms[1]] = eff[syms[2]] = 2
        else:
            # tree-select: skewed [1,2,3,3] vs flat [2,2,2,2]
            f = [int(freqs[s]) for s in syms]
            skew_cost = f[0] + 2 * f[1] + 3 * (f[2] + f[3])
            flat_cost = 2 * sum(f)
            tree = 1 if skew_cost < flat_cost else 0
            for s in syms:
                sink.put(s, nbits_sym)
            sink.put(tree, 1)
            if tree:
                eff[syms[0]] = 1
                eff[syms[1]] = 2
                eff[syms[2]] = eff[syms[3]] = 3
            else:
                eff[syms] = 2
        return eff

    # complex code (hskip = 0)
    sink.put(0, 2)
    seq = _length_seq(lengths)
    cl_freqs = np.zeros(18, np.int64)
    for c, _e, _n in seq:
        cl_freqs[c] += 1
    cl_lens = _huffman_lengths(cl_freqs, max_bits=5)
    cl_codes = _canonical_rev(cl_lens)
    # code-length-code lengths in _CL_ORDER; the decoder stops once the
    # 32-unit space fills, or reads all 18 entries (single-code case)
    nz_cl = int(np.count_nonzero(cl_lens))
    space = 32
    for idx in _CL_ORDER:
        v = int(cl_lens[idx])
        bits, n = _CL_STATIC[v]
        sink.put(bits, n)
        if v:
            space -= 32 >> v
            if space <= 0 and nz_cl > 1:
                break
    for c, extra, nb in seq:
        if nz_cl > 1:
            sink.put(int(cl_codes[c]), int(cl_lens[c]))
        sink.put(extra, nb)
    return lengths


# --------------------------------------------------------- LZ77 parse ---

def _find_matches(s, quality: int, window_size: int, mb_size: int):
    """(mpos, mlen, moff), int64 numpy arrays sorted by position: tpu7z's
    `_find_matches`, the windowed parse on the device of the uint8 tensor
    `s`."""
    n = s.numel()
    if quality <= 4:
        hashlog, depth, lazy = 15, 1, 0
    elif quality <= 8:
        hashlog, depth, lazy = 16, 4, 1
    else:
        hashlog, depth, lazy = 17, 16, 2
    wlog = max(10, min(24, (max(2, n - 1)).bit_length()))
    mpos, mlen, moff = zc.find_sequences_windowed(s, hashlog, wlog, depth=depth,
                                                  lazy=lazy, device=s.device)
    # brotli's max back-reference distance is window_size, 16 less than
    # the matcher's power-of-two window
    keep = moff <= window_size
    mpos, mlen, moff = (t[keep].cpu().numpy() for t in (mpos, mlen, moff))
    mpos, mlen, moff = zc._split_at_block_boundaries(mpos, mlen, moff, mb_size)
    order = np.argsort(mpos, kind="stable")
    return mpos[order], mlen[order], moff[order]


def _dist_codes(dist, ring):
    """(code, extra, extra bits) of each distance, int64 tensors: tpu7z's
    `_dist_code` (the smallest code, npostfix = ndirect = 0) against the
    ring before each command, given as its last, second, third and
    fourth most recent distances."""
    last, second, third, fourth = ring
    val = dist + 3
    nb = hash_chain.floor_log2(val) - 1
    hcode = 2 * (nb - 1) + ((val >> nb) & 1)
    code = 16 + hcode
    extra = val & ((1 << nb) - 1)
    # the first code that fits wins: assign the last-tried first
    for dc in range(15, 3, -1):
        base = last if dc < 10 else second
        k = dc - 4 if dc < 10 else dc - 10
        off = 1 + (k >> 1)
        cand = base + off if (k & 1) else base - off
        code = torch.where((cand == dist) & (cand > 0), dc, code)
    for dc, ref in ((3, fourth), (2, third), (1, second), (0, last)):
        code = torch.where(dist == ref, dc, code)
    ring_code = code < 16
    return (code, torch.where(ring_code, 0, extra), torch.where(ring_code, 0, nb))


def _commands(seqs, a: int, b: int, ring: tuple, dev):
    """The meta-block [a, b)'s commands, as tensors on `dev`: per command
    its symbol, insert length and extra bits, copy extra bits and their
    width, distance symbol (-1: none) with its extra bits and width; and
    the ring after them. `ring` is (fourth, third, second, last)."""
    mp, ml, mo = (torch.from_numpy(x).to(dev) for x in seqs)
    k = mp.numel()
    ins_base = torch.tensor(INSERT_BASE, dtype=torch.int64, device=dev)
    cpy_base = torch.tensor(COPY_BASE, dtype=torch.int64, device=dev)
    ends = mp + ml
    starts = torch.cat([torch.tensor([a], dtype=torch.int64, device=dev), ends])
    tail = b - (int(ends[-1]) if k else a)
    # the tail command: the literals after the last match, no distance
    ilen = torch.cat([mp - starts[:-1], torch.tensor([tail], dtype=torch.int64, device=dev)])
    if tail == 0:
        ilen = ilen[:k]
    nc = ilen.numel()
    ins = torch.searchsorted(ins_base, ilen, right=True) - 1
    cpy = torch.zeros(nc, dtype=torch.int64, device=dev)
    cpy[:k] = torch.searchsorted(cpy_base, ml, right=True) - 1
    # the ring: a distance is pushed unless it equals the last one
    hist = torch.tensor(ring, dtype=torch.int64, device=dev)
    seq = torch.cat([hist, mo])
    push = seq[4:] != seq[3:-1]
    pushed = torch.cat([hist, mo[push]])
    count = 4 + torch.cumsum(push.to(torch.int64), 0) - push.to(torch.int64)
    before = [pushed[count - d] for d in (1, 2, 3, 4)]
    dcode, dextra, dnb = _dist_codes(mo, before)
    implicit = torch.zeros(nc, dtype=torch.bool, device=dev)
    implicit[:k] = (dcode == 0) & (ins[:k] < 8) & (cpy[:k] < 16)
    io = torch.clamp(ins // 8, max=2)
    co = torch.clamp(cpy // 8, max=2)
    if nc > k:
        # the tail's cell is (io, 0, io == 0)
        implicit[k] = bool(io[k] == 0)
    cell = torch.from_numpy(_CELLS).to(dev)[io, co, implicit.to(torch.int64)]
    sym = (cell << 6) | ((ins - 8 * io) << 3) | (cpy - 8 * co)
    dsym = torch.full((nc,), -1, dtype=torch.int64, device=dev)
    dsym[:k] = torch.where(implicit[:k], -1, dcode)
    d_extra = torch.zeros(nc, dtype=torch.int64, device=dev)
    d_nb = torch.zeros(nc, dtype=torch.int64, device=dev)
    d_extra[:k], d_nb[:k] = dextra, dnb
    cl_extra = torch.zeros(nc, dtype=torch.int64, device=dev)
    cl_nb = torch.zeros(nc, dtype=torch.int64, device=dev)
    cl_extra[:k] = ml - cpy_base[cpy[:k]]
    cl_nb[:k] = torch.tensor(COPY_EXTRA, dtype=torch.int64, device=dev)[cpy[:k]]
    il_extra = ilen - ins_base[ins]
    il_nb = torch.tensor(INSERT_EXTRA, dtype=torch.int64, device=dev)[ins]
    after = tuple(int(x) for x in pushed[-4:].cpu())
    return (sym, ilen, il_extra, il_nb, cl_extra, cl_nb, dsym, d_extra, d_nb), after


def _entropy_bits(h):
    tot = h.sum()
    if tot == 0:
        return 0.0
    nz = h[h > 0].astype(np.float64)
    return float((nz * (np.log2(tot) - np.log2(nz))).sum())


def _cluster_contexts(hist64, max_trees=6):
    """Greedy pairwise merge of 64 per-context literal histograms into
    <= max_trees clusters, stopping early when merging stops paying
    (the reference's HistogramCombine idea, br_cluster.c, re-derived
    as plain entropy-delta greedy merging). Returns (cmap64, ntrees,
    cluster_hists)."""
    hists = [hist64[c].copy() for c in range(64)]
    members = [[c] for c in range(64)]
    costs = [_entropy_bits(h) for h in hists]
    # drop empty contexts into cluster 0 upfront
    live = [i for i in range(64) if hists[i].sum() > 0] or [0]
    dead = [i for i in range(64) if hists[i].sum() == 0 and i != live[0]]
    for i in dead:
        members[live[0]].extend(members[i])
    hists = [hists[i] for i in live]
    members = [members[i] for i in live]
    costs = [costs[i] for i in live]
    TABLE_BITS = 350.0  # rough serialized-table cost per extra tree
    while len(hists) > 1:
        best = None
        for i in range(len(hists)):
            for j in range(i + 1, len(hists)):
                d = _entropy_bits(hists[i] + hists[j]) - costs[i] - costs[j]
                if best is None or d < best[0]:
                    best = (d, i, j)
        d, i, j = best
        if len(hists) <= max_trees and d > TABLE_BITS:
            break
        hists[i] = hists[i] + hists[j]
        costs[i] = _entropy_bits(hists[i])
        members[i].extend(members[j])
        del hists[j], members[j], costs[j]
    cmap = [0] * 64
    for t, mem in enumerate(members):
        for c in mem:
            cmap[c] = t
    return cmap, len(hists), hists


def _put_varlen_uint8(sink, v: int):
    """Inverse of decoder._read_varlen_uint8."""
    if v == 0:
        sink.put(0, 1)
        return
    sink.put(1, 1)
    if v == 1:
        sink.put(0, 3)
        return
    n = v.bit_length() - 1
    sink.put(n, 3)
    sink.put(v - (1 << n), n)


def _encode_metablock(s, a: int, b: int, seqs, ring: tuple, quality: int = 9):
    """One compressed meta-block body of s[a:b] (s a uint8 tensor) in a
    fresh sink, and the ring after it (which the caller keeps only with
    the body)."""
    dev = s.device
    sink = _Sink(dev)
    with trace.stage("brotli.commands", dev):
        (sym, ilen, il_extra, il_nb, cl_extra, cl_nb, dsym, d_extra, d_nb), ring = \
            _commands(seqs, a, b, ring, dev)
    with trace.stage("brotli.histograms", dev):
        # the literal mask: every position of [a, b) no match covers
        mp = torch.from_numpy(seqs[0]).to(dev) - a
        ml = torch.from_numpy(seqs[1]).to(dev)
        edge = torch.zeros(b - a + 1, dtype=torch.int64, device=dev)
        edge.index_add_(0, mp, torch.ones_like(mp))
        edge.index_add_(0, mp + ml, -torch.ones_like(mp))
        lit_pos = torch.nonzero(torch.cumsum(edge[:-1], 0) == 0).flatten() + a
        lit_bytes = s[lit_pos].to(torch.int64)
        has_dist = dsym >= 0
        counts = torch.cat([torch.bincount(sym, minlength=704),
                            torch.bincount(dsym[has_dist], minlength=64),
                            torch.bincount(lit_bytes, minlength=256)]).cpu().numpy()
        cmd_freq, dst_freq, lit_freq = counts[:704], counts[704:768], counts[768:]
        # literal context modelling (quality >= 10): each literal's UTF-8
        # context (RFC 7932 7.1) and the per-context histograms
        nlit = lit_pos.numel()
        use_ctx = quality >= 10 and nlit > CTX_LITERALS
        if use_ctx:
            lut = torch.from_numpy(_CTX_LUT.astype(np.int64)).to(dev)
            p1 = torch.where(lit_pos >= 1, s[(lit_pos - 1).clamp(min=0)].to(torch.int64), 0)
            p2 = torch.where(lit_pos >= 2, s[(lit_pos - 2).clamp(min=0)].to(torch.int64), 0)
            ctx = lut[1024 + p1] | lut[1280 + p2]
            hist64 = torch.bincount(ctx * 256 + lit_bytes, minlength=64 * 256)
            hist64 = hist64.view(64, 256).cpu().numpy()
    with trace.stage("brotli.header", dev):
        ntrees = 1
        if use_ctx:
            cmap, ntrees, cl_hists = _cluster_contexts(hist64)
            use_ctx = ntrees > 1
        cmd_lens = _huffman_lengths(cmd_freq)
        dst_lens = _huffman_lengths(dst_freq)
        # header: single block type per category
        for _cat in range(3):
            sink.put(0, 1)       # NBLTYPES = 1 (varlen-uint8 zero)
        sink.put(0, 2)           # NPOSTFIX = 0
        sink.put(0, 4)           # NDIRECT = 0
        if use_ctx:
            sink.put(2, 2)       # literal context mode: UTF8
            _put_varlen_uint8(sink, ntrees - 1)   # NTREESL
            # context map: no RLE, direct symbols, no IMTF
            sink.put(0, 1)       # use_rle = 0
            cm_freq = np.bincount(np.asarray(cmap, np.int64), minlength=ntrees)
            cm_lens = _huffman_lengths(cm_freq)
            cm_elens = _emit_prefix_code(sink, cm_lens, cm_freq, ntrees)
            cm_codes = _canonical_rev(cm_elens)
            for v in cmap:
                sink.put(int(cm_codes[v]), int(cm_elens[v]))
            sink.put(0, 1)       # IMTF = 0
        else:
            sink.put(0, 2)       # literal context mode (irrelevant, 1 tree)
            sink.put(0, 1)       # NTREESL = 1
        sink.put(0, 1)           # NTREESD = 1
        if use_ctx:
            lit_elens = np.zeros((ntrees, 256), np.int64)
            for t in range(ntrees):
                lit_elens[t] = _emit_prefix_code(sink, _huffman_lengths(cl_hists[t]),
                                                 cl_hists[t], 256)
        else:
            lit_elens = _emit_prefix_code(sink, _huffman_lengths(lit_freq), lit_freq,
                                          256)[None]
        lit_codes = np.stack([_canonical_rev(e) for e in lit_elens])
        cmd_elens = _emit_prefix_code(sink, cmd_lens, cmd_freq, 704)
        dst_elens = _emit_prefix_code(sink, dst_lens, dst_freq, 64)
        cmd_codes = _canonical_rev(cmd_elens)
        dst_codes = _canonical_rev(dst_elens)

    with trace.stage("brotli.pack", dev):
        # the body's fields: a command's three (code and insert extra,
        # copy extra, distance code and extra) around its literals
        def table(x):
            return torch.from_numpy(x).to(dev)

        nc = sym.numel()
        before = torch.cumsum(ilen, 0) - ilen
        head = 3 * torch.arange(nc, dtype=torch.int64, device=dev) + before
        total = 3 * nc + nlit
        vals = torch.zeros(total, dtype=torch.int64, device=dev)
        nbits = torch.zeros(total, dtype=torch.int64, device=dev)
        c_len = table(cmd_elens)[sym]
        vals[head] = table(cmd_codes)[sym] | (il_extra << c_len)
        nbits[head] = c_len + il_nb
        vals[head + 1] = cl_extra
        nbits[head + 1] = cl_nb
        dpos = head + 2 + ilen
        has = dsym >= 0
        ds = dsym.clamp(min=0)
        d_len = table(dst_elens)[ds]
        vals[dpos] = torch.where(has, table(dst_codes)[ds] | (d_extra << d_len), 0)
        nbits[dpos] = torch.where(has, d_len + d_nb, 0)
        if nlit:
            owner = torch.repeat_interleave(torch.arange(nc, dtype=torch.int64, device=dev),
                                            ilen)
            lidx = 3 * owner + torch.arange(nlit, dtype=torch.int64, device=dev) + 2
            tree = table(np.asarray(cmap, np.int64))[ctx] if use_ctx else 0
            vals[lidx] = table(lit_codes)[tree, lit_bytes]
            nbits[lidx] = table(lit_elens)[tree, lit_bytes]
        sink.put_tensor(vals, nbits, int(nbits.sum()))
    return sink, ring


# ------------------------------------------------------------ driver ---

def compress(data: bytes, quality: int = 9, device=None) -> bytes:
    """tpu7z's brotli stream of `data` at `quality` (0-11), its tensor
    stages on `device` (the CUDA card unless it names the CPU)."""
    dev = resolve_device(device)
    n = len(data)
    s = torch.from_numpy(np.frombuffer(bytes(data), dtype=np.uint8).copy()).to(dev)
    sink = _Sink(dev)
    # window bits (the decoder's header encoding)
    if quality <= 1 or n == 0:
        wbits = 16
    else:
        wbits = max(10, min(24, (n + 16).bit_length()))
    if wbits == 16:
        sink.put(0, 1)
    elif wbits == 17:
        sink.put(1, 1)
        sink.put(0, 3)
        sink.put(0, 3)
    elif wbits > 17:
        sink.put(1, 1)
        sink.put(wbits - 17, 3)
    else:
        sink.put(1, 1)
        sink.put(0, 3)
        sink.put(wbits - 8, 3)
    window_size = (1 << wbits) - 16

    if quality >= 2 and n:
        with trace.stage("brotli.parse", dev, size=n):
            seqs = _find_matches(s, quality, window_size, MB_SIZE)
    else:
        seqs = (np.empty(0, np.int64),) * 3
    ring = (16, 15, 11, 4)   # fourth, third, second and last distances

    pos = 0
    while pos < n:
        b = min(pos + MB_SIZE, n)
        chunk_len = b - pos
        body = None
        if quality >= 2:
            lo, hi = np.searchsorted(seqs[0], [pos, b])
            body, after = _encode_metablock(s, pos, b, tuple(x[lo:hi] for x in seqs),
                                            ring, quality=quality)
            if (body.bits + 7) // 8 >= chunk_len + 4:
                body = None
            else:
                ring = after
        sink.put(0, 1)       # ISLAST = 0
        mlen1 = chunk_len - 1
        if mlen1 < (1 << 16):
            sink.put(0, 2)
            sink.put(mlen1, 16)
        elif mlen1 < (1 << 20):
            sink.put(1, 2)
            sink.put(mlen1, 20)
        else:
            sink.put(2, 2)
            sink.put(mlen1, 24)
        if body is None:
            sink.put(1, 1)   # ISUNCOMPRESSED
            sink.raw(s[pos:b])
        else:
            sink.put(0, 1)
            sink.extend(body)
        pos = b
    sink.put(1, 1)  # ISLAST
    sink.put(1, 1)  # ISLASTEMPTY
    with trace.stage("brotli.pack", dev):
        return sink.close()


def compress_mt_container(data: bytes, quality: int = 9, device=None) -> bytes:
    """`compress` in the brotli-mt container: one 16-byte skippable
    header ("BR", the stream's size, a 64 KiB-unit size hint)."""
    stream = compress(data, quality, device=device)
    hdr = bytearray()
    hdr += (0x184D2A50).to_bytes(4, "little")
    hdr += (8).to_bytes(4, "little")
    hdr += len(stream).to_bytes(4, "little")
    hdr += b"BR"
    hint = min(0xFFFF, (len(data) >> 16) + (1 if len(data) & 0xFFFF else 0))
    hdr += hint.to_bytes(2, "little")
    return bytes(hdr) + stream
