"""Plain PyTorch and NumPy reference of the port's gzip member.

Written for the benchmark from the encoder's specification (the JAX
package's `tpu7z/models/deflate/codec.py`, RFC 1951 and RFC 1952) and
imports nothing of either package. It gives the bytes that
`gzip_compress(data, level=6)` must return: the level is ignored, as the
specification ignores it.

- header 1f 8b 08 00, mtime 0, XFL 0, OS 255; then the DEFLATE stream;
  then the CRC-32 and the length mod 2^32, little-endian;
- the input in 128 KiB blocks, each one dynamic-Huffman block (HLIT 286,
  HDIST 30), BFINAL only on the last;
- each block parsed alone: the 4-byte word at every position up to
  n - 4 hashed ((w * 2654435761) mod 2^32 >> 17), its candidate the most
  recent earlier position with the same hash, kept only if the words are
  equal and it lies at most 32768 back; its length the common prefix,
  at most 258 and at most the block's end; a greedy walk from the
  block's first byte takes every match it lands on; a block under 16
  bytes has none;
- code lengths by package-merge (15 bits, 7 for the code-length code,
  ties as a stable sort leaves them), EOB counted once, a distance tree
  of one 1-bit code where no match is taken; the code lengths run-length
  coded with 16, 17 and 18 as the specification writes them.

The parse runs as tensor code on `device`, every block a row; the code
lengths and headers in Python; the fields are packed on `device`.
`hashlog` other than 15 gives another parse, a control.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

BLOCK = 1 << 17
HASHLOG = 15
MAX_MATCH = 258
MAX_DIST = 32768
NLIT = 286
NDIST = 30
LENGTH_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43, 51,
               59, 67, 83, 99, 115, 131, 163, 195, 227, 258]
LENGTH_EXTRA = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4,
                4, 5, 5, 5, 5, 0]
DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257, 385,
             513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289, 16385, 24577]
DIST_EXTRA = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 10,
              10, 11, 11, 12, 12, 13, 13]
CLC_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
GZIP_HEADER = bytes([0x1F, 0x8B, 8, 0, 0, 0, 0, 0, 0, 255])
EMPTY_STREAM = bytes([0x03, 0x00])      # one fixed block holding its EOB


def parse(rows, ns, hashlog=HASHLOG):
    """(take, mlen, off) int64/bool (nb, width) over blocks as rows (uint8,
    zero padded past ns): the matches the greedy walk of each block
    takes, with their lengths and distances."""
    nb, width = rows.shape
    dev = rows.device
    b = torch.zeros((nb, width + MAX_MATCH + 4), dtype=torch.int64, device=dev)
    b[:, :width] = rows
    pos = torch.arange(width, device=dev)
    n = ns.to(torch.int64)[:, None]
    word = b[:, :width] | (b[:, 1:width + 1] << 8) | (b[:, 2:width + 2] << 16) | (b[:, 3:width + 3] << 24)
    h = ((word * 2654435761) & 0xFFFFFFFF) >> (32 - hashlog)
    has = (pos <= n - 4) & (n >= 16)
    key = torch.where(has, h, 1 << hashlog)
    skey, order = torch.sort(key, dim=1, stable=True)
    same = (skey[:, 1:] == skey[:, :-1]) & (skey[:, 1:] < (1 << hashlog))
    cand = torch.full_like(word, -1)
    cand.scatter_(1, order[:, 1:], torch.where(same, order[:, :-1], -1))
    safe = cand.clamp(min=0)
    off = pos - cand
    valid = has & (cand >= 0) & (word.gather(1, safe) == word) & (off <= MAX_DIST)
    limit = torch.clamp(n - pos, max=MAX_MATCH)
    mlen = torch.where(valid, 4, 0)
    alive = valid.clone()
    for k in range(4, MAX_MATCH):
        alive &= (k < limit) & (b.gather(1, pos.expand(nb, -1) + k) == b.gather(1, safe + k))
        mlen += alive
    # the walk: p goes to p + mlen over a match, else to p + 1; blocks end
    # at column `width`
    step = torch.where(valid, pos + mlen, pos + 1)
    jump = torch.full((nb, width + 1), width, dtype=torch.int64, device=dev)
    jump[:, :width] = torch.where((step < n) & (pos < n), step, width)
    seen = torch.zeros((nb, width + 1), dtype=torch.bool, device=dev)
    seen[:, 0] = ns > 0
    for _ in range(width.bit_length() + 1):
        hit = torch.zeros_like(seen, dtype=torch.int64).scatter_add_(1, jump, seen.to(torch.int64))
        seen |= hit > 0
        jump = jump.gather(1, jump)
    return seen[:, :width] & valid, mlen, off


def package_merge(freqs, max_bits):
    """Optimal code lengths of `freqs` bounded by max_bits; equal weights
    keep the order a stable sort of the leaves, then the packages, gives."""
    n = len(freqs)
    order = sorted(range(n), key=lambda i: freqs[i])
    leaves = [(int(freqs[i]), (k,)) for k, i in enumerate(order)]
    level, packages = [], []
    for _ in range(max_bits):
        level = sorted(leaves + packages, key=lambda t: t[0])
        packages = [(level[i][0] + level[i + 1][0], level[i][1] + level[i + 1][1])
                    for i in range(0, len(level) - 1, 2)]
    counts = [0] * n
    for _, members in level[:2 * n - 2]:
        for k in members:
            counts[k] += 1
    lengths = [0] * n
    for k, i in enumerate(order):
        lengths[i] = counts[k]
    return lengths


def code_lengths(hist, max_bits):
    used = [s for s, c in enumerate(hist) if c]
    lens = [0] * len(hist)
    if len(used) == 1:
        lens[used[0]] = 1
        return lens
    for s, ln in zip(used, package_merge([hist[s] for s in used], max_bits)):
        lens[s] = ln
    return lens


def reversed_codes(lens):
    """RFC 1951's canonical codes, bit-reversed for an LSB-first stream."""
    top = max(lens)
    count = [0] * (top + 2)
    for ln in lens:
        count[ln] += 1
    count[0] = 0
    nxt, code = [0] * (top + 2), 0
    for bits in range(1, top + 1):
        code = (code + count[bits - 1]) << 1
        nxt[bits] = code
    out = [0] * len(lens)
    for s, ln in enumerate(lens):
        if ln:
            c, nxt[ln] = nxt[ln], nxt[ln] + 1
            out[s] = int(format(c, f"0{ln}b")[::-1], 2)
    return out


def header_fields(final, lit_lens, dist_lens):
    """(values, bits) of a dynamic block's header: BFINAL, BTYPE, HLIT,
    HDIST, HCLEN, the code-length code and the run-length coded lengths."""
    lens = list(lit_lens) + list(dist_lens)
    ops = []
    i = 0
    while i < len(lens):
        v = lens[i]
        j = i
        while j < len(lens) and lens[j] == v:
            j += 1
        run = j - i
        if v == 0:
            while run >= 11:
                r = min(run, 138)
                ops.append((18, r - 11, 7))
                run -= r
            while run >= 3:
                r = min(run, 10)
                ops.append((17, r - 3, 3))
                run -= r
            ops += [(0, 0, 0)] * run
        else:
            ops.append((v, 0, 0))
            run -= 1
            while run >= 3:
                r = min(run, 6)
                ops.append((16, r - 3, 2))
                run -= r
            ops += [(v, 0, 0)] * run
        i = j
    hist = [0] * 19
    for sym, _, _ in ops:
        hist[sym] += 1
    clc_lens = code_lengths(hist, 7)
    clc_codes = reversed_codes(clc_lens)
    ordered = [clc_lens[s] for s in CLC_ORDER]
    hclen = 19
    while hclen > 4 and ordered[hclen - 1] == 0:
        hclen -= 1
    fields = [(final, 1), (2, 2), (NLIT - 257, 5), (NDIST - 1, 5), (hclen - 4, 4)]
    fields += [(ln, 3) for ln in ordered[:hclen]]
    for sym, arg, bits in ops:
        fields.append((clc_codes[sym], clc_lens[sym]))
        if bits:
            fields.append((arg, bits))
    return fields


def pack(values, bits):
    """LSB-first packing of fields (int64 tensors, each value under 2^48)
    into bytes."""
    dev = values.device
    start = torch.cumsum(bits, 0) - bits
    total = int(bits.sum())
    nwords = (total + 31) // 32 + 3
    words = torch.zeros(nwords, dtype=torch.int64, device=dev)
    w, s = start >> 5, start & 31
    low = values & ((1 << (32 - s)) - 1)
    words.scatter_add_(0, w, low << s)
    words.scatter_add_(0, w + 1, (values >> (32 - s)) & 0xFFFFFFFF)
    words.scatter_add_(0, w + 2, (values >> (32 - s)) >> 32)
    return words.cpu().numpy().astype("<u4").tobytes()[:(total + 7) // 8]


def deflate(data, device="cpu", hashlog=HASHLOG) -> bytes:
    src = np.frombuffer(data, dtype=np.uint8)
    if src.size == 0:
        return EMPTY_STREAM
    nb = -(-src.size // BLOCK)
    flat = np.zeros(nb * BLOCK, dtype=np.uint8)
    flat[:src.size] = src
    ns = np.clip(src.size - np.arange(nb) * BLOCK, 0, BLOCK)
    rows = torch.from_numpy(flat.reshape(nb, BLOCK)).to(device)
    nst = torch.from_numpy(ns).to(device)
    take, mlen, off = parse(rows, nst, hashlog)
    pos = torch.arange(BLOCK, device=rows.device)
    edge = torch.zeros((nb, BLOCK + MAX_MATCH + 1), dtype=torch.int64, device=rows.device)
    edge.scatter_add_(1, pos.expand(nb, -1), take.to(torch.int64))
    edge.scatter_add_(1, pos + torch.where(take, mlen, 0), -take.to(torch.int64))
    literal = (torch.cumsum(edge[:, :BLOCK], 1) == 0) & (pos < nst[:, None])
    lbase = torch.tensor(LENGTH_BASE, device=rows.device)
    dbase = torch.tensor(DIST_BASE, device=rows.device)
    lc = torch.searchsorted(lbase, mlen.contiguous(), right=True) - 1
    dc = torch.searchsorted(dbase, off.clamp(min=1).contiguous(), right=True) - 1
    sym = torch.where(take, 257 + lc, rows.to(torch.int64))
    token = take | literal
    blk = torch.arange(nb, device=rows.device)[:, None]
    lit_hist = torch.zeros(nb * NLIT, dtype=torch.int64, device=rows.device)
    lit_hist.scatter_add_(0, (blk * NLIT + sym)[token], torch.ones_like(sym[token]))
    dist_hist = torch.zeros(nb * NDIST, dtype=torch.int64, device=rows.device)
    dist_hist.scatter_add_(0, (blk * NDIST + dc)[take], torch.ones_like(dc[take]))
    lit_hist = lit_hist.view(nb, NLIT).cpu().numpy()
    dist_hist = dist_hist.view(nb, NDIST).cpu().numpy()
    lcodes, llens, dcodes, dlens, heads = [], [], [], [], []
    for k in range(nb):
        lh = lit_hist[k].tolist()
        lh[256] = 1
        ll = code_lengths(lh, 15)
        dh = dist_hist[k].tolist()
        dl = [1] + [0] * (NDIST - 1) if sum(dh) == 0 else code_lengths(dh, 15)
        lcodes.append(reversed_codes(ll))
        llens.append(ll)
        dcodes.append(reversed_codes(dl))
        dlens.append(dl)
        heads.append(header_fields(1 if k == nb - 1 else 0, ll, dl))
    lcode_t, llen_t = (torch.tensor(x, device=rows.device) for x in (lcodes, llens))
    dcode_t, dlen_t = (torch.tensor(x, device=rows.device) for x in (dcodes, dlens))
    lextra = torch.tensor(LENGTH_EXTRA, device=rows.device)[lc]
    dextra = torch.tensor(DIST_EXTRA, device=rows.device)[dc]
    b0 = llen_t.gather(1, sym)
    b2 = dlen_t.gather(1, dc)
    match_value = (lcode_t.gather(1, sym) | ((mlen - lbase[lc]) << b0)
                   | (dcode_t.gather(1, dc) << (b0 + lextra))
                   | ((off - dbase[dc]) << (b0 + lextra + b2)))
    value = torch.where(take, match_value, lcode_t.gather(1, sym))
    nbits = torch.where(take, b0 + lextra + b2 + dextra, b0)
    per_block = token.sum(1).tolist()
    tv, tb = value[token], nbits[token]
    values, bits, at = [], [], 0
    for k in range(nb):
        hv, hb = zip(*heads[k])
        values += [torch.tensor(hv, device=rows.device), tv[at:at + per_block[k]],
                   torch.tensor([lcodes[k][256]], device=rows.device)]
        bits += [torch.tensor(hb, device=rows.device), tb[at:at + per_block[k]],
                 torch.tensor([llens[k][256]], device=rows.device)]
        at += per_block[k]
    return pack(torch.cat(values), torch.cat(bits))


def compress(data, device="cpu", hashlog=HASHLOG) -> bytes:
    """The gzip member of `data` (bytes-like), its parse on `device`."""
    tail = (zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little") + (
        len(data) & 0xFFFFFFFF).to_bytes(4, "little")
    return GZIP_HEADER + deflate(data, device, hashlog) + tail


def compare(items: list) -> list:
    """For each (input, reference's member, program's member):
    members_differing, 1 where the program's bytes are not the
    reference's; members_not_inflating, 1 where zlib does not read the
    program's member back to the input, CRC and length checked."""
    out = []
    for data, want, got in items:
        try:
            back = zlib.decompress(got, wbits=31) == bytes(data)
        except zlib.error:
            back = False
        out.append({"members_differing": int(want != got),
                    "members_not_inflating": int(not back)})
    return out
