"""Plain PyTorch reference of the LZ4 device block encoder's frame.

Written for the benchmark from the encoder's specification (the numpy
twin of the JAX package, `tpu7z/ops/lz4_twin2.py`, and its plane math)
and imports nothing of either package. It runs on any device, in batches
of blocks, and gives the bytes that `shard_compress_lz4_device(data,
W=0)` must return:

- the frame header of independent 64 KiB blocks without checksums
  (magic, FLG 0x60, BD 0x40, HC), then per non-empty block its size word
  and its LZ4 bytes, or its raw bytes (bit 31 set) where those are not
  shorter, then a zero EndMark;
- each block: candidates from two sorted-neighbour tiers (8-byte hash,
  K = 2 predecessors, both words verified; 4-byte hash, the first and the
  second predecessor kept apart), run lengths of equal offsets, the
  longest tier winning only when strictly longer, every length capped at
  its 128-byte row and the block's last 5 bytes, no match from the last
  12 bytes on; the one-step lazy greedy parse of each row; a match that
  ends a row and is continued at the start of the next (odd) row with
  the same offset is one sequence; then the standard LZ4 sequences.

`tier_b=False` gives the encoder without the sorted tiers (every block
literal), the program's own weaker path.
"""

from __future__ import annotations

import numpy as np
import torch

ROW = 128
BLOCK = 1 << 16
MIN_MATCH = 4
MIN_MATCH_B = 8
TAIL_GUARD = 12
END_LITERALS = 5
C1 = 0x9E3779B1
C2 = 0x85EBCA77
MASK32 = 0xFFFFFFFF
HEADER = bytes([0x04, 0x22, 0x4D, 0x18, 0x60, 0x40, 0x82])
ENDMARK = bytes(4)
BATCH = 128          # blocks a pass: the planes of a pass stay near 1 GB


def _mul32(x, c):
    """x * c mod 2^32 for 0 <= x < 2^32, in int64 without overflow."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK32


def _shift_left(x, k):
    """out[:, i] = x[:, i + k], zero past the end."""
    out = torch.zeros_like(x)
    out[:, :-k] = x[:, k:]
    return out


def _predecessor_offsets(key, carried, guard):
    """For unique keys hash << 16 | pos: per position, the offset to its
    first and second predecessor in sorted order that has the same hash
    and the same carried words (0 where none), back in position order and
    zero from `guard` on."""
    skey = torch.sort(key, dim=1).values
    spos = skey & 0xFFFF
    words = [w.gather(1, spos) for w in carried]
    offs = []
    for k in (1, 2):
        ok = (skey[:, k:] >> 16) == (skey[:, :-k] >> 16)
        for w in words:
            ok &= w[:, k:] == w[:, :-k]
        o = torch.zeros_like(skey)
        o[:, k:] = torch.where(ok, spos[:, k:] - spos[:, :-k], 0)
        offs.append(torch.zeros_like(o).scatter_(1, spos, o))
    pos = torch.arange(BLOCK, device=key.device)
    return [torch.where(pos < guard, o, 0) for o in offs]


def _runs(off, kmin):
    """kmin plus the number of following positions with the same offset,
    where off > 0; 0 elsewhere."""
    pos = torch.arange(BLOCK, device=off.device).expand_as(off)
    cont = torch.zeros_like(off, dtype=torch.bool)
    cont[:, :-1] = (off[:, :-1] > 0) & (off[:, 1:] == off[:, :-1])
    brk = torch.where(cont, BLOCK, pos)
    first_break = torch.flip(torch.cummin(torch.flip(brk, [1]), 1).values, [1])
    return torch.where(off > 0, first_break - pos + kmin, 0)


def matches(blocks, ns, tier_b=True):
    """(mlen, moff) int64 (B, BLOCK): the longest verified match at each
    position, capped, or 0."""
    b = blocks.to(torch.int64)
    words = b | (_shift_left(b, 1) << 8) | (_shift_left(b, 2) << 16) | (_shift_left(b, 3) << 24)
    nxt = _shift_left(words, 4)
    pos = torch.arange(BLOCK, device=blocks.device)
    n = ns.to(torch.int64)[:, None]
    guard = (n - TAIL_GUARD).clamp(min=0)
    mlen = torch.zeros_like(words)
    moff = torch.zeros_like(words)
    if tier_b:
        h8 = (_mul32(words, C1) ^ _mul32(nxt, C2)) >> 16
        o8a, o8b = _predecessor_offsets((h8 << 16) | pos, [words, nxt], guard)
        so8 = torch.where(o8a > 0, o8a, o8b)
        h4 = _mul32(words, C1) >> 16
        so4a, so4b = _predecessor_offsets((h4 << 16) | pos, [words], guard)
        for off, kmin in ((so4a, MIN_MATCH), (so4b, MIN_MATCH), (so8, MIN_MATCH_B)):
            ml = _runs(off, kmin)
            longer = ml > mlen
            mlen = torch.where(longer, ml, mlen)
            moff = torch.where(longer, off, moff)
    mlen = torch.minimum(mlen, (n - END_LITERALS - pos).clamp(min=0))
    mlen = torch.minimum(mlen, ROW - pos % ROW)
    ok = (mlen >= MIN_MATCH) & (pos < guard) & (moff > 0)
    return torch.where(ok, mlen, 0), torch.where(ok, moff, 0)


def parse(mlen):
    """Match starts (B, BLOCK) bool: in each 128-byte row a cursor from
    lane 0 takes the match at its lane unless the next lane's is more than
    one byte longer, then moves past what it took."""
    ml = mlen.reshape(-1, ROW)
    rows = torch.arange(ml.shape[0], device=ml.device)
    cur = torch.zeros_like(rows)
    start = torch.zeros(ml.shape, dtype=torch.bool, device=ml.device)
    for _ in range(ROW):
        at = cur.clamp(max=ROW - 1)
        here = ml[rows, at]
        after = ml[rows, (at + 1).clamp(max=ROW - 1)]
        take = (cur < ROW) & (here >= MIN_MATCH) & ~((after > here + 1) & (at + 1 < ROW))
        start[rows, at] |= take
        cur = torch.where(take, cur + here, cur + 1)
    return start.reshape(mlen.shape)


def _per_row(x, B):
    return x.reshape(B, BLOCK // ROW, ROW).amax(2)


def encode(blocks, ns, tier_b=True):
    """(out (B, cap) uint8, used (B,) int64): block b's LZ4 bytes are
    out[b, :used[b]]."""
    B = blocks.shape[0]
    dev = blocks.device
    mlen, moff = matches(blocks, ns, tier_b)
    start = parse(mlen)
    pos = torch.arange(BLOCK, device=dev)
    lane, row = pos % ROW, pos // ROW
    n = ns.to(torch.int64)[:, None]
    live = pos < n
    start &= live

    # a match that ends its row, continued by a lane-0 start of the next,
    # odd, row at the same offset: one sequence, the continuation covered
    ends_row = start & (lane + mlen == ROW)
    end_off = _per_row(torch.where(ends_row, moff, 0), B)
    prev_end_off = torch.zeros_like(end_off)
    prev_end_off[:, 1:] = end_off[:, :-1]
    cont = start & (lane == 0) & (row % 2 == 1) & (moff == prev_end_off[:, row]) & (moff > 0)
    head = start & ~cont
    cont_len = _per_row(torch.where(cont, mlen, 0), B)
    cont_off = _per_row(torch.where(cont, moff, 0), B)
    next_len = torch.zeros_like(cont_len)
    next_off = torch.zeros_like(cont_off)
    next_len[:, :-1] = cont_len[:, 1:]
    next_off[:, :-1] = cont_off[:, 1:]
    joined = ends_row & head & (moff == next_off[:, row]) & (next_len[:, row] > 0)
    total = torch.where(head, mlen + torch.where(joined, next_len[:, row], 0), 0)

    reach = torch.where(start, lane + mlen, 0).reshape(B, -1, ROW)
    covered = (lane < torch.cummax(reach, 2).values.reshape(B, BLOCK)) & live
    literal = live & ~covered
    after_match = torch.zeros_like(covered)
    after_match[:, 1:] = covered[:, :-1]
    seq = live & ((pos == 0) | (after_match & (head | literal)))

    # each sequence's literal count: to the next head, else to the end
    head_at = torch.where(head, pos, BLOCK)
    next_head = torch.flip(torch.cummin(torch.flip(head_at, [1]), 1).values, [1])
    lits = torch.where(seq, torch.minimum(next_head, n) - pos, 0)
    mcode = total - MIN_MATCH
    next_mcode = torch.where(next_head < BLOCK,
                             mcode.gather(1, next_head.clamp(max=BLOCK - 1)), 0)
    token = (lits.clamp(max=15) << 4) | torch.where(next_head < n, next_mcode.clamp(max=15), 0)
    ext = torch.where(seq & (lits >= 15), (lits - 15) // 255 + 1, 0)

    # bytes of each position, in stream order: its sequence's token and
    # literal-length bytes, its literal, its match's offset and length byte
    seq_bytes = torch.where(seq, 1 + ext, 0)
    match_bytes = torch.where(head, 2 + (mcode >= 15).to(torch.int64), 0)
    size = seq_bytes + literal.to(torch.int64) + match_bytes
    at = torch.cumsum(size, 1) - size
    used = size.sum(1)
    cap = int(used.max()) + 1 if B else 1
    out = torch.zeros((B, cap + 1), dtype=torch.int64, device=dev)

    def put(mask, where, value):
        out.scatter_(1, torch.where(mask, where, cap), torch.where(mask, value, 0))

    put(seq, at, token)
    rem = (lits - 15) % 255
    for j in range(int(ext.max()) if B else 0):      # 255s, then the remainder
        put(seq & (ext > j), at + 1 + j, torch.where(ext - 1 == j, rem, 255))
    lit_at = at + seq_bytes
    put(literal, lit_at, blocks.to(torch.int64))
    m_at = lit_at + literal.to(torch.int64)
    put(head, m_at, moff & 0xFF)
    put(head, m_at + 1, moff >> 8)
    put(head & (mcode >= 15), m_at + 2, mcode - 15)
    return out[:, :cap].to(torch.uint8), used


def compress(data, device="cpu", tier_b=True) -> bytes:
    """The .lz4 frame of `data` (bytes-like), computed on `device`."""
    src = np.frombuffer(data, dtype=np.uint8)
    nb = max(1, -(-src.size // BLOCK))
    parts = [HEADER]
    for first in range(0, nb, BATCH):
        count = min(BATCH, nb - first)
        chunk = np.zeros(count * BLOCK, dtype=np.uint8)
        piece = src[first * BLOCK:(first + count) * BLOCK]
        chunk[:piece.size] = piece
        ns = np.clip(src.size - (first + np.arange(count)) * BLOCK, 0, BLOCK)
        blocks = torch.from_numpy(chunk.reshape(count, BLOCK)).to(device)
        out, used = encode(blocks, torch.from_numpy(ns).to(device), tier_b)
        out, used = out.cpu().numpy(), used.cpu().numpy()
        for b in range(count):
            n, u = int(ns[b]), int(used[b])
            if n == 0:
                continue
            if u >= n:
                parts += [(n | 1 << 31).to_bytes(4, "little"),
                          chunk[b * BLOCK:b * BLOCK + n].tobytes()]
            else:
                parts += [u.to_bytes(4, "little"), out[b, :u].tobytes()]
    parts.append(ENDMARK)
    return b"".join(parts)


def records(frame: bytes):
    """(header, [block records], end) of a frame of independent blocks
    without checksums, or None where it does not parse as one."""
    if len(frame) < len(HEADER) + 4 or frame[:len(HEADER)] != HEADER:
        return None
    at, out = len(HEADER), []
    while at + 4 <= len(frame):
        word = int.from_bytes(frame[at:at + 4], "little")
        if word == 0:
            return HEADER, out, frame[at:]
        size = word & 0x7FFFFFFF
        out.append(frame[at:at + 4 + size])
        at += 4 + size
    return None


def _length(src, n, p, end):
    """(n, p, bad): each lane's length field `n` with its extension bytes
    added where it reads 15 (a run of 255s and the byte that ends it), the
    read position after them, and the lanes whose extension runs past the
    block's end."""
    n, p = n.copy(), p.copy()
    bad = np.zeros(n.size, dtype=bool)
    more = n == 15
    while more.any():
        i = np.flatnonzero(more)
        over = p[i] >= end[i]
        bad[i[over]] = True
        more[i[over]] = False
        i = i[~over]
        b = src[p[i]].astype(np.int64)
        n[i] += b
        p[i] += 1
        more[i] = b == 255
    return n, p, bad


def _spans(n):
    """(lane of each byte, its index j within its span) for spans of `n`."""
    starts = np.repeat(np.cumsum(n) - n, n)
    return np.repeat(np.arange(n.size), n), np.arange(int(n.sum())) - starts


def decode_blocks(blocks: list) -> list:
    """LZ4 blocks decoded as the block format (lz4 1.10.0,
    `doc/lz4_Block_format.md`) reads them: a token, literals, a 2-byte
    offset and a match per sequence, the last sequence literals alone.
    One lane a block, every lane a sequence a step. Each entry is the
    block's bytes, or None where the block does not decode within 64 KiB:
    a field or literals past its end, an offset of 0 or before its start,
    more than 64 KiB out."""
    L = len(blocks)
    lens = np.array([len(b) for b in blocks], dtype=np.int64)
    end = np.cumsum(lens)
    pos = end - lens
    src = np.frombuffer(b"".join(blocks) + bytes(2), dtype=np.uint8)
    dst = np.zeros(L * BLOCK, dtype=np.uint8)
    base = np.arange(L, dtype=np.int64) * BLOCK
    op = np.zeros(L, dtype=np.int64)
    ok = np.ones(L, dtype=bool)
    live = np.ones(L, dtype=bool)
    while True:
        k = np.flatnonzero(live & ok)
        if k.size == 0:
            break
        p, e = pos[k], end[k]
        bad = p >= e                                    # no token
        tok = src[np.minimum(p, src.size - 1)].astype(np.int64)
        lit, p, over = _length(src, tok >> 4, p + 1, e)
        bad |= over | (p + lit > e) | (op[k] + lit > BLOCK)
        ok[k[bad]] = False
        k, p, e, tok, lit = k[~bad], p[~bad], e[~bad], tok[~bad], lit[~bad]
        lane, j = _spans(lit)
        dst[(base[k] + op[k])[lane] + j] = src[p[lane] + j]
        p = p + lit
        op[k] += lit
        last = p == e                                   # literals alone: the end
        live[k[last]] = False
        pos[k[last]] = p[last]
        k, p, e, tok = k[~last], p[~last], e[~last], tok[~last]
        bad = p + 2 > e
        q = np.minimum(p, src.size - 2)
        off = src[q].astype(np.int64) | src[q + 1].astype(np.int64) << 8
        ml, p, over = _length(src, tok & 15, p + 2, e)
        ml += MIN_MATCH
        bad |= over | (off == 0) | (off > op[k]) | (op[k] + ml > BLOCK)
        ok[k[bad]] = False
        k, p, off, ml = k[~bad], p[~bad], off[~bad], ml[~bad]
        lane, j = _spans(ml)
        at = (base[k] + op[k])[lane]
        dst[at + j] = dst[at - off[lane] + j % off[lane]]   # overlap: the period repeats
        op[k] += ml
        pos[k] = p
    return [dst[base[i]:base[i] + op[i]].tobytes() if ok[i] else None for i in range(L)]


def decodes(pairs: list) -> list:
    """For each (input, frame): whether the frame decodes to the input as
    a frame of independent blocks without checksums: its header, every
    block (raw where bit 31 of its size word is set, LZ4 elsewhere, none
    over 64 KiB), the EndMark with nothing after it."""
    lanes, plans = [], []
    for _, frame in pairs:
        r = records(frame)
        plan = None
        if r is not None and r[2] == ENDMARK:
            plan = []
            for rec in r[1]:
                word = int.from_bytes(rec[:4], "little")
                body = rec[4:]
                if len(body) != word & 0x7FFFFFFF or len(body) > BLOCK:
                    plan = None
                    break
                if word >> 31:
                    plan.append(body)
                else:
                    plan.append(len(lanes))
                    lanes.append(body)
        plans.append(plan)
    out = decode_blocks(lanes)
    result = []
    for (data, _), plan in zip(pairs, plans):
        parts = None if plan is None else [x if isinstance(x, bytes) else out[x] for x in plan]
        result.append(parts is not None and None not in parts
                      and b"".join(parts) == bytes(data))
    return result


def compare(items: list) -> list:
    """For each (input, reference's frame, program's frame):
    blocks_differing, the blocks whose record (size word and bytes)
    differs between the frames, plus one for a differing header or end,
    every block where the program's does not parse; frames_not_decoding,
    1 where the program's frame does not decode to the input."""
    back = decodes([(data, got) for data, _, got in items])
    out = []
    for (data, want, got), fine in zip(items, back):
        a, b = records(want), records(got)
        if b is None:
            n = max(1, len(a[1]))
        else:
            n = sum(x != y for x, y in zip(a[1], b[1])) + abs(len(a[1]) - len(b[1]))
            n += a[2] != b[2]
        out.append({"blocks_differing": n, "frames_not_decoding": int(not fine)})
    return out
