"""Batched LZ match finding and greedy parse, on the device.

The counterpart of tpu7z/ops/match_jax.py `find_matches`, giving the same
three planes at every position:

  hash every position      u32 word (wrapping at the row end) * HASH_MULT
  stable sort by hash      the row-sort kernel of sort_cuda.py on the card
  previous occurrence      the sorted neighbour with the same hash
  match lengths            eight widening passes of 16-byte compares
  greedy parse             reachability from position 0 by pointer doubling

Everything but the sort is plain PyTorch, as the JAX version is XLA ops.
The host emitter merges adjacent same-offset matches, which restores long
matches past the device cap ML_CAP.
"""

from __future__ import annotations

import torch

from . import sort_cuda
from .lz4_plane import _mul32

HASH_MULT = 2654435761
ML_CAP = 4 + 16 * 8       # device match-length cap (merged at emission)
EXT = 16                  # bytes compared by one extension pass
MAX_HASHLOG = 31          # the sentinel hash 1 << hashlog must fit a u32


def _word(blocks):
    """(B, N) int64 little-endian u32 word at every position; the last
    three positions of a row read the row's first bytes (a roll, as the
    JAX version builds it)."""
    u = blocks.to(torch.int64)
    return (u | (torch.roll(u, -1, 1) << 8) | (torch.roll(u, -2, 1) << 16)
            | (torch.roll(u, -3, 1) << 24))


def hashes(blocks, lengths, hashlog: int = 16):
    """(v, h, in_range), each (B, N): the u32 word and its hash at every
    position, and whether the position lies before its block's last three
    bytes. Out-of-range positions get the sentinel hash 1 << hashlog, so
    they sort after every other."""
    n = lengths.to(torch.int64)[:, None]
    pos = torch.arange(blocks.shape[1], dtype=torch.int64, device=blocks.device)
    v = _word(blocks)
    in_range = pos < (n - 3).clamp(min=0)
    h = torch.where(in_range, _mul32(v, HASH_MULT) >> (32 - hashlog), 1 << hashlog)
    return v, h, in_range


def hash_key(h, hashlog: int):
    """(key, begin_bit) for any row length and hashlog 0-31: the hash
    shifted to the top of a u32, h << (31 - hashlog), as int32 raw bits.
    Its hashlog + 1 bits hold every hash and the sentinel 1 << hashlog,
    which sorts after them; begin_bit, the multiple of 8 at or below the
    shift, makes a stable sort by the key a stable sort by h in
    ceil((hashlog + 1) / 8) passes."""
    shift = 31 - hashlog
    return sort_cuda.raw_bits(h << shift), 8 * (shift // 8)


def sort_order(h, hashlog: int, sort=sort_cuda.sort_rows):
    """order (B, N) int64: each row's positions in the order of a stable
    sort by h, as `jnp.argsort(h, stable=True)` gives them: `hash_key`
    sorted with the position as an int32 payload."""
    B, N = h.shape
    key, begin_bit = hash_key(h, hashlog)
    pos = torch.arange(N, dtype=torch.int32, device=h.device).expand(B, N)
    _, order = sort(key, pos.contiguous(), begin_bit=begin_bit)
    return order.to(torch.int64)


def _previous_occurrence(h, hashlog, sort):
    """cand (B, N) int64: the position just before p in the stable order
    by hash when its hash equals p's, else -1."""
    order = sort_order(h, hashlog, sort)
    sh = h.gather(1, order)
    same = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    same[:, 1:] = sh[:, 1:] == sh[:, :-1]
    prev = torch.zeros_like(order)
    prev[:, 1:] = order[:, :-1]
    cand_val = torch.where(same, prev, -1)
    return torch.full_like(order, -1).scatter_(1, order, cand_val)


def find_matches(blocks, lengths, hashlog: int = 16, max_offset: int = 65535,
                 min_match: int = 4, tail_guard: int = 12,
                 sort=sort_cuda.sort_rows):
    """Batched match finding and greedy parse on the device of `blocks`.

    blocks: (B, N) uint8 zero padded, rows of any length; lengths: (B,)
    int32 block sizes; hashlog: 0-31, as `match_jax.find_matches` takes
    it. Returns (selected bool, mlen int32, moff int32), each
    (B, N): selected[b, p] is True where the greedy parse takes the match
    at p, whose length and offset are mlen[b, p] and moff[b, p]. mlen and
    moff are given at every position, as the JAX version gives them.
    `sort` is the row sort (sort_cuda.sort_rows; its plain version gives
    the same result and serves as the on-card reference)."""
    if not isinstance(blocks, torch.Tensor) or blocks.dim() != 2 \
            or blocks.dtype != torch.uint8:
        raise ValueError("blocks: expected a (B, N) uint8 tensor")
    B, N = blocks.shape
    if N < 1:
        raise ValueError("blocks: rows of 0 bytes, expected at least 1")
    if not 0 <= hashlog <= MAX_HASHLOG:
        raise ValueError(f"hashlog={hashlog}, expected 0..{MAX_HASHLOG}")
    if not isinstance(lengths, torch.Tensor) or tuple(lengths.shape) != (B,) \
            or lengths.device != blocks.device:
        raise ValueError("lengths: expected a (B,) tensor on the blocks' device")
    dev = blocks.device
    blocks = blocks.contiguous()
    n = lengths.to(torch.int64)[:, None]
    pos = torch.arange(N, dtype=torch.int64, device=dev)

    v, h, in_range = hashes(blocks, lengths, hashlog)
    cand = _previous_occurrence(h, hashlog, sort)

    offset = pos - cand
    c0 = cand.clamp(0, N - 1)
    valid = ((cand >= 0) & (offset <= max_offset) & (v.gather(1, c0) == v)
             & in_range & (pos <= n - tail_guard - 1))

    # match-length extension: fixed widening passes of EXT bytes; a pass
    # adds the count of leading equal bytes within the span still allowed
    limit = torch.where(valid, (n - 5 - pos).clamp(min=0), 0)
    mlen = torch.where(valid, min_match, 0)
    alive = valid & (limit > 0)
    for _ in range((ML_CAP - 4) // EXT):
        a = pos + mlen
        c = c0 + mlen
        span = (limit - mlen).clamp(0, EXT)
        run = torch.zeros_like(mlen)
        lead = torch.ones_like(alive)
        for k in range(EXT):
            ea = blocks.gather(1, (a + k).clamp(0, N - 1))
            ec = blocks.gather(1, (c + k).clamp(0, N - 1))
            lead &= (ea == ec) & (k < span)
            run += lead
        mlen = mlen + torch.where(alive, run, 0)
        alive = alive & (run == EXT) & (mlen < limit)
    valid &= mlen >= min_match

    # greedy parse: from p the parse goes to p + mlen on a match, else to
    # p + 1; the positions reached from 0, by pointer doubling
    jump = torch.where(valid, pos + mlen, pos + 1).clamp(max=N - 1)
    reach = torch.zeros((B, N), dtype=torch.int32, device=dev)
    reach[:, 0] = 1
    for _ in range(max(1, (N - 1).bit_length())):      # ceil(log2 N)
        tgt = torch.where(reach > 0, jump, 0)
        reach = reach.scatter_reduce(1, tgt, reach, "amax")
        jump = jump.gather(1, jump)

    selected = (reach > 0) & valid
    return selected, mlen.to(torch.int32), offset.to(torch.int32)
