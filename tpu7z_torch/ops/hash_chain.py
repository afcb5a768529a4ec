"""Depth-k hash chains and exact match lengths of one byte row, as tensor
code: the candidate search of the zstd tensor encoder, on the device of
its input (the CUDA card, or the CPU when the caller names it).

The counterparts of tpu7z/models/lz4/block.py `_u32_at` (:135),
`_find_candidates_multi` (:173), `build_prefix_hash` (:240),
`_modinv_pow2` (:271) and `match_lengths_hashed` (:280), giving the same
values bit for bit:

  word at every position   little-endian u32 of s[p:p+4], n - 3 of them
  hash                     (word * HASH_MULT mod 2**32) >> (32 - hashlog)
  stable sort by hash      `match.sort_order`: the row-sort kernel of
                           sort_cuda.py on the card (no torch.sort there)
  depth-k candidates       the d-th sorted neighbour before p with p's
                           hash, its word verified equal, d = 1..k
  prefix hash              H[i] = hash of s[:i] under h * A + (byte + 1)
                           mod 2**64, with A's powers and inverse powers
  match lengths            a gallop of doubling probes, then a binary
                           refine, each probe one O(1) compare of two
                           substring hashes

The 64-bit arithmetic runs on int64 tensors: +, - and * wrap modulo 2**64
in two's complement, which gives the bits numpy's uint64 gives. Powers
are built by binary exponentiation (one multiply a bit of the exponent),
never by `cumprod`. The probe loops read the size of their active set
back to the host once a step; `STEPS` counts those steps.
"""

from __future__ import annotations

import torch

from . import match
from .lz4_plane import _mul32

HASH_MULT = 2654435761
POLY_A = 0x9E3779B97F4A7C15 | 1
MIN_MATCH = 3
_M64 = (1 << 64) - 1

# host round trips of the probe loops since the last reset
STEPS = {"gallop": 0, "refine": 0}


def reset_steps():
    STEPS["gallop"] = STEPS["refine"] = 0


def _signed(x: int) -> int:
    """An unsigned 64-bit value as the int64 with its bits."""
    x &= _M64
    return x - (1 << 64) if x >> 63 else x


def modinv_pow2(a: int) -> int:
    """Inverse of odd `a` modulo 2**64 (Newton's iteration), unsigned."""
    x = a
    for _ in range(5):
        x = (x * (2 - a * x)) & _M64
    return x


def u32_at(s):
    """int64 (n - 3,): the little-endian u32 word at every position of the
    uint8 row `s`."""
    u = s.to(torch.int64)
    n = u.numel()
    return u[:n - 3] | (u[1:n - 2] << 8) | (u[2:n - 1] << 16) | (u[3:n] << 24)


def hashes(v, hashlog: int):
    """The hash of each word, below 1 << hashlog."""
    return _mul32(v, HASH_MULT) >> (32 - hashlog)


def find_candidates_multi(s, hashlog: int = 16, depth: int = 2):
    """[cand_1, ..., cand_depth], each int64 (n - 3,): cand_d[p] is the
    d-th most recent q < p whose hash equals p's and whose word equals
    p's, else -1. One stable sort of the hashes; deeper candidates are
    earlier sorted neighbours."""
    v = u32_at(s)
    h = hashes(v, hashlog)
    order = match.sort_order(h[None], hashlog)[0]
    sh = h[order]
    m = v.numel()
    out = []
    for d in range(1, depth + 1):
        cand = torch.full((m,), -1, dtype=torch.int64, device=s.device)
        if m > d:
            same = sh[d:] == sh[:-d]
            cand.scatter_(0, order[d:], torch.where(same, order[:-d], -1))
        ok = (cand >= 0) & (v[cand.clamp(min=0)] == v)
        out.append(torch.where(ok, cand, -1))
    return out


def powers(base: int, count: int, device):
    """int64 (count,): base**i mod 2**64 for i < count, by binary
    exponentiation of the exponent tensor."""
    idx = torch.arange(count, dtype=torch.int64, device=device)
    out = torch.ones(count, dtype=torch.int64, device=device)
    sq = base & _M64
    for k in range(max(count - 1, 0).bit_length()):
        out = torch.where((idx >> k) & 1 == 1, out * _signed(sq), out)
        sq = (sq * sq) & _M64
    return out


def build_prefix_hash(s):
    """(H, APOW), int64 (n + 1,) each, for O(1) substring hashes:
    H[i] = hash of s[:i] under the rolling hash h * A + (byte + 1) mod
    2**64, APOW[i] = A**i, so hash(s[i:i+L]) = H[i+L] - H[i] * APOW[L].
    H[k] * A**(n-k) is a prefix sum of (s[i] + 1) * A**(n-1-i), and A is
    odd, so A**(n-k) is invertible modulo 2**64."""
    n = s.numel()
    apow = powers(POLY_A, n + 1, s.device)
    inv_pow = powers(modinv_pow2(POLY_A), n + 1, s.device)
    terms = (s.to(torch.int64) + 1) * apow[:n].flip(0)
    csum = torch.zeros(n + 1, dtype=torch.int64, device=s.device)
    csum[1:] = torch.cumsum(terms, 0)
    return csum * inv_pow.flip(0), apow


def match_lengths_hashed(prefix_hash, pos, cand, limit, verified: int = MIN_MATCH):
    """Common-prefix length of s[pos:] and s[cand:] (their first
    `verified` bytes known equal), capped elementwise by `limit`: a
    gallop of doubling probes brackets the first mismatch, a binary
    search inside the bracket finds it."""
    h, apow = prefix_hash
    lo = torch.clamp(limit, max=verified).to(torch.int64)
    hi = limit.to(torch.int64).clone()
    hp = h[pos]
    hc = h[cand]

    def equal(idx, ln):
        pw = apow[ln]
        return h[pos[idx] + ln] - hp[idx] * pw == h[cand[idx] + ln] - hc[idx] * pw

    step = torch.full_like(lo, 8)
    active = torch.nonzero(lo < hi).flatten()
    while active.numel():
        STEPS["gallop"] += 1
        la, ha = lo[active], hi[active]
        probe = torch.minimum(la + step[active], ha)
        eq = equal(active, probe)
        la = torch.where(eq, probe, la)
        ha = torch.where(eq, ha, probe - 1)
        lo[active], hi[active] = la, ha
        step[active] <<= 1
        active = active[eq & (la < ha)]
    active = torch.nonzero(lo < hi).flatten()
    while active.numel():
        STEPS["refine"] += 1
        la, ha = lo[active], hi[active]
        mid = la + (ha - la + 1) // 2
        eq = equal(active, mid)
        la = torch.where(eq, mid, la)
        ha = torch.where(eq, ha, mid - 1)
        lo[active], hi[active] = la, ha
        active = active[la < ha]
    return lo


def floor_log2(v):
    """Exact elementwise floor(log2(v)) of positive int64 values."""
    x = v.to(torch.int64)
    bits = torch.zeros_like(x)
    for shift in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << shift)
        bits = torch.where(big, bits + shift, bits)
        x = torch.where(big, x >> shift, x)
    return bits
