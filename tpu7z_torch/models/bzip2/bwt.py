"""Burrows-Wheeler transform as tensor code, a port of
tpu7z/models/bzip2/bwt.py: the same last column and pointer.

Behavioral reference: C/BwtSort.c, replaced (as in tpu7z) by a
data-parallel doubling sort over rotations. Each round orders the
rotations by (rank[i], rank[(i + k) mod n]), as tpu7z's `np.lexsort`
does, in two stable row sorts (`sort_rows` on the card, its plain
version on the CPU): first by the second key, then by the rank. A
packed 64-bit (rank, key2) key would not do: the row sort reads an
int64 key as its low 32 bits. The new ranks are a cumsum of the key
changes along the sorted order; the round's `rank.max() == n - 1` is
read on the host, as there. Ranks stay below n, and bzip2's blocks below
2**20 bytes, so each pass sorts a key of at most 20 bits in 3 digits.

The inverse transform's stable occurrence index is one row sort of the
bytes (one digit), and the orbit of the LF mapping is concatenating
pointer doubling, both on the same device.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device
from ...ops import match


def _stable_order(key, bits: int):
    """int64: the positions of the int64 tensor `key` (values below
    2**bits, bits <= 32) in the order of a stable sort by key: one row
    of `match.sort_order`, whose key is `key << (32 - bits)`."""
    return match.sort_order(key[None], bits - 1)[0]


def _lexsort2(primary, secondary, bits: int):
    """int64: the order of `np.lexsort((secondary, primary))`, both
    int64 below 2**bits: a stable sort by `secondary`, then a stable sort
    of that order by `primary`."""
    first = _stable_order(secondary, bits)
    return first[_stable_order(primary[first], bits)]


def _tensor(data, dev):
    return torch.from_numpy(np.frombuffer(bytes(data), dtype=np.uint8).copy()).to(dev)


def bwt_forward(data: bytes, device=None):
    """Returns (last_column bytes, orig_ptr). Sorts all rotations on
    `device` (the CUDA card unless it names the CPU)."""
    dev = resolve_device(device)
    n = len(data)
    if n == 0:
        return b"", 0
    if n == 1:
        return bytes(data), 0
    if n >= 1 << 31:
        raise ValueError("bwt_forward: at most 2**31 - 1 bytes")
    s = _tensor(data, dev)
    rank = s.to(torch.int64)
    bits = 8
    k = 1
    while True:
        key2 = torch.roll(rank, -k)      # rank[(i + k) mod n]
        order = _lexsort2(rank, key2, bits)
        r_ord = rank[order]
        k_ord = key2[order]
        diff = torch.zeros(n, dtype=torch.int64, device=dev)
        diff[1:] = ((r_ord[1:] != r_ord[:-1]) | (k_ord[1:] != k_ord[:-1])).to(torch.int64)
        rank = torch.empty_like(rank)
        rank[order] = torch.cumsum(diff, 0)
        top = int(rank.max())
        if top == n - 1:
            break
        bits = max(top.bit_length(), 1)
        k <<= 1
        if k >= n:
            # tie-break cycle-equal rotations deterministically by index
            order = _stable_order(rank, bits)
            rank[order] = torch.arange(n, dtype=torch.int64, device=dev)
            break
    # rank[i] = sorted position of rotation starting at i
    sa = torch.empty_like(rank)
    sa[rank] = torch.arange(n, dtype=torch.int64, device=dev)
    last = s[(sa - 1) % n]
    return last.cpu().numpy().tobytes(), int(rank[0])


def bwt_inverse(last: bytes, orig_ptr: int, device=None) -> bytes:
    """The block whose transform is (last, orig_ptr), on `device` (the
    CUDA card unless it names the CPU). A pointer outside the block raises
    IndexError, as tpu7z's numpy indexing does."""
    dev = resolve_device(device)
    n = len(last)
    if n == 0:
        return b""
    if not 0 <= orig_ptr < n:
        raise IndexError(f"index {orig_ptr} is out of bounds for axis 0 with size {n}")
    s = _tensor(last, dev)
    sym = s.to(torch.int64)
    # T[j]: position in `last` of the rotation that precedes sorted row j
    counts = torch.bincount(sym, minlength=256)
    starts = torch.cumsum(counts, 0) - counts
    T = starts[sym] + _occurrence_index(sym)
    # The orbit of the LF-mapping enumerates the string back-to-front;
    # order-preserving doubling + one reverse yields the original.
    seq = _orbit(T, orig_ptr, n)
    return s[seq].flip(0).cpu().numpy().tobytes()


def _occurrence_index(sym):
    """int64: how many earlier positions hold each position's byte
    (`sym`, int64 below 256), from one stable sort of the bytes."""
    n = sym.numel()
    order = _stable_order(sym, 8)
    sorted_vals = sym[order]
    first_of_run = torch.ones(n, dtype=torch.bool, device=sym.device)
    first_of_run[1:] = sorted_vals[1:] != sorted_vals[:-1]
    idx = torch.arange(n, dtype=torch.int64, device=sym.device)
    run_start = torch.cummax(torch.where(first_of_run, idx, 0), 0).values
    ranks = torch.empty_like(idx)
    ranks[order] = idx - run_start
    return ranks


def _orbit(T, start: int, n: int):
    """[start, T[start], T[T[start]], ...] of length n, order preserved."""
    seq = torch.tensor([start], dtype=torch.int64, device=T.device)
    jump = T
    while seq.numel() < n:
        seq = torch.cat([seq, jump[seq]])
        jump = jump[jump]
    return seq[:n]
