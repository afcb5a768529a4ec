"""Hash chains, exact match lengths and the greedy walk of one byte row,
as tensor code on the device of its input (the CUDA card, or the CPU when
the caller names it): the LZ matcher that tpu7z runs as data-parallel
numpy, shared by its LZ4 parse, its LZMA fast parse, its DEFLATE, LZ5
and Lizard parses, and the zstd and Brotli tensor encoders. The blocks
of DEFLATE, LZ5 and Lizard are rows (`block_candidates`,
`greedy_blocks`): the candidates of every row come from one sort, and
one walk starts at every row.

The counterparts of tpu7z/models/lz4/block.py `_u32_at` (:135),
`_find_candidates` (:145), `_find_candidates_multi` (:173),
`_match_lengths` (:195), `build_prefix_hash` (:240), `_modinv_pow2`
(:271), `match_lengths_hashed` (:280) and `_greedy_parse` (:321), and of
tpu7z/models/lzma/encoder.py `_parse_from` (:237), giving the same values
bit for bit:

  word at every position   little-endian u32 of s[p:p+4], n - 3 of them
  hash                     (word * HASH_MULT mod 2**32) >> (32 - hashlog)
  stable sort by hash      `match.sort_order`: the row-sort kernel of
                           sort_cuda.py on the card (no torch.sort there)
  depth-k candidates       the d-th sorted neighbour before p with p's
                           hash, its word verified equal, d = 1..k
  exact match lengths      `match_lengths`: a position whose successor
                           continues its match at the same offset takes
                           the successor's length plus one; the others
                           compare byte panels that widen pass by pass
  prefix hash              H[i] = hash of s[:i] under h * A + (byte + 1)
                           mod 2**64, with A's powers and inverse powers
  hashed match lengths     a gallop of doubling probes, then a binary
                           refine, each probe one O(1) compare of two
                           substring hashes
  greedy walk              `greedy_walk`: the positions a cursor visits
                           by pointer doubling

The 64-bit arithmetic runs on int64 tensors: +, - and * wrap modulo 2**64
in two's complement, which gives the bits numpy's uint64 gives. Powers
are built by binary exponentiation (one multiply a bit of the exponent),
never by `cumprod`. The probe loops read the size of their active set
back to the host once a step, to compact it; `STEPS` counts their steps.

`match_lengths` on a CUDA tensor is one launch of the hand-written kernel
in csrc/lz_match.cu, with no host read and no PyTorch scan
(`LAUNCHES["lz_match_lengths"]` counts the calls that launch it); on a
CPU tensor it is its plain version, `match_lengths_ref`, tensor code
whose panel loop reads its active set back to the host once a pass.
There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import trace
from . import _build, match
from .lz4_plane import _mul32

HASH_MULT = 2654435761
POLY_A = 0x9E3779B97F4A7C15 | 1
MIN_MATCH = 3
VERIFIED = 4            # bytes a verified candidate is known to share
PANEL = 16              # bytes compared by the first panel pass
PANEL_MAX = 1 << 12     # the widest panel
PANEL_BUDGET = 1 << 22  # byte pairs gathered by one panel pass at most
_M64 = (1 << 64) - 1

# host round trips of the probe loops since the last reset
STEPS = {"gallop": 0, "refine": 0}
# launches of csrc/lz_match.cu made by `match_lengths` in this process
LAUNCHES = {"lz_match_lengths": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def reset_steps():
    STEPS["gallop"] = STEPS["refine"] = 0


def reset_launches():
    LAUNCHES["lz_match_lengths"] = 0


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("lz_match")
        lib.lz_match_launch.argtypes = [_P] * 6 + [_I, _I, _P]
        lib.lz_match_launch.restype = ctypes.c_int
        lib.lz_match_scratch.argtypes = [_I]
        lib.lz_match_scratch.restype = ctypes.c_longlong
        lib.lz_match_max_n.argtypes = []
        lib.lz_match_max_n.restype = ctypes.c_int
        lib.lz_match_error_string.argtypes = [_I]
        lib.lz_match_error_string.restype = ctypes.c_char_p
        lib.lz_match_kernel_info.argtypes = 5 * [ctypes.POINTER(_I)]
        lib.lz_match_kernel_info.restype = ctypes.c_int
        _lib = lib
    return _lib


def kernel_info():
    """What the compiler and the current card make of csrc/lz_match.cu's
    kernel: registers and local (spill) bytes a thread, static shared bytes
    and threads a CTA, resident CTAs per SM."""
    lib = _library()
    vals = [_I() for _ in range(5)]
    err = lib.lz_match_kernel_info(*[ctypes.byref(v) for v in vals])
    if err != 0:
        raise RuntimeError(f"lz_match_kernel_info: {lib.lz_match_error_string(err).decode()}")
    return dict(zip(("regs", "local_bytes", "shared_bytes", "threads", "ctas_per_sm"),
                    (v.value for v in vals)))


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
    """int64 (..., n - 3): the little-endian u32 word at every position of
    the uint8 row `s`, or of each row of a (B, n) tensor."""
    u = s.to(torch.int64)
    n = u.shape[-1]
    return (u[..., :n - 3] | (u[..., 1:n - 2] << 8) | (u[..., 2:n - 1] << 16)
            | (u[..., 3:n] << 24))


def hashes(v, hashlog: int):
    """The hash of each word, below 1 << hashlog."""
    return _mul32(v, HASH_MULT) >> (32 - hashlog)


def find_candidates(s, hashlog: int = 16):
    """int64 (n - 3,): cand[p] is the most recent q < p whose hash and
    word equal p's, else -1 (tpu7z's `_find_candidates`): depth 1 of
    `find_candidates_multi`, one stable sort of the hashes (`sort_rows`
    on the card). Given a (B, n) tensor, the same of each row as (B, n - 3)
    row-local positions, all rows in that one sort. A span `lz.sort` when
    tracing is on."""
    with trace.stage("lz.sort", s.device):
        return find_candidates_multi(s, hashlog, 1)[0]


def find_candidates_multi(s, hashlog: int = 16, depth: int = 2):
    """[cand_1, ..., cand_depth], each int64 (n - 3,): cand_d[p] is the
    d-th most recent q < p whose hash equals p's and whose word equals
    p's, else -1. One stable sort of the hashes; deeper candidates are
    earlier sorted neighbours. A (B, n) tensor gives each row's, (B, n - 3)
    each, from one sort of B rows."""
    rows = s if s.dim() == 2 else s[None]
    v = u32_at(rows)
    B, m = v.shape
    if m == 0:
        empty = torch.full(v.shape, -1, dtype=torch.int64, device=s.device)
        return [empty if s.dim() == 2 else empty[0]] * depth
    h = hashes(v, hashlog)
    order = match.sort_order(h, hashlog)
    sh = h.gather(1, order)
    out = []
    for d in range(1, depth + 1):
        cand = torch.full((B, m), -1, dtype=torch.int64, device=s.device)
        if m > d:
            same = sh[:, d:] == sh[:, :-d]
            cand.scatter_(1, order[:, d:], torch.where(same, order[:, :-d], -1))
        ok = (cand >= 0) & (v.gather(1, cand.clamp(min=0)) == v)
        cand = torch.where(ok, cand, -1)
        out.append(cand if s.dim() == 2 else cand[0])
    return out


def _panel_lengths(s, a, b, bound):
    """int64: the number of leading bytes on which s[a:] and s[b:] agree,
    at most `bound` (each a[i] + bound[i] and b[i] + bound[i] within s):
    byte panels compared pass by pass, a panel twice as wide as the last
    (at most PANEL_MAX, and PANEL_BUDGET byte pairs a pass), the rows
    still equal over their whole panel kept for the next. Host reads:
    the rows to compare (`read.lz_panel_rows`), then those left after
    each pass (`read.lz_panel_pass`)."""
    dev = s.device
    last = s.numel() - 1
    run = torch.zeros_like(bound)
    with trace.span("read.lz_panel_rows"):
        active = torch.nonzero(bound > 0).flatten()
    width = PANEL
    while active.numel():
        width = max(PANEL, min(width, PANEL_BUDGET // active.numel()))
        done = run[active]
        span = torch.clamp(bound[active] - done, max=width)
        offs = torch.arange(width, dtype=torch.int64, device=dev)
        ia = (a[active] + done)[:, None] + offs
        ib = (b[active] + done)[:, None] + offs
        inside = offs < span[:, None]
        eq = (s[ia.clamp(max=last)] == s[ib.clamp(max=last)]) & inside
        # the first byte that differs, or the end of the span
        lead = torch.cumprod(eq.to(torch.int32), 1).sum(1).to(torch.int64)
        run[active] = done + lead
        with trace.span("read.lz_panel_pass"):
            active = active[(lead == span) & (done + span < bound[active])]
        width = min(2 * width, PANEL_MAX)
    return run


def match_lengths_ref(s, pos, cand, limit):
    """Plain version of `match_lengths`, tensor code on any device: the
    same integers. A position p whose successor p + 1 is in `pos` with
    candidate cand + 1, and whose byte p + 4 equals cand + 4, has the
    successor's common prefix plus one: such links form chains, each
    position's chain end is found by a suffix minimum over a plane of the
    n + 1 positions (`cummin`), and only each chain's last position
    compares panels (`_panel_lengths`, whose first differing byte is a
    `cumprod`), up to the most any position of its chain can use. Host
    reads: the chain ends (`read.lz_chain_ends`) and those of
    `_panel_lengths`."""
    dev = s.device
    n = s.numel()
    pos = pos.to(torch.int64)
    cand = cand.to(torch.int64)
    cap = (limit.to(torch.int64) - VERIFIED).clamp(min=0)
    if pos.numel() == 0:
        return cap + VERIFIED
    plane = torch.full((n + 1,), -1, dtype=torch.int64, device=dev)
    plane[pos] = cand
    at = pos + VERIFIED
    inside = at < n
    last = n - 1
    same = s[at.clamp(max=last)] == s[(cand + VERIFIED).clamp(max=last)]
    link = inside & same & (plane[(pos + 1).clamp(max=n)] == cand + 1)
    # each position's chain end: the first unlinked position at or after
    # it, a suffix minimum over the plane
    mark = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    mark[pos] = torch.where(link, n, pos)
    end = torch.cummin(mark.flip(0), 0).values.flip(0)[pos]
    # what the chain end's panels must cover for every position behind it
    dist = end - pos
    need = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    need.scatter_reduce_(0, end, cap - dist, "amax", include_self=True)
    with trace.span("read.lz_chain_ends"):
        ends = pos[~link]
    ec = plane[ends]
    room = (n - (ends + VERIFIED)).clamp(min=0)
    bound = torch.minimum(need[ends], room)
    tail = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    tail[ends] = _panel_lengths(s, ends + VERIFIED, ec + VERIFIED, bound)
    return VERIFIED + torch.minimum(dist + tail[end], cap)


def launch_bytes(n: int, m: int) -> int:
    """Bytes one launch of csrc/lz_match.cu over n bytes and m entries
    reads and writes by its contract: pos, cand and limit read and the
    lengths written (8 bytes an entry each), the candidate plane written
    and read (4 bytes a position each way), each entry's reach and tail
    written and read (4 bytes an entry each way), and the link and
    chain-end words written and read (4 bytes a word each way). The bytes
    of s it compares, which the data asks for, are left out."""
    return 32 * m + 8 * (n + 1) + 8 * m + 16 * (-(-n // 32))


def _check(s, pos, cand, limit):
    if s.dtype != torch.uint8 or s.dim() != 1 or not s.is_contiguous():
        raise ValueError("s: expected a contiguous 1-D uint8 tensor")
    for name, t in (("pos", pos), ("cand", cand), ("limit", limit)):
        if t.dim() != 1 or t.shape != pos.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(pos.shape)}")
        if t.device != s.device:
            raise ValueError(f"{name}: on {t.device}, s on {s.device}")
    max_n = _library().lz_match_max_n()
    if s.numel() > max_n:
        raise ValueError(f"s: {s.numel()} bytes, more than the kernel's int32 positions "
                         f"take ({max_n})")


def buffers(n: int, m: int, device):
    """What the kernel writes over n bytes and m entries: the int64
    lengths and its int32 scratch (the planes, words and queue)."""
    out = torch.empty(m, dtype=torch.int64, device=device)
    scratch = torch.empty(_library().lz_match_scratch(n), dtype=torch.int32, device=device)
    return out, scratch


def _launch(s, pos, cand, limit, out, scratch):
    """The kernel's one launch on the current stream, into buffers from
    `buffers`; adds one to LAUNCHES["lz_match_lengths"]."""
    lib = _library()
    stream = torch.cuda.current_stream(s.device).cuda_stream
    err = lib.lz_match_launch(s.data_ptr(), pos.data_ptr(), cand.data_ptr(), limit.data_ptr(),
                              out.data_ptr(), scratch.data_ptr(), s.numel(), pos.numel(), stream)
    if err != 0:
        raise RuntimeError(f"lz_match_lengths: {lib.lz_match_error_string(err).decode()}")
    LAUNCHES["lz_match_lengths"] += 1
    return out


def match_lengths(s, pos, cand, limit):
    """int64: tpu7z's `_match_lengths` (block.py:195) of the uint8 row `s`,
    each entry 4 plus the number of leading bytes past the first 4 on
    which s[pos:] and s[cand:] agree, at most limit - 4: the exact common
    prefix of a verified candidate capped by `limit`. `pos` holds
    distinct positions, `cand` earlier ones (0 <= cand < pos), and
    pos + limit <= len(s).

    tpu7z widens byte panels until each row mismatches; its `depth > n`
    break never ends a row early (a row still active after a pass has
    matched all of its panels and still lies below its limit <= n). Here
    a position's length follows from its successor's where they continue
    one match, and only the last position of each such chain compares
    bytes (`match_lengths_ref` says how). On a CUDA tensor that is one
    launch of csrc/lz_match.cu (a span `lz.match_kernel` carrying its
    `bytes`), with no host read; s may then hold at most 2**31 - 2**22 - 1
    bytes (`lz_match_max_n` of the library), and a longer one raises. On
    a CPU tensor it is `match_lengths_ref`. A span `lz.match_lengths` when tracing is
    on."""
    dev = s.device
    with trace.stage("lz.match_lengths", dev):
        if dev.type == "cpu":
            return match_lengths_ref(s, pos, cand, limit)
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        pos = pos.to(torch.int64).contiguous()
        cand = cand.to(torch.int64).contiguous()
        limit = limit.to(torch.int64).contiguous()
        _check(s, pos, cand, limit)
        if pos.numel() == 0:
            return (limit - VERIFIED).clamp(min=0) + VERIFIED
        with trace.span("lz.match_kernel", bytes=launch_bytes(s.numel(), pos.numel())):
            return _launch(s, pos, cand, limit, *buffers(s.numel(), pos.numel(), dev))


def greedy_walk(next_pos, n: int, start=0):
    """bool (n + 1,): the positions a greedy cursor visits from `start`
    by following next_pos (a position's successor, int64, one entry for
    each of the first len(next_pos) <= n positions; the others, and any
    successor past n, lead to n): tpu7z's `_greedy_parse` (block.py:321)
    and `_parse_from` (lzma/encoder.py:237) as a mask. `start` may be an
    ascending tensor of positions, each the start of a walk that runs
    until it lands on the next start (deflate's blocks, one walk a row).
    Pointer doubling: each step adds the successors of the positions
    reached so far and squares the successor map, so after k steps the
    first 2**k positions of each walk are reached; ceil(log2(span)) steps
    reach all of them, span being the widest gap from a start to the next
    or to n + 1 (one host read of a tensor of starts, a span
    `read.lz_bounds`). A span `lz.walk` when tracing is on."""
    dev = next_pos.device
    bounds = torch.as_tensor(start, dtype=torch.int64).flatten()
    if isinstance(start, torch.Tensor):
        with trace.span("read.lz_bounds"):
            bounds = bounds.cpu()
    span = int(torch.diff(bounds, append=torch.tensor([n + 1])).max()) if bounds.numel() else 1
    with trace.stage("lz.walk", dev):
        jump = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
        jump[:next_pos.numel()] = next_pos.clamp(max=n)
        reach = torch.zeros(n + 1, dtype=torch.int32, device=dev)
        reach[start] = 1
        steps = 1
        while steps < span:
            reach = reach.scatter_reduce(0, jump, reach, "amax")
            jump = jump[jump]
            steps *= 2
        return reach > 0


def block_candidates(s, block_size: int, hashlog: int, depth: int = 1,
                     min_block: int = 16):
    """[cand_1, ..., cand_depth], each int64 (n,): `find_candidates_multi`
    of every `block_size` block of the uint8 tensor `s` on its own, as
    positions in `s` (-1: none, and so in each block's last 3 bytes).
    Every block is a row of one sort (one `sort_rows` launch on the card):
    a short last block of at least `min_block` bytes is zero-padded to a
    full row, and the padding, which follows every real position of its
    row, is no earlier occurrence of any of them, so their candidates are
    those of the block alone; shorter blocks get none."""
    n = s.numel()
    dev = s.device
    cands = [torch.full((n,), -1, dtype=torch.int64, device=dev) for _ in range(depth)]
    full = n // block_size
    last = full * block_size
    ragged = n - last >= max(min_block, 4)
    nrows = full + ragged
    if not nrows or block_size < min_block:
        return cands
    if ragged:
        rows = torch.zeros(nrows * block_size, dtype=s.dtype, device=dev)
        rows[:n] = s
        rows = rows.view(nrows, block_size)
    else:
        rows = s[:last].view(full, block_size)
    base = torch.arange(nrows, dtype=torch.int64, device=dev)[:, None] * block_size
    for c, local in zip(cands, find_candidates_multi(rows, hashlog, depth)):
        local = torch.where(local >= 0, local + base, -1)
        c[:last].view(full, block_size)[:, :block_size - 3] = local[:full]
        if ragged:
            c[last:n - 3] = local[full, :n - last - 3]
    return cands


def greedy_blocks(s, block_size: int, hashlog: int, *, min_offset: int = 1,
                  max_offset: int = 0xFFFF, tail: int, end: int, min_len: int,
                  max_len: int | None = None, min_block: int = 16):
    """(take, mlen, off), each (n,) over the uint8 tensor `s`: the greedy
    LZ4-style parse of every `block_size` block at once, as tpu7z's LZ5,
    Lizard and DEFLATE parse each block alone. In a block of nb bytes a
    position p (block-local) takes its depth-1 candidate at an offset in
    [min_offset, max_offset] if p <= nb - tail, its length capped at
    nb - end - p (and at max_len) and at least `min_len`; the walk starts
    at every block's first position. The candidates are
    `block_candidates`' (a span `lz.sort`). A candidate lies in its
    position's block and no position in a block's last 3 bytes has one,
    so `match_lengths` runs over the whole input. One host read of its
    own, the positions with a candidate (`read.lz_valid`)."""
    n = s.numel()
    dev = s.device
    with trace.stage("lz.sort", dev):
        cand = block_candidates(s, block_size, hashlog, 1, min_block)[0]
    pos = torch.arange(n, dtype=torch.int64, device=dev)
    off = pos - cand
    block_end = torch.clamp((pos // block_size + 1) * block_size, max=n)
    valid = (cand >= 0) & (off >= min_offset) & (off <= max_offset) & (pos <= block_end - tail)
    with trace.span("read.lz_valid"):
        vidx = torch.nonzero(valid).flatten()
    limit = block_end[vidx] - end - vidx
    if max_len is not None:
        limit = torch.clamp(limit, max=max_len)
    mlen = torch.zeros(n, dtype=torch.int64, device=dev)
    mlen[vidx] = match_lengths(s, vidx, cand[vidx], limit)
    valid &= mlen >= min_len
    starts = torch.arange(0, n, block_size, dtype=torch.int64, device=dev)
    reach = greedy_walk(torch.where(valid, pos + mlen, pos + 1), n, starts)
    return reach[:n] & valid, mlen, off


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
