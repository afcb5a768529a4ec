"""Plain PyTorch version of the LZ4 device block encoder.

Every phase runs batched over `(B, BLOCK)` tensors of independent 64 KiB
blocks, on whatever device its inputs lie on. The functions are the
reference that each hand-written CUDA kernel in `lz4_cuda.py` is held
against, and the CPU path of those wrappers. They give the same integers
as the JAX plane math of the TPU encoder; the algorithm is unchanged,
only the idiom differs (`cumsum`, `cummax`, `gather`, `scatter_` in place
of the TPU's full-plane shift trees).

Phases (the TPU kernel of each in brackets):
  0  u32 word at every position                          [a1]
  1  candidate offsets: tier A nearest-offset window     [a1]
     and the sorted-neighbour tiers B and B4: candidate_keys, one sort of
     both tiers' rows (`torch.sort` here, the row-sort kernel of
     sort_cuda.py on the card), candidate_probe [XLA's lax.sort tiers; on
     the card the kernels lz4_keys and lz4_probe]
  2  match length = verified same-offset run, longest tier wins  [a1]
  3  lazy greedy parse, one cursor per 128-byte row      [a2]
  4  sequence geometry and the output prefix sums        [a3]
  5  core bytes: each position's glen bytes at core_pos  [b1, b2]
  6  255-runs of long literal lengths inserted           [c]
     (5 and 6 as one call: emit_ref, the plain version of the fused
     CUDA kernel lz4_emit)

Unsigned 32-bit arithmetic is carried in int64 masked to 32 bits: PyTorch
has no uint32 shifts or compares on the CPU.
"""

from __future__ import annotations

import torch

MIN_MATCH = 4
MIN_MATCH_B = 8      # tier-B verified bytes per sorted-neighbour candidate
ROW = 128
NROWS = 512
BLOCK = ROW * NROWS
W_DEFAULT = 0        # tier-A window; 0 = rely on tier B4, which subsumes it
TAIL_GUARD = 12      # no match may start in the last 12 bytes
END_LITERALS = 5     # the last 5 bytes are always literals
LONG_LIT = 270       # literal runs this long need 255-bytes in their length
HASH_C1 = 0x9E3779B1
HASH_C2 = 0x85EBCA77

# core content of a block is <= 1.25 * BLOCK + 6 bytes; padded to whole rows
CORE_ROWS = 672
CORE_CAP = CORE_ROWS * ROW
# output adds at most 257 bytes of 255-runs
OUT_ROWS = CORE_ROWS + 4
OUT_CAP = OUT_ROWS * ROW

# geometry planes, in the order the CUDA geometry kernel writes them
# (enum GeoPlane in csrc/lz4_stages.cu)
GEO_NAMES = ("kept", "anchor", "mstart", "token", "litrem", "e", "gap255",
             "long_run", "mlc", "ml_ext", "glen", "core_pos", "gap_here",
             "gap_before")

_M32 = 0xFFFFFFFF


def encoder_config() -> dict:
    """The encoder's constants. It has no weights: these fix its output."""
    return dict(MIN_MATCH=MIN_MATCH, MIN_MATCH_B=MIN_MATCH_B, ROW=ROW,
                NROWS=NROWS, BLOCK=BLOCK, W_DEFAULT=W_DEFAULT,
                TAIL_GUARD=TAIL_GUARD, END_LITERALS=END_LITERALS,
                LONG_LIT=LONG_LIT, HASH_C1=HASH_C1, HASH_C2=HASH_C2,
                CORE_ROWS=CORE_ROWS, CORE_CAP=CORE_CAP, OUT_ROWS=OUT_ROWS,
                OUT_CAP=OUT_CAP)


def _pos(device):
    return torch.arange(BLOCK, dtype=torch.int64, device=device)


def _guard(ns):
    """(B, 1) first position where no match may start."""
    return (ns.to(torch.int64) - TAIL_GUARD).clamp(min=0)[:, None]


def _mul32(x, c: int):
    """x * c mod 2**32 for 0 <= x < 2**32, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


# ---------------------------------------------------------------------------
# phases 0-2: candidates and match lengths
# ---------------------------------------------------------------------------

def phase0_words(blocks):
    """blocks (B, BLOCK) uint8 -> (B, BLOCK) int64 little-endian u32 word
    at every position (zero past the block end)."""
    u = blocks.to(torch.int64)
    w = u.clone()
    for k in (1, 2, 3):
        w[:, :-k] |= u[:, k:] << (8 * k)
    return w


def phase1_nearest_offset(words, ns, W: int):
    """so[p] = the smallest o in 1..W with words[p-o] == words[p], else 0
    (tier A); zero from n - TAIL_GUARD on."""
    so = torch.zeros_like(words)
    for o in range(W, 0, -1):          # nearest last, so it wins
        eq = torch.zeros_like(words, dtype=torch.bool)
        eq[:, o:] = words[:, o:] == words[:, :-o]
        so = torch.where(eq, o, so)
    so = torch.where(_pos(words.device) < _guard(ns), so, 0)
    return so.to(torch.int32)


def _next_word(words):
    """The word 4 bytes on: with `words` it covers 8 bytes."""
    w1 = torch.zeros_like(words)
    w1[:, :-4] = words[:, 4:]
    return w1


def tier_b_key(words):
    """Tier-B sort key hash16(8 bytes) << 16 | pos; unique, so the sorted
    order is fully determined."""
    h16 = (_mul32(words, HASH_C1) ^ _mul32(_next_word(words), HASH_C2)) >> 16
    return (h16 << 16) | _pos(words.device)


def tier_b4_key(words):
    """Tier-B4 sort key hash16(4 bytes) << 16 | pos."""
    return ((_mul32(words, HASH_C1) >> 16) << 16) | _pos(words.device)


def sort_keys(key):
    """The plain sort: each row of unique uint32 keys ascending, in the
    key's own carrier (int32 raw bits, or int64 in [0, 2**32))."""
    order = torch.sort(key.to(torch.int64) & _M32, dim=1).indices
    return key.gather(1, order)


def _bits32(x):
    """int64 values in [0, 2**32) as int32 tensors of the same bits."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32)


def candidate_keys(blocks):
    """blocks (B, BLOCK) uint8 -> keys (2, B, BLOCK) int32, the raw bits
    of the uint32 sort keys: keys[0] tier B (hash of 8 bytes), keys[1]
    tier B4 (hash of 4 bytes). The plain version of the kernel lz4_keys."""
    words = phase0_words(blocks)
    return _bits32(torch.stack([tier_b_key(words), tier_b4_key(words)]))


def _probe(skey, swords, k: int):
    """Offset to the k-th predecessor in sorted order where its hash and
    every carried word agree exactly, else 0."""
    pk, cur = skey[:, :-k], skey[:, k:]
    ok = (pk >> 16) == (cur >> 16)
    for sw in swords:
        ok &= sw[:, :-k] == sw[:, k:]
    off = torch.zeros_like(skey)
    off[:, k:] = torch.where(ok, (cur & 0xFFFF) - (pk & 0xFFFF), 0)
    return off


def _unsort(skey, vals, ns):
    """Back to position order (the inverse permutation as a scatter), with
    the tail guard applied."""
    out = torch.zeros_like(vals).scatter_(1, skey & 0xFFFF, vals)
    out = torch.where(_pos(vals.device) < _guard(ns), out, 0)
    return out.to(torch.int32)


def candidate_probe(blocks, skeys, ns):
    """(so8, so4a, so4b) (B, BLOCK) int32 from the sorted keys (2, B,
    BLOCK), each row of candidate_keys ascending as uint32. Each sorted
    entry's offset to the k-th entry before it (k = 1, 2) where the hash
    and the carried bytes (8 for tier B, 4 for B4, zero past the block's
    end) agree: so8 takes k = 1, else k = 2; so4a k = 1; so4b k = 2. Each
    lands at the entry's own position, zero from ns - TAIL_GUARD on. The
    plain version of the kernel lz4_probe."""
    words = phase0_words(blocks)
    sk = skeys.to(torch.int64) & _M32
    kb, k4 = sk[0], sk[1]
    sw8 = [w.gather(1, kb & 0xFFFF) for w in (words, _next_word(words))]
    so8 = _probe(kb, sw8, 1)
    so8 = torch.where(so8 == 0, _probe(kb, sw8, 2), so8)
    sw4 = [words.gather(1, k4 & 0xFFFF)]
    return (_unsort(kb, so8, ns), _unsort(k4, _probe(k4, sw4, 1), ns),
            _unsort(k4, _probe(k4, sw4, 2), ns))


def candidates(blocks, ns):
    """The sorted-neighbour planes (so8, so4a, so4b): both tiers' keys, one
    sort over their 2B rows, the probes."""
    keys = candidate_keys(blocks)
    skeys = sort_keys(keys.view(-1, BLOCK)).view(keys.shape)
    return candidate_probe(blocks, skeys, ns)


def _tier_runs(so, kmin: int):
    """Verified length at each position: kmin plus the count of following
    positions that keep the same offset. Flat across rows and uncapped."""
    so = so.to(torch.int64)
    pos = _pos(so.device)
    diag = so > 0
    diag[:, :-1] &= so[:, 1:] == so[:, :-1]
    diag[:, -1] = False
    brk = torch.where(diag, BLOCK, pos)
    nxt = torch.flip(torch.cummin(torch.flip(brk, [1]), dim=1).values, [1])
    return torch.where(so > 0, nxt - pos + kmin, 0)


def phase2_lengths(so, ns, planes):
    """(mlen, moff) int32. Tier A `so` first, then each (plane, kmin) of
    `planes` in order; a later tier wins only with a strictly longer run.
    Lengths are then capped at the block tail and the row end."""
    mlen = _tier_runs(so, MIN_MATCH)
    moff = so.to(torch.int64)
    for sp, kmin in planes:
        ml = _tier_runs(sp, kmin)
        use = ml > mlen
        mlen = torch.where(use, ml, mlen)
        moff = torch.where(use, sp.to(torch.int64), moff)
    pos = _pos(so.device)
    n = ns.to(torch.int64)[:, None]
    mlen = torch.minimum(mlen, (n - END_LITERALS - pos).clamp(min=0))
    mlen = torch.minimum(mlen, ROW - pos % ROW)
    ok = (mlen >= MIN_MATCH) & (pos < _guard(ns)) & (moff > 0)
    return (torch.where(ok, mlen, 0).to(torch.int32),
            torch.where(ok, moff, 0).to(torch.int32))


def match_lengths_ref(blocks, ns, so8, so4a, so4b, W: int):
    """Plain version of the match kernel: phases 0, 1 (tier A) and 2."""
    words = phase0_words(blocks)
    if W:
        so = phase1_nearest_offset(words, ns, W)
    else:
        so = torch.zeros_like(so8)
    return phase2_lengths(so, ns, ((so4a, MIN_MATCH), (so4b, MIN_MATCH),
                                   (so8, MIN_MATCH_B)))


# ---------------------------------------------------------------------------
# phase 3: parse
# ---------------------------------------------------------------------------

def phase3_parse(mlen):
    """is_start (B, BLOCK) bool: a greedy cursor in each 128-byte row takes
    a match unless the next position's match is more than one byte longer
    (one-step lazy matching)."""
    ml = mlen.reshape(-1, ROW).to(torch.int64)
    R = ml.shape[0]
    rows = torch.arange(R, device=ml.device)
    c = torch.zeros(R, dtype=torch.int64, device=ml.device)
    st = torch.zeros((R, ROW), dtype=torch.bool, device=ml.device)
    for _ in range(ROW):
        cc = c.clamp(max=ROW - 1)
        cur = ml[rows, cc]
        nxt = ml[rows, (cc + 1).clamp(max=ROW - 1)]
        defer = (nxt > cur + 1) & (cc + 1 < ROW)
        take = (c < ROW) & (cur >= MIN_MATCH) & ~defer
        st[rows, cc] |= take
        c = torch.where(take, c + cur, c + 1)
    return st.reshape(mlen.shape)


# ---------------------------------------------------------------------------
# phase 4: geometry
# ---------------------------------------------------------------------------

def _row_next(x):
    """(B, NROWS) -> value of the next row (0 past the last)."""
    out = torch.zeros_like(x)
    out[:, :-1] = x[:, 1:]
    return out


def _row_prev(x):
    out = torch.zeros_like(x)
    out[:, 1:] = x[:, :-1]
    return out


def _row_max(x):
    return x.reshape(x.shape[0], NROWS, ROW).amax(dim=2)


def phase4_geometry(mlen, moff, is_start, ns):
    """Sequence geometry. Returns a dict of (B, BLOCK) int32 planes named
    by GEO_NAMES, plus `core_used` and `used` (B,) int32."""
    B = mlen.shape[0]
    dev = mlen.device
    pos = _pos(dev)
    lane = pos % ROW
    rowi = pos // ROW
    n = ns.to(torch.int64)[:, None]
    mlen = mlen.to(torch.int64)
    moff = moff.to(torch.int64)
    in_range = pos < n
    mstart = is_start & in_range

    # covered: in-row running max of each match's reach (matches are
    # row-capped and never overlap)
    reach = torch.where(mstart, lane + mlen, 0).reshape(B, NROWS, ROW)
    acc = torch.cummax(reach, dim=2).values.reshape(B, BLOCK)
    covered = (lane < acc) & in_range
    kept = in_range & ~covered

    # odd-row continuation: a lane-0 start on an odd row whose previous
    # row's match ends at the row boundary with the same offset emits
    # nothing; the head absorbs its length
    end_m = mstart & (lane + mlen == ROW)
    prev_end_off = _row_prev(_row_max(torch.where(end_m, moff, 0)))[:, rowi]
    cont = (mstart & (lane == 0) & (rowi % 2 == 1) & (prev_end_off > 0)
            & (moff == prev_end_off))
    head = mstart & ~cont
    next_cont_len = _row_next(_row_max(torch.where(cont, mlen, 0)))[:, rowi]
    next_cont_off = _row_next(_row_max(torch.where(cont, moff, 0)))[:, rowi]
    add = torch.where(end_m & head & (moff == next_cont_off)
                      & (next_cont_len > 0), next_cont_len, 0)

    prev_cov = torch.zeros_like(covered)
    prev_cov[:, 1:] = covered[:, :-1]
    anchor = in_range & ((pos == 0) | (prev_cov & (head | ~covered)))

    # next match start at or after p, with its length nibble: suffix max of
    # (BLOCK - pos) * 16 + nib, larger = earlier
    mlc = torch.where(head, mlen + add - MIN_MATCH, 0)
    enc = torch.where(head, (BLOCK - pos) * 16 + mlc.clamp(max=15), 0)
    best = torch.flip(torch.cummax(torch.flip(enc, [1]), dim=1).values, [1])
    has_next = best > 0
    next_start = torch.minimum(
        torch.where(has_next, BLOCK - (best >> 4), n), n)
    next_nib = torch.where(has_next, best & 15, 0)

    L = torch.where(anchor, next_start - pos, 0)
    has_ext = anchor & (L >= 15)
    e = torch.where(has_ext, (L - 15) // 255 + 1, 0)
    gap255 = (e - 1).clamp(min=0)
    litrem = torch.where(has_ext, (L - 15) % 255, 0)
    long_run = anchor & (L >= LONG_LIT)
    ml_ext = head & (mlc >= 15)
    token = torch.where(anchor, (L.clamp(max=15) << 4) | next_nib, 0)

    inj_h = torch.where(anchor, 1 + e.clamp(max=1), 0)
    inj_t = torch.where(head, 2 + ml_ext.to(torch.int64), 0)
    glen = torch.where(in_range, kept.to(torch.int64) + inj_h + inj_t, 0)
    gap_here = torch.where(long_run, gap255, 0)
    core_pos = torch.cumsum(glen, dim=1) - glen
    gap_before = torch.cumsum(gap_here, dim=1) - gap_here
    core_used = glen.sum(dim=1)

    planes = dict(kept=kept, anchor=anchor, mstart=head, token=token,
                  litrem=litrem, e=e, gap255=gap255, long_run=long_run,
                  mlc=mlc, ml_ext=ml_ext, glen=glen, core_pos=core_pos,
                  gap_here=gap_here, gap_before=gap_before)
    geo = {k: planes[k].to(torch.int32) for k in GEO_NAMES}
    geo["core_used"] = core_used.to(torch.int32)
    geo["used"] = (core_used + gap_here.sum(dim=1)).to(torch.int32)
    return geo


# ---------------------------------------------------------------------------
# phases 5 and 6: bytes
# ---------------------------------------------------------------------------

def _put(buf, mask, idx, val):
    """buf[b, idx] = val where mask; the rest lands in the spare last
    column, which the caller drops."""
    spare = buf.shape[1] - 1
    buf.scatter_(1, torch.where(mask, idx, spare), torch.where(mask, val, 0))


def phase5_core(blocks, moff, geo):
    """Gapless core (B, CORE_CAP) uint8: position p's glen bytes at
    core_pos[p], in the order token, litrem, literal, offset lo, offset hi,
    match-length extension; zero from core_used on."""
    B = blocks.shape[0]
    g = {k: geo[k].to(torch.int64) for k in GEO_NAMES}
    anchor, kept = g["anchor"] > 0, g["kept"] > 0
    mstart, ml_ext = g["mstart"] > 0, g["ml_ext"] > 0
    moff = moff.to(torch.int64)
    cp = g["core_pos"]
    lit_off = torch.where(anchor, 1 + g["e"].clamp(max=1), 0)
    t_off = lit_off + g["kept"]
    core = torch.zeros((B, CORE_CAP + 1), dtype=torch.int64,
                       device=blocks.device)
    _put(core, anchor, cp, g["token"])
    _put(core, anchor & (g["e"] >= 1), cp + 1, g["litrem"])
    _put(core, kept, cp + lit_off, blocks.to(torch.int64))
    _put(core, mstart, cp + t_off, moff & 0xFF)
    _put(core, mstart, cp + t_off + 1, moff >> 8)
    _put(core, ml_ext, cp + t_off + 2, g["mlc"] - 15)
    return core[:, :CORE_CAP].to(torch.uint8)


def phase6_expand(core, geo):
    """Insert the 255-runs: each long literal run's gap255 bytes of 255
    follow its token. Returns (out (B, OUT_CAP) uint8, used (B,) int32);
    out is zero from used on."""
    B = core.shape[0]
    dev = core.device
    lr = geo["long_run"] > 0
    cp = geo["core_pos"].to(torch.int64)
    g255 = geo["gap255"].to(torch.int64)
    # a core byte moves right by every gap that starts at or before it
    delta = torch.zeros((B, CORE_CAP + 1), dtype=torch.int64, device=dev)
    delta.scatter_add_(1, torch.where(lr, cp + 1, CORE_CAP),
                       torch.where(lr, g255, 0))
    shift = torch.cumsum(delta[:, :CORE_CAP], dim=1)
    c = torch.arange(CORE_CAP, dtype=torch.int64, device=dev)
    live = c < geo["core_used"].to(torch.int64)[:, None]
    out = torch.zeros((B, OUT_CAP + 1), dtype=torch.int64, device=dev)
    _put(out, live, c + shift, core.to(torch.int64))
    # the gaps themselves: +1 at each start, -1 at each end
    gs = cp + 1 + geo["gap_before"].to(torch.int64)
    edge = torch.zeros((B, OUT_CAP + 1), dtype=torch.int64, device=dev)
    edge.scatter_add_(1, torch.where(lr, gs, OUT_CAP), lr.to(torch.int64))
    edge.scatter_add_(1, torch.where(lr, gs + g255, OUT_CAP),
                      -lr.to(torch.int64))
    in_gap = torch.cumsum(edge[:, :OUT_CAP], dim=1) > 0
    out = torch.where(in_gap, 255, out[:, :OUT_CAP])
    return out.to(torch.uint8), geo["used"]


def emit_ref(blocks, moff, geo):
    """Plain version of the emit kernel: phase 6 of phase 5. Returns
    (out (B, OUT_CAP) uint8, used (B,) int32); out is zero from used on."""
    return phase6_expand(phase5_core(blocks, moff, geo), geo)


def encode_blocks_ref(blocks, ns, W: int):
    """The whole encoder in plain PyTorch. blocks (B, BLOCK) uint8, ns (B,)
    int32 valid lengths. Returns (out (B, OUT_CAP) uint8, used (B,) int32):
    block b's LZ4 bytes are out[b, :used[b]]."""
    so8, so4a, so4b = candidates(blocks, ns)
    mlen, moff = match_lengths_ref(blocks, ns, so8, so4a, so4b, W)
    geo = phase4_geometry(mlen, moff, phase3_parse(mlen), ns)
    return emit_ref(blocks, moff, geo)
