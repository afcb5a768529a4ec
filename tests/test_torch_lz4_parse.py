"""The parse's walk, against the JAX package.

lz4_parse (csrc/lz4_stages.cu) gives each group of 4 lanes one
128-position row, eight rows a warp. It turns the row's mlen into take
flags, tables for each position the next take at or after it, and walks
from one match start to the next: the first start at or after the cursor
is the first take at or after it. `walk` below is that algorithm in numpy,
step for step. It, the port's plain `lz4_plane.phase3_parse` and the
wrapper `lz4_cuda.parse` on the CPU are held against
`tpu7z.ops.lz4_plane.phase3_parse` (jitted on the CPU) on the synthetic
mlen planes of `tpu7z_torch.utils.parse_planes`, the planes chip_smoke.py
holds the kernel to on the card, and on the mlen of the row-join edge
blocks of tests/test_torch_lz4_rows.py. Every value is an integer, so the tolerance
is exact equality.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tpu7z.ops import lz4_plane as JP  # noqa: E402
from tpu7z_torch.ops import lz4_cuda  # noqa: E402
from tpu7z_torch.ops import lz4_plane as P  # noqa: E402
from tpu7z_torch.utils.parse_planes import parse_planes  # noqa: E402

ROW = P.ROW
PLANES = ("random_capped", "uncapped", "defer_chains", "fours", "zeros",
          "take_at_127", "ends_at_row_end", "alternating")
EDGE_NAMES = ("period128_n65533", "period384_n4099", "text_n129", "text_n3",
              "empty")
WS = (0, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread each keeps PyTorch's thread pools from contending for the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


NO_TAKE = 0xFF80  # t 255, cursor ROW: above every real entry
SPANS, LANES, LANE_POS = 8, 4, 4  # position 16k + 4i + j: span k, lane i, j
SPAN = LANES * LANE_POS


def walk(mlen):
    """is_start as lz4_parse computes it, a group of LANES lanes a row:
    take flags; for each position the next take t at or after it with
    the cursor after t, packed as t << 8 | min(t + mlen[t], ROW), in the
    lane's 4 positions of a span, then from the lanes above in the span,
    then from the later spans; two 16-bit entries a register; then the
    walk from one start to the next."""
    ml = np.asarray(mlen).astype(np.int64).reshape(-1, ROW)
    R = ml.shape[0]
    after = np.zeros_like(ml)
    after[:, :-1] = ml[:, 1:]
    pos = np.arange(ROW)
    has_next = pos + 1 < ROW
    take = (ml >= P.MIN_MATCH) & ~(has_next & (after > ml + 1))
    packed = np.where(take, pos << 8 | (pos + np.minimum(ml, ROW - pos)), NO_TAKE)
    e = packed.reshape(R, SPANS, LANES, LANE_POS)
    e = np.minimum.accumulate(e[..., ::-1], axis=3)[..., ::-1]
    incl = np.minimum.accumulate(e[..., 0][..., ::-1], axis=2)[..., ::-1]  # (R, SPANS, LANES)
    above = np.full_like(incl, NO_TAKE)
    above[..., :-1] = incl[..., 1:]
    later = np.full((R, SPANS), NO_TAKE, np.int64)
    later[:, :-1] = np.minimum.accumulate(incl[..., 0][:, ::-1], axis=1)[:, ::-1][:, 1:]
    e = np.minimum(e, np.minimum(above, later[..., None])[..., None])
    tab = e[..., 0::2] | e[..., 1::2] << 16  # (R, SPANS, LANES, 2)
    st = np.zeros((R, ROW), np.uint8)
    rows = np.arange(R)
    c = np.zeros(R, np.int64)
    for _ in range(ROW):  # at most 32 starts; the bound makes the end evident
        if not (c < ROW).any():
            break
        # a row whose walk has ended reads NO_TAKE: t 255 marks nothing
        cc = np.minimum(c, ROW - 1)
        got = tab[rows, cc // SPAN, (cc >> 2) % LANES, (cc >> 1) & 1]
        v = np.where(c < ROW, np.where(cc & 1, got >> 16, got & 0xFFFF), NO_TAKE)
        t = v >> 8
        st[rows[t < ROW], t[t < ROW]] = 1
        c = v & 0xFF
    return st.reshape(np.shape(mlen)).astype(bool)


@pytest.fixture(scope="module")
def planes():
    return parse_planes()


@pytest.fixture(scope="module")
def jparse():
    return jax.jit(JP.phase3_parse)


def _jax_parse(jparse, mlen):
    """tpu7z's parse of each (NROWS, ROW) block of a (B, BLOCK) plane."""
    return np.stack([np.asarray(jparse(jnp.asarray(b.reshape(P.NROWS, ROW))))
                     .reshape(-1) for b in np.asarray(mlen)])


IMPLS = {
    "walk": walk,
    "plain": lambda m: P.phase3_parse(torch.from_numpy(m)).numpy(),
    "wrapper": lambda m: lz4_cuda.parse(torch.from_numpy(m)).numpy(),
}


@pytest.mark.parametrize("impl", list(IMPLS))
@pytest.mark.parametrize("name", PLANES)
def test_parse_synthetic(name, impl, planes, jparse):
    mlen = planes[name]
    got = IMPLS[impl](mlen)
    assert got.dtype == np.bool_ and got.shape == mlen.shape
    assert np.array_equal(got, _jax_parse(jparse, mlen))


def test_synthetic_planes_reach_their_edges(planes):
    """Each plane does what it is for."""
    assert set(planes) == {*PLANES, "int32_extremes"}
    assert all(v.dtype == np.int32 and v.shape == (2, P.BLOCK) for v in planes.values())
    st = {k: walk(v).reshape(-1, ROW) for k, v in planes.items()}
    assert (st["fours"].sum(1) == 32).all()
    assert not st["zeros"].any()
    assert (st["take_at_127"][:, 127]).all() and st["take_at_127"].sum() == len(st["take_at_127"])
    assert (st["alternating"][:, 1::4]).all() and st["alternating"].sum() == 32 * len(st["alternating"])
    # the row that is one defer chain takes only its last position
    assert st["defer_chains"][0].nonzero()[0].tolist() == [127]
    ml = planes["ends_at_row_end"].reshape(-1, ROW)
    last = ROW - 1 - np.argmax(st["ends_at_row_end"][:, ::-1], axis=1)
    assert (last + ml[np.arange(len(ml)), last] == ROW).all()
    uc = planes["uncapped"].reshape(-1, ROW)
    assert (uc.min() == -1 and uc.max() == 256
            and (st["uncapped"] & (np.arange(ROW) + uc > ROW)).any())


def test_parse_int32_extremes(planes):
    """Any int32 plane: values at and near both ends of the range, where
    mlen[c] + 1 and c + mlen[c] leave int32. The walk and the wrapper equal
    the plain version, which works in int64 (tpu7z's works in int32 and
    wraps, so it is not the reference here)."""
    mlen = planes["int32_extremes"]
    i32 = np.iinfo(np.int32)
    assert mlen.min() == i32.min and mlen.max() == i32.max
    want = P.phase3_parse(torch.from_numpy(mlen)).numpy()
    assert want.any()
    assert np.array_equal(walk(mlen), want)
    assert np.array_equal(lz4_cuda.parse(torch.from_numpy(mlen)).numpy(), want)


def _edge_blocks():
    """(bytes zero padded to BLOCK, n) in EDGE_NAMES order; built as
    tests/test_torch_lz4_rows.py and chip_smoke.py's patterns() build
    them."""
    rng = np.random.default_rng(7)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"zstd ", b"tpu "]
    text = b"".join(words[i] for i in rng.integers(0, 6, 14000))[:P.BLOCK]
    r2 = np.random.default_rng(3)
    p128 = np.tile(r2.integers(0, 256, 128, dtype=np.uint8),
                   P.BLOCK // 128).tobytes()
    p384 = np.tile(r2.integers(0, 256, 384, dtype=np.uint8),
                   P.BLOCK // 384 + 1).tobytes()
    return [(d[:n].ljust(P.BLOCK, b"\0"), n)
            for d, n in ((p128, 65533), (p384, 4099), (text, 129), (text, 3),
                         (b"", 0))]


@pytest.fixture(scope="module")
def edge_mlen():
    """W -> the edge blocks' mlen (B, BLOCK) int32, from the plain chain."""
    pats = _edge_blocks()
    blocks = torch.from_numpy(np.stack([np.frombuffer(d, np.uint8) for d, _ in pats]))
    ns = torch.tensor([n for _, n in pats], dtype=torch.int32)
    cand = P.candidates(blocks, ns)
    return {W: P.match_lengths_ref(blocks, ns, *cand, W)[0].numpy() for W in WS}


@pytest.mark.parametrize("W,idx", [(W, i) for W in WS for i in range(len(EDGE_NAMES))],
                         ids=[f"W{W}-{k}" for W in WS for k in EDGE_NAMES])
def test_walk_edge_blocks(W, idx, edge_mlen, jparse):
    mlen = edge_mlen[W][idx:idx + 1]
    assert np.array_equal(walk(mlen), _jax_parse(jparse, mlen))
