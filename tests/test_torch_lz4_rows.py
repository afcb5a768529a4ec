"""Edge blocks of the row kernels' joins, against the JAX package.

lz4_match and lz4_geometry give each warp one 128-byte row and join rows
and lanes through shared summaries. These blocks sit on the edges of
those joins: every row's match ending at the row end (so odd rows
continue) with a length that is no multiple of 4, runs across many rows,
one row and a byte, three bytes, nothing. On CPU tensors the wrappers run
the plain versions (tpu7z_torch.ops.lz4_plane); they are held, phase by
phase and whole, against tpu7z's plane math (jnp on the CPU) and its
numpy twin. All values are integers, so the tolerance is exact equality.
The same blocks are in chip_smoke.py's patterns, where the kernels are
held against these plain versions on the card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from tpu7z.models.lz4 import block as jblock  # noqa: E402
from tpu7z.ops import lz4_plane as JP  # noqa: E402
from tpu7z.ops import lz4_twin2 as T  # noqa: E402
from tpu7z_torch.models.lz4 import block as tblock  # noqa: E402
from tpu7z_torch.ops import lz4_cuda  # noqa: E402
from tpu7z_torch.ops import lz4_plane as P  # noqa: E402

WS = (0, 16)
NAMES = ("period128_n65533", "period384_n4099", "text_n129", "text_n3",
         "empty")
MASKS = ("kept", "anchor", "mstart", "long_run", "ml_ext")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several worker processes at once; one intra-op
    thread each keeps PyTorch's thread pools from contending for the
    cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _edge_blocks():
    """(bytes zero padded to BLOCK, n) in NAMES order; built as
    chip_smoke.py's patterns() builds them."""
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
def batch():
    pats = _edge_blocks()
    blocks = np.stack([np.frombuffer(d, np.uint8) for d, _ in pats])
    ns = np.array([n for _, n in pats], np.int32)
    return blocks, ns


@pytest.fixture(scope="module")
def port(batch):
    """The plain chain's intermediates for the whole batch, per W."""
    blocks = torch.from_numpy(batch[0])
    ns = torch.from_numpy(batch[1])
    words = P.phase0_words(blocks)
    so8, so4a, so4b = P.candidates(blocks, ns)
    res = {"words": words, "cand": (so8, so4a, so4b)}
    for W in WS:
        mlen, moff = P.match_lengths_ref(blocks, ns, so8, so4a, so4b, W)
        st = P.phase3_parse(mlen)
        geo = P.phase4_geometry(mlen, moff, st, ns)
        core = P.phase5_core(blocks, moff, geo)
        out, used = P.phase6_expand(core, geo)
        res[W] = dict(mlen=mlen, moff=moff, st=st, geo=geo, core=core,
                      out=out, used=used)
    return res


def _a1(v, n, so8, so4a, so4b, W):
    so = JP.phase1_nearest_offset(v, n, W) if W else jnp.zeros_like(v)
    return JP.phase2_lengths(so, n, so8, extra_planes=((so4a, 4), (so4b, 4)))


@pytest.fixture(scope="module")
def jfn():
    return dict(words=jax.jit(JP.phase0_words),
                tier_b=jax.jit(JP.tier_b_candidates),
                tier_b4=jax.jit(JP.tier_b4_candidates),
                a1=jax.jit(_a1, static_argnames="W"),
                parse=jax.jit(JP.phase3_parse),
                geo=jax.jit(JP.phase4_geometry),
                core=jax.jit(JP.phase5_core),
                expand=jax.jit(JP.phase6_expand))


def _plane(x):
    """One block of a port tensor as a JAX (NROWS, ROW) plane."""
    a = x.numpy().reshape(P.NROWS, P.ROW)
    return jnp.asarray(a if a.dtype == np.bool_ else a.astype(np.int32))


def _block_plane(batch, idx):
    return jnp.asarray(batch[0][idx].astype(np.int32).reshape(P.NROWS, P.ROW))


def _flat(x):
    return np.asarray(x).reshape(-1).astype(np.int64)


def _jgeo(geo, i):
    """Block i of the port's geometry as the JAX phases take it."""
    g = {k: _plane(geo[k][i] > 0) if k in MASKS else _plane(geo[k][i])
         for k in P.GEO_NAMES}
    g["used"] = jnp.int32(int(geo["used"][i]))
    return g


cases = pytest.mark.parametrize("W,idx", [(W, i) for W in WS
                                          for i in range(len(NAMES))],
                                ids=[f"W{W}-{k}" for W in WS for k in NAMES])


@pytest.mark.parametrize("idx", range(len(NAMES)), ids=NAMES)
def test_words_and_candidates(idx, batch, port, jfn):
    jv = jfn["words"](_block_plane(batch, idx))
    assert np.array_equal(np.asarray(jv).reshape(-1).view(np.uint32),
                          port["words"][idx].numpy().astype(np.uint32))
    ns = jnp.asarray(batch[1][idx:idx + 1])
    so8 = jfn["tier_b"](jv.reshape(1, -1), ns)
    so4a, so4b = jfn["tier_b4"](jv.reshape(1, -1), ns)
    for j, ref in zip(port["cand"], (so8, so4a, so4b)):
        assert np.array_equal(_flat(ref), j[idx].numpy())


@cases
def test_match_lengths(W, idx, batch, port, jfn):
    n = jnp.int32(int(batch[1][idx]))
    so = [_plane(c[idx]) for c in port["cand"]]
    mlen, moff = jfn["a1"](jfn["words"](_block_plane(batch, idx)), n, *so,
                           W=W)
    assert np.array_equal(_flat(mlen), port[W]["mlen"][idx].numpy())
    assert np.array_equal(_flat(moff), port[W]["moff"][idx].numpy())


@cases
def test_parse(W, idx, port, jfn):
    st = jfn["parse"](_plane(port[W]["mlen"][idx]))
    assert np.array_equal(np.asarray(st).reshape(-1),
                          port[W]["st"][idx].numpy())


@cases
def test_geometry(W, idx, batch, port, jfn):
    r = port[W]
    geo = jfn["geo"](_plane(r["mlen"][idx]), _plane(r["moff"][idx]),
                     _plane(r["st"][idx]), jnp.int32(int(batch[1][idx])))
    for k in P.GEO_NAMES:
        assert np.array_equal(_flat(geo[k]), r["geo"][k][idx].numpy()), k
    assert int(geo["core_used"]) == int(r["geo"]["core_used"][idx])
    assert int(geo["used"]) == int(r["geo"]["used"][idx])


@cases
def test_core(W, idx, batch, port, jfn):
    r = port[W]
    core = jfn["core"](_block_plane(batch, idx), _plane(r["moff"][idx]),
                       _jgeo(r["geo"], idx))
    k = int(r["geo"]["core_used"][idx])
    assert np.array_equal(_flat(core)[:k], r["core"][idx, :k].numpy())
    assert not r["core"][idx, k:].any()


@cases
def test_expand(W, idx, port, jfn):
    r = port[W]
    core = jnp.asarray(r["core"][idx].numpy().astype(np.int32)
                       .reshape(P.CORE_ROWS, P.ROW))
    out, used = jfn["expand"](core, _jgeo(r["geo"], idx))
    u = int(used)
    assert u == int(r["used"][idx])
    assert np.array_equal(_flat(out)[:u], r["out"][idx, :u].numpy())
    assert not r["out"][idx, u:].any()


@cases
def test_encoder_matches_twin_and_roundtrips(W, idx, batch):
    blocks = torch.from_numpy(batch[0][idx:idx + 1].copy())
    ns = torch.from_numpy(batch[1][idx:idx + 1].copy())
    out, used = lz4_cuda.encode_blocks(blocks, ns, W)
    got = out[0, :int(used[0])].numpy().tobytes()
    n = int(batch[1][idx])
    assert got == T.encode_block(batch[0][idx].astype(np.int64), n, W=W)
    raw = batch[0][idx, :n].tobytes()
    assert jblock.decompress_block(got, dst_size=n) == raw
    assert tblock.decompress_block(got, dst_size=n) == raw


def test_edge_blocks_reach_the_joins(port):
    """The blocks do what they are for. In the 128-byte period every odd
    row from row 3 on starts with a continuation, which the head before it
    absorbs (mlc past the row); in the 384-byte period matches span whole
    rows, from the second period to the last full row before n."""
    i128, i384 = NAMES.index("period128_n65533"), NAMES.index("period384_n4099")
    for W in WS:
        r = port[W]
        st = r["st"][i128].reshape(P.NROWS, P.ROW)
        head = r["geo"]["mstart"][i128].reshape(P.NROWS, P.ROW)
        assert bool(st[1::2, 0].all()) and not bool(head[3::2, 0].any())
        assert int(r["geo"]["mlc"][i128].max()) > P.ROW
        rows = r["mlen"][i384][384:3968].reshape(-1, P.ROW)
        assert bool((rows[:, 0] == P.ROW).all())
