"""The port's LZ4 device block encoder against the JAX package.

On CPU tensors every wrapper of tpu7z_torch.ops.lz4_cuda runs its plain
PyTorch version (tpu7z_torch.ops.lz4_plane). Those are held, phase by
phase and whole, against tpu7z's plane math (jnp on the CPU), its Pallas
chain in interpret mode and its numpy twin. All values are integers, so
the tolerance is exact equality.
"""

import re
from pathlib import Path

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
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

WS = (0, 16)
NAMES = ("text", "zeros_mid", "far", "random", "short", "corpus", "zeros")
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


def _patterns():
    """Blocks that exercise every phase: literals, near and far matches,
    long literal runs (255-runs), row-boundary merges, a short block, real
    corpus bytes and one giant run. The first five are those of
    tests/test_lz4_kernel.py."""
    rng = np.random.default_rng(7)
    words = [b"alpha ", b"beta ", b"gamma ", b"delta ", b"zstd ", b"tpu "]
    text = b"".join(words[i] for i in rng.integers(0, 6, 14000))[:P.BLOCK]
    zeros_mid = bytearray(rng.integers(0, 256, P.BLOCK, dtype=np.uint8))
    zeros_mid[1000:9000] = b"\x00" * 8000
    far = bytearray(rng.integers(0, 256, P.BLOCK, dtype=np.uint8))
    far[40000:40600] = far[2000:2600]               # 38K offset: tier B only
    rand = rng.integers(0, 256, P.BLOCK, dtype=np.uint8).tobytes()
    return [(bytes(text.ljust(P.BLOCK, b" ")), P.BLOCK),
            (bytes(zeros_mid), P.BLOCK),
            (bytes(far), P.BLOCK),
            (rand, P.BLOCK),
            (bytes(text[:50000]).ljust(P.BLOCK, b"\x00"), 50000),
            (make_corpus(P.BLOCK), P.BLOCK),
            (bytes(P.BLOCK), P.BLOCK)]


@pytest.fixture(scope="module")
def batch():
    pats = _patterns()
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
    res = {}
    for W in WS:
        mlen, moff = P.match_lengths_ref(blocks, ns, so8, so4a, so4b, W)
        st = P.phase3_parse(mlen)
        geo = P.phase4_geometry(mlen, moff, st, ns)
        core = P.phase5_core(blocks, moff, geo)
        out, used = P.phase6_expand(core, geo)
        res[W] = dict(mlen=mlen, moff=moff, st=st, geo=geo, core=core,
                      out=out, used=used)
    res["words"] = words
    res["cand"] = (so8, so4a, so4b)
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
    plane = jnp.asarray(batch[0][idx].astype(np.int32).reshape(P.NROWS, P.ROW))
    jv = jfn["words"](plane)
    assert np.array_equal(np.asarray(jv).reshape(-1).view(np.uint32),
                          port["words"][idx].numpy().astype(np.uint32))
    ns = jnp.asarray(batch[1][idx:idx + 1])
    so8 = jfn["tier_b"](jv.reshape(1, -1), ns)
    so4a, so4b = jfn["tier_b4"](jv.reshape(1, -1), ns)
    for j, ref in zip(port["cand"], (so8, so4a, so4b)):
        assert np.array_equal(_flat(ref), j[idx].numpy())


def _edge_blocks():
    """The candidate stage's edges: text cut to lengths about the tail
    guard (ns - 12) and a whole block, an all-zero block (every hash ties,
    so the order is by position alone) and a block whose last 8 bytes are
    non-zero (its last windows reach the zero words past the end)."""
    text = _patterns()[0][0]
    blocks = [(text[:n].ljust(P.BLOCK, b"\0"), n) for n in (0, 11, 12, 13, P.BLOCK)]
    tail = bytearray(text)
    tail[1000:1008] = b"abcd\0\0\0\0"
    tail[2000:2008] = b"abcdabcd"
    tail[-8:] = b"abcdabcd"
    return blocks + [(bytes(P.BLOCK), P.BLOCK), (bytes(tail), P.BLOCK)]


EDGE_NAMES = ("n0", "n11", "n12", "n13", "n65536", "all_zero", "last8_nonzero")
ALL_NAMES = NAMES + EDGE_NAMES


@pytest.fixture(scope="module")
def edge_batch():
    pats = _edge_blocks()
    return (np.stack([np.frombuffer(d, np.uint8) for d, _ in pats]),
            np.array([n for _, n in pats], np.int32))


def _one(batch, edge_batch, idx):
    """Block idx of ALL_NAMES as (1, BLOCK) uint8 and (1,) int32 tensors."""
    blocks, ns = batch if idx < len(NAMES) else edge_batch
    i = idx % len(NAMES) if idx < len(NAMES) else idx - len(NAMES)
    return (torch.from_numpy(blocks[i:i + 1].copy()),
            torch.from_numpy(ns[i:i + 1].copy()))


def _int64_tiers(blocks, ns):
    """The candidate stage as the port ran it on int64 planes before its
    kernels: each tier's keys, sorted with their words gathered into that
    order, the K = 2 probes, the unsort by scatter, the tail guard. Returns
    the two key planes and (so8, so4a, so4b)."""
    words = P.phase0_words(blocks)
    nxt = torch.zeros_like(words)
    nxt[:, :-4] = words[:, 4:]
    pos = torch.arange(P.BLOCK)
    keep = pos < (ns.to(torch.int64) - P.TAIL_GUARD).clamp(min=0)[:, None]

    def probe(skey, sw, k):
        ok = (skey[:, :-k] >> 16) == (skey[:, k:] >> 16)
        for w in sw:
            ok &= w[:, :-k] == w[:, k:]
        off = torch.zeros_like(skey)
        off[:, k:] = torch.where(ok, (skey[:, k:] & 0xFFFF) - (skey[:, :-k] & 0xFFFF), 0)
        return off

    def unsort(skey, vals):
        out = torch.zeros_like(vals).scatter_(1, skey & 0xFFFF, vals)
        return torch.where(keep, out, 0).to(torch.int32)

    kb, k4 = P.tier_b_key(words), P.tier_b4_key(words)
    sb = torch.sort(kb, dim=1, stable=True).values
    s4 = torch.sort(k4, dim=1, stable=True).values
    sw8 = [w.gather(1, sb & 0xFFFF) for w in (words, nxt)]
    sw4 = [words.gather(1, s4 & 0xFFFF)]
    so8 = probe(sb, sw8, 1)
    so8 = torch.where(so8 == 0, probe(sb, sw8, 2), so8)
    return (kb, k4), (unsort(sb, so8), unsort(s4, probe(s4, sw4, 1)),
                      unsort(s4, probe(s4, sw4, 2)))


every_block = pytest.mark.parametrize("idx", range(len(ALL_NAMES)), ids=ALL_NAMES)


@every_block
def test_candidate_keys_equal_int64_keys(idx, batch, edge_batch):
    blocks, ns = _one(batch, edge_batch, idx)
    keys = P.candidate_keys(blocks)
    assert keys.dtype == torch.int32 and tuple(keys.shape) == (2, 1, P.BLOCK)
    for got, want in zip(keys, _int64_tiers(blocks, ns)[0]):
        assert torch.equal(got.to(torch.int64) & 0xFFFFFFFF, want)


@every_block
def test_candidate_probe_equals_int64_path(idx, batch, edge_batch):
    blocks, ns = _one(batch, edge_batch, idx)
    keys = P.candidate_keys(blocks)
    skeys = P.sort_keys(keys.view(-1, P.BLOCK)).view(keys.shape)
    got = P.candidate_probe(blocks, skeys, ns)
    for g, w in zip(got, _int64_tiers(blocks, ns)[1]):
        assert g.dtype == torch.int32 and torch.equal(g, w)


@pytest.mark.parametrize("idx", range(len(EDGE_NAMES)), ids=EDGE_NAMES)
def test_candidates_on_edges_equal_int64_path_and_tpu7z(idx, batch, edge_batch, jfn):
    """The composition (keys, one sort of both tiers' rows, probe), plain
    and through the wrapper, against the int64 path and tpu7z's tiers."""
    blocks, ns = _one(batch, edge_batch, len(NAMES) + idx)
    got = P.candidates(blocks, ns)
    _, want = _int64_tiers(blocks, ns)
    wrapped = lz4_cuda.candidates(blocks, ns)
    jv = jfn["words"](jnp.asarray(blocks.numpy()[0].astype(np.int32).reshape(P.NROWS, P.ROW)))
    jns = jnp.asarray(ns.numpy())
    jtiers = (jfn["tier_b"](jv.reshape(1, -1), jns),) + tuple(
        jfn["tier_b4"](jv.reshape(1, -1), jns))
    for g, w, k, j in zip(got, want, wrapped, jtiers):
        assert torch.equal(g, w) and torch.equal(k, w)
        assert np.array_equal(_flat(j), w[0].numpy())
    if int(ns[0]) <= P.TAIL_GUARD:
        assert not any(bool(g.any()) for g in got)


@cases
def test_match_lengths(W, idx, batch, port, jfn):
    plane = jnp.asarray(batch[0][idx].astype(np.int32).reshape(P.NROWS, P.ROW))
    n = jnp.int32(int(batch[1][idx]))
    so = [_plane(c[idx]) for c in port["cand"]]
    mlen, moff = jfn["a1"](jfn["words"](plane), n, *so, W=W)
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
    plane = jnp.asarray(batch[0][idx].astype(np.int32).reshape(P.NROWS, P.ROW))
    core = jfn["core"](plane, _plane(r["moff"][idx]), _jgeo(r["geo"], idx))
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


def test_encoder_matches_pallas_interpret(batch):
    """The whole encoder equals the Pallas chain run in interpret mode, on
    one batch with a full and a short block."""
    from tpu7z.ops import lz4_pallas
    pick = [NAMES.index("text"), NAMES.index("short")]
    blocks, ns = batch[0][pick], batch[1][pick]
    W = 16
    jout, jused = lz4_pallas.encode_blocks(jnp.asarray(blocks),
                                           jnp.asarray(ns), W=W,
                                           interpret=True)
    out, used = lz4_cuda.encode_blocks(torch.from_numpy(blocks),
                                       torch.from_numpy(ns), W)
    assert np.array_equal(np.asarray(jused), used.numpy())
    for b in range(len(pick)):
        u = int(used[b])
        assert np.array_equal(np.asarray(jout)[b, :u].view(np.uint8),
                              out[b, :u].numpy())


CORPUS_BLOCKS = 16   # the corpus's first 1 MiB


@pytest.fixture(scope="module")
def corpus_mib():
    """The corpus's first 1 MiB as 16 full blocks, encoded at W = 0 by the
    port (`encode_blocks`, its plain version on the CPU) and by tpu7z's
    plane encoder mapped over the blocks, as bench.py's CPU child encodes
    them: (data, (out, used) of the port, (out, used) of tpu7z)."""
    N = P.BLOCK
    data = make_corpus(32 << 20)[:CORPUS_BLOCKS * N]
    blocks = np.frombuffer(data, np.uint8).reshape(CORPUS_BLOCKS, N)
    out, used = lz4_cuda.encode_blocks(torch.from_numpy(blocks.copy()),
                                       torch.full((CORPUS_BLOCKS,), N, dtype=torch.int32), 0)
    planes = jnp.asarray(blocks).reshape(CORPUS_BLOCKS, JP.NROWS, JP.ROW).astype(jnp.int32)

    @jax.jit
    def encode(planes, ns):
        outs, useds = jax.lax.map(lambda a: JP.encode_block_planes(a[0], a[1], W=0),
                                  (planes, ns))
        return outs.reshape(CORPUS_BLOCKS, -1), useds

    jout, jused = encode(planes, jnp.full((CORPUS_BLOCKS,), N, jnp.int32))
    return data, (out.numpy(), used.numpy()), (np.asarray(jout), np.asarray(jused))


@pytest.mark.parametrize("b", range(CORPUS_BLOCKS))
def test_encode_blocks_equals_tpu7z_on_the_corpus(b, corpus_mib):
    _, (out, used), (jout, jused) = corpus_mib
    u = int(used[b])
    assert u == int(jused[b])
    assert np.array_equal(out[b, :u], jout[b, :u].astype(np.uint8))


def test_corpus_ratio_equals_bench_py_formula_on_tpu7z(corpus_mib):
    """bench.py's ratio over the same 16 blocks: comp_total = sum(min(used,
    N + 4)), each block at most its stored size and its 4-byte size word;
    the port's and tpu7z's agree, and the corpus compresses."""
    data, (_, used), (_, jused) = corpus_mib
    comp_total, jcomp_total = (int(np.minimum(u.astype(np.int64), P.BLOCK + 4).sum())
                               for u in (used, jused))
    assert comp_total == jcomp_total < len(data)
    assert round(len(data) / comp_total, 3) == round(len(data) / jcomp_total, 3) > 1


def test_encoder_config_matches_tpu7z():
    cfg = P.encoder_config()
    assert cfg == {k: getattr(JP, k) for k in cfg}


def test_geometry_plane_order_matches_kernel_source():
    src = (Path(P.__file__).parent.parent / "csrc" / "lz4_stages.cu").read_text()
    body = re.search(r"enum GeoPlane \{([^}]*)\}", src).group(1)
    names = [s.strip() for s in body.split(",") if s.strip()]
    assert names[-1] == "G_NPLANES"
    assert names[:-1] == ["G_" + k.upper() for k in P.GEO_NAMES]


def test_wrappers_reject_bad_inputs():
    blocks = torch.zeros((1, P.BLOCK), dtype=torch.uint8)
    ns = torch.full((1,), P.BLOCK, dtype=torch.int32)
    with pytest.raises(TypeError):
        lz4_cuda.encode_blocks(blocks.to(torch.int32), ns)
    with pytest.raises(ValueError):
        lz4_cuda.encode_blocks(blocks[:, :100], ns)
    with pytest.raises(TypeError):
        lz4_cuda.parse(torch.zeros((1, P.BLOCK), dtype=torch.int64))
    with pytest.raises(ValueError):
        lz4_cuda.parse(torch.zeros((1, 2 * P.BLOCK), dtype=torch.int32)[:, ::2])
    for bad in (-1, P.BLOCK + 1):
        with pytest.raises(ValueError, match="ns"):
            lz4_cuda.encode_blocks(blocks, torch.full((1,), bad, dtype=torch.int32))


def test_wrappers_take_the_plain_version_only_on_the_cpu():
    """A tensor on any device but the CPU goes to a kernel or raises; it
    never reaches the plain version."""
    mlen = torch.zeros((1, P.BLOCK), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lz4_cuda.parse(mlen)
