"""The emit stage (lz4_emit on the card) against the JAX package.

`lz4_plane.emit_ref`, the plain version of the fused emit kernel, must
equal tpu7z's phase 5 then phase 6 (the Pallas kernels b1, b2 and c) on
the edges of the kernel's row spans: long literal runs whose token ends
a row, a 255-run that starts right after a row's last position, an
all-random block, blocks whose `used` ends inside a 16-byte word, and the
row-join edge blocks of the other row kernels. The blocks are
chip_smoke.py's `emit_edges` and `patterns`, so the card holds the kernel
against emit_ref on these same inputs. On CPU tensors the wrapper
`lz4_cuda.emit` runs emit_ref. All values are integers, so the tolerance
is exact equality.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from tpu7z.ops import lz4_plane as JP  # noqa: E402
from tpu7z_torch.ops import lz4_cuda  # noqa: E402
from tpu7z_torch.ops import lz4_plane as P  # noqa: E402

WS = (0, 16)
SETS = {"emit_edges": chip_smoke.emit_edges, "patterns": chip_smoke.patterns}
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


@pytest.fixture(scope="module")
def port():
    """Per (set, W): the blocks, moff, the geometry and emit_ref's result."""
    res = {}
    for name, make in SETS.items():
        b, n = make(P.BLOCK)
        blocks, ns = torch.from_numpy(b), torch.from_numpy(n)
        cand = P.candidates(blocks, ns)
        for W in WS:
            mlen, moff = P.match_lengths_ref(blocks, ns, *cand, W)
            geo = P.phase4_geometry(mlen, moff, P.phase3_parse(mlen), ns)
            out, used = P.emit_ref(blocks, moff, geo)
            res[name, W] = dict(blocks=blocks, moff=moff, geo=geo, out=out,
                                used=used)
    return res


@pytest.fixture(scope="module")
def jchain():
    core = jax.jit(JP.phase5_core)
    expand = jax.jit(JP.phase6_expand)
    return lambda block, moff, geo: expand(core(block, moff, geo), geo)


def _plane(x):
    """One block of a port tensor as a JAX (NROWS, ROW) plane."""
    a = x.numpy().reshape(P.NROWS, P.ROW)
    return jnp.asarray(a if a.dtype == np.bool_ else a.astype(np.int32))


def _jgeo(geo, i):
    """Block i of the port's geometry as the JAX phases take it."""
    g = {k: _plane(geo[k][i] > 0) if k in MASKS else _plane(geo[k][i])
         for k in P.GEO_NAMES}
    g["used"] = jnp.int32(int(geo["used"][i]))
    return g


CASES = [(name, W, i) for name in SETS for W in WS
         for i in range(len(SETS[name](P.BLOCK)[1]))]


@pytest.mark.parametrize("name,W,idx", CASES,
                         ids=[f"{s}-W{W}-{i}" for s, W, i in CASES])
def test_emit_ref_equals_jax_phase5_then_6(name, W, idx, port, jchain):
    r = port[name, W]
    block = jnp.asarray(r["blocks"][idx].numpy().astype(np.int32)
                        .reshape(P.NROWS, P.ROW))
    out, used = jchain(block, _plane(r["moff"][idx]), _jgeo(r["geo"], idx))
    u = int(used)
    assert u == int(r["used"][idx])
    assert np.array_equal(np.asarray(out).reshape(-1)[:u].astype(np.int64),
                          r["out"][idx, :u].numpy().astype(np.int64))
    assert not r["out"][idx, u:].any()


@pytest.mark.parametrize("W", WS)
def test_emit_edges_reach_the_span_edges(W, port):
    """The blocks do what they are for (the check chip_smoke.py makes on
    the card before it holds the kernel against emit_ref)."""
    chip_smoke.check_emit_edges(port["emit_edges", W]["geo"])


@pytest.mark.parametrize("W", WS)
@pytest.mark.parametrize("name", SETS)
def test_emit_wrapper_on_cpu_equals_emit_ref(name, W, port):
    r = port[name, W]
    out, used = lz4_cuda.emit(r["blocks"], r["moff"], r["geo"])
    assert out.dtype == torch.uint8 and tuple(out.shape) == tuple(r["out"].shape)
    assert torch.equal(out, r["out"]) and torch.equal(used, r["used"])
    ns = torch.from_numpy(SETS[name](P.BLOCK)[1])
    enc_out, enc_used = lz4_cuda.encode_blocks(r["blocks"], ns, W)
    assert torch.equal(enc_out, out) and torch.equal(enc_used, used)


def test_emit_wrapper_rejects_bad_inputs(port):
    r = port["emit_edges", 0]
    with pytest.raises(TypeError, match="moff"):
        lz4_cuda.emit(r["blocks"], r["moff"].to(torch.int64), r["geo"])
    with pytest.raises(ValueError, match="blocks"):
        lz4_cuda.emit(r["blocks"][:, :100], r["moff"], r["geo"])
    meta = torch.zeros((1, P.BLOCK), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lz4_cuda.emit(meta, torch.zeros((1, P.BLOCK), dtype=torch.int32,
                                        device="meta"), r["geo"])
