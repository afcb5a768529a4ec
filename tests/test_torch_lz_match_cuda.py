"""The shared LZ matcher's exact match lengths on the card
(tpu7z_torch/csrc/lz_match.cu through `hash_chain.match_lengths`) against
its plain version, `hash_chain.match_lengths_ref`, run on the card too,
and against tpu7z's `_match_lengths` (tpu7z/models/lz4/block.py, numpy
alone) on the host: at every caller's shape (gzip's 4 MiB with lengths up
to 258, LZMA's MATCH_MAX 273, LZ4's tensor parse with limits to the end
of a 4 MiB zero run and of 4 MiB of random bytes) and on edge inputs
(`edge_cases`, which `tests/test_torch_lz_matcher.py` also holds against
tpu7z through the plain version on the CPU). The tests marked `card` run
on a CUDA card and skip here:

    python -m pytest tests/test_torch_lz_match_cuda.py -m card --noconftest -q

(`--noconftest`: `tests/conftest.py` imports JAX, which this file does not
need; it imports nothing from `tests` either.) Everything compared is
integers, so equality is exact."""

import numpy as np
import pytest
import torch

from tpu7z.models.lz4 import block as jblock
from tpu7z_torch.models.deflate import codec
from tpu7z_torch.models.lz4 import block
from tpu7z_torch.models.lzma import encoder
from tpu7z_torch.ops import hash_chain
from tpu7z_torch.utils import trace
from tpu7z_torch.utils.corpus import make_corpus

TEXT = 696156            # the corpus's first byte past its sparse chunk
SPLIT = 16 + 8 * 512     # csrc/lz_match.cu: an end still equal past this byte is queued
PANEL_READS = {"read.lz_chain_ends", "read.lz_panel_rows", "read.lz_panel_pass"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def _detached():
    trace.detach()
    trace.clear()
    yield
    trace.detach()
    trace.clear()


def _candidates(s):
    """(pos, cand): every position with a verified depth-1 candidate, from
    the port's own candidates on the CPU."""
    cand = hash_chain.find_candidates(torch.from_numpy(s)).numpy()
    pos = np.nonzero(cand >= 0)[0].astype(np.int64)
    return pos, cand[pos]


def edge_cases():
    """name -> (s, pos, cand, limit) as numpy arrays (uint8, int64 x 3):
    an empty `pos`; limits under 4; positions up to n - 4 with limits to
    the end; a chain end whose successor has a nearer candidate (a 3000-byte
    block repeated with a copy of its second half in between); a bound long
    enough to be split (the same with a 20000-byte block, so that a chain
    end's common prefix runs past SPLIT bytes); that input's entries in a
    shuffled order."""
    rng = np.random.default_rng(27)
    out = {}
    s = rng.integers(0, 256, 64, np.uint8)
    empty = np.zeros(0, np.int64)
    out["empty"] = (s, empty, empty, empty)
    s = np.resize(np.array([7, 1, 200], np.uint8), 600)
    pos, cand = _candidates(s)
    out["limits_under_4"] = (s, pos, cand, pos % 4)
    s = np.zeros(40, np.uint8)
    pos, cand = _candidates(s)
    assert pos[-1] == s.size - 4
    out["at_n_minus_4"] = (s, pos, cand, s.size - pos)
    for name, size in (("past_a_chain_end", 3000), ("split", 20000)):
        a = rng.integers(0, 256, size, np.uint8)
        s = np.concatenate([a, a[size // 2:], rng.integers(0, 256, 40, np.uint8), a, a[:100]])
        pos, cand = _candidates(s)
        out[name] = (s, pos, cand, (s.size - 5) - pos)
    s, pos, cand, limit = out["split"]
    order = rng.permutation(pos.size)
    out["shuffled"] = (s, pos[order], cand[order], limit[order])
    return out


EDGES = list(edge_cases())


def _on(dev, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def _same(args):
    """The kernel's lengths and the plain version's, over one call's
    arguments on the card."""
    got = hash_chain.match_lengths(*args)
    want = hash_chain.match_lengths_ref(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and got.device == want.device
    assert torch.equal(got, want)
    return got


def _calls(monkeypatch, run):
    """Run `run()` and return the arguments of every `match_lengths` call
    it made."""
    seen = []
    real = hash_chain.match_lengths

    def record(s, pos, cand, limit):
        seen.append((s, pos, cand, limit))
        return real(s, pos, cand, limit)

    monkeypatch.setattr(hash_chain, "match_lengths", record)
    run()
    monkeypatch.setattr(hash_chain, "match_lengths", real)
    return seen


def _caller(name, dev):
    """The caller's run at its shape on `dev`, and the least bound
    (limit - 4) its lengths must reach somewhere."""
    if name == "gzip":
        data = make_corpus(TEXT + (4 << 20))[TEXT:]
        return (lambda: codec.gzip_compress(data, device=dev)), 254
    if name == "lzma":
        data = make_corpus(TEXT + (4 << 20))[TEXT:]
        return (lambda: encoder.WindowMatcher(data, device=dev)), 269
    size = 4 << 20
    if name == "lz4_zeros":
        data = bytes(size)
    else:
        data = np.random.default_rng(4).integers(0, 256, size, np.uint8).tobytes()
    return (lambda: block.compress_block(data, accel=2, device=dev)), 0


@pytest.mark.card
@pytest.mark.parametrize("name", ["gzip", "lzma", "lz4_zeros", "lz4_random"])
def test_kernel_equals_plain_at_callers_shapes(card, monkeypatch, name):
    run, least_cap = _caller(name, card)
    calls = _calls(monkeypatch, run)
    assert calls
    for args in calls:
        assert args[0].device.type == "cuda"
        _same(args)
        if least_cap:
            assert int((args[3] - 4).max()) >= least_cap


@pytest.mark.card
@pytest.mark.parametrize("name", EDGES)
def test_kernel_equals_plain_on_edges(card, name):
    s, pos, cand, limit = edge_cases()[name]
    got = _same(_on(card, s, pos, cand, limit))
    if name in ("split", "shuffled"):
        assert int(got.max()) - 4 > SPLIT


CALLERS = ["gzip", "lzma", "lz4_zeros", "lz4_random"]


@pytest.mark.card
@pytest.mark.parametrize("name", CALLERS + EDGES)
def test_kernel_equals_tpu7z(card, monkeypatch, name):
    """The card's kernel (csrc/lz_match.cu through `match_lengths`)
    against tpu7z's `_match_lengths` on the host, on the arguments of each
    caller's call at its shape (gzip's 4 MiB, LZMA's MATCH_MAX 273, LZ4's
    tensor parse over 4 MiB of zeros and of random bytes) and on the edge
    inputs. tpu7z's rows are independent, and a row over a zero run costs
    its compares the square of its length, so over the zeros it takes the
    entries whose limit is under 4096 and 128 others drawn from a seed;
    there every length is also max(limit, 4), which every entry is held
    to."""
    if name in EDGES:
        calls = [_on(card, *edge_cases()[name])]
    else:
        calls = _calls(monkeypatch, _caller(name, card)[0])
    assert calls
    for args in calls:
        got = hash_chain.match_lengths(*args).cpu().numpy()
        s = args[0].cpu().numpy()
        pos, cand, limit = (a.to(torch.int64).cpu().numpy() for a in args[1:])
        pick = np.arange(pos.size)
        if name == "lz4_zeros":
            assert not s.any()
            assert np.array_equal(got, np.maximum(limit, 4))
            rng = np.random.default_rng(27)
            pick = np.union1d(np.nonzero(limit < 4096)[0], rng.choice(pos.size, 128))
        want = jblock._match_lengths(s, pos[pick], cand[pick], limit[pick])
        assert np.array_equal(got[pick], want)


@pytest.mark.card
def test_more_long_ends_than_the_queue_holds(card):
    """Every entry its own chain end (no successor in `pos`), at offset 1
    in zeros with a 1 every 7919 bytes: about half of the common prefixes
    run past SPLIT, more of them than the queue holds, so the rest are
    compared by the warp that found them; mismatches fall inside queued
    segments and past them."""
    n = 400_000
    s = np.zeros(n, np.uint8)
    s[::7919] = 1
    pos = np.arange(9000, n - 9000, 2, dtype=np.int64)
    pos = pos[[bytes(s[p:p + 4]) == bytes(s[p - 1:p + 3]) for p in pos]]
    limit = np.minimum(n - pos, 9000)
    tail = _same(_on(card, s, pos, pos - 1, limit)).cpu().numpy() - 4
    assert int((tail > SPLIT).sum()) > (1 << 16)
    assert int((tail < limit - 4).sum()) > 0


@pytest.mark.card
def test_one_launch_a_call(card):
    s, pos, cand, limit = edge_cases()["past_a_chain_end"]
    args = _on(card, s, pos, cand, limit)
    hash_chain.reset_launches()
    for k in range(1, 4):
        hash_chain.match_lengths(*args)
        assert hash_chain.LAUNCHES["lz_match_lengths"] == k
    s, pos, cand, limit = edge_cases()["empty"]
    assert hash_chain.match_lengths(*_on(card, s, pos, cand, limit)).numel() == 0
    assert hash_chain.LAUNCHES["lz_match_lengths"] == 3


@pytest.mark.card
def test_gzip_on_the_card_reads_no_chain_ends_or_panels(card):
    """The gzip writer on the card: the matcher's lengths are one kernel
    span inside `lz.match_lengths` with no host read; the member equals
    the CPU's."""
    data = make_corpus(TEXT + 300_000)[TEXT:]
    trace.attach(keep_records=True)
    hash_chain.reset_launches()
    got = codec.gzip_compress(data, device=card)
    names = [r["name"] for r in trace.records()]
    trace.detach()
    assert not PANEL_READS & set(names)
    assert names.count("lz.match_kernel") == names.count("lz.match_lengths") == 1
    assert names.index("lz.match_kernel") < names.index("lz.match_lengths")
    (kern,) = [r for r in trace.records() if r["name"] == "lz.match_kernel"]
    assert kern["bytes"] > 0
    assert hash_chain.LAUNCHES["lz_match_lengths"] == 1
    assert got == codec.gzip_compress(data, device="cpu")


def test_cpu_tensors_take_the_plain_version():
    """On the CPU no kernel is launched, and the plain version's host reads
    are made as before."""
    s, pos, cand, limit = edge_cases()["past_a_chain_end"]
    args = _on("cpu", s, pos, cand, limit)
    hash_chain.reset_launches()
    trace.attach(keep_records=True)
    got = hash_chain.match_lengths(*args)
    names = {r["name"] for r in trace.records()}
    trace.detach()
    assert torch.equal(got, hash_chain.match_lengths_ref(*args))
    assert hash_chain.LAUNCHES["lz_match_lengths"] == 0
    assert PANEL_READS <= names and "lz.match_kernel" not in names


def test_other_devices_are_refused():
    s, pos, cand, limit = (t.to("meta") for t in _on("cpu", *edge_cases()["split"]))
    with pytest.raises(ValueError, match="unsupported device"):
        hash_chain.match_lengths(s, pos, cand, limit)


@pytest.mark.parametrize("n,m", [(0, 0), (1, 0), (31, 5), (32, 7), (4 << 20, 3 << 20)])
def test_launch_bytes_by_hand(n, m):
    """pos, cand and limit read and the lengths written, 8 bytes an entry
    each; the plane 4 bytes a position each way; reach and tail 4 bytes an
    entry each way; link and chain-end words 4 bytes a word each way."""
    words = (n + 31) // 32
    assert hash_chain.launch_bytes(n, m) == 4 * 8 * m + 2 * 4 * (n + 1) + 2 * 4 * m + 2 * 2 * 4 * words


@pytest.mark.parametrize("name", EDGES)
def test_edge_cases_are_within_the_contract(name):
    """Distinct positions, verified earlier candidates, pos + limit <= n."""
    s, pos, cand, limit = edge_cases()[name]
    assert np.unique(pos).size == pos.size
    assert np.all((cand >= 0) & (cand < pos)) and np.all(pos + limit <= s.size)
    for p, c in zip(pos[:2000], cand[:2000]):
        assert bytes(s[p:p + 4]) == bytes(s[c:c + 4])
