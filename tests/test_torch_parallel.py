"""The port's sharded entry points at 1, 2 and 4 ranks against the JAX
package.

Each world size runs once, as one spawned gloo session on the CPU
(tests/torch_ranks.py, which the ranks import without JAX); the tests
assert on what every rank returned. The JAX reference runs here, on the
virtual CPU devices of tests/conftest.py: the frame at make_mesh(1)
(tests/test_torch_parallel_mesh4.py holds it at make_mesh(4)), the
container and the match finder at make_mesh(n). All outputs are integers
or bytes, so the tolerance is exact equality.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests import torch_ranks  # noqa: E402
from tpu7z.parallel import progress as jprogress  # noqa: E402
from tpu7z.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from tpu7z.parallel.sharded import shard_compress_lz4 as jax_container  # noqa: E402
from tpu7z.parallel.sharded import (  # noqa: E402
    shard_compress_lz4_device as jax_frame)
from tpu7z.parallel.sharded import (  # noqa: E402
    sharded_find_matches as jax_find_matches)
from tpu7z_torch.entry import dryrun_multichip  # noqa: E402
from tpu7z_torch.models.lz4 import frame as tframe  # noqa: E402
from tpu7z_torch.parallel import distributed, mesh, progress, sharded  # noqa: E402

WORLDS = [1, 2, 4]
FRAMES = list(torch_ranks.frame_payloads())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sessions():
    """world size -> every rank's results, each world spawned once."""
    cache = {}

    def get(n):
        if n not in cache:
            cache[n] = distributed.run_ranks(torch_ranks.session, n,
                                             device="cpu", timeout_s=300)
        return cache[n]
    return get


@pytest.fixture(scope="module")
def jax_frames():
    cache = {}

    def get(name):
        if name not in cache:
            payload, W = torch_ranks.frame_payloads()[name]
            cache[name] = jax_frame(payload, mesh=jax_mesh(1), W=W)
        return cache[name]
    return get


@pytest.mark.parametrize("name", FRAMES)
@pytest.mark.parametrize("n", WORLDS)
def test_frame_equals_jax_mesh1(sessions, jax_frames, n, name):
    want = jax_frames(name)
    for rank, got in enumerate(sessions(n)):
        assert got["frame", name] == want, (n, rank)
    payload, _ = torch_ranks.frame_payloads()[name]
    assert tframe.decompress(want) == payload


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_find_matches_equals_jax(sessions, n):
    blocks, lengths = torch_ranks.match_blocks()
    want = jax_find_matches(blocks, lengths, jax_mesh(n))
    for got in (r["find_matches"] for r in sessions(n)):
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == np.asarray(w).dtype
            assert np.array_equal(g, w)
        assert got[3] == want[3] > 0


@pytest.mark.parametrize("n", WORLDS)
def test_shard_compress_lz4_equals_jax(sessions, n):
    sample = torch_ranks.match_sample()
    want = jax_container(sample, mesh=jax_mesh(n),
                         block_size=torch_ranks.SMALL_BLOCK)
    for r in sessions(n):
        assert r["container"] == want
    assert tframe.decompress(want) == sample


@pytest.mark.parametrize("n", WORLDS)
def test_reduce_progress_equals_jax(sessions, n):
    want = [int(v) for v in jprogress.reduce_progress(*torch_ranks.progress_entries())]
    assert want[2] == 7
    for r in sessions(n):
        assert r["progress"] == want


@pytest.mark.parametrize("n", WORLDS)
def test_subgroup_members_encode_and_the_rest_are_refused(sessions, n):
    """make_mesh(n // 2) inside an n-rank world: its members give the
    world's frame; a rank outside it is refused."""
    results = sessions(n)
    members = max(1, n // 2)
    for rank, r in enumerate(results):
        if rank < members:
            assert r["half"] == r["frame", "words_W16"]
        else:
            assert r["half"] == "refused: this process is not a member of the group"


@pytest.mark.parametrize("n", WORLDS)
def test_gloo_group_refuses_other_devices(sessions, n):
    for r in sessions(n):
        assert r["meta_refused"] == "a gloo process group does not carry tensors on meta"


def test_reduce_progress_alone_equals_jax():
    entries = torch_ranks.progress_entries()
    got = progress.reduce_progress(*(torch.from_numpy(a) for a in entries))
    assert all(t.dtype == torch.int64 and t.dim() == 0 for t in got)
    assert [int(t) for t in got] == [int(v) for v in jprogress.reduce_progress(*entries)]


def test_progress_keeps_the_first_error():
    seen = []
    for cls in (progress.Progress, jprogress.Progress):
        p = cls(callback=lambda i, o: seen.append((i, o)))
        p.add(10, 4)
        first = ValueError("first")
        p.set_error(first)
        p.set_error(RuntimeError("second"))
        p.add(5, 5)
        assert (p.in_total, p.out_total, p.error) == (10, 4, first)
        with pytest.raises(ValueError, match="first"):
            p.check()
    assert seen == [(10, 4), (10, 4)]


def test_initialize_without_an_address_is_a_noop(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert not torch.distributed.is_initialized()
    assert distributed.global_mesh() is None
    assert distributed.process_info() == {
        "process_id": 0, "process_count": 1, "local_devices": 1,
        "global_devices": 1}


@pytest.mark.parametrize("n", [2, 0])
def test_make_mesh_refuses_ranks_it_does_not_have(n):
    assert mesh.make_mesh() is None and mesh.make_mesh(1) is None
    with pytest.raises(ValueError, match="requested"):
        mesh.make_mesh(n)


def test_positional_option_lands_on_the_group():
    """tpu7z's second parameter is the mesh: `f(data, 16)` must not bind W
    in the port either."""
    with pytest.raises(TypeError, match="ProcessGroup"):
        sharded.shard_compress_lz4_device(b"abc" * 100, 16)
    with pytest.raises(TypeError):
        sharded.shard_compress_lz4_device(b"abc" * 100, None, 16)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_on_cpu_ranks(n):
    dryrun_multichip(n, device="cpu")


def test_dryrun_multichip_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun_multichip(1)


def test_run_ranks_raises_a_failed_rank():
    with pytest.raises(RuntimeError, match="fails on purpose"):
        distributed.run_ranks(torch_ranks.fail, 2, device="cpu", timeout_s=120)


def test_run_ranks_kills_ranks_past_the_deadline():
    with pytest.raises(TimeoutError, match="2 of 2 ranks"):
        distributed.run_ranks(torch_ranks.hang, 2, 600.0, device="cpu",
                              timeout_s=5)
