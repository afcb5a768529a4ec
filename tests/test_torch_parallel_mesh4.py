"""The port's device frame at 1, 2 and 4 gloo ranks against the JAX
package's at make_mesh(4), on the payloads of tests/torch_ranks.py.

The companion of tests/test_torch_parallel.py, which holds the same
frames at make_mesh(1); the two files run on separate test workers, each
compiling its own five JAX frames. Exact equality.
"""

import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tests import torch_ranks  # noqa: E402
from tpu7z.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from tpu7z.parallel.sharded import (  # noqa: E402
    shard_compress_lz4_device as jax_frame)
from tpu7z_torch.models.lz4 import frame as tframe  # noqa: E402
from tpu7z_torch.parallel import distributed  # noqa: E402

WORLDS = [1, 2, 4]
FRAMES = list(torch_ranks.frame_payloads())


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
            cache[name] = jax_frame(payload, mesh=jax_mesh(4), W=W)
        return cache[name]
    return get


@pytest.mark.parametrize("name", FRAMES)
@pytest.mark.parametrize("n", WORLDS)
def test_frame_equals_jax_mesh4(sessions, jax_frames, n, name):
    want = jax_frames(name)
    for rank, got in enumerate(sessions(n)):
        assert got["frame", name] == want, (n, rank)
    payload, _ = torch_ranks.frame_payloads()[name]
    assert tframe.decompress(want) == payload
