"""The port's native XXH32 (csrc/xxh32.cpp, built with the host C++
compiler) against tpu7z's XXH32 and the port's own Python twin, and the
frames whose content checksum it now writes and verifies. Exact equality."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from tpu7z.models.lz4 import jax_backend  # noqa: E402
from tpu7z.ops.hashing import xxh32 as jxxh32  # noqa: E402
from tpu7z_torch.models.lz4 import frame as tframe  # noqa: E402
from tpu7z_torch.models.lz4 import torch_backend  # noqa: E402
from tpu7z_torch.ops.hashing import xxh32, xxh32_native  # noqa: E402
from tpu7z_torch.utils.corpus import make_corpus  # noqa: E402

SEEDS = [0, 0x9747B28C]
DATA = np.random.default_rng(21).integers(0, 256, 1 << 20, np.uint8).tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", range(34))
def test_short_inputs_equal_tpu7z(n, seed):
    """Every tail length (0-3 bytes after 0-3 lanes), and the stripe loop
    from 16 bytes on."""
    d = DATA[:n]
    assert xxh32_native(d, seed) == jxxh32(d, seed) == xxh32(d, seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_one_mib_equals_tpu7z(seed):
    want = jxxh32(DATA, seed)
    assert xxh32_native(DATA, seed) == want == xxh32(DATA, seed)
    assert xxh32_native(np.frombuffer(DATA, np.uint8), seed) == want
    assert xxh32_native(bytearray(DATA), seed) == want


def test_spec_values():
    """XXH32 of the empty input, from the xxHash specification."""
    assert xxh32_native(b"") == 0x02CC5D05
    assert xxh32_native(b"", 1) == 0x0B2CB792


@pytest.mark.parametrize("size", [0, 3 * (1 << 16) + 77])
def test_compress_frame_device_unchanged(size):
    """The match-finder frame, whose content checksum is now the native
    XXH32, still equals tpu7z's, and the decoder verifies it."""
    data = make_corpus(size)
    got = torch_backend.compress_frame_device(data, device="cpu")
    assert got == jax_backend.compress_frame_device(data)
    assert int.from_bytes(got[-4:], "little") == xxh32(data)
    assert tframe.decompress(got) == data
    bad = got[:-4] + (xxh32(data) ^ 1).to_bytes(4, "little")
    with pytest.raises(tframe.CorruptError, match="content checksum"):
        tframe.decompress(bad)
