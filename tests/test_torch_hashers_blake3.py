"""The port's BLAKE3 entry (HASHERS["BLAKE3"]: tensor code, here on CPU
tensors) against tpu7z's serial Python on the CPU at every length of one
chunk (0 to 1024), at 4095-4097, 65535-65537 and 1 MiB + 7; the lengths
of two chunks (1025 to 2100) are test_torch_hashers_blake3_two_chunks.py.
Files of their own: each call runs a chunk's block compressions in turn,
a few hundred small tensor operations each."""

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_hashers import check_lengths, data  # noqa: E402

SPANS = {"0-511": range(0, 512), "512-1024": range(512, 1025), "4095-4097": range(4095, 4098),
         "65535-65537": range(65535, 65538), "1MiB+7": [(1 << 20) + 7]}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def buf():
    return data()


@pytest.mark.parametrize("span", sorted(SPANS))
def test_blake3_equals_tpu7z(buf, span):
    check_lengths("BLAKE3", SPANS[span], buf)
