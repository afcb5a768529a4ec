"""The port's BLAKE3 entry against tpu7z's on the CPU at every length of
two chunks, 1025 to 2100: both chunks' chaining values in one batch,
their 16 blocks in turn, the second chunk's last block short, then the
root parent (test_torch_hashers_blake3.py has the other lengths)."""

import pytest

torch = pytest.importorskip("torch")

from tests.test_torch_hashers import check_lengths, data  # noqa: E402

SPANS = {"1025-1399": range(1025, 1400), "1400-1749": range(1400, 1750),
         "1750-2100": range(1750, 2101)}


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
