"""The port's MD2 (tpu7z_torch/ops/hashers.py, Python as tpu7z's) against
tpu7z's on the CPU: HASHERS["MD2"] at every length from 0 to 2100, at
4095-4097, 65535-65537 and 1 MiB + 7. A file of its own: both sides are
serial Python, tpu7z's at about 13 s a MiB."""

import pytest

pytest.importorskip("torch")

from tests.test_torch_hashers import RANGES, check_lengths, data  # noqa: E402


@pytest.fixture(scope="module")
def buf():
    return data()


@pytest.mark.parametrize("span", sorted(RANGES))
def test_md2_equals_tpu7z(buf, span):
    check_lengths("MD2", RANGES[span], buf)
