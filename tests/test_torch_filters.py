"""The port's filters (`tpu7z_torch.models.filters`) against tpu7z's on
the CPU: the whole-array branch converters (ARM, ARM64, PPC, SPARC,
ARM-Thumb) and the byte swaps, tensor code here on CPU tensors, and the
delta filter, each equal to tpu7z's at several `ip` values and on
unaligned lengths, with branch opcodes planted; the host converters (x86,
IA-64, RISC-V) and the BCJ2 encoder equal to tpu7z's, converted code
decoded as tpu7z decodes it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu7z.models.filters import bcj as jbcj  # noqa: E402
from tpu7z.models.filters import bcj2 as jbcj2  # noqa: E402
from tpu7z.models.filters import delta as jdelta  # noqa: E402
from tpu7z_torch.models.filters import FILTERS, bcj, bcj2, delta  # noqa: E402

TENSOR = ("arm", "arm64", "ppc", "sparc", "armt")
HOST = ("x86", "ia64", "riscv")
LENGTHS = (0, 1, 3, 4, 5, 6, 7, 16, 17, 4099, 65537)
IPS = (0, 4, 0x1000, 123457, 0xFFFFF000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _code(n: int, seed: int = 0) -> bytes:
    """Random bytes with each converter's opcodes planted: ARM BL (0xEB at
    +3), ARM64 BL and ADRP (0x94/0x90 at +3, in and out of range), PPC bl
    and SPARC call (0x48/0x40 at +0, big-endian), Thumb BL pairs (0xF0 at
    odd bytes, 0xF8 after), x86 E8/E9 with 00/FF high bytes, RISC-V JAL
    and AUIPC low bytes, IA-64 branch templates."""
    rng = np.random.default_rng(seed + n)
    b = rng.integers(0, 256, n, dtype=np.uint8)
    if n == 0:
        return b""
    pick = lambda view, p: rng.random(view.size) < p  # noqa: E731
    b[3::4][pick(b[3::4], 0.15)] = 0xEB
    b[3::4][pick(b[3::4], 0.15)] = 0x94
    b[3::4][pick(b[3::4], 0.1)] = 0x90
    b[2::4][pick(b[2::4], 0.1)] = 0x00
    b[::4][pick(b[::4], 0.15)] = 0x48
    b[3::4][pick(b[3::4], 0.05)] = 0x01
    b[::4][pick(b[::4], 0.1)] = 0x40
    b[1::4][pick(b[1::4], 0.1)] = 0x00
    b[1::2][pick(b[1::2], 0.2)] = 0xF0
    b[3::2][pick(b[3::2], 0.2)] = 0xF9
    b[pick(b, 0.04)] = 0xE8
    b[pick(b, 0.02)] = 0xE9
    b[4::5][pick(b[4::5], 0.3)] = 0x00
    b[::2][pick(b[::2], 0.05)] = 0xEF
    b[::2][pick(b[::2], 0.05)] = 0x97
    b[::16][pick(b[::16], 0.5)] = 0x10
    return b.tobytes()


@pytest.mark.parametrize("ip", IPS, ids=[hex(i) for i in IPS])
@pytest.mark.parametrize("name", TENSOR)
def test_tensor_converters_equal_tpu7z(name, ip):
    enc, dec = FILTERS[name]
    jenc, jdec = jbcj.FILTERS[name]
    for n in LENGTHS:
        data = _code(n, len(name))
        packed = jenc(data, ip)
        assert enc(data, ip, device="cpu") == packed, (name, n)
        assert n < 4096 or packed != data, (name, n)   # branches were rewritten
        assert dec(data, ip, device="cpu") == jdec(data, ip), (name, n)
        # decoding converted code takes every branch the encoder rewrote
        assert dec(packed, ip, device="cpu") == jdec(packed, ip), (name, n)


@pytest.mark.parametrize("ip", IPS[:4], ids=[hex(i) for i in IPS[:4]])
@pytest.mark.parametrize("name", HOST)
def test_host_converters_equal_tpu7z(name, ip):
    enc, dec = FILTERS[name]
    jenc, jdec = jbcj.FILTERS[name]
    for n in LENGTHS[:-1]:
        data = _code(n, 3)
        assert enc(data, ip) == jenc(data, ip), (name, n)
        assert dec(data, ip) == jdec(data, ip), (name, n)
        assert dec(jenc(data, ip), ip) == jdec(jenc(data, ip), ip), (name, n)


@pytest.mark.parametrize("n", LENGTHS)
def test_swaps_equal_tpu7z(n):
    data = _code(n)
    for mine, ref in ((bcj.swap2, jbcj.swap2), (bcj.swap4, jbcj.swap4)):
        got = mine(data, device="cpu")
        assert got == ref(data)
        assert mine(got, device="cpu") == data


@pytest.mark.parametrize("dist", [1, 2, 3, 4, 7, 16, 255, 256])
def test_delta_equals_tpu7z(dist):
    for n in LENGTHS:
        data = _code(n, dist)
        packed = jdelta.delta_encode(data, dist)
        assert delta.delta_encode(data, dist, device="cpu") == packed
        assert delta.delta_decode(packed, dist, device="cpu") == data
        assert delta.delta_decode(data, dist, device="cpu") == jdelta.delta_decode(data, dist)


@pytest.mark.parametrize("dist", [0, 257])
def test_delta_refuses_a_distance_as_tpu7z(dist):
    with pytest.raises(ValueError):
        jdelta.delta_encode(b"abc", dist)
    with pytest.raises(ValueError):
        delta.delta_encode(b"abc", dist, device="cpu")
    with pytest.raises(ValueError):
        delta.delta_decode(b"abc", dist, device="cpu")


@pytest.mark.parametrize("n", [0, 4, 5, 100, 5000])
def test_bcj2_encoder_equals_tpu7z(n):
    data = _code(n, 9)
    assert bcj2.bcj2_encode(data) == jbcj2.bcj2_encode(data)


def test_tensor_converters_run_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (bcj.bcj_arm_decode, bcj.bcj_arm64_decode, bcj.swap4, delta.delta_decode):
        with pytest.raises(RuntimeError, match="runs on a CUDA device"):
            fn(b"\x00" * 64)
