"""7z AES-256-CBC with the 7z key derivation, a port of
tpu7z/containers/sevenzip/aes7z.py.

Behavioral reference: CPP/7zip/Archive/7z/7zAes.cpp:39-111 (KDF: SHA-256
over salt || utf16le(password) || counter, 2^numCyclesPower rounds) and
C/Aes.c. The AES core is FIPS-197's, its S-boxes generated from GF(2^8).

Decryption is data-parallel across blocks, so it is tensor code on the
device the caller names (the CUDA card unless it names the CPU): every
block ECB-decrypted at once as a (N, 4, 4) uint8 state (InvSubBytes a
gather from a 256-entry table, InvShiftRows `torch.roll` a row,
InvMixColumns xtime chains), then one XOR with the shifted ciphertext.
It runs CHUNK_BLOCKS blocks a pass, so its temporaries stay bounded
whatever the folder's size.
CBC encryption chains block to block, so it runs in the host library
built from csrc/aes.cpp (`encrypt_cbc`, `aes_encrypt`); `aes_encrypt_ref` is its Python
twin, for the tests.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np
import torch

from ...device import resolve_device
from ...ops import _build
from ...utils.errors import CorruptError

_SBOX = None
_INV_SBOX = None


def _init_tables():
    global _SBOX, _INV_SBOX
    if _SBOX is not None:
        return
    # the S-box from the GF(2^8) inverse and the affine transform
    gf_exp = np.zeros(512, dtype=np.int64)
    gf_log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        gf_exp[i] = x
        gf_log[x] = i
        x ^= (x << 1) ^ (0x11B if x & 0x80 else 0)
        x &= 0xFF
    for i in range(255, 512):
        gf_exp[i] = gf_exp[i - 255]
    inv = np.zeros(256, dtype=np.int64)
    for a in range(1, 256):
        inv[a] = gf_exp[255 - gf_log[a]]
    sbox = np.zeros(256, dtype=np.uint8)
    for a in range(256):
        b = int(inv[a])
        s = b
        for _ in range(4):
            b = ((b << 1) | (b >> 7)) & 0xFF
            s ^= b
        sbox[a] = s ^ 0x63
    inv_sbox = np.zeros(256, dtype=np.uint8)
    inv_sbox[sbox] = np.arange(256, dtype=np.uint8)
    _SBOX = sbox
    _INV_SBOX = inv_sbox


def _expand_key(key: bytes):
    """(round keys as a (nr + 1, 4, 4) uint8 array of [row, column], nr)."""
    _init_tables()
    nk = len(key) // 4
    nr = nk + 6
    w = [int.from_bytes(key[4 * i:4 * i + 4], "big") for i in range(nk)]
    rcon = 1
    for i in range(nk, 4 * (nr + 1)):
        t = w[i - 1]
        if i % nk == 0:
            t = ((t << 8) | (t >> 24)) & 0xFFFFFFFF
            t = int.from_bytes(bytes(_SBOX[list(t.to_bytes(4, "big"))]), "big")
            t ^= rcon << 24
            rcon = ((rcon << 1) ^ (0x11B if rcon & 0x80 else 0)) & 0xFF
        elif nk > 6 and i % nk == 4:
            t = int.from_bytes(bytes(_SBOX[list(t.to_bytes(4, "big"))]), "big")
        w.append(w[i - nk] ^ t)
    rk = np.zeros((nr + 1, 4, 4), dtype=np.uint8)
    for r in range(nr + 1):
        for c in range(4):
            col = w[4 * r + c].to_bytes(4, "big")
            for row in range(4):
                rk[r, row, c] = col[row]
    return rk, nr


def _xtime(a: torch.Tensor) -> torch.Tensor:
    """a * 2 in GF(2^8), bytewise; uint8 shifts drop the carry."""
    return (a << 1) ^ ((a >> 7) * 0x1B)


def _decrypt_blocks(ct: torch.Tensor, rk, nr: int) -> torch.Tensor:
    """ECB-decrypt (N, 16) uint8 blocks on ct's device, all at once: its
    temporaries come to about fourteen times ct's bytes."""
    _init_tables()
    dev = ct.device
    rk = torch.as_tensor(rk, dtype=torch.uint8, device=dev)
    inv_sbox = torch.from_numpy(_INV_SBOX).to(dev)
    n = ct.shape[0]
    # state [block, row, column]: a block's bytes fill it column by column
    st = ct.reshape(n, 4, 4).transpose(1, 2) ^ rk[nr]
    for r in range(nr - 1, -1, -1):
        # InvShiftRows: row i turns right by i
        st = torch.stack([st[:, 0]] + [torch.roll(st[:, row], row, dims=1)
                                       for row in (1, 2, 3)], dim=1)
        # InvSubBytes
        st = torch.index_select(inv_sbox, 0, st.reshape(-1).to(torch.int32)).view(n, 4, 4)
        st = st ^ rk[r]
        if r > 0:
            # InvMixColumns: 9, 11, 13 and 14 times each byte, from xtime
            a = [st[:, row] for row in range(4)]
            x2 = [_xtime(v) for v in a]
            x4 = [_xtime(v) for v in x2]
            x8 = [_xtime(v) for v in x4]
            m9 = [x8[i] ^ a[i] for i in range(4)]
            m11 = [x8[i] ^ x2[i] ^ a[i] for i in range(4)]
            m13 = [x8[i] ^ x4[i] ^ a[i] for i in range(4)]
            m14 = [x8[i] ^ x4[i] ^ x2[i] for i in range(4)]
            st = torch.stack([
                m14[0] ^ m11[1] ^ m13[2] ^ m9[3],
                m9[0] ^ m14[1] ^ m11[2] ^ m13[3],
                m13[0] ^ m9[1] ^ m14[2] ^ m11[3],
                m11[0] ^ m13[1] ^ m9[2] ^ m14[3],
            ], dim=1)
    return st.transpose(1, 2).reshape(n, 16)


# blocks decrypted a pass: 16 MiB of ciphertext, some 224 MiB of temporaries
CHUNK_BLOCKS = 1 << 20


def decrypt_cbc(ct: torch.Tensor, key: bytes, iv: bytes) -> torch.Tensor:
    """CBC-decrypt (N, 16) uint8 ciphertext blocks on their device: the
    blocks ECB-decrypted, each XORed with the block before it (the IV
    before the first), CHUNK_BLOCKS blocks a pass."""
    rk, nr = _expand_key(key)
    out = torch.empty_like(ct)
    prev = torch.frombuffer(bytearray(iv), dtype=torch.uint8).to(ct.device)[None]
    for s in range(0, ct.shape[0], CHUNK_BLOCKS):
        c = ct[s:s + CHUNK_BLOCKS]
        torch.bitwise_xor(_decrypt_blocks(c, rk, nr), torch.cat([prev, c[:-1]]),
                          out=out[s:s + CHUNK_BLOCKS])
        prev = c[-1:]
    return out


def derive_key(password: str, salt: bytes, cycles_power: int) -> bytes:
    """7z KDF (7zAes.cpp:39-111)."""
    pw = password.encode("utf-16-le")
    if cycles_power == 0x3F:
        return (salt + pw + b"\x00" * 32)[:32]
    h = hashlib.sha256()
    for i in range(1 << cycles_power):
        h.update(salt)
        h.update(pw)
        h.update(i.to_bytes(8, "little"))
    return h.digest()


def parse_props(props: bytes):
    """AES coder props: b0 = (numCyclesPower & 0x3F) | saltSize/ivSize high
    bits; optional b1 = low sizes; then salt, then iv."""
    if len(props) < 1:
        raise CorruptError("7z aes: missing props")
    b0 = props[0]
    cycles = b0 & 0x3F
    salt_size = (b0 >> 7) & 1
    iv_size = (b0 >> 6) & 1
    pos = 1
    if b0 & 0xC0:
        if len(props) < 2:
            raise CorruptError("7z aes: truncated props")
        b1 = props[1]
        salt_size += b1 >> 4
        iv_size += b1 & 0x0F
        pos = 2
    salt = props[pos:pos + salt_size]
    pos += salt_size
    iv = props[pos:pos + iv_size]
    iv = iv + b"\x00" * (16 - len(iv))
    return cycles, salt, iv


def aes_decrypt(data: bytes, props: bytes, password: str, *, device=None) -> bytes:
    """Decrypt a 7z AES coder's stream on `device` (the card unless it
    names the CPU); a tail short of a block is dropped, as in tpu7z."""
    dev = resolve_device(device)
    cycles, salt, iv = parse_props(props)
    key = derive_key(password, salt, cycles)
    n = len(data) // 16
    if n == 0:
        return b""
    ct = torch.frombuffer(bytearray(data[:n * 16]), dtype=torch.uint8).to(dev).view(n, 16)
    return decrypt_cbc(ct, key, iv).cpu().numpy().tobytes()


_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("aes")
        lib.tz_aes_cbc_encrypt.argtypes = [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t,
                                           ctypes.c_void_p]
        lib.tz_aes_cbc_encrypt.restype = ctypes.c_int
        _lib = lib
    return _lib


def _padded(data: bytes) -> bytes:
    return bytes(data) + b"\x00" * ((-len(data)) % 16)


def encrypt_cbc(data: bytes, key: bytes, iv: bytes) -> bytes:
    """CBC-encrypt whole 16-byte blocks with `key` by the host library
    built from csrc/aes.cpp. A failed build raises."""
    if len(data) % 16:
        raise ValueError(f"encrypt_cbc: {len(data)} bytes is not a whole number of blocks")
    rk, nr = _expand_key(key)
    out = ctypes.create_string_buffer(len(data))
    # round keys in a block's byte order: [round, column, row]
    rc = _library().tz_aes_cbc_encrypt(_SBOX.tobytes(), rk.transpose(0, 2, 1).tobytes(), nr,
                                       iv, data, len(data), ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"tz_aes_cbc_encrypt returned {rc}")
    return out.raw


def aes_encrypt(data: bytes, props: bytes, password: str) -> bytes:
    """CBC-encrypt `data`, zero-padded to whole blocks, on the host; the
    bytes of tpu7z's `aes_encrypt`."""
    cycles, salt, iv = parse_props(props)
    return encrypt_cbc(_padded(data), derive_key(password, salt, cycles), iv)


def _gmul2(a: int) -> int:
    return ((a << 1) ^ (0x1B if a & 0x80 else 0)) & 0xFF


def _encrypt_block_ref(pt: bytes, rk, nr: int) -> bytes:
    """tpu7z's `_encrypt_block` on Python ints: st[row][col]."""
    sbox = _SBOX
    st = [[pt[4 * c + row] ^ int(rk[0, row, c]) for c in range(4)] for row in range(4)]
    for r in range(1, nr + 1):
        st = [[int(sbox[st[row][(c + row) % 4]]) for c in range(4)] for row in range(4)]
        if r < nr:
            cols = []
            for c in range(4):
                a0, a1, a2, a3 = (st[row][c] for row in range(4))
                cols.append((_gmul2(a0) ^ _gmul2(a1) ^ a1 ^ a2 ^ a3,
                             a0 ^ _gmul2(a1) ^ _gmul2(a2) ^ a2 ^ a3,
                             a0 ^ a1 ^ _gmul2(a2) ^ _gmul2(a3) ^ a3,
                             _gmul2(a0) ^ a0 ^ a1 ^ a2 ^ _gmul2(a3)))
            st = [[cols[c][row] for c in range(4)] for row in range(4)]
        st = [[st[row][c] ^ int(rk[r, row, c]) for c in range(4)] for row in range(4)]
    return bytes(st[row][c] for c in range(4) for row in range(4))


def aes_encrypt_ref(data: bytes, props: bytes, password: str) -> bytes:
    """The Python twin of `aes_encrypt`: tpu7z's serial CBC loop."""
    cycles, salt, iv = parse_props(props)
    rk, nr = _expand_key(derive_key(password, salt, cycles))
    data = _padded(data)
    out = bytearray()
    prev = iv
    for i in range(0, len(data), 16):
        prev = _encrypt_block_ref(bytes(a ^ b for a, b in zip(data[i:i + 16], prev)), rk, nr)
        out += prev
    return bytes(out)
