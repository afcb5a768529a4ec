"""The hasher registry, a port of tpu7z/ops/hashers.py: tpu7z's 21
names, each giving tpu7z's hex string for the same bytes.

    HASHERS[name](data, device=None) -> str

Where each runs:
  - BLAKE3 on the card (`blake3`, tensor code, unless `device` names the
    CPU); `blake3_ref` is its plain version, a copy of tpu7z's serial
    Python;
  - XXH3-64 and XXH3-128 in the host library built from csrc/xxh3.cpp
    (`xxh3_64`, `xxh3_128`), where tpu7z calls the `xxhash` package;
  - CRC32, CRC64, XXH32 and XXH64 in the host libraries of ops/hashing.py;
  - MD5 and the SHA-1, SHA-2, SHA-3 and BLAKE2s families (BLAKE2sp's
    eight leaves and root) in `hashlib`, as in tpu7z; a name that the
    host's `hashlib` lacks raises when it is called;
  - MD2 and MD4 in Python, as in tpu7z.
Every entry takes `device` and only BLAKE3 reads it. A failed native
build raises; nothing falls back to Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import struct

import numpy as np
import torch

from ..device import resolve_device
from . import _build
from .hashing import crc32_native, crc64_native, xxh32_native, xxh64_native

_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# MD2 (RFC 1319)
# ---------------------------------------------------------------------------

_MD2_S = bytes([
    41, 46, 67, 201, 162, 216, 124, 1, 61, 54, 84, 161, 236, 240, 6, 19,
    98, 167, 5, 243, 192, 199, 115, 140, 152, 147, 43, 217, 188, 76, 130,
    202, 30, 155, 87, 60, 253, 212, 224, 22, 103, 66, 111, 24, 138, 23,
    229, 18, 190, 78, 196, 214, 218, 158, 222, 73, 160, 251, 245, 142,
    187, 47, 238, 122, 169, 104, 121, 145, 21, 178, 7, 63, 148, 194, 16,
    137, 11, 34, 95, 33, 128, 127, 93, 154, 90, 144, 50, 39, 53, 62, 204,
    231, 191, 247, 151, 3, 255, 25, 48, 179, 72, 165, 181, 209, 215, 94,
    146, 42, 172, 86, 170, 198, 79, 184, 56, 210, 150, 164, 125, 182,
    118, 252, 107, 226, 156, 116, 4, 241, 69, 157, 112, 89, 100, 113,
    135, 32, 134, 91, 207, 101, 230, 45, 168, 2, 27, 96, 37, 173, 174,
    176, 185, 246, 28, 70, 97, 105, 52, 64, 126, 15, 85, 71, 163, 35,
    221, 81, 175, 58, 195, 92, 249, 206, 186, 197, 234, 38, 44, 83, 13,
    110, 133, 40, 132, 9, 211, 223, 205, 244, 65, 129, 77, 82, 106, 220,
    55, 200, 108, 193, 171, 250, 36, 225, 123, 8, 12, 189, 177, 74, 120,
    136, 149, 139, 227, 99, 232, 109, 233, 203, 213, 254, 59, 0, 29, 57,
    242, 239, 183, 14, 102, 88, 208, 228, 166, 119, 114, 248, 235, 117,
    75, 10, 49, 68, 80, 180, 143, 237, 31, 26, 219, 153, 141, 51, 159,
    17, 131, 20])
# S[t] ^ v for every (t, v): one lookup a step of the 18 x 48 chain
_MD2_XS = [bytes(s ^ v for v in range(256)) for s in _MD2_S]


def md2(data: bytes) -> bytes:
    pad = 16 - (len(data) % 16)
    data = bytes(data) + bytes([pad]) * pad
    s = _MD2_S
    checksum = bytearray(16)
    l = 0
    for i in range(0, len(data), 16):
        for j in range(16):
            l = checksum[j] = checksum[j] ^ s[data[i + j] ^ l]
    data += bytes(checksum)
    xs = _MD2_XS
    x = bytearray(48)
    for i in range(0, len(data), 16):
        block = data[i:i + 16]
        x[16:32] = block
        x[32:48] = bytes(a ^ b for a, b in zip(block, x[:16]))
        t = 0
        for j in range(18):
            for k in range(48):
                t = x[k] = xs[t][x[k]]
            t = (t + j) & 0xFF
    return bytes(x[:16])


# ---------------------------------------------------------------------------
# MD4 (RFC 1320)
# ---------------------------------------------------------------------------

def _rotl32(x, n):
    return ((x << n) | (x >> (32 - n))) & _M32


def md4(data: bytes) -> bytes:
    msg = bytearray(data)
    ml = len(data) * 8
    msg.append(0x80)
    msg += bytes((56 - len(msg)) % 64)
    msg += struct.pack("<Q", ml & 0xFFFFFFFFFFFFFFFF)
    a, b, c, d = 0x67452301, 0xEFCDAB89, 0x98BADCFE, 0x10325476
    for off in range(0, len(msg), 64):
        x = struct.unpack_from("<16I", msg, off)
        aa, bb, cc, dd = a, b, c, d
        for i, s in zip(range(16), (3, 7, 11, 19) * 4):
            a, d, c, b = d, c, b, _rotl32((a + ((b & c) | (~b & d)) + x[i]) & _M32, s)
        for i, s in zip((0, 4, 8, 12, 1, 5, 9, 13, 2, 6, 10, 14, 3, 7, 11, 15),
                        (3, 5, 9, 13) * 4):
            a, d, c, b = d, c, b, _rotl32(
                (a + ((b & c) | (b & d) | (c & d)) + x[i] + 0x5A827999) & _M32, s)
        for i, s in zip((0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15),
                        (3, 9, 11, 15) * 4):
            a, d, c, b = d, c, b, _rotl32((a + (b ^ c ^ d) + x[i] + 0x6ED9EBA1) & _M32, s)
        a = (a + aa) & _M32
        b = (b + bb) & _M32
        c = (c + cc) & _M32
        d = (d + dd) & _M32
    return struct.pack("<4I", a, b, c, d)


# ---------------------------------------------------------------------------
# BLAKE2sp (8 BLAKE2s leaves of depth 2, 64-byte blocks round-robin)
# ---------------------------------------------------------------------------

def blake2sp(data: bytes) -> bytes:
    lanes = [hashlib.blake2s(digest_size=32, fanout=8, depth=2, leaf_size=0, node_offset=i,
                             node_depth=0, inner_size=32, last_node=(i == 7))
             for i in range(8)]
    for off in range(0, len(data), 64):
        lanes[(off // 64) % 8].update(data[off:off + 64])
    root = hashlib.blake2s(digest_size=32, fanout=8, depth=2, leaf_size=0, node_offset=0,
                           node_depth=1, inner_size=32, last_node=True)
    for lane in lanes:
        root.update(lane.digest())
    return root.digest()


# ---------------------------------------------------------------------------
# BLAKE3 (public spec): the plain version, a copy of tpu7z's
# ---------------------------------------------------------------------------

B3_IV = (0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
         0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19)
B3_PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8)
CHUNK_START = 1
CHUNK_END = 2
PARENT = 4
ROOT = 8
CHUNK = 1024
BLOCK = 64


def _rotr32(x, n):
    return ((x >> n) | (x << (32 - n))) & _M32


def _b3_g(st, a, b, c, d, mx, my):
    st[a] = (st[a] + st[b] + mx) & _M32
    st[d] = _rotr32(st[d] ^ st[a], 16)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotr32(st[b] ^ st[c], 12)
    st[a] = (st[a] + st[b] + my) & _M32
    st[d] = _rotr32(st[d] ^ st[a], 8)
    st[c] = (st[c] + st[d]) & _M32
    st[b] = _rotr32(st[b] ^ st[c], 7)


def _b3_compress(cv, words, counter, block_len, flags):
    st = list(cv) + list(B3_IV[:4]) + [counter & _M32, (counter >> 32) & _M32, block_len, flags]
    m = list(words)
    for r in range(7):
        _b3_g(st, 0, 4, 8, 12, m[0], m[1])
        _b3_g(st, 1, 5, 9, 13, m[2], m[3])
        _b3_g(st, 2, 6, 10, 14, m[4], m[5])
        _b3_g(st, 3, 7, 11, 15, m[6], m[7])
        _b3_g(st, 0, 5, 10, 15, m[8], m[9])
        _b3_g(st, 1, 6, 11, 12, m[10], m[11])
        _b3_g(st, 2, 7, 8, 13, m[12], m[13])
        _b3_g(st, 3, 4, 9, 14, m[14], m[15])
        if r < 6:
            m = [m[p] for p in B3_PERM]
    lo = [st[i] ^ st[i + 8] for i in range(8)]
    hi = [st[i + 8] ^ cv[i] for i in range(8)]
    return lo, hi


def _b3_words(block: bytes):
    return struct.unpack("<16I", block + bytes(BLOCK - len(block)))


def _b3_chunk_cv(chunk: bytes, counter: int):
    cv = list(B3_IV)
    blocks = [chunk[i:i + BLOCK] for i in range(0, max(len(chunk), 1), BLOCK)]
    for bi, blk in enumerate(blocks):
        flags = (CHUNK_START if bi == 0 else 0) | (CHUNK_END if bi == len(blocks) - 1 else 0)
        cv, _ = _b3_compress(cv, _b3_words(blk), counter, len(blk), flags)
    return cv


def _b3_root_output(cv, words, block_len, flags, out_len):
    out = bytearray()
    ctr = 0
    while len(out) < out_len:
        lo, hi = _b3_compress(cv, words, ctr, block_len, flags)
        out += struct.pack("<16I", *lo, *hi)
        ctr += 1
    return bytes(out[:out_len])


def blake3_ref(data: bytes, out_len: int = 32) -> bytes:
    """BLAKE3 in serial Python, tpu7z's (tpu7z/ops/hashers.py:202):
    every chunk's chaining value, then the parent levels, each pairing
    adjacent values and carrying an odd last one up unchanged."""
    if len(data) <= CHUNK:
        cv = list(B3_IV)
        blocks = [data[i:i + BLOCK] for i in range(0, max(len(data), 1), BLOCK)]
        for bi, blk in enumerate(blocks[:-1]):
            cv, _ = _b3_compress(cv, _b3_words(blk), 0, len(blk),
                                 CHUNK_START if bi == 0 else 0)
        flags = CHUNK_END | ROOT | (CHUNK_START if len(blocks) == 1 else 0)
        return _b3_root_output(cv, _b3_words(blocks[-1]), len(blocks[-1]), flags, out_len)
    cvs = [_b3_chunk_cv(data[off:off + CHUNK], ci)
           for ci, off in enumerate(range(0, len(data), CHUNK))]
    while len(cvs) > 2:
        nxt = [_b3_compress(list(B3_IV), cvs[i] + cvs[i + 1], 0, BLOCK, PARENT)[0]
               for i in range(0, len(cvs) - 1, 2)]
        if len(cvs) % 2:
            nxt.append(cvs[-1])
        cvs = nxt
    return _b3_root_output(list(B3_IV), cvs[0] + cvs[1], BLOCK, PARENT | ROOT, out_len)


# ---------------------------------------------------------------------------
# BLAKE3 as tensor code: every row of a batch compressed at once
# ---------------------------------------------------------------------------

def _schedule() -> list[int]:
    """The message word each round reads at each place: round r reads
    the block permuted r times."""
    order, rounds = list(range(16)), []
    for _ in range(7):
        rounds += order
        order = [order[p] for p in B3_PERM]
    return rounds


_SCHEDULE = _schedule()


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x >> n) | ((x << (32 - n)) & _M32)


def _g(a, b, c, d, mx, my):
    """G on four columns at once: (R, 4) int64 words below 2**32, each sum
    masked back to 32 bits."""
    a = (a + b + mx) & _M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & _M32
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & _M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & _M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


_constants = {}


def _device_constants(dev: torch.device):
    """The message schedule and the IV, kept on `dev`."""
    got = _constants.get(dev)
    if got is None:
        got = (torch.tensor(_SCHEDULE, dtype=torch.int64, device=dev),
               torch.tensor(B3_IV, dtype=torch.int64, device=dev))
        _constants[dev] = got
    return got


def _compress_rows(cv: torch.Tensor, m: torch.Tensor, counter: torch.Tensor,
                   block_len: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """BLAKE3's compression of R rows: cv (R, 8), m (R, 16), counter,
    block_len and flags (R,), all int64 holding 32-bit words (the
    counter 64 bits). Returns the (R, 16) output words; the first 8 are
    the next chaining value. The state's rows a, b, c, d are (R, 4)
    each: the column step of a round is four G functions wide, and so is
    the diagonal step, on rows b, c and d rotated by 1, 2 and 3 places."""
    sched, iv = _device_constants(cv.device)
    ms = m.index_select(1, sched).view(-1, 7, 16)
    a, b = cv[:, :4], cv[:, 4:]
    c = iv[:4].expand_as(a)
    d = torch.stack([counter & _M32, counter >> 32, block_len, flags], dim=1)
    for r in range(7):
        mr = ms[:, r]
        a, b, c, d = _g(a, b, c, d, mr[:, 0:8:2], mr[:, 1:8:2])
        a, b, c, d = _g(a, b.roll(-1, 1), c.roll(-2, 1), d.roll(-3, 1),
                        mr[:, 8:16:2], mr[:, 9:16:2])
        b, c, d = b.roll(1, 1), c.roll(2, 1), d.roll(3, 1)
    return torch.cat([a ^ c, b ^ d, c ^ cv[:, :4], d ^ cv[:, 4:]], dim=1)


def _root_output(cv, m, block_len: int, flags: int, out_len: int) -> bytes:
    """The extendable root output: one compression a 64-byte output
    block, its counter the block's index."""
    rows = max(1, -(-out_len // BLOCK))
    dev = cv.device
    counter = torch.arange(rows, dtype=torch.int64, device=dev)
    words = _compress_rows(cv.expand(rows, 8), m.expand(rows, 16), counter,
                           torch.full((rows,), block_len, dtype=torch.int64, device=dev),
                           torch.full((rows,), flags, dtype=torch.int64, device=dev))
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64, device=dev)
    out = ((words[..., None] >> shifts) & 0xFF).to(torch.uint8).reshape(-1)
    return out[:out_len].cpu().numpy().tobytes()


def blake3(data, out_len: int = 32, device=None) -> bytes:
    """BLAKE3 of `data` (bytes-like) as tensor code on `device` (the card
    unless it names the CPU); equal to `blake3_ref`. Every 1 KiB chunk's
    chaining value in one batch, its blocks in turn; then one batched
    compression a parent level."""
    dev = resolve_device(device)
    data = memoryview(data).cast("B")
    n = len(data)
    chunks = max(1, -(-n // CHUNK))
    padded = bytearray(chunks * CHUNK)
    padded[:n] = data
    # the bytes go to the device as they are; the little-endian words are
    # read there
    raw = torch.frombuffer(padded, dtype=torch.uint8).to(dev)
    words = (raw.view(torch.int32).to(torch.int64) & _M32).view(chunks, 16, 16)
    last_len = n - (chunks - 1) * CHUNK
    last_blocks = max(1, -(-last_len // BLOCK))
    last_block_len = last_len - (last_blocks - 1) * BLOCK
    iv = _device_constants(dev)[1]
    cv = iv.expand(chunks, 8)
    counter = torch.arange(chunks, dtype=torch.int64, device=dev)
    # one chunk: its last block is the root; else every chunk's last block
    # ends its chaining value
    steps = last_blocks - 1 if chunks == 1 else 16
    for j in range(steps):
        rows = chunks if j < last_blocks else chunks - 1
        block_len = torch.full((rows,), BLOCK, dtype=torch.int64, device=dev)
        flags = torch.full((rows,), (CHUNK_START if j == 0 else 0) |
                           (CHUNK_END if j == 15 else 0), dtype=torch.int64, device=dev)
        if rows == chunks and j == last_blocks - 1:
            block_len[-1] = last_block_len
            flags[-1] |= CHUNK_END
        out = _compress_rows(cv[:rows], words[:rows, j], counter[:rows], block_len, flags)
        cv = torch.cat([out[:, :8], cv[rows:]])
    if chunks == 1:
        flags = CHUNK_END | ROOT | (CHUNK_START if last_blocks == 1 else 0)
        return _root_output(cv, words[0, last_blocks - 1], last_block_len, flags, out_len)
    while cv.shape[0] > 2:
        pairs = cv.shape[0] // 2
        zero = torch.zeros(pairs, dtype=torch.int64, device=dev)
        parents = _compress_rows(iv.expand(pairs, 8), cv[:2 * pairs].reshape(pairs, 16), zero,
                                 zero + BLOCK, zero + PARENT)[:, :8]
        cv = torch.cat([parents, cv[2 * pairs:]])
    return _root_output(iv, cv.reshape(16), BLOCK, PARENT | ROOT, out_len)


# ---------------------------------------------------------------------------
# XXH3-64 and XXH3-128 (seed 0, the default secret): csrc/xxh3.cpp
# ---------------------------------------------------------------------------

_xxh3 = {}


def _xxh3_fn(name: str):
    fn = _xxh3.get(name)
    if fn is None:
        fn = getattr(_build.load("xxh3"), name)
        if name == "tz_xxh3_64":
            fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_size_t], ctypes.c_uint64
        else:
            fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p], None
        _xxh3[name] = fn
    return fn


def _buffer(data) -> np.ndarray:
    return np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)


def xxh3_64(data) -> int:
    """XXH3-64 of `data` by the host library built from csrc/xxh3.cpp."""
    buf = _buffer(data)
    return _xxh3_fn("tz_xxh3_64")(buf.ctypes.data, buf.size)


def xxh3_128(data) -> int:
    """XXH3-128 of `data` by the same library, as one integer (the high
    64 bits first, as `xxhash.xxh3_128_intdigest` gives it)."""
    buf = _buffer(data)
    out = np.zeros(2, dtype=np.uint64)
    _xxh3_fn("tz_xxh3_128")(buf.ctypes.data, buf.size, out.ctypes.data)
    return (int(out[1]) << 64) | int(out[0])


# ---------------------------------------------------------------------------
# Registry (name -> hex digest), tpu7z's names and strings
# ---------------------------------------------------------------------------

def _host(fn):
    def run(data, device=None):
        return fn(data)
    return run


def _hl(name):
    return _host(lambda d: hashlib.new(name, d).hexdigest())


HASHERS = {
    "CRC32": _host(lambda d: f"{crc32_native(d):08x}"),
    "CRC64": _host(lambda d: f"{crc64_native(d):016x}"),
    "XXH32": _host(lambda d: f"{xxh32_native(d):08x}"),
    "XXH64": _host(lambda d: f"{xxh64_native(d):016x}"),
    # 7-Zip presents the XXH3-64 digest as little-endian bytes
    "XXH3-64": _host(lambda d: xxh3_64(d).to_bytes(8, "little").hex()),
    "XXH3-128": _host(lambda d: f"{xxh3_128(d):032x}"),
    "MD2": _host(lambda d: md2(d).hex()),
    "MD4": _host(lambda d: md4(d).hex()),
    "MD5": _hl("md5"),
    "SHA1": _hl("sha1"),
    "SHA256": _hl("sha256"),
    "SHA384": _hl("sha384"),
    "SHA512": _hl("sha512"),
    "SHA512-224": _hl("sha512_224"),
    "SHA512-256": _hl("sha512_256"),
    "SHA3-224": _hl("sha3_224"),
    "SHA3-256": _hl("sha3_256"),
    "SHA3-384": _hl("sha3_384"),
    "SHA3-512": _hl("sha3_512"),
    "BLAKE2sp": _host(lambda d: blake2sp(d).hex()),
    "BLAKE3": lambda d, device=None: blake3(d, device=device).hex(),
}
