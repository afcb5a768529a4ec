"""BCJ branch-converter filters, a port of tpu7z/models/filters/bcj.py.

Behavioral reference: C/Bra86.c (x86 E8/E9 rewriting with the 3-bit
prevMask state machine), C/Bra.c (fixed-width ARM/ARM64/PPC/SPARC/ARMT
rewrites), C/SwapBytes.c. Each function gives tpu7z's bytes.

The fixed-width converters (ARM, ARM64, PPC, SPARC, ARM-Thumb) and the
byte swaps rewrite every aligned word at once, so they are tensor code on
the device the caller names (the CUDA card unless `device` names the
CPU): words as int64, masked to 32 bits where tpu7z's uint32 arithmetic
wraps. x86, IA-64 and RISC-V carry state from one position to the next,
so they stay on the host, as tpu7z's loops.
"""

from __future__ import annotations

import torch

from ...device import resolve_device

M32 = 0xFFFFFFFF


def _on_device(data, device) -> torch.Tensor:
    dev = resolve_device(device)
    if not data:
        return torch.empty(0, dtype=torch.uint8, device=dev)
    return torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)


def _words(s: torch.Tensor, n: int, big: bool) -> torch.Tensor:
    """The first n bytes of s as 32-bit words in int64."""
    b = s[:n].view(-1, 4).to(torch.int64)
    if big:
        b = b.flip(1)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def _with_words(s: torch.Tensor, n: int, w: torch.Tensor, big: bool) -> bytes:
    """s with its first n bytes replaced by the words w."""
    b = torch.stack([(w >> (8 * k)) & 0xFF for k in range(4)], dim=1).to(torch.uint8)
    if big:
        b = b.flip(1)
    out = s.clone()
    out[:n] = b.reshape(-1)
    return out.cpu().numpy().tobytes()


def _positions(count: int, ip: int, dev) -> torch.Tensor:
    """Each word's address, ip + 4 * i, wrapped to 32 bits."""
    return (torch.arange(count, dtype=torch.int64, device=dev) * 4 + ip) & M32


def _arm_convert(data: bytes, ip: int, encoding: bool, device=None) -> bytes:
    """ARM (little-endian A32): BL imm24 at word-aligned positions
    (opcode byte 0xEB). addr = imm24 << 2; pc bias 8."""
    n = (len(data) // 4) * 4
    if n == 0:
        return data
    s = _on_device(data, device)
    w = s[:n].view(-1, 4).to(torch.int64)
    hit = w[:, 3] == 0xEB
    v = (w[:, 0] | (w[:, 1] << 8) | (w[:, 2] << 16)) << 2
    cur = (_positions(w.shape[0], ip, s.device) + 8) & M32
    v2 = (((v + cur) if encoding else (v - cur)) & M32) >> 2
    new = torch.stack([v2 & 0xFF, (v2 >> 8) & 0xFF, (v2 >> 16) & 0xFF, w[:, 3]], dim=1)
    out = s.clone()
    out[:n] = torch.where(hit[:, None], new, w).to(torch.uint8).reshape(-1)
    return out.cpu().numpy().tobytes()


def _arm64_convert(data: bytes, ip: int, encoding: bool, device=None) -> bytes:
    """ARM64: BL (imm26, word branch) and in-range ADRP (21-bit page
    delta) rewritten to absolute (C/Bra.c arm64 branch)."""
    n = (len(data) // 4) * 4
    if n == 0:
        return data
    s = _on_device(data, device)
    w = _words(s, n, big=False)
    pos = _positions(w.numel(), ip, s.device)
    # BL: word-granular 26-bit displacement
    is_bl = (w & 0xFC000000) == 0x94000000
    imm = w & 0x03FFFFFF
    pc_words = pos >> 2
    abs_bl = (imm + pc_words) if encoding else (imm - pc_words)
    bl_new = 0x94000000 | (abs_bl & 0x03FFFFFF)
    # ADRP: page-granular 21-bit delta, only when within +-512 MiB
    is_adrp = (w & 0x9F000000) == 0x90000000
    src = ((w >> 29) & 3) | ((w >> 3) & 0x001FFFFC)
    in_range = ((src + 0x00020000) & 0x001C0000) == 0
    pc_pages = pos >> 12
    dest = (src + pc_pages) if encoding else (src - pc_pages)
    adrp_new = ((w & 0x9000001F) | ((dest & 3) << 29) | ((dest & 0x0003FFFC) << 3)
                | ((0 - (dest & 0x00020000)) & 0x00E00000))
    w = torch.where(is_bl, bl_new, torch.where(is_adrp & in_range, adrp_new, w))
    return _with_words(s, n, w, big=False)


def _ppc_convert(data: bytes, ip: int, encoding: bool, device=None) -> bytes:
    """PPC (big-endian): bl absolute-address rewrite (opcode 0x48 with
    AA/LK bits == 1)."""
    n = (len(data) // 4) * 4
    if n == 0:
        return data
    s = _on_device(data, device)
    w = _words(s, n, big=True)
    pos = _positions(w.numel(), ip, s.device)
    hit = (w & 0xFC000003) == 0x48000001
    off = w & 0x03FFFFFC
    abs_ = (off + pos) if encoding else (off - pos)
    w = torch.where(hit, 0x48000001 | (abs_ & 0x03FFFFFC), w)
    return _with_words(s, n, w, big=True)


def _sparc_convert(data: bytes, ip: int, encoding: bool, device=None) -> bytes:
    """SPARC call (30-bit word displacement), per C/Bra.c."""
    n = (len(data) // 4) * 4
    if n == 0:
        return data
    s = _on_device(data, device)
    w = _words(s, n, big=True)
    pos = _positions(w.numel(), ip, s.device)
    low = w & 0x3FFFFFFF
    hit = ((w & 0xC0000000) == 0x40000000) & ((low < 0x00400000) | (low >= 0x3FC00000))
    byte_off = (w << 2) & M32
    abs_ = ((byte_off + pos) if encoding else (byte_off - pos)) & M32
    w = torch.where(hit, 0x40000000 | ((abs_ >> 2) & 0x3FFFFFFF), w)
    return _with_words(s, n, w, big=True)


def _armt_convert(data: bytes, ip: int, encoding: bool, device=None) -> bytes:
    """ARM Thumb BL pairs (halfwords 0xF0xx 0xF8xx); 22-bit halfword
    displacement. A pair's second halfword cannot start a pair, so pairs
    never overlap and every one is rewritten at once."""
    n = len(data)
    if n < 4:
        return data
    s = _on_device(data, device)
    q = torch.arange(0, n - 3, 2, device=s.device)
    hit = ((s[q + 1] & 0xF8) == 0xF0) & ((s[q + 3] & 0xF8) == 0xF8)
    idx = q[hit]
    b = [s[idx + k].to(torch.int64) for k in range(4)]
    hi = b[0] | (b[1] << 8)
    lo = b[2] | (b[3] << 8)
    v = (hi << 11) | (lo & 0x7FF)
    c = ((idx + 4 + ip) >> 1) & M32
    v = ((v + c) if encoding else (v - c)) & M32
    new_hi = ((v >> 11) & 0x7FF) | 0xF000
    new_lo = (v & 0x7FF) | 0xF800
    out = s.clone()
    for k, val in enumerate((new_hi & 0xFF, new_hi >> 8, new_lo & 0xFF, new_lo >> 8)):
        out[idx + k] = val.to(torch.uint8)
    return out.cpu().numpy().tobytes()


def _swap(data: bytes, width: int, device=None) -> bytes:
    s = _on_device(data, device)
    n = s.numel() - s.numel() % width
    out = s.clone()
    out[:n] = s[:n].view(-1, width).flip(1).reshape(-1)
    return out.cpu().numpy().tobytes()


def swap2(data: bytes, *, device=None) -> bytes:
    """SWAP2 filter (C/SwapBytes.c): 16-bit byte swap, self-inverse."""
    return _swap(data, 2, device)


def swap4(data: bytes, *, device=None) -> bytes:
    """SWAP4 filter: 32-bit byte swap, self-inverse."""
    return _swap(data, 4, device)


def _mk(convert):
    """(encode, decode) of a tensor converter, on `device`."""
    def enc(data, ip=0, *, device=None):
        return convert(data, ip, True, device)

    def dec(data, ip=0, *, device=None):
        return convert(data, ip, False, device)
    return enc, dec


def _mk_host(convert):
    """(encode, decode) of a host converter."""
    def enc(data, ip=0):
        return convert(data, ip, True)

    def dec(data, ip=0):
        return convert(data, ip, False)
    return enc, dec


bcj_arm_encode, bcj_arm_decode = _mk(_arm_convert)
bcj_arm64_encode, bcj_arm64_decode = _mk(_arm64_convert)
bcj_ppc_encode, bcj_ppc_decode = _mk(_ppc_convert)
bcj_sparc_encode, bcj_sparc_decode = _mk(_sparc_convert)
bcj_armt_encode, bcj_armt_decode = _mk(_armt_convert)


# ---------------------------------------------------------------------------
# The serial converters, on the host: tpu7z's loops
# ---------------------------------------------------------------------------

def _test86_ms_byte(b: int) -> bool:
    return b == 0 or b == 0xFF


def _x86_convert(data: bytes, ip: int, encoding: bool) -> bytes:
    buf = bytearray(data)
    size = len(buf)
    if size < 5:
        return bytes(buf)
    limit = size - 4
    mask = 0
    pos = 0
    prev_pos = -1
    while True:
        # advance to next 0xE8/0xE9
        p = pos
        while p < limit and (buf[p] & 0xFE) != 0xE8:
            p += 1
        d = p - pos
        pos = p
        if p >= limit:
            break
        if d > 2:
            mask = 0
        else:
            mask >>= d
            if mask != 0 and (mask > 4 or mask == 3
                              or _test86_ms_byte(buf[p + (mask >> 1) + 1])):
                mask = (mask >> 1) | 4
                pos += 1
                continue
        if _test86_ms_byte(buf[p + 4]):
            v = (buf[p + 4] << 24) | (buf[p + 3] << 16) \
                | (buf[p + 2] << 8) | buf[p + 1]
            cur = (ip + 5 + pos) & 0xFFFFFFFF
            while True:
                if encoding:
                    v = (v + cur) & 0xFFFFFFFF
                else:
                    v = (v - cur) & 0xFFFFFFFF
                if mask == 0:
                    break
                sh = (mask & 6) << 2
                if _test86_ms_byte((v >> sh) & 0xFF):
                    v ^= ((0x100 << sh) - 1)
                    continue
                break
            buf[p + 1] = v & 0xFF
            buf[p + 2] = (v >> 8) & 0xFF
            buf[p + 3] = (v >> 16) & 0xFF
            buf[p + 4] = (0 - ((v >> 24) & 1)) & 0xFF
            pos += 5
            mask = 0
        else:
            mask = (mask >> 1) | 4
            pos += 1
    return bytes(buf)


def bcj_x86_encode(data: bytes, ip: int = 0) -> bytes:
    return _x86_convert(data, ip, True)


def bcj_x86_decode(data: bytes, ip: int = 0) -> bytes:
    return _x86_convert(data, ip, False)



_IA64_BRANCH_TABLE = (0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                      4, 4, 6, 6, 0, 0, 7, 7, 4, 4, 0, 0, 4, 4, 0, 0)


def _ia64_convert(data: bytes, ip: int, encoding: bool) -> bytes:
    """IA64 branch conversion over 16-byte bundles (3 x 41-bit slots)."""
    buf = bytearray(data)
    n = len(buf) & ~15
    for i in range(0, n, 16):
        mask = _IA64_BRANCH_TABLE[buf[i] & 0x1F]
        if not mask:
            continue
        bit_pos = 5
        for slot in range(3):
            if (mask >> slot) & 1:
                byte_pos = bit_pos >> 3
                bit_res = bit_pos & 7
                instr = int.from_bytes(buf[i + byte_pos:i + byte_pos + 6],
                                       "little")
                inst_norm = instr >> bit_res
                if ((inst_norm >> 37) & 0xF) == 5 \
                        and ((inst_norm >> 9) & 0x7) == 0:
                    src = (inst_norm >> 13) & 0xFFFFF
                    src |= ((inst_norm >> 36) & 1) << 20
                    src <<= 4
                    if encoding:
                        dest = (src + ip + i) & 0xFFFFFFFF
                    else:
                        dest = (src - ip - i) & 0xFFFFFFFF
                    dest >>= 4
                    inst_norm &= ~(0x8FFFFF << 13)
                    inst_norm |= (dest & 0xFFFFF) << 13
                    inst_norm |= (dest & 0x100000) << (36 - 20)
                    instr &= (1 << bit_res) - 1
                    instr |= inst_norm << bit_res
                    buf[i + byte_pos:i + byte_pos + 6] = \
                        (instr & ((1 << 48) - 1)).to_bytes(6, "little")
            bit_pos += 41
    return bytes(buf)



def _riscv_convert(data: bytes, ip: int, encoding: bool) -> bytes:
    """RISC-V branch filter (alignment 2).

    Behavioral reference: C/Bra.c BranchConv_{ENC,DEC}(RISCV) and
    CPP/7zip/Compress/BranchRegister.cpp (method 0x0B). Two rewrites:
    JAL (low byte 0x6F/0xEF) gets its scrambled 21-bit immediate
    de-interleaved, made absolute, and stored big-endian-ish; an
    AUIPC+load/store/jalr pair (when the check links their registers)
    is fused into a marker form holding the absolute 32-bit address
    big-endian. x0/x2-destination AUIPCs are reserved as the marker
    space, handled by the inverse branch so the transform is bijective.
    """
    d = bytearray(data)
    M = 0xFFFFFFFF
    n = len(d) & ~1
    if n <= 6:
        return bytes(d)
    lim = n - 6
    i = 0

    def u32(o):
        return d[o] | (d[o + 1] << 8) | (d[o + 2] << 16) | (d[o + 3] << 24)

    def pu32(o, v):
        d[o] = v & 0xFF
        d[o + 1] = (v >> 8) & 0xFF
        d[o + 2] = (v >> 16) & 0xFF
        d[o + 3] = (v >> 24) & 0xFF

    while i < lim:
        a = (((d[i] | (d[i + 1] << 8)) ^ 0x10) + 1) & M
        if a & 0x77:
            i += 2
            continue
        pc = (ip + i) & M
        if (a & 8) == 0:
            # JAL rd=ra family
            if encoding:
                if ((a - 0x100) & 0xD80):
                    i += 2
                    continue
                w = u32(i)
                v = (((w & 0x80000000) >> 11) | ((w & (0x3FF << 21)) >> 20)
                     | ((w & (1 << 20)) >> 9) | (w & (0xFF << 12)))
                v = (v + pc) & M
                d[i + 1] = ((v >> 13) & 0xF0) | ((w >> 8) & 0x0F)
                d[i + 2] = (v >> 9) & 0xFF
                d[i + 3] = (v >> 1) & 0xFF
            else:
                a = (a - 0x81) & M
                if a & 0xD80:
                    i += 2
                    continue
                low12 = (a + 0x70) & 0xFFF
                v = ((d[i + 3] << 1) | (d[i + 2] << 9)
                     | ((a & 0xF000) << 5)) & M
                v = (v - pc) & M
                w = (low12 | ((v << 11) & 0x80000000)
                     | ((v << 20) & (0x3FF << 21)) | ((v << 9) & (1 << 20))
                     | (v & (0xFF << 12)))
                pu32(i, w)
            i += 4
            continue
        # AUIPC family; v = scan value, w = full first instruction
        v = a
        w = u32(i)

        def check1(b):
            return ((((b - 3) & M) ^ ((v << 8) & M)) & 0xF8003) == 0

        def check2(r):
            return ((((v - 0x3108) & M) << 18) & M) < (r & 0x1D)

        if encoding:
            if v & 0xE80:  # rd not x0/x2: real AUIPC candidate
                b = u32(i + 4)
                if check1(b):
                    pu32(i, ((b << 12) & M) | 0x117)
                    hi = w & 0xFFFFF000
                    s = b >> 20
                    if b & 0x80000000:
                        s = (s - 0x1000) & M
                    t = (hi + s + pc) & M
                    d[i + 4] = (t >> 24) & 0xFF
                    d[i + 5] = (t >> 16) & 0xFF
                    d[i + 6] = (t >> 8) & 0xFF
                    d[i + 7] = t & 0xFF
                    i += 8
                else:
                    i += 6
            else:  # x0/x2 marker space: apply inverse so filter stays 1:1
                r = w >> 27
                if check2(r):
                    v2 = u32(i + 4)
                    pu32(i, ((r << 7) + 0x17 + (v2 & 0xFFFFF000)) & M)
                    pu32(i + 4, ((w >> 12) | ((v2 << 20) & M)) & M)
                    i += 8
                else:
                    i += 4
        else:
            if (v & 0xE80) == 0:  # marker form: restore AUIPC pair
                r = w >> 27
                if check2(r):
                    b = ((d[i + 4] << 24) | (d[i + 5] << 16)
                         | (d[i + 6] << 8) | d[i + 7])
                    b = (b - pc) & M
                    pu32(i, ((r << 7) + 0x17
                             + ((b + 0x800) & 0xFFFFF000)) & M)
                    pu32(i + 4, ((w >> 12) | ((b << 20) & M)) & M)
                    i += 8
                else:
                    i += 4
            else:  # forward-convert real pairs into marker space
                b = u32(i + 4)
                if check1(b):
                    pu32(i, ((b << 12) & M) | 0x117)
                    pu32(i + 4, (w & 0xFFFFF000) | (b >> 20))
                    i += 8
                else:
                    i += 6
    return bytes(d)


bcj_ia64_encode, bcj_ia64_decode = _mk_host(_ia64_convert)
bcj_riscv_encode, bcj_riscv_decode = _mk_host(_riscv_convert)

FILTERS = {
    "x86": (bcj_x86_encode, bcj_x86_decode),
    "arm": (bcj_arm_encode, bcj_arm_decode),
    "arm64": (bcj_arm64_encode, bcj_arm64_decode),
    "ppc": (bcj_ppc_encode, bcj_ppc_decode),
    "sparc": (bcj_sparc_encode, bcj_sparc_decode),
    "armt": (bcj_armt_encode, bcj_armt_decode),
    "ia64": (bcj_ia64_encode, bcj_ia64_decode),
    "riscv": (bcj_riscv_encode, bcj_riscv_decode),
}
