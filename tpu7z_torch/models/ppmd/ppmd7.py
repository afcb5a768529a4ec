"""PPMd variant H (PPMd7) codec with the 7z range coder, a copy of
tpu7z/models/ppmd/ppmd7.py: the same streams from the same bytes, order
and memory size, and the same errors. It runs on the host, in Python.

Behavioral reference: C/Ppmd7.c, C/Ppmd7Dec.c, C/Ppmd7Enc.c (Igor
Pavlov's public-domain implementation of Dmitry Shkarin's PPMd var.H).
This is a faithful re-expression of the algorithm in Python: the model
is inherently pointer-serial, and its behavior depends on the exact
suballocator layout (RAW-successors are text offsets compared against
unit addresses), so the 12-byte-unit memory map is emulated over a flat
buffer to keep encode/decode bit-compatible with the reference.

7z coder props (PpmdDecoder.cpp:31): order byte + u32le memory size.
"""

from __future__ import annotations

from ...utils.errors import CorruptError, ParamError

MAX_O = 64
MIN_O = 2
MAX_FREQ = 124
UNIT_SIZE = 12
N_INDEXES = 38
INT_BITS = 7
PERIOD_BITS = 7
BIN_SCALE = 1 << (INT_BITS + PERIOD_BITS)
K_TOP = 1 << 24
EXP_ESCAPE = (25, 14, 9, 7, 5, 5, 4, 4, 4, 3, 3, 3, 2, 2, 2, 2)
INIT_BIN_ESC = (0x3CDD, 0x1F3F, 0x59BF, 0x48F3, 0x64A1, 0x5ABC, 0x6632,
                0x6051)


def _get_mean(summ):
    return (summ + (1 << (PERIOD_BITS - 2))) >> PERIOD_BITS


def _hi_bits_flag3(sym):
    return ((sym + 0xC0) >> 5) & (1 << 3)


def _hi_bits_flag4(sym):
    return ((sym + 0xC0) >> 4) & (1 << 4)


class _See:
    __slots__ = ("summ", "shift", "count")

    def update(self):
        if self.shift < PERIOD_BITS:
            self.count -= 1
            if self.count == 0:
                self.summ = (self.summ << 1) & 0xFFFF
                self.count = 3 << self.shift
                self.shift += 1


class Ppmd7:
    """The model + suballocator over a flat byte buffer."""

    def __init__(self, order: int, mem_size: int):
        if not MIN_O <= order <= MAX_O:
            raise ParamError("ppmd7: bad order")
        self.max_order = order
        self.align_offset = (4 - mem_size) & 3
        self.size = mem_size
        self.B = bytearray(self.align_offset + mem_size)
        # index tables
        self.units2indx = [0] * 128
        self.indx2units = [0] * N_INDEXES
        k = 0
        for i in range(N_INDEXES):
            step = 4 if i >= 12 else (i >> 2) + 1
            for _ in range(step):
                self.units2indx[k] = i
                k += 1
            self.indx2units[i] = k
        self.ns2bsindx = [0] * 256
        self.ns2bsindx[0] = 0
        self.ns2bsindx[1] = 2
        for i in range(2, 11):
            self.ns2bsindx[i] = 4
        for i in range(11, 256):
            self.ns2bsindx[i] = 6
        self.ns2indx = [0] * 256
        for i in range(3):
            self.ns2indx[i] = i
        m, kk = 3, 1
        for i in range(3, 256):
            self.ns2indx[i] = m
            kk -= 1
            if kk == 0:
                m += 1
                kk = m - 2
        self.bin_summ = [[0] * 64 for _ in range(128)]
        self.see = [[_See() for _ in range(16)] for _ in range(25)]
        self.dummy_see = _See()
        self.restart()

    # --- raw memory accessors ---------------------------------------------

    def u16(self, off):
        return self.B[off] | (self.B[off + 1] << 8)

    def set_u16(self, off, v):
        self.B[off] = v & 0xFF
        self.B[off + 1] = (v >> 8) & 0xFF

    def u32(self, off):
        return int.from_bytes(self.B[off:off + 4], "little")

    def set_u32(self, off, v):
        self.B[off:off + 4] = (v & 0xFFFFFFFF).to_bytes(4, "little")

    # context field helpers (ctx is a ref/offset)
    def ns(self, c):
        return self.u16(c)

    def set_ns(self, c, v):
        self.set_u16(c, v)

    def summ(self, c):
        return self.u16(c + 2)

    def set_summ(self, c, v):
        self.set_u16(c + 2, v)

    def stats(self, c):
        return self.u32(c + 4)

    def set_stats(self, c, v):
        self.set_u32(c + 4, v)

    def suffix(self, c):
        return self.u32(c + 8)

    def set_suffix(self, c, v):
        self.set_u32(c + 8, v)

    def one_state(self, c):
        return c + 2

    # state field helpers (s is a ref/offset)
    def sym(self, s):
        return self.B[s]

    def set_sym(self, s, v):
        self.B[s] = v

    def freq(self, s):
        return self.B[s + 1]

    def set_freq(self, s, v):
        self.B[s + 1] = v

    def succ(self, s):
        return self.u32(s + 2)

    def set_succ(self, s, v):
        self.set_u32(s + 2, v)

    def copy_state(self, dst, src):
        self.B[dst:dst + 6] = self.B[src:src + 6]

    # --- allocator ---------------------------------------------------------

    def _u2b(self, nu):
        return nu * UNIT_SIZE

    def _u2i(self, nu):
        return self.units2indx[nu - 1]

    def _i2u(self, i):
        return self.indx2units[i]

    def insert_node(self, node, indx):
        self.set_u32(node, self.free_list[indx])
        self.free_list[indx] = node

    def remove_node(self, indx):
        node = self.free_list[indx]
        self.free_list[indx] = self.u32(node)
        return node

    def split_block(self, ptr, old_indx, new_indx):
        nu = self._i2u(old_indx) - self._i2u(new_indx)
        ptr = ptr + self._u2b(self._i2u(new_indx))
        i = self._u2i(nu)
        if self._i2u(i) != nu:
            i -= 1
            k = self._i2u(i)
            self.insert_node(ptr + self._u2b(k), nu - k - 1)
        self.insert_node(ptr, i)

    def glue_free_blocks(self):
        self.glue_count = 255
        # node fields: stamp u16@0, nu u16@2, next u32@4
        if self.lo_unit != self.hi_unit:
            self.set_u16(self.lo_unit, 1)  # guard stamp
        n = 0
        for i in range(N_INDEXES):
            nu16 = self._i2u(i)
            nxt = self.free_list[i]
            self.free_list[i] = 0
            while nxt != 0:
                tmp = nxt
                nxt = self.u32(tmp)
                self.set_u16(tmp, 0)        # stamp = EMPTY
                self.set_u16(tmp + 2, nu16)  # NU
                self.set_u32(tmp + 4, n)     # Next
                n = tmp
        head = n
        # glue adjacent free blocks
        prev_holder = None  # None => head variable
        n = head
        while n:
            node = n
            nu = self.u16(node + 2)
            n = self.u32(node + 4)
            if nu == 0:
                if prev_holder is None:
                    head = n
                else:
                    self.set_u32(prev_holder + 4, n)
                continue
            prev_holder = node
            while True:
                node2 = node + self._u2b(nu)
                nu2 = self.u16(node2 + 2)
                if self.u16(node2) != 0 or nu + nu2 >= 0x10000:
                    break
                nu += nu2
                self.set_u16(node + 2, nu)
                self.set_u16(node2 + 2, 0)
        # refill free lists
        n = head
        while n != 0:
            node = n
            nu = self.u16(node + 2)
            n = self.u32(node + 4)
            if nu == 0:
                continue
            while nu > 128:
                self.insert_node(node, N_INDEXES - 1)
                nu -= 128
                node += self._u2b(128)
            i = self._u2i(nu)
            if self._i2u(i) != nu:
                i -= 1
                k = self._i2u(i)
                self.insert_node(node + self._u2b(k), nu - k - 1)
            self.insert_node(node, i)

    def alloc_units_rare(self, indx):
        if self.glue_count == 0:
            self.glue_free_blocks()
            if self.free_list[indx] != 0:
                return self.remove_node(indx)
        i = indx
        while True:
            i += 1
            if i == N_INDEXES:
                num_bytes = self._u2b(self._i2u(indx))
                self.glue_count -= 1
                if self.units_start - self.text > num_bytes:
                    self.units_start -= num_bytes
                    return self.units_start
                return 0
            if self.free_list[i] != 0:
                break
        block = self.remove_node(i)
        self.split_block(block, i, indx)
        return block

    def alloc_units(self, indx):
        if self.free_list[indx] != 0:
            return self.remove_node(indx)
        num_bytes = self._u2b(self._i2u(indx))
        if self.hi_unit - self.lo_unit >= num_bytes:
            lo = self.lo_unit
            self.lo_unit += num_bytes
            return lo
        return self.alloc_units_rare(indx)

    def alloc_context(self):
        if self.hi_unit != self.lo_unit:
            self.hi_unit -= UNIT_SIZE
            return self.hi_unit
        if self.free_list[0] != 0:
            return self.remove_node(0)
        return self.alloc_units_rare(0)

    # --- model -------------------------------------------------------------

    def restart(self):
        self.free_list = [0] * N_INDEXES
        self.text = self.align_offset
        self.hi_unit = self.align_offset + self.size
        nu7 = self.size // 8 // UNIT_SIZE * 7 * UNIT_SIZE
        self.lo_unit = self.units_start = self.hi_unit - nu7
        self.glue_count = 0

        self.order_fall = self.max_order
        self.init_rl = -(self.max_order if self.max_order < 12 else 12) - 1
        self.run_length = self.init_rl
        self.prev_success = 0
        self.hi_bits_flag = 0
        self.init_esc = 0

        self.hi_unit -= UNIT_SIZE
        mc = self.hi_unit
        s = self.lo_unit
        self.lo_unit += self._u2b(256 // 2)
        self.max_context = self.min_context = mc
        self.found_state = s
        self.set_ns(mc, 256)
        self.set_summ(mc, 256 + 1)
        self.set_stats(mc, s)
        self.set_suffix(mc, 0)
        for i in range(256):
            self.set_sym(s, i)
            self.set_freq(s, 1)
            self.set_succ(s, 0)
            s += 6

        for i in range(128):
            for k in range(8):
                val = BIN_SCALE - INIT_BIN_ESC[k] // (i + 2)
                for m in range(0, 64, 8):
                    self.bin_summ[i][k + m] = val
        for i in range(25):
            summ = (5 * i + 10) << (PERIOD_BITS - 4)
            for k in range(16):
                se = self.see[i][k]
                se.summ = summ
                se.shift = PERIOD_BITS - 4
                se.count = 4
        self.dummy_see.summ = 0
        self.dummy_see.shift = PERIOD_BITS
        self.dummy_see.count = 64

    def create_successors(self):
        c = self.min_context
        up_branch = self.succ(self.found_state)
        ps = []
        if self.order_fall != 0:
            ps.append(self.found_state)
        while self.suffix(c):
            c = self.suffix(c)
            if self.ns(c) != 1:
                s = self.stats(c)
                symb = self.sym(self.found_state)
                while self.sym(s) != symb:
                    s += 6
            else:
                s = self.one_state(c)
            successor = self.succ(s)
            if successor != up_branch:
                c = successor
                if not ps:
                    return c
                break
            ps.append(s)

        new_sym = self.B[up_branch]
        up_branch += 1
        if self.ns(c) == 1:
            new_freq = self.freq(self.one_state(c))
        else:
            s = self.stats(c)
            while self.sym(s) != new_sym:
                s += 6
            cf = self.freq(s) - 1
            s0 = self.summ(c) - self.ns(c) - cf
            if 2 * cf <= s0:
                new_freq = 1 + (1 if 5 * cf > s0 else 0)
            else:
                new_freq = 1 + (2 * cf + s0 - 1) // (2 * s0) + 1

        while True:
            c1 = self.alloc_context()
            if not c1:
                return 0
            self.set_ns(c1, 1)
            os = self.one_state(c1)
            self.set_sym(os, new_sym)
            self.set_freq(os, new_freq)
            self.set_succ(os, up_branch)
            self.set_suffix(c1, c)
            self.set_succ(ps.pop(), c1)
            c = c1
            if not ps:
                break
        return c

    def swap_states(self, s):
        self.B[s:s + 6], self.B[s - 6:s] = \
            bytes(self.B[s - 6:s]), bytes(self.B[s:s + 6])

    def update_model(self):
        fs = self.found_state
        if self.freq(fs) < MAX_FREQ // 4 and self.suffix(self.min_context):
            c = self.suffix(self.min_context)
            if self.ns(c) == 1:
                s = self.one_state(c)
                if self.freq(s) < 32:
                    self.set_freq(s, self.freq(s) + 1)
            else:
                s = self.stats(c)
                symb = self.sym(fs)
                if self.sym(s) != symb:
                    while True:
                        s += 6
                        if self.sym(s) == symb:
                            break
                    if self.freq(s) >= self.freq(s - 6):
                        self.swap_states(s)
                        s -= 6
                if self.freq(s) < MAX_FREQ - 9:
                    self.set_freq(s, self.freq(s) + 2)
                    self.set_summ(c, self.summ(c) + 2)

        if self.order_fall == 0:
            mc = self.create_successors()
            if not mc:
                self.restart()
                return
            self.max_context = self.min_context = mc
            self.set_succ(self.found_state, mc)
            return

        self.B[self.text] = self.sym(fs)
        self.text += 1
        max_successor = self.text
        if self.text >= self.units_start:
            self.restart()
            return

        min_successor = self.succ(fs)
        if min_successor:
            if min_successor <= max_successor:
                cs = self.create_successors()
                if not cs:
                    self.restart()
                    return
                min_successor = cs
            self.order_fall -= 1
            if self.order_fall == 0:
                max_successor = min_successor
                if self.max_context != self.min_context:
                    self.text -= 1
        else:
            self.set_succ(fs, max_successor)
            min_successor = self.min_context

        mc = self.min_context
        c = self.max_context
        self.max_context = self.min_context = min_successor
        if c == mc:
            return

        ns = self.ns(mc)
        s0 = self.summ(mc) - ns - (self.freq(fs) - 1)
        fs_sym = self.sym(fs)
        fs_freq = self.freq(fs)

        while True:
            ns1 = self.ns(c)
            if ns1 != 1:
                if (ns1 & 1) == 0:
                    old_nu = ns1 >> 1
                    i = self._u2i(old_nu)
                    if i != self._u2i(old_nu + 1):
                        ptr = self.alloc_units(i + 1)
                        if not ptr:
                            self.restart()
                            return
                        old_ptr = self.stats(c)
                        self.B[ptr:ptr + self._u2b(old_nu)] = \
                            self.B[old_ptr:old_ptr + self._u2b(old_nu)]
                        self.insert_node(old_ptr, i)
                        self.set_stats(c, ptr)
                summ2 = self.summ(c)
                summ2 += (1 if 2 * ns1 < ns else 0) + 2 * (
                    (1 if 4 * ns1 <= ns else 0) & (1 if summ2 <= 8 * ns1
                                                   else 0))
            else:
                sptr = self.alloc_units(0)
                if not sptr:
                    self.restart()
                    return
                self.copy_state(sptr, self.one_state(c))
                self.set_stats(c, sptr)
                fr = self.freq(sptr)
                if fr < MAX_FREQ // 4 - 1:
                    fr <<= 1
                else:
                    fr = MAX_FREQ - 4
                self.set_freq(sptr, fr)
                summ2 = fr + self.init_esc + (1 if ns > 3 else 0)

            s = self.stats(c) + ns1 * 6
            cf = 2 * (summ2 + 6) * fs_freq
            sf = s0 + summ2
            self.set_sym(s, fs_sym)
            self.set_ns(c, ns1 + 1)
            self.set_succ(s, max_successor)
            if cf < 6 * sf:
                cf = 1 + (1 if cf > sf else 0) + (1 if cf >= 4 * sf else 0)
                summ2 += 3
            else:
                cf = (4 + (1 if cf >= 9 * sf else 0)
                      + (1 if cf >= 12 * sf else 0)
                      + (1 if cf >= 15 * sf else 0))
                summ2 += cf
            self.set_summ(c, summ2)
            self.set_freq(s, cf)
            c = self.suffix(c)
            if c == mc:
                break

    def rescale(self):
        mc = self.min_context
        stats = self.stats(mc)
        s = self.found_state
        if s != stats:
            tmp = bytes(self.B[s:s + 6])
            while s != stats:
                self.copy_state(s, s - 6)
                s -= 6
            self.B[stats:stats + 6] = tmp
        s = stats
        sum_freq = self.freq(s)
        esc_freq = self.summ(mc) - sum_freq
        adder = 1 if self.order_fall != 0 else 0
        sum_freq = (sum_freq + 4 + adder) >> 1
        self.set_freq(s, sum_freq)
        i = self.ns(mc) - 1
        while i:
            s += 6
            fr = self.freq(s)
            esc_freq -= fr
            fr = (fr + adder) >> 1
            sum_freq += fr
            self.set_freq(s, fr)
            if fr > self.freq(s - 6):
                tmp = bytes(self.B[s:s + 6])
                s1 = s
                while s1 != stats and fr > self.freq(s1 - 6):
                    self.copy_state(s1, s1 - 6)
                    s1 -= 6
                self.B[s1:s1 + 6] = tmp
            i -= 1

        if self.freq(s) == 0:
            i = 0
            while True:
                i += 1
                s -= 6
                if self.freq(s) != 0:
                    break
            esc_freq += i
            num_stats = self.ns(mc)
            num_stats_new = num_stats - i
            self.set_ns(mc, num_stats_new)
            n0 = (num_stats + 1) >> 1
            if num_stats_new == 1:
                fr = self.freq(stats)
                while True:
                    esc_freq >>= 1
                    fr = (fr + 1) >> 1
                    if esc_freq <= 1:
                        break
                os = self.one_state(mc)
                self.copy_state(os, stats)
                self.set_freq(os, fr)
                self.found_state = os
                self.insert_node(stats, self._u2i(n0))
                return
            n1 = (num_stats_new + 1) >> 1
            if n0 != n1:
                i0 = self._u2i(n0)
                i1 = self._u2i(n1)
                if i0 != i1:
                    if self.free_list[i1] != 0:
                        ptr = self.remove_node(i1)
                        self.set_stats(mc, ptr)
                        self.B[ptr:ptr + self._u2b(n1)] = \
                            self.B[stats:stats + self._u2b(n1)]
                        self.insert_node(stats, i0)
                    else:
                        self.split_block(stats, i0, i1)
        mc = self.min_context
        self.set_summ(mc, sum_freq + esc_freq - (esc_freq >> 1))
        self.found_state = self.stats(mc)

    def make_esc_freq(self, num_masked):
        mc = self.min_context
        num_stats = self.ns(mc)
        if num_stats != 256:
            non_masked = num_stats - num_masked
            idx = (self.ns2indx[non_masked - 1])
            see = self.see[idx][
                (1 if non_masked < self.ns(self.suffix(mc)) - num_stats
                 else 0)
                + 2 * (1 if self.summ(mc) < 11 * num_stats else 0)
                + 4 * (1 if num_masked > non_masked else 0)
                + self.hi_bits_flag]
            summ = see.summ & 0xFFFF
            r = summ >> see.shift
            see.summ = (summ - r) & 0xFFFF
            return see, r + (1 if r == 0 else 0)
        return self.dummy_see, 1

    def next_context(self):
        c = self.succ(self.found_state)
        if self.order_fall == 0 and c > self.text:
            self.max_context = self.min_context = c
        else:
            self.update_model()

    def update1(self):
        s = self.found_state
        fr = self.freq(s) + 4
        self.set_summ(self.min_context, self.summ(self.min_context) + 4)
        self.set_freq(s, fr & 0xFF)
        if fr > self.freq(s - 6):
            self.swap_states(s)
            s -= 6
            self.found_state = s
            if fr > MAX_FREQ:
                self.rescale()
        self.next_context()

    def update1_0(self):
        s = self.found_state
        mc = self.min_context
        fr = self.freq(s)
        summ_freq = self.summ(mc)
        self.prev_success = 1 if 2 * fr > summ_freq else 0
        self.run_length += self.prev_success
        self.set_summ(mc, summ_freq + 4)
        fr += 4
        self.set_freq(s, fr & 0xFF)
        if fr > MAX_FREQ:
            self.rescale()
        self.next_context()

    def update2(self):
        s = self.found_state
        fr = self.freq(s) + 4
        self.run_length = self.init_rl
        self.set_summ(self.min_context, self.summ(self.min_context) + 4)
        self.set_freq(s, fr & 0xFF)
        if fr > MAX_FREQ:
            self.rescale()
        self.update_model()

    def get_bin_summ_idx(self):
        os = self.one_state(self.min_context)
        self.hi_bits_flag = _hi_bits_flag3(self.sym(self.found_state))
        row = self.freq(os) - 1
        col = (self.prev_success
               + ((self.run_length >> 26) & 0x20)
               + self.ns2bsindx[self.ns(self.suffix(self.min_context)) - 1]
               + _hi_bits_flag4(self.sym(os))
               + self.hi_bits_flag)
        return row, col


# ---------------------------------------------------------------------------
# 7z range coder (decoder / encoder)
# ---------------------------------------------------------------------------

class _RDec:
    __slots__ = ("data", "pos", "code", "range")

    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.code = 0
        self.range = 0xFFFFFFFF
        if self._byte() != 0:
            raise CorruptError("ppmd7: bad stream start")
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF

    def _byte(self):
        if self.pos < len(self.data):
            b = self.data[self.pos]
        else:
            b = 0
        self.pos += 1
        return b

    def norm(self):
        while self.range < K_TOP:
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF

    def threshold(self, total):
        self.range //= total
        return self.code // self.range

    def decode(self, start, size):
        self.code -= start * self.range
        self.range *= size
        self.range &= 0xFFFFFFFF

    def decode_bit0(self, size0):
        self.range = size0
        if self.range < K_TOP:
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF

    def decode_bit1(self, size0):
        self.code -= size0
        self.range -= size0


class _REnc:
    __slots__ = ("low", "range", "cache", "cache_size", "out")

    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def shift_low(self):
        if (self.low & 0xFFFFFFFF) < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            for _ in range(self.cache_size - 1):
                self.out.append((0xFF + carry) & 0xFF)
            self.cache_size = 0
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def norm(self):
        while self.range < K_TOP:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.shift_low()

    def encode(self, start, size):
        self.low += start * self.range
        self.range *= size
        self.range &= 0xFFFFFFFF

    def flush(self):
        for _ in range(5):
            self.shift_low()
        return bytes(self.out)


# ---------------------------------------------------------------------------
# Symbol decode / encode (Ppmd7Dec.c / Ppmd7Enc.c logic)
# ---------------------------------------------------------------------------

def _decode_symbol(p: Ppmd7, rc: _RDec):
    mask = bytearray(256)
    mc = p.min_context
    if p.ns(mc) != 1:
        s = p.stats(mc)
        summ_freq = p.summ(mc)
        count = rc.threshold(summ_freq)
        hi_cnt = count
        count -= p.freq(s)
        if count < 0:
            rc.decode(0, p.freq(s))
            rc.norm()
            p.found_state = s
            symb = p.sym(s)
            p.update1_0()
            return symb
        p.prev_success = 0
        i = p.ns(mc) - 1
        while i:
            s += 6
            count -= p.freq(s)
            if count < 0:
                rc.decode((hi_cnt - count) - p.freq(s), p.freq(s))
                rc.norm()
                p.found_state = s
                symb = p.sym(s)
                p.update1()
                return symb
            i -= 1
        if hi_cnt >= summ_freq:
            raise CorruptError("ppmd7: decode error")
        hi_cnt -= count
        rc.decode(hi_cnt, summ_freq - hi_cnt)
        p.hi_bits_flag = _hi_bits_flag3(p.sym(p.found_state))
        for _ in (0,):
            s2 = p.stats(mc)
            end = s + 6
            while s2 != end:
                mask[p.sym(s2)] = 1
                s2 += 6
    else:
        s = p.one_state(mc)
        row, col = p.get_bin_summ_idx()
        pr = p.bin_summ[row][col]
        size0 = (rc.range >> 14) * pr
        pr_new = pr - _get_mean(pr)
        if rc.code < size0:
            p.bin_summ[row][col] = (pr_new + (1 << INT_BITS)) & 0xFFFF
            rc.decode_bit0(size0)
            symb = p.sym(s)
            fr = p.freq(s)
            c = p.succ(s)
            p.found_state = s
            p.prev_success = 1
            p.run_length += 1
            p.set_freq(s, fr + (1 if fr < 128 else 0))
            if p.order_fall == 0 and c > p.text:
                p.max_context = p.min_context = c
            else:
                p.update_model()
            return symb
        p.bin_summ[row][col] = pr_new & 0xFFFF
        p.init_esc = EXP_ESCAPE[pr_new >> 10]
        rc.decode_bit1(size0)
        mask[p.sym(s)] = 1
        p.prev_success = 0

    while True:
        rc.norm()
        mc = p.min_context
        num_masked = p.ns(mc)
        while True:
            p.order_fall += 1
            if not p.suffix(mc):
                return -1  # end of stream
            mc = p.suffix(mc)
            if p.ns(mc) != num_masked:
                break
        p.min_context = mc
        s = p.stats(mc)
        num = p.ns(mc)
        hi_cnt = 0
        ss = s
        for _ in range(num):
            if not mask[p.sym(ss)]:
                hi_cnt += p.freq(ss)
            ss += 6
        see, esc_freq = p.make_esc_freq(num_masked)
        freq_sum = esc_freq + hi_cnt
        count = rc.threshold(freq_sum)
        if count < hi_cnt:
            acc = count
            ss = s
            while True:
                if not mask[p.sym(ss)]:
                    acc -= p.freq(ss)
                    if acc < 0:
                        break
                ss += 6
            fr = p.freq(ss)
            rc.decode((count - acc) - fr, fr)
            rc.norm()
            see.update()
            p.found_state = ss
            symb = p.sym(ss)
            p.update2()
            return symb
        if count >= freq_sum:
            raise CorruptError("ppmd7: decode error (esc)")
        rc.decode(hi_cnt, freq_sum - hi_cnt)
        see.summ = (see.summ + freq_sum) & 0xFFFF
        ss = s
        for _ in range(num):
            mask[p.sym(ss)] = 1
            ss += 6


def _encode_symbol(p: Ppmd7, rc: _REnc, symbol: int):
    mask = bytearray(256)
    mc = p.min_context
    if p.ns(mc) != 1:
        s = p.stats(mc)
        rc.range //= p.summ(mc)
        if p.sym(s) == symbol:
            rc.encode(0, p.freq(s))
            rc.norm()
            p.found_state = s
            p.update1_0()
            return
        p.prev_success = 0
        summ = p.freq(s)
        i = p.ns(mc) - 1
        found = False
        while i:
            s += 6
            if p.sym(s) == symbol:
                rc.encode(summ, p.freq(s))
                rc.norm()
                p.found_state = s
                p.update1()
                return
            summ += p.freq(s)
            i -= 1
        rc.encode(summ, p.summ(mc) - summ)
        p.hi_bits_flag = _hi_bits_flag3(p.sym(p.found_state))
        s2 = p.stats(mc)
        end = s + 6
        while s2 != end:
            mask[p.sym(s2)] = 1
            s2 += 6
    else:
        s = p.one_state(mc)
        row, col = p.get_bin_summ_idx()
        pr = p.bin_summ[row][col]
        bound = (rc.range >> 14) * pr
        pr_new = pr - _get_mean(pr)
        if p.sym(s) == symbol:
            p.bin_summ[row][col] = (pr_new + (1 << INT_BITS)) & 0xFFFF
            rc.range = bound
            if rc.range < K_TOP:
                rc.range = (rc.range << 8) & 0xFFFFFFFF
                rc.shift_low()
            fr = p.freq(s)
            c = p.succ(s)
            p.found_state = s
            p.prev_success = 1
            p.run_length += 1
            p.set_freq(s, fr + (1 if fr < 128 else 0))
            if p.order_fall == 0 and c > p.text:
                p.max_context = p.min_context = c
            else:
                p.update_model()
            return
        p.bin_summ[row][col] = pr_new & 0xFFFF
        p.init_esc = EXP_ESCAPE[pr_new >> 10]
        rc.low += bound
        rc.range -= bound
        mask[p.sym(s)] = 1
        p.prev_success = 0

    while True:
        rc.norm()
        mc = p.min_context
        num_masked = p.ns(mc)
        while True:
            p.order_fall += 1
            if not p.suffix(mc):
                raise CorruptError("ppmd7: cannot encode symbol")
            mc = p.suffix(mc)
            if p.ns(mc) != num_masked:
                break
        p.min_context = mc
        see, esc_freq = p.make_esc_freq(num_masked)
        s = p.stats(mc)
        num = p.ns(mc)
        summ = 0
        found_s = 0
        ss = s
        for _ in range(num):
            cur = p.sym(ss)
            if cur == symbol:
                found_s = ss
                break
            if not mask[cur]:
                summ += p.freq(ss)
            ss += 6
        if found_s:
            low = summ
            fr = p.freq(found_s)
            see.update()
            p.found_state = found_s
            total = low + fr + esc_freq
            ss = found_s + 6
            rem = num - ((found_s - s) // 6) - 1
            for _ in range(rem):
                if not mask[p.sym(ss)]:
                    total += p.freq(ss)
                ss += 6
            rc.range //= total
            rc.encode(low, fr)
            rc.norm()
            p.update2()
            return
        # escape again
        hi_cnt = summ
        total = hi_cnt + esc_freq
        see.summ = (see.summ + total) & 0xFFFF
        rc.range //= total
        rc.encode(hi_cnt, esc_freq)
        ss = s
        for _ in range(num):
            mask[p.sym(ss)] = 1
            ss += 6


# ---------------------------------------------------------------------------
# Public API (7z coder framing)
# ---------------------------------------------------------------------------

def decompress(src: bytes, props: bytes, out_size: int) -> bytes:
    """Raw 7z PPMd stream: props = order byte + u32le memSize."""
    if len(props) < 5:
        raise CorruptError("ppmd7: missing props")
    order = props[0]
    mem = int.from_bytes(props[1:5], "little")
    p = Ppmd7(order, mem)
    rc = _RDec(src)
    out = bytearray()
    for _ in range(out_size):
        symb = _decode_symbol(p, rc)
        if symb < 0:
            raise CorruptError("ppmd7: unexpected end symbol")
        out.append(symb)
    return bytes(out)


def compress(data: bytes, order: int = 6, mem: int = 1 << 24):
    """Returns (stream, props)."""
    p = Ppmd7(order, mem)
    rc = _REnc()
    for b in data:
        _encode_symbol(p, rc, b)
    stream = rc.flush()
    props = bytes([order]) + mem.to_bytes(4, "little")
    return stream, props
