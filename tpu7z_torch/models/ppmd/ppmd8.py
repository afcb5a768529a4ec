"""PPMd variant I (PPMd8) codec with the Subbotin carryless range coder,
a copy of tpu7z/models/ppmd/ppmd8.py: the same .zip method-98 streams
and the same errors. It runs on the host, in Python.

Behavioral reference: C/Ppmd8.c, C/Ppmd8Dec.c, C/Ppmd8Enc.c (Igor
Pavlov's public-domain implementation of Dmitry Shkarin's PPMd var.I,
rev.2, FREEZE mode disabled) and the zip framing of
CPP/7zip/Compress/PpmdZip.cpp:55-73,265-272.

Like ppmd7.py this is a faithful re-expression over a flat byte buffer:
the model's behavior depends on the exact 12-byte-unit suballocator
layout (successor refs are compared against UnitsStart), so the memory
map is emulated to keep encode/decode bit-compatible with the reference.

H -> I differences (Ppmd8Enc.c:232-240 summary): NS2Indx tables, glue
method + stamps, BinSumm/See init and indexing via the context Flags
byte, CreateSuccessors updating suffix freqs, ReduceOrder + CutOff
restore, UpdateModel constants, carryless range coder (kTop/kBot).
"""

from __future__ import annotations

from ...utils.errors import CorruptError, ParamError

MAX_O = 16
MIN_O = 2
MAX_FREQ = 124
UNIT_SIZE = 12
N_INDEXES = 38
INT_BITS = 7
PERIOD_BITS = 7
BIN_SCALE = 1 << (INT_BITS + PERIOD_BITS)
K_TOP = 1 << 24
K_BOT = 1 << 15
EMPTY_NODE = 0xFFFFFFFF
EXP_ESCAPE = (25, 14, 9, 7, 5, 5, 4, 4, 4, 3, 3, 3, 2, 2, 2, 2)
INIT_BIN_ESC = (0x3CDD, 0x1F3F, 0x59BF, 0x48F3, 0x64A1, 0x5ABC, 0x6632,
                0x6051)

FLAG_RESCALED = 1 << 2
FLAG_PREV_HIGH = 1 << 4

RESTORE_RESTART = 0
RESTORE_CUT_OFF = 1

SYM_END = -1
SYM_ERROR = -2


def _hi_bits_flag3(sym):
    return ((sym + 0xC0) >> 5) & (1 << 3)


def _hi_bits_flag4(sym):
    return ((sym + 0xC0) >> 4) & (1 << 4)


def _get_mean(summ):
    return (summ + (1 << (PERIOD_BITS - 2))) >> PERIOD_BITS


class _See:
    __slots__ = ("summ", "shift", "count")

    def update(self):
        if self.shift < PERIOD_BITS:
            self.count -= 1
            if self.count == 0:
                self.summ = (self.summ << 1) & 0xFFFF
                self.count = 3 << self.shift
                self.shift += 1


class Ppmd8:
    """Model + suballocator over a flat byte buffer.

    Context (12B): NumStats u8@0 (= count-1), Flags u8@1, SummFreq
    u16@2 (or one-state at @2), Stats u32@4, Suffix u32@8.
    State (6B): Symbol u8, Freq u8, Successor u32.
    Free node (12B): Stamp u32@0, Next u32@4, NU u32@8."""

    def __init__(self, order: int, mem_size: int,
                 restore: int = RESTORE_RESTART):
        if not MIN_O <= order <= MAX_O:
            raise ParamError("ppmd8: bad order")
        if restore not in (RESTORE_RESTART, RESTORE_CUT_OFF):
            raise ParamError("ppmd8: bad restore method")
        self.max_order = order
        self.restore = restore
        self.align_offset = (4 - mem_size) & 3
        self.size = mem_size
        self.B = bytearray(self.align_offset + mem_size)
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
        # NS2Indx[260] (Ppmd8.c:74-81)
        self.ns2indx = [0] * 260
        for i in range(5):
            self.ns2indx[i] = i
        m, kk = 5, 1
        for i in range(5, 260):
            self.ns2indx[i] = m
            kk -= 1
            if kk == 0:
                m += 1
                kk = m - 4
        self.bin_summ = [[0] * 64 for _ in range(25)]
        self.see = [[_See() for _ in range(32)] for _ in range(24)]
        self.dummy_see = _See()
        self.restart()

    # --- raw memory accessors ------------------------------------------

    def u16(self, off):
        return self.B[off] | (self.B[off + 1] << 8)

    def set_u16(self, off, v):
        self.B[off] = v & 0xFF
        self.B[off + 1] = (v >> 8) & 0xFF

    def u32(self, off):
        return int.from_bytes(self.B[off:off + 4], "little")

    def set_u32(self, off, v):
        self.B[off:off + 4] = (v & 0xFFFFFFFF).to_bytes(4, "little")

    # context fields
    def ns(self, c):            # stored count-1
        return self.B[c]

    def set_ns(self, c, v):
        self.B[c] = v & 0xFF

    def flags(self, c):
        return self.B[c + 1]

    def set_flags(self, c, v):
        self.B[c + 1] = v & 0xFF

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

    # state fields
    def sym(self, s):
        return self.B[s]

    def set_sym(self, s, v):
        self.B[s] = v & 0xFF

    def freq(self, s):
        return self.B[s + 1]

    def set_freq(self, s, v):
        self.B[s + 1] = v & 0xFF

    def succ(self, s):
        return self.u32(s + 2)

    def set_succ(self, s, v):
        self.set_u32(s + 2, v)

    def copy_state(self, dst, src):
        self.B[dst:dst + 6] = self.B[src:src + 6]

    def swap_states(self, a, b):
        self.B[a:a + 6], self.B[b:b + 6] = \
            bytes(self.B[b:b + 6]), bytes(self.B[a:a + 6])

    # --- allocator ------------------------------------------------------

    def _u2b(self, nu):
        return nu * UNIT_SIZE

    def _u2i(self, nu):
        return self.units2indx[nu - 1]

    def _i2u(self, i):
        return self.indx2units[i]

    def insert_node(self, node, indx):
        self.set_u32(node, EMPTY_NODE)
        self.set_u32(node + 4, self.free_list[indx])
        self.set_u32(node + 8, self._i2u(indx))
        self.free_list[indx] = node
        self.stamps[indx] += 1

    def remove_node(self, indx):
        node = self.free_list[indx]
        self.free_list[indx] = self.u32(node + 4)
        self.stamps[indx] -= 1
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
        # Ppmd8.c:168-248
        self.glue_count = 1 << 13
        self.stamps = [0] * N_INDEXES
        if self.lo_unit != self.hi_unit:
            self.set_u32(self.lo_unit, 0)  # guard stamp
        # chain all free blocks, gluing adjacent ones
        head = 0
        prev_holder = None  # None => head
        for i in range(N_INDEXES):
            nxt = self.free_list[i]
            self.free_list[i] = 0
            while nxt != 0:
                node = nxt
                nu = self.u32(node + 8)
                if prev_holder is None:
                    head = node
                else:
                    self.set_u32(prev_holder + 4, node)
                nxt = self.u32(node + 4)
                if nu != 0:
                    prev_holder = node
                    while self.u32(node + self._u2b(nu)) == EMPTY_NODE:
                        node2 = node + self._u2b(nu)
                        nu += self.u32(node2 + 8)
                        self.set_u32(node2 + 8, 0)
                        self.set_u32(node + 8, nu)
        if prev_holder is None:
            head = 0
        else:
            self.set_u32(prev_holder + 4, 0)
        # refill free lists
        n = head
        while n != 0:
            node = n
            nu = self.u32(node + 8)
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

    def shrink_units(self, old_ptr, old_nu, new_nu):
        i0 = self._u2i(old_nu)
        i1 = self._u2i(new_nu)
        if i0 == i1:
            return old_ptr
        if self.free_list[i1] != 0:
            ptr = self.remove_node(i1)
            self.B[ptr:ptr + self._u2b(new_nu)] = \
                self.B[old_ptr:old_ptr + self._u2b(new_nu)]
            self.insert_node(old_ptr, i0)
            return ptr
        self.split_block(old_ptr, i0, i1)
        return old_ptr

    def free_units(self, ptr, nu):
        self.insert_node(ptr, self._u2i(nu))

    def special_free_unit(self, ptr):
        if ptr != self.units_start:
            self.insert_node(ptr, 0)
        else:
            self.units_start += UNIT_SIZE

    def expand_text_area(self):
        # Ppmd8.c:370-410
        count = [0] * N_INDEXES
        if self.lo_unit != self.hi_unit:
            self.set_u32(self.lo_unit, 0)
        node = self.units_start
        while self.u32(node) == EMPTY_NODE:
            nu = self.u32(node + 8)
            self.set_u32(node, 0)
            count[self._u2i(nu)] += 1
            node += self._u2b(nu)
        self.units_start = node
        for i in range(N_INDEXES):
            cnt = count[i]
            if cnt == 0:
                continue
            self.stamps[i] -= cnt
            prev_holder = None  # None => free_list head
            n = self.free_list[i]
            while True:
                node = n
                n = self.u32(node + 4)
                if self.u32(node) != 0:
                    prev_holder = node
                    continue
                if prev_holder is None:
                    self.free_list[i] = n
                else:
                    self.set_u32(prev_holder + 4, n)
                cnt -= 1
                if cnt == 0:
                    break

    def used_memory(self):
        v = 0
        for i in range(N_INDEXES):
            v += self.stamps[i] * self._i2u(i)
        return (self.size - (self.hi_unit - self.lo_unit)
                - (self.units_start - self.text) - self._u2b(v))

    # --- model ----------------------------------------------------------

    def restart(self):
        self.free_list = [0] * N_INDEXES
        self.stamps = [0] * N_INDEXES
        self.text = self.align_offset
        self.hi_unit = self.align_offset + self.size
        nu7 = self.size // 8 // UNIT_SIZE * 7 * UNIT_SIZE
        self.lo_unit = self.units_start = self.hi_unit - nu7
        self.glue_count = 0

        self.order_fall = self.max_order
        self.init_rl = -(self.max_order if self.max_order < 12 else 12) - 1
        self.run_length = self.init_rl
        self.prev_success = 0
        self.init_esc = 0

        self.hi_unit -= UNIT_SIZE
        mc = self.hi_unit
        s = self.lo_unit
        self.lo_unit += self._u2b(256 // 2)
        self.max_context = self.min_context = mc
        self.found_state = s
        self.set_flags(mc, 0)
        self.set_ns(mc, 256 - 1)
        self.set_summ(mc, 256 + 1)
        self.set_stats(mc, s)
        self.set_suffix(mc, 0)
        for i in range(256):
            self.set_sym(s, i)
            self.set_freq(s, 1)
            self.set_succ(s, 0)
            s += 6

        # BinSumm init (Ppmd8.c:470-482)
        i = 0
        for m in range(25):
            while self.ns2indx[i] == m:
                i += 1
            for k in range(8):
                val = (BIN_SCALE - INIT_BIN_ESC[k] // (i + 1)) & 0xFFFF
                for r in range(0, 64, 8):
                    self.bin_summ[m][k + r] = val
        # See init (Ppmd8.c:484-498)
        i = 0
        for m in range(24):
            while self.ns2indx[i + 3] == m + 3:
                i += 1
            summ = (2 * i + 5) << (PERIOD_BITS - 4)
            for k in range(32):
                se = self.see[m][k]
                se.summ = summ
                se.shift = PERIOD_BITS - 4
                se.count = 7
        self.dummy_see.summ = 0
        self.dummy_see.shift = PERIOD_BITS
        self.dummy_see.count = 64

    # --- refresh / cut-off (restore machinery) -------------------------

    def refresh(self, ctx, old_nu, scale):
        # Ppmd8.c:533-580
        i = self.ns(ctx)
        s = self.shrink_units(self.stats(ctx), old_nu, (i + 2) >> 1)
        self.set_stats(ctx, s)
        scale |= 1 if self.summ(ctx) >= (1 << 15) else 0
        flags = self.sym(s) + 0xC0
        fr = self.freq(s)
        esc_freq = self.summ(ctx) - fr
        fr = (fr + scale) >> scale
        sum_freq = fr
        self.set_freq(s, fr)
        while i:
            s += 6
            fr = self.freq(s)
            esc_freq -= fr
            fr = (fr + scale) >> scale
            sum_freq += fr
            self.set_freq(s, fr)
            flags |= self.sym(s) + 0xC0
            i -= 1
        self.set_summ(ctx, sum_freq + ((esc_freq + scale) >> scale))
        self.set_flags(ctx, (self.flags(ctx)
                             & (FLAG_PREV_HIGH + FLAG_RESCALED * scale))
                       + ((flags >> 5) & (1 << 3)))

    def cut_off(self, ctx, order):
        # Ppmd8.c:596-675
        ns = self.ns(ctx)
        if ns == 0:
            s = self.one_state(ctx)
            successor = self.succ(s)
            if successor >= self.units_start:
                if order < self.max_order:
                    successor = self.cut_off(successor, order + 1)
                else:
                    successor = 0
                self.set_succ(s, successor)
                if successor or order <= 9:  # O_BOUND
                    return ctx
            self.special_free_unit(ctx)
            return 0

        nu = (ns + 2) >> 1
        # MoveUnitsUp when stats are close to UnitsStart
        indx = self._u2i(nu)
        stats = self.stats(ctx)
        if (stats - self.units_start) <= (1 << 14) and \
                self.stats(ctx) <= self.free_list[indx]:
            ptr = self.remove_node(indx)
            self.set_stats(ctx, ptr)
            self.B[ptr:ptr + self._u2b(nu)] = \
                self.B[stats:stats + self._u2b(nu)]
            if stats != self.units_start:
                self.insert_node(stats, indx)
            else:
                self.units_start += self._u2b(self._i2u(indx))
            stats = ptr

        s = stats + ns * 6
        while s >= stats:
            successor = self.succ(s)
            if successor < self.units_start:
                s2 = stats + ns * 6
                ns -= 1
                if order:
                    if s != s2:
                        self.copy_state(s, s2)
                else:
                    self.swap_states(s, s2)
                    self.set_succ(s2, 0)
            else:
                if order < self.max_order:
                    self.set_succ(s, self.cut_off(successor, order + 1))
                else:
                    self.set_succ(s, 0)
            s -= 6

        if ns != self.ns(ctx) and order:
            if ns < 0:
                self.free_units(stats, nu)
                self.special_free_unit(ctx)
                return 0
            self.set_ns(ctx, ns)
            if ns == 0:
                sym = self.sym(stats)
                self.set_flags(ctx, (self.flags(ctx) & FLAG_PREV_HIGH)
                               + _hi_bits_flag3(sym))
                os = self.one_state(ctx)
                self.set_sym(os, sym)
                self.set_freq(os, (self.freq(stats) + 11) >> 3)
                self.set_succ(os, self.succ(stats))
                self.free_units(stats, nu)
            else:
                self.refresh(ctx, nu,
                             1 if self.summ(ctx) > 16 * ns else 0)
        return ctx

    def restore_model(self, ctx_error):
        # Ppmd8.c:782-858
        self.text = self.align_offset
        c = self.max_context
        while c != ctx_error:
            ns = self.ns(c) - 1
            self.set_ns(c, ns)
            if ns == 0:
                s = self.stats(c)
                sym = self.sym(s)
                self.set_flags(c, (self.flags(c) & FLAG_PREV_HIGH)
                               + _hi_bits_flag3(sym))
                os = self.one_state(c)
                self.set_sym(os, sym)
                self.set_freq(os, (self.freq(s) + 11) >> 3)
                self.set_succ(os, self.succ(s))
                self.special_free_unit(s)
            else:
                self.refresh(c, (ns + 3) >> 1, 0)
            c = self.suffix(c)
        while c != self.min_context:
            if self.ns(c) == 0:
                os = self.one_state(c)
                self.set_freq(os, (self.freq(os) + 1) >> 1)
            else:
                summ = self.summ(c) + 4
                self.set_summ(c, summ)
                if summ > 128 + 4 * self.ns(c):
                    self.refresh(c, (self.ns(c) + 2) >> 1, 1)
            c = self.suffix(c)

        if self.restore == RESTORE_RESTART or \
                self.used_memory() < (self.size >> 1):
            self.restart()
        else:
            while self.suffix(self.max_context):
                self.max_context = self.suffix(self.max_context)
            while True:
                self.cut_off(self.max_context, 0)
                self.expand_text_area()
                if self.used_memory() <= 3 * (self.size >> 2):
                    break
            self.glue_count = 0
            self.order_fall = self.max_order
        self.min_context = self.max_context

    # --- successor creation / model update ------------------------------

    def create_successors(self, skip, s1, c):
        # Ppmd8.c:863-962
        up_branch = self.succ(self.found_state)
        ps = []
        if not skip:
            ps.append(self.found_state)
        while self.suffix(c):
            c = self.suffix(c)
            if s1 is not None:
                s = s1
                s1 = None
            elif self.ns(c) != 0:
                symb = self.sym(self.found_state)
                s = self.stats(c)
                while self.sym(s) != symb:
                    s += 6
                if self.freq(s) < MAX_FREQ - 9:
                    self.set_freq(s, self.freq(s) + 1)
                    self.set_summ(c, self.summ(c) + 1)
            else:
                s = self.one_state(c)
                bump = (1 if self.ns(self.suffix(c)) == 0 else 0) & \
                    (1 if self.freq(s) < 24 else 0)
                self.set_freq(s, self.freq(s) + bump)
            successor = self.succ(s)
            if successor != up_branch:
                c = successor
                if not ps:
                    return c
                break
            ps.append(s)

        new_sym = self.B[up_branch]
        up_branch += 1
        flags = _hi_bits_flag4(self.sym(self.found_state)) + \
            _hi_bits_flag3(new_sym)
        if self.ns(c) == 0:
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
                new_freq = 1 + (cf + 2 * s0 - 3) // s0

        while True:
            c1 = self.alloc_context()
            if not c1:
                return 0
            self.set_flags(c1, flags)
            self.set_ns(c1, 0)
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

    def reduce_order(self, s1, c):
        # Ppmd8.c:966-1063
        c1 = c
        up_branch = self.text
        self.set_succ(self.found_state, up_branch)
        self.order_fall += 1
        while True:
            if s1 is not None:
                c = self.suffix(c)
                s = s1
                s1 = None
            else:
                if not self.suffix(c):
                    return c
                c = self.suffix(c)
                if self.ns(c) != 0:
                    symb = self.sym(self.found_state)
                    s = self.stats(c)
                    while self.sym(s) != symb:
                        s += 6
                    if self.freq(s) < MAX_FREQ - 9:
                        self.set_freq(s, self.freq(s) + 2)
                        self.set_summ(c, self.summ(c) + 2)
                else:
                    s = self.one_state(c)
                    if self.freq(s) < 32:
                        self.set_freq(s, self.freq(s) + 1)
            if self.succ(s):
                break
            self.set_succ(s, up_branch)
            self.order_fall += 1

        if self.succ(s) <= up_branch:
            s2 = self.found_state
            self.found_state = s
            cs = self.create_successors(False, None, c)
            self.set_succ(s, cs if cs else 0)
            self.found_state = s2
        successor = self.succ(s)
        if self.order_fall == 1 and c1 == self.max_context:
            self.set_succ(self.found_state, successor)
            self.text -= 1
        if successor == 0:
            return 0
        return successor

    def update_model(self):
        # Ppmd8.c:1067-1311
        fs = self.found_state
        min_successor = self.succ(fs)
        f_freq = self.freq(fs)
        f_symbol = self.sym(fs)
        s = None
        if f_freq < MAX_FREQ // 4 and self.suffix(self.min_context):
            c = self.suffix(self.min_context)
            if self.ns(c) == 0:
                s = self.one_state(c)
                if self.freq(s) < 32:
                    self.set_freq(s, self.freq(s) + 1)
            else:
                symb = f_symbol
                s = self.stats(c)
                if self.sym(s) != symb:
                    while True:
                        s += 6
                        if self.sym(s) == symb:
                            break
                    if self.freq(s) >= self.freq(s - 6):
                        self.swap_states(s, s - 6)
                        s -= 6
                if self.freq(s) < MAX_FREQ - 9:
                    self.set_freq(s, self.freq(s) + 2)
                    self.set_summ(c, self.summ(c) + 2)

        c = self.max_context
        if self.order_fall == 0 and min_successor:
            cs = self.create_successors(True, s, self.min_context)
            if not cs:
                self.set_succ(fs, 0)
                self.restore_model(c)
                return
            self.set_succ(fs, cs)
            self.min_context = self.max_context = cs
            return

        self.B[self.text] = f_symbol
        self.text += 1
        max_successor = self.text
        if self.text >= self.units_start:
            self.restore_model(c)
            return

        if not min_successor:
            cs = self.reduce_order(s, self.min_context)
            if not cs:
                self.restore_model(c)
                return
            min_successor = cs
        elif min_successor < self.units_start:
            cs = self.create_successors(False, s, self.min_context)
            if not cs:
                self.restore_model(c)
                return
            min_successor = cs

        self.order_fall -= 1
        if self.order_fall == 0:
            max_successor = min_successor
            if self.max_context != self.min_context:
                self.text -= 1

        flag = _hi_bits_flag3(f_symbol)
        ns = self.ns(self.min_context)
        s0 = self.summ(self.min_context) - ns - f_freq

        while c != self.min_context:
            ns1 = self.ns(c)
            if ns1 != 0:
                if (ns1 & 1) != 0:
                    old_nu = (ns1 + 1) >> 1
                    i = self._u2i(old_nu)
                    if i != self._u2i(old_nu + 1):
                        ptr = self.alloc_units(i + 1)
                        if not ptr:
                            self.restore_model(c)
                            return
                        old_ptr = self.stats(c)
                        self.B[ptr:ptr + self._u2b(old_nu)] = \
                            self.B[old_ptr:old_ptr + self._u2b(old_nu)]
                        self.insert_node(old_ptr, i)
                        self.set_stats(c, ptr)
                summ2 = self.summ(c)
                summ2 += 1 if 3 * ns1 + 1 < ns else 0
            else:
                sptr = self.alloc_units(0)
                if not sptr:
                    self.restore_model(c)
                    return
                os = self.one_state(c)
                self.copy_state(sptr, os)
                self.set_stats(c, sptr)
                fr = self.freq(sptr)
                if fr < MAX_FREQ // 4 - 1:
                    fr <<= 1
                else:
                    fr = MAX_FREQ - 4
                self.set_freq(sptr, fr)
                summ2 = fr + self.init_esc + (1 if ns > 2 else 0)

            s2 = self.stats(c) + (ns1 + 1) * 6
            cf = 2 * (summ2 + 6) * f_freq
            sf = s0 + summ2
            self.set_sym(s2, f_symbol)
            self.set_ns(c, ns1 + 1)
            self.set_succ(s2, max_successor)
            self.set_flags(c, self.flags(c) | flag)
            if cf < 6 * sf:
                cf = 1 + (1 if cf > sf else 0) + (1 if cf >= 4 * sf else 0)
                summ2 += 4
            else:
                cf = (4 + (1 if cf > 9 * sf else 0)
                      + (1 if cf > 12 * sf else 0)
                      + (1 if cf > 15 * sf else 0))
                summ2 += cf
            self.set_summ(c, summ2)
            self.set_freq(s2, cf)
            c = self.suffix(c)
        self.max_context = self.min_context = min_successor

    def rescale(self):
        # Ppmd8.c:1316-1427
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
        i = self.ns(mc)
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
            n0 = (num_stats + 2) >> 1
            if num_stats_new == 0:
                fr = (2 * self.freq(stats) + esc_freq - 1) // esc_freq
                if fr > MAX_FREQ // 3:
                    fr = MAX_FREQ // 3
                self.set_flags(mc, (self.flags(mc) & FLAG_PREV_HIGH)
                               + _hi_bits_flag3(self.sym(stats)))
                os = self.one_state(mc)
                self.copy_state(os, stats)
                self.set_freq(os, fr)
                self.found_state = os
                self.insert_node(stats, self._u2i(n0))
                return
            n1 = (num_stats_new + 2) >> 1
            if n0 != n1:
                self.set_stats(mc, self.shrink_units(stats, n0, n1))
        self.set_summ(mc, sum_freq + esc_freq - (esc_freq >> 1))
        self.set_flags(mc, self.flags(mc) | FLAG_RESCALED)
        self.found_state = self.stats(mc)

    def make_esc_freq(self, num_masked1):
        # Ppmd8.c:1430-1466
        mc = self.min_context
        num_stats = self.ns(mc)
        if num_stats != 0xFF:
            see = self.see[self.ns2indx[num_stats + 2] - 3][
                (1 if self.summ(mc) > 11 * (num_stats + 1) else 0)
                + 2 * (1 if 2 * num_stats <
                       self.ns(self.suffix(mc)) + num_masked1 else 0)
                + self.flags(mc)]
            summ = see.summ & 0xFFFF
            r = summ >> see.shift
            see.summ = (summ - r) & 0xFFFF
            return see, r + (1 if r == 0 else 0)
        return self.dummy_see, 1

    def next_context(self):
        c = self.succ(self.found_state)
        if self.order_fall == 0 and c >= self.units_start:
            self.max_context = self.min_context = c
        else:
            self.update_model()

    def update1(self):
        s = self.found_state
        fr = self.freq(s) + 4
        self.set_summ(self.min_context, self.summ(self.min_context) + 4)
        self.set_freq(s, fr)
        if fr > self.freq(s - 6):
            self.swap_states(s, s - 6)
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
        self.prev_success = 1 if 2 * fr >= summ_freq else 0  # Ppmd8 (>=)
        self.run_length += self.prev_success
        self.set_summ(mc, summ_freq + 4)
        fr += 4
        self.set_freq(s, fr)
        if fr > MAX_FREQ:
            self.rescale()
        self.next_context()

    def update2(self):
        s = self.found_state
        fr = self.freq(s) + 4
        self.run_length = self.init_rl
        self.set_summ(self.min_context, self.summ(self.min_context) + 4)
        self.set_freq(s, fr)
        if fr > MAX_FREQ:
            self.rescale()
        self.update_model()

    def get_bin_summ_idx(self):
        # Ppmd8_GetBinSumm (Ppmd8.h:128-133)
        mc = self.min_context
        os = self.one_state(mc)
        row = self.ns2indx[self.freq(os) - 1]
        col = (self.prev_success
               + ((self.run_length >> 26) & 0x20)
               + self.ns2bsindx[self.ns(self.suffix(mc))]
               + self.flags(mc))
        return row, col


# ---------------------------------------------------------------------------
# Subbotin carryless range coder
# ---------------------------------------------------------------------------

class _RDec:
    __slots__ = ("data", "pos", "code", "range", "low")

    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.code = 0
        self.range = 0xFFFFFFFF
        self.low = 0
        for _ in range(4):
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
        if self.code == 0xFFFFFFFF:
            raise CorruptError("ppmd8: bad stream start")

    def _byte(self):
        if self.pos < len(self.data):
            b = self.data[self.pos]
        else:
            b = 0
        self.pos += 1
        return b

    def norm(self):
        while True:
            if ((self.low ^ (self.low + self.range)) & 0xFFFFFFFF) \
                    >= K_TOP:
                if self.range >= K_BOT:
                    break
                self.range = (0 - self.low) & (K_BOT - 1)
            self.code = ((self.code << 8) | self._byte()) & 0xFFFFFFFF
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.low = (self.low << 8) & 0xFFFFFFFF

    def threshold(self, total):
        self.range //= total
        return self.code // self.range

    def decode(self, start, size):
        start *= self.range
        self.low = (self.low + start) & 0xFFFFFFFF
        self.code = (self.code - start) & 0xFFFFFFFF
        self.range = (self.range * size) & 0xFFFFFFFF


class _REnc:
    __slots__ = ("low", "range", "out")

    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.out = bytearray()

    def norm(self):
        while True:
            if ((self.low ^ (self.low + self.range)) & 0xFFFFFFFF) \
                    >= K_TOP:
                if self.range >= K_BOT:
                    break
                self.range = (0 - self.low) & (K_BOT - 1)
            self.out.append((self.low >> 24) & 0xFF)
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.low = (self.low << 8) & 0xFFFFFFFF

    def encode(self, start, size, total):
        self.range //= total
        self.low = (self.low + start * self.range) & 0xFFFFFFFF
        self.range = (self.range * size) & 0xFFFFFFFF

    def flush(self):
        for _ in range(4):
            self.out.append((self.low >> 24) & 0xFF)
            self.low = (self.low << 8) & 0xFFFFFFFF
        return bytes(self.out)


# ---------------------------------------------------------------------------
# Symbol decode / encode (Ppmd8Dec.c / Ppmd8Enc.c)
# ---------------------------------------------------------------------------

def _decode_symbol(p: Ppmd8, rc: _RDec):
    mask = bytearray(256)
    mc = p.min_context
    if p.ns(mc) != 0:
        s = p.stats(mc)
        summ_freq = p.summ(mc)
        if summ_freq > rc.range:       # PPMD8_CORRECT_SUM_RANGE
            summ_freq = rc.range
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
        i = p.ns(mc)
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
            return SYM_ERROR
        hi_cnt -= count
        rc.decode(hi_cnt, summ_freq - hi_cnt)
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
            rc.range = size0
            rc.norm()
            symb = p.sym(s)
            fr = p.freq(s)
            c = p.succ(s)
            p.found_state = s
            p.prev_success = 1
            p.run_length += 1
            p.set_freq(s, fr + (1 if fr < 196 else 0))  # Ppmd8 (196)
            if p.order_fall == 0 and c >= p.units_start:
                p.max_context = p.min_context = c
            else:
                p.update_model()
            return symb
        p.bin_summ[row][col] = pr_new & 0xFFFF
        p.init_esc = EXP_ESCAPE[pr_new >> 10]
        rc.low = (rc.low + size0) & 0xFFFFFFFF
        rc.code = (rc.code - size0) & 0xFFFFFFFF
        rc.range = (rc.range & ~(BIN_SCALE - 1)) - size0
        mask[p.sym(s)] = 1
        p.prev_success = 0

    while True:
        rc.norm()
        mc = p.min_context
        num_masked = p.ns(mc)
        while True:
            p.order_fall += 1
            if not p.suffix(mc):
                return SYM_END
            mc = p.suffix(mc)
            if p.ns(mc) != num_masked:
                break
        p.min_context = mc
        s = p.stats(mc)
        num = p.ns(mc) + 1
        hi_cnt = 0
        ss = s
        for _ in range(num):
            if not mask[p.sym(ss)]:
                hi_cnt += p.freq(ss)
            ss += 6
        see, esc_freq = p.make_esc_freq(num_masked)
        freq_sum = esc_freq + hi_cnt
        freq_sum2 = freq_sum
        if freq_sum2 > rc.range:       # PPMD8_CORRECT_SUM_RANGE
            freq_sum2 = rc.range
        count = rc.threshold(freq_sum2)
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
        if count >= freq_sum2:
            return SYM_ERROR
        rc.decode(hi_cnt, freq_sum2 - hi_cnt)
        see.summ = (see.summ + freq_sum) & 0xFFFF
        ss = s
        for _ in range(num):
            mask[p.sym(ss)] = 1
            ss += 6


def _encode_symbol(p: Ppmd8, rc: _REnc, symbol: int):
    mask = bytearray(256)
    mc = p.min_context
    if p.ns(mc) != 0:
        s = p.stats(mc)
        summ_freq = p.summ(mc)
        if summ_freq > rc.range:       # PPMD8_CORRECT_SUM_RANGE
            summ_freq = rc.range
        if p.sym(s) == symbol:
            rc.encode(0, p.freq(s), summ_freq)
            rc.norm()
            p.found_state = s
            p.update1_0()
            return
        p.prev_success = 0
        summ = p.freq(s)
        i = p.ns(mc)
        while i:
            s += 6
            if p.sym(s) == symbol:
                rc.encode(summ, p.freq(s), summ_freq)
                rc.norm()
                p.found_state = s
                p.update1()
                return
            summ += p.freq(s)
            i -= 1
        rc.encode(summ, summ_freq - summ, summ_freq)
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
            rc.norm()
            fr = p.freq(s)
            c = p.succ(s)
            p.found_state = s
            p.prev_success = 1
            p.run_length += 1
            p.set_freq(s, fr + (1 if fr < 196 else 0))
            if p.order_fall == 0 and c >= p.units_start:
                p.max_context = p.min_context = c
            else:
                p.update_model()
            return
        p.bin_summ[row][col] = pr_new & 0xFFFF
        p.init_esc = EXP_ESCAPE[pr_new >> 10]
        rc.low = (rc.low + bound) & 0xFFFFFFFF
        rc.range = (rc.range & ~(BIN_SCALE - 1)) - bound
        mask[p.sym(s)] = 1
        p.prev_success = 0

    while True:
        rc.norm()
        mc = p.min_context
        num_masked = p.ns(mc)
        while True:
            p.order_fall += 1
            if not p.suffix(mc):
                return  # end marker path (symbol == -1)
            mc = p.suffix(mc)
            if p.ns(mc) != num_masked:
                break
        p.min_context = mc
        see, esc_freq = p.make_esc_freq(num_masked)
        s = p.stats(mc)
        summ = 0
        num = p.ns(mc) + 1
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
            if total > rc.range:       # PPMD8_CORRECT_SUM_RANGE
                total = rc.range
            rc.encode(low, fr, total)
            rc.norm()
            p.update2()
            return
        hi_cnt = summ
        total = hi_cnt + esc_freq
        see.summ = (see.summ + total) & 0xFFFF
        if total > rc.range:           # PPMD8_CORRECT_SUM_RANGE
            total = rc.range
        rc.encode(hi_cnt, total - hi_cnt, total)
        ss = s
        for _ in range(num):
            mask[p.sym(ss)] = 1
            ss += 6


# ---------------------------------------------------------------------------
# Public API (zip framing, PpmdZip.cpp)
# ---------------------------------------------------------------------------

def decompress(src: bytes, out_size: int | None = None) -> bytes:
    """Zip method-98 stream: u16le props then range-coded payload.
    props = (order-1) | ((memMB-1) << 4) | (restore << 12)."""
    if len(src) < 2:
        raise CorruptError("ppmd8: missing props")
    val = src[0] | (src[1] << 8)
    order = (val & 0xF) + 1
    mem_mb = ((val >> 4) & 0xFF) + 1
    restor = val >> 12
    if order < MIN_O or restor > 1:
        raise CorruptError("ppmd8: unsupported props")
    p = Ppmd8(order, mem_mb << 20, restor)
    rc = _RDec(src[2:])
    out = bytearray()
    while True:
        symb = _decode_symbol(p, rc)
        if symb == SYM_END:
            break
        if symb == SYM_ERROR:
            raise CorruptError("ppmd8: decode error")
        out.append(symb)
        if out_size is not None and len(out) > out_size:
            raise CorruptError("ppmd8: output overrun")
    if out_size is not None and len(out) != out_size:
        raise CorruptError("ppmd8: size mismatch")
    return bytes(out)


def compress(data: bytes, order: int = 8, mem_mb: int = 16,
             restore: int = RESTORE_RESTART) -> bytes:
    """Zip method-98 stream with end marker (PpmdZip.cpp:282-285)."""
    if not 1 <= mem_mb <= 256:
        raise ParamError("ppmd8: bad memMB")
    p = Ppmd8(order, mem_mb << 20, restore)
    rc = _REnc()
    for b in data:
        _encode_symbol(p, rc, b)
    _encode_symbol(p, rc, -1)  # end marker
    val = (order - 1) | ((mem_mb - 1) << 4) | (restore << 12)
    return bytes([val & 0xFF, (val >> 8) & 0xFF]) + rc.flush()
