// Native LZMA1/LZMA2 encoder with a price-based optimal parse.
//
// Behavioral reference (NOT copied): C/LzmaEnc.c — context model
// :364-378, GetOptimum :1225 (the opt[] cell DP re-derived here as a
// shortest-path relaxation with per-cell (state, reps) propagation),
// price tables :700-760; C/Lzma2Enc.c chunk control bytes. The model
// semantics mirror the repo's validated Python encoder
// (tpu7z/models/lzma/encoder.py) bit-for-bit; any valid parse decodes
// identically, the DP only picks cheaper choices.
//
// Exposed (ctypes):
//   tz_lzma2_encode(src, n, dst, cap, level, lc, lp, pb, shard_size)
//   tz_lzma_raw_encode(src, n, dst, cap, level, lc, lp, pb, marker)
//
// The port's copy of tpu7z/native/src/lzma_enc.cpp, unchanged below this
// header; bound by tpu7z_torch/models/lzma/native.py and built by
// tpu7z_torch/ops/_build.py (c++ -O3 -fPIC -shared -std=c++17).

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace lzenc {

// ------------------------------------------------------------ range coder
constexpr unsigned kNumBitModelTotalBits = 11;
constexpr unsigned kBitModelTotal = 1u << kNumBitModelTotalBits;
constexpr unsigned kNumMoveBits = 5;
constexpr uint32_t kTopValue = 1u << 24;

struct RangeEnc {
    std::vector<uint8_t> out;
    uint64_t low = 0;
    uint32_t range = 0xFFFFFFFFu;
    uint8_t cache = 0;
    uint64_t cache_size = 1;

    void shift_low() {
        if ((uint32_t)(low >> 32) != 0 || (uint32_t)low < 0xFF000000u) {
            uint8_t carry = (uint8_t)(low >> 32);
            do {
                out.push_back((uint8_t)(cache + carry));
                cache = 0xFF;
            } while (--cache_size);
            cache = (uint8_t)(low >> 24);
        }
        cache_size++;
        low = (uint32_t)low << 8;
    }
    inline void encode_bit(uint16_t* prob, unsigned bit) {
        uint32_t bound = (range >> kNumBitModelTotalBits) * *prob;
        if (!bit) {
            range = bound;
            *prob = (uint16_t)(*prob
                               + ((kBitModelTotal - *prob) >> kNumMoveBits));
        } else {
            low += bound;
            range -= bound;
            *prob = (uint16_t)(*prob - (*prob >> kNumMoveBits));
        }
        if (range < kTopValue) { range <<= 8; shift_low(); }
    }
    void encode_direct(uint32_t v, unsigned n) {
        while (n--) {
            range >>= 1;
            uint32_t b = (v >> n) & 1;
            low += (uint64_t)b * range;
            if (range < kTopValue) { range <<= 8; shift_low(); }
        }
    }
    void encode_tree(uint16_t* probs, unsigned nbits, uint32_t sym) {
        unsigned ctx = 1;
        for (int i = (int)nbits - 1; i >= 0; i--) {
            unsigned b = (sym >> i) & 1;
            encode_bit(probs + ctx, b);
            ctx = (ctx << 1) | b;
        }
    }
    void encode_tree_reverse(uint16_t* probs, unsigned nbits, uint32_t sym) {
        unsigned ctx = 1;
        for (unsigned i = 0; i < nbits; i++) {
            unsigned b = sym & 1;
            sym >>= 1;
            encode_bit(probs + ctx, b);
            ctx = (ctx << 1) | b;
        }
    }
    void flush() {
        for (int i = 0; i < 5; i++) shift_low();
    }
};

// ------------------------------------------------------------ price table
constexpr unsigned kNumBitPriceShiftBits = 4;

struct Prices {
    uint32_t table[kBitModelTotal >> kNumBitPriceShiftBits];
    Prices() {
        // price of encoding a bit that has probability p/2048:
        // -log2(p/2048) in 1/16-bit units (the LzmaEnc price scale)
        for (unsigned i = 0; i < (kBitModelTotal >> kNumBitPriceShiftBits);
             i++) {
            double w = (double)((i << kNumBitPriceShiftBits)
                                + (1u << (kNumBitPriceShiftBits - 1)));
            double bits = -std::log2(w / (double)kBitModelTotal);
            uint32_t pr = (uint32_t)(bits * (1 << kNumBitPriceShiftBits)
                                     + 0.5);
            table[i] = pr < 1 ? 1 : pr;
        }
    }
};
static const Prices g_prices;

static inline uint32_t price0(uint16_t prob) {
    return g_prices.table[prob >> kNumBitPriceShiftBits];
}
static inline uint32_t price1(uint16_t prob) {
    return g_prices.table[(kBitModelTotal - prob) >> kNumBitPriceShiftBits];
}
static inline uint32_t price_bit(uint16_t prob, unsigned bit) {
    return bit ? price1(prob) : price0(prob);
}

static uint32_t price_tree(const uint16_t* probs, unsigned nbits,
                           uint32_t sym) {
    uint32_t price = 0;
    unsigned ctx = 1;
    for (int i = (int)nbits - 1; i >= 0; i--) {
        unsigned b = (sym >> i) & 1;
        price += price_bit(probs[ctx], b);
        ctx = (ctx << 1) | b;
    }
    return price;
}

static uint32_t price_tree_reverse(const uint16_t* probs, unsigned nbits,
                                   uint32_t sym) {
    uint32_t price = 0;
    unsigned ctx = 1;
    for (unsigned i = 0; i < nbits; i++) {
        unsigned b = sym & 1;
        sym >>= 1;
        price += price_bit(probs[ctx], b);
        ctx = (ctx << 1) | b;
    }
    return price;
}

// ------------------------------------------------------------ model probs
constexpr int kNumStates = 12;
constexpr int kNumPosStatesMax = 16;
constexpr int kMatchMinLen = 2;
constexpr int kMatchMaxLen = 273;

struct LenProbs {
    uint16_t choice[2];
    uint16_t low[kNumPosStatesMax << 3];
    uint16_t mid[kNumPosStatesMax << 3];
    uint16_t high[256];
};

struct Probs {
    uint16_t is_match[kNumStates << 4];
    uint16_t is_rep[kNumStates];
    uint16_t is_rep_g0[kNumStates];
    uint16_t is_rep_g1[kNumStates];
    uint16_t is_rep_g2[kNumStates];
    uint16_t is_rep0_long[kNumStates << 4];
    uint16_t pos_slot[4 << 6];
    uint16_t spec_pos[115];
    uint16_t align_[16];
    LenProbs len_coder, rep_len_coder;
    std::vector<uint16_t> literal;  // 0x300 << (lc+lp)

    void init(int lc, int lp) {
        literal.assign((size_t)0x300 << (lc + lp), kBitModelTotal / 2);
        auto fill = [](uint16_t* p, size_t n) {
            for (size_t i = 0; i < n; i++) p[i] = kBitModelTotal / 2;
        };
        fill(is_match, kNumStates << 4);
        fill(is_rep, kNumStates);
        fill(is_rep_g0, kNumStates);
        fill(is_rep_g1, kNumStates);
        fill(is_rep_g2, kNumStates);
        fill(is_rep0_long, kNumStates << 4);
        fill(pos_slot, 4 << 6);
        fill(spec_pos, 115);
        fill(align_, 16);
        for (LenProbs* l : {&len_coder, &rep_len_coder}) {
            fill(l->choice, 2);
            fill(l->low, kNumPosStatesMax << 3);
            fill(l->mid, kNumPosStatesMax << 3);
            fill(l->high, 256);
        }
    }
};

static inline unsigned pos_slot_of(uint32_t dist) {
    if (dist < 4) return dist;
    unsigned nd = 31 - __builtin_clz(dist);
    return (nd << 1) | ((dist >> (nd - 1)) & 1);
}

static void encode_len(RangeEnc& rc, LenProbs& lp, unsigned pos_state,
                       unsigned length) {
    unsigned v = length - kMatchMinLen;
    if (v < 8) {
        rc.encode_bit(lp.choice, 0);
        rc.encode_tree(lp.low + (pos_state << 3), 3, v);
    } else if (v < 16) {
        rc.encode_bit(lp.choice, 1);
        rc.encode_bit(lp.choice + 1, 0);
        rc.encode_tree(lp.mid + (pos_state << 3), 3, v - 8);
    } else {
        rc.encode_bit(lp.choice, 1);
        rc.encode_bit(lp.choice + 1, 1);
        rc.encode_tree(lp.high, 8, v - 16);
    }
}

// cached length prices per (pos_state, len)
struct LenPrices {
    uint32_t p[kNumPosStatesMax][kMatchMaxLen - kMatchMinLen + 1];
    void build(const LenProbs& lp, unsigned num_pos_states) {
        for (unsigned ps = 0; ps < num_pos_states; ps++) {
            uint32_t c0 = price0(lp.choice[0]);
            uint32_t c1 = price1(lp.choice[0]);
            uint32_t c10 = c1 + price0(lp.choice[1]);
            uint32_t c11 = c1 + price1(lp.choice[1]);
            for (unsigned v = 0; v <= (unsigned)(kMatchMaxLen - kMatchMinLen);
                 v++) {
                uint32_t pr;
                if (v < 8)
                    pr = c0 + price_tree(lp.low + (ps << 3), 3, v);
                else if (v < 16)
                    pr = c10 + price_tree(lp.mid + (ps << 3), 3, v - 8);
                else
                    pr = c11 + price_tree(lp.high, 8, v - 16);
                p[ps][v] = pr;
            }
        }
    }
};

// ------------------------------------------------------------ match finder
static inline uint32_t ld32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}
static inline uint64_t ld64(const uint8_t* p) {
    uint64_t v; memcpy(&v, p, 8); return v;
}

static inline size_t mlen_at(const uint8_t* a, const uint8_t* b,
                             const uint8_t* end) {
    const uint8_t* a0 = a;
    while (a + 8 <= end) {
        uint64_t x = ld64(a) ^ ld64(b);
        if (x) return (size_t)(a - a0) + (__builtin_ctzll(x) >> 3);
        a += 8; b += 8;
    }
    while (a < end && *a == *b) { a++; b++; }
    return (size_t)(a - a0);
}

struct Cand { uint32_t len, dist; };  // dist in 1-based form

// Binary-tree match finder (adapted from this repo's zstd tier,
// tpu7z/native/src/zstd_enc.cpp BTMatcher; role analog of the
// reference's BT4 in C/LzFind.c GetMatchesSpec1 / LzmaEnc MatchFinder).
// Each hash bucket holds a tree of positions ordered by suffix; one
// walk inserts the position and collects the nearest-offset candidate
// per strictly longer length — the ascending list the DP relaxes.
struct BTMatcher {
    static constexpr int kH3Log = 16;
    static constexpr uint32_t kH3MaxOff = 1u << 16;
    std::vector<int32_t> head;
    std::vector<int32_t> lr;     // lr[2i] = left child, lr[2i+1] = right
    std::vector<int32_t> head3;  // 3-byte hash -> most recent pos
    uint32_t hl;
    const uint8_t* base;
    size_t n;

    void init(const uint8_t* src, size_t len, unsigned hash_log) {
        base = src; n = len; hl = hash_log;
        head.assign((size_t)1 << hl, -1);
        lr.assign(2 * len + 2, -1);
        head3.assign((size_t)1 << kH3Log, -1);
    }
    inline uint32_t hash_at(size_t i) const {
        return (ld32(base + i) * 2654435761u) >> (32 - hl);
    }
    inline uint32_t hash3_at(size_t i) const {
        return ((ld32(base + i) & 0xFFFFFFu) * 2654435761u)
               >> (32 - kH3Log);
    }
    // len >= 3 matches at small offsets from a single-slot 3-byte hash
    int probe3(size_t i, size_t end_pos, Cand* out, uint32_t min_len) {
        int nc = 0;
        if (i + 3 <= end_pos && i + 4 <= n) {
            int32_t c = head3[hash3_at(i)];
            if (c >= 0 && (size_t)c < i && i - (size_t)c <= kH3MaxOff
                && out != nullptr) {
                const uint8_t* a = base + i;
                const uint8_t* b = base + c;
                if (a[0] == b[0] && a[1] == b[1] && a[2] == b[2]) {
                    uint32_t len = (uint32_t)(
                        3 + mlen_at(a + 3, b + 3, base + end_pos));
                    if (len > (uint32_t)kMatchMaxLen) len = kMatchMaxLen;
                    if (len > min_len && len >= 3)
                        out[nc++] = {len, (uint32_t)(i - (size_t)c)};
                }
            }
            head3[hash3_at(i)] = (int32_t)i;
        }
        return nc;
    }
    // one walk: insert position i AND collect ascending candidates
    int insert_search(size_t i, size_t end_pos, int depth, Cand* out,
                      int cap) {
        if (i + 4 > n) return 0;
        uint32_t min_len = 1;
        int nc = out ? probe3(i, end_pos, out, min_len) : 0;
        if (nc) min_len = out[0].len;
        uint32_t h = hash_at(i);
        int32_t cur = head[h];
        head[h] = (int32_t)i;
        int32_t* pr = &lr[2 * i + 1];
        int32_t* pl = &lr[2 * i];
        size_t len_l = 0, len_r = 0;
        // compare horizon: matches cannot exceed kMatchMaxLen, so
        // compares past i + 273 + 64 only serve tree ordering; cap them
        // (full-extension ties drop the walked node, like the zstd tier)
        const size_t cmp_cap = std::min(n, i + (size_t)kMatchMaxLen + 64);
        const uint8_t* lim = base + cmp_cap;
        size_t max_rec = std::min(end_pos - i, (size_t)kMatchMaxLen);
        uint32_t best = min_len;
        for (;;) {
            if (depth-- == 0 || cur < 0) {
                *pl = -1;
                *pr = -1;
                break;
            }
            size_t len = std::min(len_l, len_r);
            len += mlen_at(base + i + len, base + cur + len, lim);
            size_t rec = len < max_rec ? len : max_rec;
            if (out && rec > best && rec >= 2) {
                if (nc < cap) out[nc++] = {(uint32_t)rec,
                                           (uint32_t)(i - (size_t)cur)};
                best = (uint32_t)rec;
            }
            if (i + len >= cmp_cap) {
                *pl = lr[2 * cur];
                *pr = lr[2 * cur + 1];
                break;
            }
            if (base[cur + len] < base[i + len]) {
                *pl = cur;
                pl = &lr[2 * cur + 1];
                cur = *pl;
                len_l = len;
            } else {
                *pr = cur;
                pr = &lr[2 * cur];
                cur = *pr;
                len_r = len;
            }
        }
        return nc;
    }
};

// ------------------------------------------------------------ the encoder
struct Encoder {
    int lc, lp, pb;
    unsigned pb_mask, lp_mask;
    Probs probs;
    unsigned state = 0;
    uint32_t reps[4] = {0, 0, 0, 0};  // distance-1 form
    BTMatcher mf;
    int depth;
    int opt_window;
    int nice_len;   // numFastBytes analog: take longer matches greedily

    void init(int lc_, int lp_, int pb_, int level) {
        lc = lc_; lp = lp_; pb = pb_;
        pb_mask = (1u << pb) - 1;
        lp_mask = (1u << lp) - 1;
        depth = level >= 9 ? 32 : level >= 7 ? 24 : level >= 5 ? 16 : 8;
        opt_window = level >= 7 ? 2048 : level >= 5 ? 1024 : 0;
        nice_len = level >= 9 ? 40 : level >= 7 ? 32 : 24;
        reset_state();
    }
    void reset_state() {
        probs.init(lc, lp);
        state = 0;
        reps[0] = reps[1] = reps[2] = reps[3] = 0;
    }
    uint8_t props_byte() const {
        return (uint8_t)((pb * 5 + lp) * 9 + lc);
    }

    // ---------------- literal price/encode
    inline uint16_t* lit_probs(size_t pos, const uint8_t* w) {
        unsigned prev = pos > 0 ? w[pos - 1] : 0;
        unsigned lit_state = (((unsigned)pos & lp_mask) << lc)
                             + (prev >> (8 - lc));
        return probs.literal.data() + (size_t)0x300 * lit_state;
    }
    uint32_t lit_price(size_t pos, const uint8_t* w, unsigned st,
                       uint32_t rep0) {
        const uint16_t* lit = lit_probs(pos, w);
        unsigned sym = w[pos];
        uint32_t price = 0;
        if (st < 7) {
            unsigned ctx = 1;
            for (int i = 7; i >= 0; i--) {
                unsigned b = (sym >> i) & 1;
                price += price_bit(lit[ctx], b);
                ctx = (ctx << 1) | b;
            }
        } else {
            unsigned match_byte = w[pos - rep0 - 1];
            unsigned ctx = 1;
            int i = 7;
            for (; i >= 0; i--) {
                unsigned b = (sym >> i) & 1;
                unsigned mb = (match_byte >> i) & 1;
                price += price_bit(lit[((1 + mb) << 8) + ctx], b);
                ctx = (ctx << 1) | b;
                if (mb != b) { i--; break; }
            }
            for (; i >= 0; i--) {
                unsigned b = (sym >> i) & 1;
                price += price_bit(lit[ctx], b);
                ctx = (ctx << 1) | b;
            }
        }
        return price;
    }
    void lit_encode(RangeEnc& rc, size_t pos, const uint8_t* w) {
        uint16_t* lit = lit_probs(pos, w);
        unsigned sym = w[pos];
        if (state < 7) {
            unsigned ctx = 1;
            for (int i = 7; i >= 0; i--) {
                unsigned b = (sym >> i) & 1;
                rc.encode_bit(lit + ctx, b);
                ctx = (ctx << 1) | b;
            }
        } else {
            unsigned match_byte = w[pos - reps[0] - 1];
            unsigned ctx = 1;
            int i = 7;
            for (; i >= 0; i--) {
                unsigned b = (sym >> i) & 1;
                unsigned mb = (match_byte >> i) & 1;
                rc.encode_bit(lit + (((1 + mb) << 8) + ctx), b);
                ctx = (ctx << 1) | b;
                if (mb != b) { i--; break; }
            }
            for (; i >= 0; i--) {
                unsigned b = (sym >> i) & 1;
                rc.encode_bit(lit + ctx, b);
                ctx = (ctx << 1) | b;
            }
        }
        state = state < 4 ? 0 : state < 10 ? state - 3 : state - 6;
    }

    // ---------------- match/rep price helpers (approximate: probs at
    // parse time; adaptive drift within a window is ignored, as the
    // reference does between FillPrices calls)
    uint32_t dist_price(uint32_t dist /*1-based -> use dist-1*/,
                        unsigned len_state) {
        uint32_t d = dist - 1;
        unsigned slot = pos_slot_of(d);
        uint32_t price = price_tree(probs.pos_slot + (len_state << 6), 6,
                                    slot);
        if (slot >= 4) {
            unsigned nd = (slot >> 1) - 1;
            uint32_t base_v = (2u | (slot & 1)) << nd;
            uint32_t rem = d - base_v;
            if (slot < 14)
                // signed: slot 4 gives base index -1 (ctx >= 1 keeps
                // every dereference inside the array)
                price += price_tree_reverse(
                    probs.spec_pos + ((std::ptrdiff_t)base_v - slot - 1),
                    nd, rem);
            else
                price += ((nd - 4) << kNumBitPriceShiftBits)
                         + price_tree_reverse(probs.align_, 4, rem & 15);
        }
        return price;
    }

    // ---------------- main block encoder: optimal-ish DP parse
    struct Cell {
        uint32_t price;
        int32_t prev;        // arrival position
        uint32_t len;        // 0 = literal step
        uint32_t dist;       // for len>0: 1-based dist, or rep idx 1..4
        uint8_t st;          // state AT this cell
        uint32_t rp[4];      // reps AT this cell (distance-1 form)
    };

    std::vector<Cell> cells;
    std::vector<uint32_t> best_len;   // parse output per position
    std::vector<uint32_t> best_dist;  // 0 = literal; else dist/repidx

    // price of starting a rep-k match (state st) excluding length
    uint32_t rep_price(unsigned k, unsigned st, unsigned pos_state,
                       const uint32_t* rp) {
        (void)rp;
        uint32_t p = price1(probs.is_match[(st << 4) + pos_state])
                     + price1(probs.is_rep[st]);
        if (k == 0) {
            p += price0(probs.is_rep_g0[st]);
            p += price1(probs.is_rep0_long[(st << 4) + pos_state]);
        } else {
            p += price1(probs.is_rep_g0[st]);
            if (k == 1) p += price0(probs.is_rep_g1[st]);
            else {
                p += price1(probs.is_rep_g1[st]);
                p += price_bit(probs.is_rep_g2[st], k - 2);
            }
        }
        return p;
    }

    void parse_window(const uint8_t* w, size_t start, size_t end,
                      size_t wstart, size_t wend,
                      LenPrices& lenp, LenPrices& replenp) {
        size_t W = wend - wstart;
        if (cells.size() < W + 1) cells.resize(W + 1);
        const uint32_t INF = 0x3FFFFFFFu;
        for (size_t i = 0; i <= W; i++) cells[i].price = INF;
        cells[0].price = 0;
        cells[0].st = (uint8_t)state;
        memcpy(cells[0].rp, reps, sizeof(reps));
        cells[0].prev = -1;
        const uint8_t* endp = w + end;
        Cand cands[64];
        size_t skip_until = 0;
        for (size_t i = 0; i < W; i++) {
            size_t pos = wstart + i;
            Cell& c = cells[i];
            if (c.price >= INF) {
                mf.insert_search(pos, end, 8, nullptr, 0);
                continue;
            }
            unsigned pos_state = (unsigned)pos & pb_mask;
            unsigned st = c.st;
            if (pos < skip_until) {  // interior of a greedily-taken match
                // sparse indexing (the zstd tier's ins_step idea): a
                // long match's interior suffixes are near-duplicates of
                // the source's; full BT inserts there dominate runtime
                // on repetitive data
                if ((pos & 3) == 0 || skip_until - pos <= 8)
                    mf.insert_search(pos, end, 8, nullptr, 0);
                continue;
            }
            // gather candidates first: rep lengths + BT ascending list
            size_t rep_ml[4] = {0, 0, 0, 0};
            for (unsigned k = 0; k < 4; k++) {
                uint32_t rd = c.rp[k];
                if (pos < (size_t)rd + 1) continue;
                const uint8_t* a = w + pos;
                const uint8_t* b = a - rd - 1;
                if (*a != *b || a + 1 >= endp || a[1] != b[1]) continue;
                size_t ml = 2 + mlen_at(a + 2, b + 2, endp);
                if (ml > (size_t)kMatchMaxLen) ml = kMatchMaxLen;
                rep_ml[k] = ml;
            }
            int nc = mf.insert_search(pos, end, depth, cands, 64);

            // numFastBytes cutoff (LzmaEnc GetOptimum fast exit): a
            // match >= nice_len is taken whole and its interior skipped
            size_t long_len = 0;
            int long_choice = -1;  // 0..3 rep, 4 new
            uint32_t long_dist = 0;
            for (unsigned k = 0; k < 4; k++)
                if (rep_ml[k] >= (size_t)nice_len
                    && rep_ml[k] > long_len) {
                    long_len = rep_ml[k];
                    long_choice = (int)k;
                }
            if (nc && cands[nc - 1].len >= (uint32_t)nice_len
                && cands[nc - 1].len > long_len) {
                long_len = cands[nc - 1].len;
                long_choice = 4;
                long_dist = cands[nc - 1].dist;
            }
            if (long_choice >= 0) {
                size_t L = long_len;
                if (wstart + i + L > wend) L = wend - wstart - i;
                if (L >= 2) {
                    uint32_t np;
                    Cell& nx = cells[i + L];
                    if (long_choice < 4) {
                        unsigned k = (unsigned)long_choice;
                        np = c.price + rep_price(k, st, pos_state, c.rp)
                             + replenp.p[pos_state][L - 2];
                        if (np < nx.price) {
                            nx.price = np;
                            nx.prev = (int32_t)i;
                            nx.len = (uint32_t)L;
                            nx.dist = k + 1;
                            nx.st = (uint8_t)(st < 7 ? 8 : 11);
                            uint32_t nr[4];
                            memcpy(nr, c.rp, sizeof(nr));
                            if (k) {
                                uint32_t d = nr[k];
                                for (unsigned j = k; j > 0; j--)
                                    nr[j] = nr[j - 1];
                                nr[0] = d;
                            }
                            memcpy(nx.rp, nr, sizeof(nr));
                        }
                    } else {
                        unsigned len_state = std::min<size_t>(L - 2, 3);
                        np = c.price
                             + price1(probs.is_match[(st << 4) + pos_state])
                             + price0(probs.is_rep[st])
                             + lenp.p[pos_state][L - 2]
                             + dist_price(long_dist, len_state);
                        if (np < nx.price) {
                            nx.price = np;
                            nx.prev = (int32_t)i;
                            nx.len = (uint32_t)L;
                            nx.dist = long_dist + 4;
                            nx.st = (uint8_t)(st < 7 ? 7 : 10);
                            nx.rp[0] = long_dist - 1;
                            nx.rp[1] = c.rp[0];
                            nx.rp[2] = c.rp[1];
                            nx.rp[3] = c.rp[2];
                        }
                    }
                    skip_until = pos + L;
                    continue;
                }
            }
            // literal
            {
                uint32_t lp_ = price0(probs.is_match[(st << 4) + pos_state])
                               + lit_price(pos, w, st, c.rp[0]);
                uint32_t np = c.price + lp_;
                Cell& nx = cells[i + 1];
                if (np < nx.price) {
                    nx.price = np;
                    nx.prev = (int32_t)i;
                    nx.len = 0;
                    nx.dist = 0;
                    nx.st = (uint8_t)(st < 4 ? 0 : st < 10 ? st - 3
                                                           : st - 6);
                    memcpy(nx.rp, c.rp, sizeof(c.rp));
                }
            }
            // short rep0 (len 1)
            {
                uint32_t rd = c.rp[0];
                if (pos >= (size_t)rd + 1 && w[pos] == *(w + pos - rd - 1)) {
                    uint32_t p0 = price1(probs.is_match[(st << 4)
                                                        + pos_state])
                                  + price1(probs.is_rep[st])
                                  + price0(probs.is_rep_g0[st])
                                  + price0(probs.is_rep0_long[(st << 4)
                                                              + pos_state]);
                    uint32_t np = c.price + p0;
                    Cell& nx = cells[i + 1];
                    if (np < nx.price) {
                        nx.price = np;
                        nx.prev = (int32_t)i;
                        nx.len = 1;
                        nx.dist = 1;
                        nx.st = (uint8_t)(st < 7 ? 9 : 11);
                        memcpy(nx.rp, c.rp, sizeof(c.rp));
                    }
                }
            }
            // rep matches, all lengths
            for (unsigned k = 0; k < 4; k++) {
                size_t ml = rep_ml[k];
                if (wstart + i + ml > wend) ml = wend - wstart - i;
                if (ml < 2) continue;
                uint32_t head = rep_price(k, st, pos_state, c.rp);
                uint8_t nst = (uint8_t)(st < 7 ? 8 : 11);
                uint32_t nr[4];
                memcpy(nr, c.rp, sizeof(nr));
                if (k) {
                    uint32_t d = nr[k];
                    for (unsigned j = k; j > 0; j--) nr[j] = nr[j - 1];
                    nr[0] = d;
                }
                // relax a contiguous head of lengths plus the full
                // length (tail lengths between rarely win and cost
                // O(len) per position on repetitive data)
                size_t cap_l = std::min(ml, (size_t)32);
                for (size_t L = 2; L <= cap_l; L++) {
                    uint32_t np = c.price + head
                                  + replenp.p[pos_state][L - 2];
                    Cell& nx = cells[i + L];
                    if (np < nx.price) {
                        nx.price = np;
                        nx.prev = (int32_t)i;
                        nx.len = (uint32_t)L;
                        nx.dist = k + 1;
                        nx.st = nst;
                        memcpy(nx.rp, nr, sizeof(nr));
                    }
                }
                if (ml > cap_l) {
                    uint32_t np = c.price + head
                                  + replenp.p[pos_state][ml - 2];
                    Cell& nx = cells[i + ml];
                    if (np < nx.price) {
                        nx.price = np;
                        nx.prev = (int32_t)i;
                        nx.len = (uint32_t)ml;
                        nx.dist = k + 1;
                        nx.st = nst;
                        memcpy(nx.rp, nr, sizeof(nr));
                    }
                }
            }
            // new matches
            uint32_t head_p = price1(probs.is_match[(st << 4) + pos_state])
                              + price0(probs.is_rep[st]);
            size_t lmin = 2;
            for (int ci = 0; ci < nc; ci++) {
                size_t ml = cands[ci].len;
                uint32_t dist = cands[ci].dist;  // >= 1
                if (ml > (size_t)kMatchMaxLen) ml = kMatchMaxLen;
                if (wstart + i + ml > wend) ml = wend - wstart - i;
                uint32_t nr0 = dist - 1;
                uint32_t dp4[4];
                for (unsigned ls = 0; ls < 4; ls++)
                    dp4[ls] = dist_price(dist, ls);
                size_t cap_n = std::min(ml, lmin + 30);
                for (size_t L = lmin; L <= ml;
                     L = (L < cap_n) ? L + 1 : (L < ml ? ml : ml + 1)) {
                    if (L == 2 && dist >= (1u << 9)) continue;
                    if (L == 3 && dist >= (1u << 22)) continue;
                    unsigned len_state = std::min<size_t>(L - 2, 3);
                    uint32_t np = c.price + head_p
                                  + lenp.p[pos_state][L - 2]
                                  + dp4[len_state];
                    Cell& nx = cells[i + L];
                    if (np < nx.price) {
                        nx.price = np;
                        nx.prev = (int32_t)i;
                        nx.len = (uint32_t)L;
                        nx.dist = dist + 4;
                        nx.st = (uint8_t)(st < 7 ? 7 : 10);
                        nx.rp[0] = nr0;
                        nx.rp[1] = c.rp[0];
                        nx.rp[2] = c.rp[1];
                        nx.rp[3] = c.rp[2];
                    }
                }
                if (cands[ci].len >= lmin) lmin = cands[ci].len + 1;
            }
        }
        // backtrack
        best_len.assign(W, 0);
        best_dist.assign(W, 0);
        size_t i = W;
        while (i > 0) {
            Cell& c = cells[i];
            size_t p = (size_t)c.prev;
            if (c.len == 0) {
                best_len[p] = 0;
                best_dist[p] = 0;
            } else {
                best_len[p] = c.len;
                best_dist[p] = c.dist;
            }
            i = p;
        }
    }

    // greedy window parse for the fast levels (no DP): longest of
    // {rep matches, best BT candidate} with LzmaEnc-style rep
    // preference; fills best_len/best_dist in the same encoding the
    // emission loop consumes. Reps tracked exactly (greedy is
    // sequential, unlike the DP's per-cell propagation).
    void parse_window_greedy(const uint8_t* w, size_t end,
                             size_t wstart, size_t wend) {
        size_t W = wend - wstart;
        best_len.assign(W, 0);
        best_dist.assign(W, 0);
        uint32_t rp[4];
        memcpy(rp, reps, sizeof(rp));
        const uint8_t* endp = w + end;
        Cand cands[16];
        size_t i = 0;
        while (i < W) {
            size_t pos = wstart + i;
            // rep probes
            size_t rep_best = 0;
            unsigned rep_k = 0;
            for (unsigned k = 0; k < 4; k++) {
                uint32_t rd = rp[k];
                if (pos < (size_t)rd + 1) continue;
                const uint8_t* a = w + pos;
                const uint8_t* b = a - rd - 1;
                if (*a != *b || a + 1 >= endp || a[1] != b[1]) continue;
                size_t ml = 2 + mlen_at(a + 2, b + 2, endp);
                if (ml > rep_best) { rep_best = ml; rep_k = k; }
            }
            int nc = mf.insert_search(pos, end, depth, cands, 16);
            size_t cl = nc ? cands[nc - 1].len : 0;
            uint32_t cd = nc ? cands[nc - 1].dist : 0;
            size_t take = 0;
            bool use_rep = false;
            if (rep_best >= 2 && rep_best + 1 >= cl) {
                take = rep_best;
                use_rep = true;
            } else if (cl >= 3 || (cl == 2 && cd < 512)) {
                take = cl;
            }
            if (take > (size_t)kMatchMaxLen) take = kMatchMaxLen;
            if (wstart + i + take > wend) take = wend - wstart - i;
            if (take < 2) {
                i += 1;  // literal (best_len stays 0)
                continue;
            }
            if (use_rep) {
                best_len[i] = (uint32_t)take;
                best_dist[i] = rep_k + 1;
                if (rep_k) {
                    uint32_t d = rp[rep_k];
                    for (unsigned j = rep_k; j > 0; j--) rp[j] = rp[j - 1];
                    rp[0] = d;
                }
            } else {
                best_len[i] = (uint32_t)take;
                best_dist[i] = cd + 4;
                rp[3] = rp[2]; rp[2] = rp[1]; rp[1] = rp[0];
                rp[0] = cd - 1;
            }
            // sparse-index the interior
            for (size_t q = 1; q < take; q++)
                if ((pos + q) % 4 == 0 || take - q <= 8)
                    mf.insert_search(pos + q, end, 8, nullptr, 0);
            i += take;
        }
    }

    // encode one chunk range with the DP parse
    std::vector<uint8_t> encode_chunk(const uint8_t* w, size_t start,
                                      size_t end) {
        RangeEnc rc;
        unsigned nps = 1u << pb;
        LenPrices lenp, replenp;
        size_t pos = start;
        while (pos < end) {
            size_t wend = std::min(end, pos + (size_t)(opt_window ?
                                                       opt_window : 4096));
            lenp.build(probs.len_coder, nps);
            replenp.build(probs.rep_len_coder, nps);
            if (opt_window)
                parse_window(w, start, end, pos, wend, lenp, replenp);
            else
                parse_window_greedy(w, end, pos, wend);
            size_t W = wend - pos;
            size_t i = 0;
            while (i < W) {
                size_t apos = pos + i;
                unsigned pos_state = (unsigned)apos & pb_mask;
                uint32_t L = best_len[i];
                uint32_t D = best_dist[i];
                if (L == 0) {  // literal
                    rc.encode_bit(probs.is_match + (state << 4) + pos_state,
                                  0);
                    lit_encode(rc, apos, w);
                    i += 1;
                    continue;
                }
                rc.encode_bit(probs.is_match + (state << 4) + pos_state, 1);
                if (D <= 4) {  // rep match, index D-1
                    unsigned k = D - 1;
                    rc.encode_bit(probs.is_rep + state, 1);
                    if (k == 0) {
                        rc.encode_bit(probs.is_rep_g0 + state, 0);
                        if (L == 1) {
                            rc.encode_bit(probs.is_rep0_long + (state << 4)
                                          + pos_state, 0);
                            state = state < 7 ? 9 : 11;
                            i += 1;
                            continue;
                        }
                        rc.encode_bit(probs.is_rep0_long + (state << 4)
                                      + pos_state, 1);
                    } else {
                        rc.encode_bit(probs.is_rep_g0 + state, 1);
                        if (k == 1) {
                            rc.encode_bit(probs.is_rep_g1 + state, 0);
                        } else {
                            rc.encode_bit(probs.is_rep_g1 + state, 1);
                            rc.encode_bit(probs.is_rep_g2 + state, k - 2);
                        }
                        uint32_t d = reps[k];
                        for (unsigned j = k; j > 0; j--)
                            reps[j] = reps[j - 1];
                        reps[0] = d;
                    }
                    encode_len(rc, probs.rep_len_coder, pos_state, L);
                    state = state < 7 ? 8 : 11;
                    i += L;
                    continue;
                }
                // new match: D-4 is the 1-based dist
                uint32_t dist1 = D - 4;      // 1-based
                uint32_t d = dist1 - 1;      // distance-1 form
                rc.encode_bit(probs.is_rep + state, 0);
                reps[3] = reps[2]; reps[2] = reps[1]; reps[1] = reps[0];
                reps[0] = d;
                encode_len(rc, probs.len_coder, pos_state, L);
                state = state < 7 ? 7 : 10;
                unsigned len_state = std::min<uint32_t>(L - 2, 3);
                unsigned slot = pos_slot_of(d);
                rc.encode_tree(probs.pos_slot + (len_state << 6), 6, slot);
                if (slot >= 4) {
                    unsigned nd = (slot >> 1) - 1;
                    uint32_t base_v = (2u | (slot & 1)) << nd;
                    uint32_t rem = d - base_v;
                    if (slot < 14)
                        rc.encode_tree_reverse(
                            probs.spec_pos
                                + ((std::ptrdiff_t)base_v - slot - 1),
                            nd, rem);
                    else {
                        rc.encode_direct(rem >> 4, nd - 4);
                        rc.encode_tree_reverse(probs.align_, 4, rem & 15);
                    }
                }
                i += L;
            }
            pos = wend;
        }
        rc.flush();
        return std::move(rc.out);
    }
};

}  // namespace lzenc

using namespace lzenc;

// LZMA2 chunk driver. shard_size=0: one continuous stream.
extern "C" long long tz_lzma2_encode(const uint8_t* src, size_t n,
                                     uint8_t* dst, size_t cap,
                                     int level, int lc, int lp, int pb,
                                     uint32_t shard_size) {
    try {
        std::vector<uint8_t> out;
        out.reserve(n / 2 + 1024);
        size_t shard = shard_size ? shard_size : n ? n : 1;
        for (size_t s0 = 0; s0 < (n ? n : 1); s0 += shard) {
            size_t s1 = std::min(n, s0 + shard);
            Encoder enc;
            enc.init(lc, lp, pb, level);
            enc.mf.init(src + s0, s1 - s0, 17);
            bool first = true;
            int need_reset = 2;
            size_t start = 0;
            size_t sn = s1 - s0;
            const uint8_t* w = src + s0;
            while (start < sn) {
                size_t end = std::min(start + (size_t)(1 << 16), sn);
                size_t usize = end - start;
                if (need_reset) enc.reset_state();
                std::vector<uint8_t> comp = enc.encode_chunk(w, start, end);
                if (comp.size() >= usize || comp.size() > 0x10000) {
                    size_t p = start;
                    while (p < end) {
                        size_t e2 = std::min(p + 0x10000, end);
                        out.push_back(first ? 1 : 2);
                        out.push_back((uint8_t)((e2 - p - 1) >> 8));
                        out.push_back((uint8_t)(e2 - p - 1));
                        out.insert(out.end(), w + p, w + e2);
                        first = false;
                        p = e2;
                    }
                    need_reset = std::max(need_reset, 1);
                } else {
                    int reset = first ? 3 : need_reset;
                    unsigned ctrl = 0x80u | ((unsigned)reset << 5)
                                    | (unsigned)((usize - 1) >> 16);
                    out.push_back((uint8_t)ctrl);
                    out.push_back((uint8_t)(((usize - 1) >> 8) & 0xFF));
                    out.push_back((uint8_t)((usize - 1) & 0xFF));
                    out.push_back((uint8_t)((comp.size() - 1) >> 8));
                    out.push_back((uint8_t)((comp.size() - 1) & 0xFF));
                    if (reset >= 2) out.push_back(enc.props_byte());
                    out.insert(out.end(), comp.begin(), comp.end());
                    need_reset = 0;
                }
                start = end;
                first = false;
            }
            if (n == 0) break;
        }
        out.push_back(0);
        if (out.size() > cap) return -2;
        memcpy(dst, out.data(), out.size());
        return (long long)out.size();
    } catch (...) {
        return -1;
    }
}

// Raw LZMA1 stream (for the 7z lzma coder / .lzma alone container).
// props_out: 1 byte (lclppb). Returns stream size.
extern "C" long long tz_lzma_raw_encode(const uint8_t* src, size_t n,
                                        uint8_t* dst, size_t cap,
                                        int level, int lc, int lp, int pb,
                                        uint8_t* props_out) {
    try {
        Encoder enc;
        enc.init(lc, lp, pb, level);
        enc.mf.init(src, n, 17);
        std::vector<uint8_t> comp = enc.encode_chunk(src, 0, n);
        if (props_out) *props_out = enc.props_byte();
        if (comp.size() > cap) return -2;
        memcpy(dst, comp.data(), comp.size());
        return (long long)comp.size();
    } catch (...) {
        return -1;
    }
}
