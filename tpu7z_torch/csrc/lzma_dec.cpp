// Host LZMA1 range decoder over a shared output window, with the LZMA2
// dictionary origin: a copy of tpu7z/native's tz_lzma_new ...
// tz_lzma_decode_chunk, with a plain C interface for ctypes
// (tpu7z_torch/models/lzma/native.py, decoder.py). Behavior per the
// public LZMA specification: an 11-bit probability model adapted by
// 5 bits, renormalized at 2**24.
//
// tz_lzma_decode_chunk decodes until `limit` bytes are written at
// window[pos..] and returns the bytes it read from src, -1 on a corrupt
// stream, -2 on an end marker.
//
// Build: c++ -O3 -fPIC -shared -std=c++17 (tpu7z_torch/ops/_build.py).

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

struct TzLzma {
    uint16_t* probs;
    size_t nprobs;
    int lc, lp, pb;
    unsigned state;
    uint32_t reps[4];
    uint64_t origin;  // dictionary origin (LZMA2 dict reset): position
                      // context and distance bounds restart here
};

enum {  // probability layout offsets (computed at init)
    kNumStates = 12,
};

static size_t lzma_nprobs(int lc, int lp) {
    // is_match 192 + is_rep 12 + g0 12 + g1 12 + g2 12 + rep0long 192
    // + pos_slot 256 + spec_pos 115 + align 16
    // + len (2 + 128 + 128 + 256) + replen (same) + literal 0x300<<(lc+lp)
    return 192 + 12*4 + 192 + 256 + 115 + 16 + 2*(2 + 128 + 128 + 256)
         + ((size_t)0x300 << (lc + lp));
}

// offsets
#define OFF_IS_MATCH    0
#define OFF_IS_REP      192
#define OFF_G0          204
#define OFF_G1          216
#define OFF_G2          228
#define OFF_REP0LONG    240
#define OFF_POS_SLOT    432
#define OFF_SPEC_POS    688
#define OFF_ALIGN       803
#define OFF_LEN         819
#define OFF_REPLEN      (819 + 514)
#define OFF_LITERAL     (819 + 2*514)

void* tz_lzma_new(int lc, int lp, int pb) {
    TzLzma* z = (TzLzma*)malloc(sizeof(TzLzma));
    z->lc = lc; z->lp = lp; z->pb = pb;
    z->nprobs = lzma_nprobs(lc, lp);
    z->probs = (uint16_t*)malloc(z->nprobs * sizeof(uint16_t));
    for (size_t i = 0; i < z->nprobs; i++) z->probs[i] = 1024;
    z->state = 0; z->reps[0] = z->reps[1] = z->reps[2] = z->reps[3] = 0;
    z->origin = 0;
    return z;
}

// LZMA2 dictionary reset: subsequent chunks behave as if output started
// at `origin` (C/Lzma2Dec.c dicPos handling)
void tz_lzma_set_origin(void* h, uint64_t origin) {
    ((TzLzma*)h)->origin = origin;
}

void tz_lzma_reset_state(void* h) {
    TzLzma* z = (TzLzma*)h;
    for (size_t i = 0; i < z->nprobs; i++) z->probs[i] = 1024;
    z->state = 0; z->reps[0] = z->reps[1] = z->reps[2] = z->reps[3] = 0;
}

void tz_lzma_reset_props(void* h, int lc, int lp, int pb) {
    TzLzma* z = (TzLzma*)h;
    size_t need = lzma_nprobs(lc, lp);
    if (need != z->nprobs) {
        free(z->probs);
        z->probs = (uint16_t*)malloc(need * sizeof(uint16_t));
        z->nprobs = need;
    }
    z->lc = lc; z->lp = lp; z->pb = pb;
    tz_lzma_reset_state(h);
}

void tz_lzma_free(void* h) {
    TzLzma* z = (TzLzma*)h;
    free(z->probs); free(z);
}

struct RD {
    const uint8_t* p; const uint8_t* end;
    uint32_t range, code; int overread;
};

static inline void rd_norm(RD* r) {
    if (r->range < (1u << 24)) {
        uint8_t b = 0;
        if (r->p < r->end) b = *r->p;
        else if (++r->overread > 24) { /* flagged */ }
        r->p++;
        r->range <<= 8;
        r->code = (r->code << 8) | b;
    }
}

static inline int rd_bit(RD* r, uint16_t* prob) {
    uint32_t bound = (r->range >> 11) * *prob;
    if (r->code < bound) {
        r->range = bound;
        *prob = (uint16_t)(*prob + ((2048 - *prob) >> 5));
        rd_norm(r);
        return 0;
    }
    r->range -= bound;
    r->code -= bound;
    *prob = (uint16_t)(*prob - (*prob >> 5));
    rd_norm(r);
    return 1;
}

static inline unsigned rd_tree(RD* r, uint16_t* probs, int nbits) {
    unsigned m = 1;
    for (int i = 0; i < nbits; i++) m = (m << 1) + rd_bit(r, probs + m);
    return m - (1u << nbits);
}

static inline unsigned rd_tree_rev(RD* r, uint16_t* probs, int nbits) {
    unsigned m = 1, sym = 0;
    for (int i = 0; i < nbits; i++) {
        unsigned b = rd_bit(r, probs + m);
        m = (m << 1) + b;
        sym |= b << i;
    }
    return sym;
}

static inline unsigned rd_direct(RD* r, int nbits) {
    unsigned res = 0;
    for (int i = 0; i < nbits; i++) {
        r->range >>= 1;
        r->code -= r->range;
        uint32_t t = 0u - (r->code >> 31);
        r->code += r->range & t;
        rd_norm(r);
        res = (res << 1) + (t + 1);
    }
    return res;
}

static inline unsigned rd_len(RD* r, uint16_t* lp, unsigned pos_state) {
    if (!rd_bit(r, lp + 0))
        return 2 + rd_tree(r, lp + 2 + (pos_state << 3), 3);
    if (!rd_bit(r, lp + 1))
        return 10 + rd_tree(r, lp + 130 + (pos_state << 3), 3);
    return 18 + rd_tree(r, lp + 258, 8);
}

// decode until `limit` bytes at window[pos..]; returns bytes consumed from
// src, or -1 on error, or -2 on end-marker.
long long tz_lzma_decode_chunk(void* h, const uint8_t* src, size_t srcn,
                               uint8_t* window, uint64_t pos,
                               uint64_t limit) {
    TzLzma* z = (TzLzma*)h;
    if (srcn < 5 || src[0] != 0) return -1;
    RD r; r.p = src + 1; r.end = src + srcn; r.overread = 0;
    r.range = 0xFFFFFFFFu;
    r.code = ((uint32_t)r.p[0] << 24) | ((uint32_t)r.p[1] << 16)
           | ((uint32_t)r.p[2] << 8) | r.p[3];
    r.p += 4;

    uint16_t* P = z->probs;
    unsigned state = z->state;
    uint32_t rep0 = z->reps[0], rep1 = z->reps[1], rep2 = z->reps[2], rep3 = z->reps[3];
    unsigned pb_mask = (1u << z->pb) - 1;
    unsigned lp_mask = (1u << z->lp) - 1;
    int lc = z->lc;
    uint64_t end = pos + limit;
    const uint64_t origin = z->origin;

    while (pos < end) {
        if (r.overread > 20) return -1;
        unsigned pos_state = (unsigned)(pos - origin) & pb_mask;
        if (!rd_bit(&r, P + OFF_IS_MATCH + (state << 4) + pos_state)) {
            unsigned prev = pos > origin ? window[pos - 1] : 0;
            unsigned lit_state = (((unsigned)(pos - origin) & lp_mask) << lc) + (prev >> (8 - lc));
            uint16_t* lit = P + OFF_LITERAL + 0x300 * (size_t)lit_state;
            unsigned sym = 1;
            if (state < 7) {
                while (sym < 0x100) sym = (sym << 1) | rd_bit(&r, lit + sym);
            } else {
                unsigned match_byte = window[pos - rep0 - 1];
                do {
                    unsigned match_bit = (match_byte >> 7) & 1;
                    match_byte <<= 1;
                    unsigned b = rd_bit(&r, lit + ((1 + match_bit) << 8) + sym);
                    sym = (sym << 1) | b;
                    if (match_bit != b) {
                        while (sym < 0x100) sym = (sym << 1) | rd_bit(&r, lit + sym);
                        break;
                    }
                } while (sym < 0x100);
            }
            window[pos++] = (uint8_t)sym;
            state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
            continue;
        }
        unsigned length;
        if (!rd_bit(&r, P + OFF_IS_REP + state)) {
            rep3 = rep2; rep2 = rep1; rep1 = rep0;
            length = rd_len(&r, P + OFF_LEN, pos_state);
            state = state < 7 ? 7 : 10;
            unsigned len_state = length - 2 < 3 ? length - 2 : 3;
            unsigned slot = rd_tree(&r, P + OFF_POS_SLOT + (len_state << 6), 6);
            if (slot < 4) rep0 = slot;
            else {
                int nd = (int)(slot >> 1) - 1;
                rep0 = (2 | (slot & 1)) << nd;
                if (slot < 14)
                    rep0 += rd_tree_rev(&r, P + OFF_SPEC_POS + rep0 - slot - 1, nd);
                else {
                    rep0 += rd_direct(&r, nd - 4) << 4;
                    rep0 += rd_tree_rev(&r, P + OFF_ALIGN, 4);
                    if (rep0 == 0xFFFFFFFFu) {
                        z->state = state; z->reps[0] = z->reps[1] = z->reps[2] = z->reps[3] = 0;
                        return -2;  // end marker
                    }
                }
            }
        } else {
            if (!rd_bit(&r, P + OFF_G0 + state)) {
                if (!rd_bit(&r, P + OFF_REP0LONG + (state << 4) + pos_state)) {
                    state = state < 7 ? 9 : 11;
                    if (rep0 + 1 > pos - origin) return -1;
                    window[pos] = window[pos - rep0 - 1];
                    pos++;
                    continue;
                }
            } else {
                uint32_t dist;
                if (!rd_bit(&r, P + OFF_G1 + state)) dist = rep1;
                else {
                    if (!rd_bit(&r, P + OFF_G2 + state)) dist = rep2;
                    else { dist = rep3; rep3 = rep2; }
                    rep2 = rep1;
                }
                rep1 = rep0; rep0 = dist;
            }
            length = rd_len(&r, P + OFF_REPLEN, pos_state);
            state = state < 7 ? 8 : 11;
        }
        if (rep0 + 1 > pos - origin || pos + length > end) return -1;
        const uint8_t* m = window + pos - rep0 - 1;
        uint8_t* d = window + pos;
        for (unsigned k = 0; k < length; k++) d[k] = m[k];
        pos += length;
    }
    z->state = state;
    z->reps[0] = rep0; z->reps[1] = rep1; z->reps[2] = rep2; z->reps[3] = rep3;
    return (long long)(r.p - src);
}


}  // extern "C"
