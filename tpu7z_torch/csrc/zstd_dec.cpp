// Fast host-tier Zstandard decoder (RFC 8878), written from the format
// spec and mirroring the port's plain Python decoder
// (tpu7z_torch/models/zstd/{frame,literals,sequences,fse,huffman}.py).
// It is tpu7z's host decoder (tpu7z/native/src/zstd_dec.cpp) without its
// cycle counters, which never touched the output: so it builds with any
// host compiler on any architecture.
//
// Behavioral reference (NOT copied): the reference zstd sources
//   zstd_decompress.c:953  (ZSTD_decompressFrame block loop)
//   zstd_decompress_block.c:134  (literals section)
//   zstd_decompress_block.c:1001 (sequence execution)
//   huf_decompress.c:602 (4-stream Huffman)
//   fse_decompress.c:161 (FSE table build)
//
// Build: c++ -O3 -fPIC -shared -std=c++17 (tpu7z_torch/ops/_build.py).

#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

#include "xxh64.h"

extern "C" uint64_t tz_xxh64(const uint8_t* data, size_t n, uint64_t seed) {
    return tz_xxh::xxh64(data, n, seed);
}

namespace zdec {

// ---------------------------------------------------------------------------
// errors
// ---------------------------------------------------------------------------
enum {
    ERR_CORRUPT = -1,
    ERR_DST_TOO_SMALL = -2,
    ERR_UNSUPPORTED = -3,
    ERR_CHECKSUM = -4,
};

struct Err {};  // thrown on corrupt input

static inline uint32_t rd32le(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}

static inline uint64_t rd64le(const uint8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

static inline int highbit32(uint32_t v) {  // floor(log2(v)), v != 0
    return 31 - __builtin_clz(v);
}

// ---------------------------------------------------------------------------
// forward LSB-first bit reader (FSE table descriptions, Huffman weights)
// ---------------------------------------------------------------------------
struct FwdBits {
    const uint8_t* data;
    size_t len;
    size_t bitpos = 0;

    FwdBits(const uint8_t* d, size_t n) : data(d), len(n) {}

    uint32_t read(unsigned nbits) {
        if (nbits == 0) return 0;
        size_t byte0 = bitpos >> 3;
        unsigned shift = bitpos & 7;
        uint64_t acc = 0;
        unsigned nbytes = (shift + nbits + 7) >> 3;
        for (unsigned i = 0; i < nbytes; i++)
            if (byte0 + i < len) acc |= (uint64_t)data[byte0 + i] << (8 * i);
        bitpos += nbits;
        return (uint32_t)((acc >> shift) & ((1ull << nbits) - 1));
    }
    size_t bytes_consumed() const { return (bitpos + 7) >> 3; }
};

// ---------------------------------------------------------------------------
// backward bit reader (zstd entropy streams). Reads from the top of the
// stream downwards; the last byte carries a 1-bit end marker. Overread
// below zero yields zero bits (allowed during final state loads).
// ---------------------------------------------------------------------------
struct BackBits {
    const uint8_t* data;
    size_t len;
    std::ptrdiff_t bitpos;  // bits remaining below the marker

    bool init(const uint8_t* d, size_t n) {
        data = d;
        len = n;
        if (n == 0 || d[n - 1] == 0) return false;
        bitpos = (std::ptrdiff_t)(8 * n) - (8 - highbit32(d[n - 1]));
        return true;
    }

    inline uint32_t peek_at(std::ptrdiff_t pos, unsigned nbits) const {
        if (pos >= 0) {
            size_t b = (size_t)pos >> 3;
            unsigned sh = (unsigned)pos & 7;
            uint64_t acc;
            if (b + 8 <= len) {
                std::memcpy(&acc, data + b, 8);
            } else {
                acc = 0;
                std::memcpy(&acc, data + b, len - b);
            }
            return (uint32_t)((acc >> sh) & ((1ull << nbits) - 1));
        }
        std::ptrdiff_t valid = (std::ptrdiff_t)nbits + pos;  // valid top bits
        if (valid <= 0) return 0;
        uint64_t acc = 0;
        size_t nbytes = ((size_t)valid + 7) >> 3;
        for (size_t i = 0; i < nbytes && i < len; i++)
            acc |= (uint64_t)data[i] << (8 * i);
        return (uint32_t)((acc & ((1ull << valid) - 1)) << (-pos));
    }

    inline uint32_t read(unsigned nbits) {
        if (nbits == 0) return 0;
        bitpos -= nbits;
        return peek_at(bitpos, nbits);
    }

    // Read three fields (top-down order) with one 8-byte load when the
    // total fits a 57-bit window; equivalent to read(n1),read(n2),read(n3).
    inline void read3(unsigned n1, unsigned n2, unsigned n3,
                      uint32_t* v1, uint32_t* v2, uint32_t* v3) {
        unsigned tot = n1 + n2 + n3;
        std::ptrdiff_t pos = bitpos - (std::ptrdiff_t)tot;
        if (pos >= 0 && tot <= 57) {
            size_t B = (size_t)pos >> 3;
            if (B + 8 <= len) {
                bitpos = pos;
                uint64_t acc;
                std::memcpy(&acc, data + B, 8);
                uint64_t w = acc >> ((unsigned)pos & 7);
                *v3 = (uint32_t)(w & ((1ull << n3) - 1));
                *v2 = (uint32_t)((w >> n3) & ((1ull << n2) - 1));
                *v1 = (uint32_t)((w >> (n3 + n2)) & ((1ull << n1) - 1));
                return;
            }
        }
        *v1 = read(n1);
        *v2 = read(n2);
        *v3 = read(n3);
    }
    inline uint32_t peek(unsigned nbits) const {
        return peek_at(bitpos - (std::ptrdiff_t)nbits, nbits);
    }
    inline void consume(unsigned nbits) { bitpos -= nbits; }
    bool overread() const { return bitpos < 0; }
};

// ---------------------------------------------------------------------------
// FSE decode tables (fse.py read_ncount / build_dtable semantics)
// ---------------------------------------------------------------------------
// Packed decode entry: base<<16 | nb_bits<<8 | symbol.  base is always in
// [0, table_size) (next_state<<nb lands in [table_size, 2*table_size)),
// so 16 bits suffice; one 32-bit load yields all three fields.
struct FseDTable {
    uint32_t ent[1 << 9];
    unsigned accuracy_log = 0;
    uint8_t symbol(uint32_t s) const { return (uint8_t)ent[s]; }
    uint8_t nb_bits(uint32_t s) const { return (uint8_t)(ent[s] >> 8); }
    uint32_t base(uint32_t s) const { return ent[s] >> 16; }
};

// Parse normalized counts. counts: out array of size max_symbol+1 (int16).
// Returns accuracy_log or throws.
static unsigned read_ncount(FwdBits& r, int16_t* counts, unsigned max_symbol,
                            unsigned max_accuracy) {
    unsigned accuracy_log = r.read(4) + 5;
    if (accuracy_log > max_accuracy) throw Err{};
    int table_size = 1 << accuracy_log;
    int remaining = table_size + 1;
    int threshold = table_size;
    unsigned nb_bits = accuracy_log + 1;
    unsigned n = 0;
    for (unsigned i = 0; i <= max_symbol; i++) counts[i] = 0;
    bool prev_zero = false;
    while (remaining > 1) {
        if (n > max_symbol + 1) throw Err{};
        if (prev_zero) {
            for (;;) {
                uint32_t rep = r.read(2);
                for (uint32_t k = 0; k < rep; k++) {
                    if (n > max_symbol) throw Err{};
                    counts[n++] = 0;
                }
                if (rep < 3) break;
                if (n > max_symbol + 1) throw Err{};
            }
            prev_zero = false;
            continue;
        }
        int maxv = 2 * threshold - 1 - remaining;
        int value = (int)r.read(nb_bits - 1);
        if (value >= maxv) {
            int extra = (int)r.read(1);
            value |= extra << (nb_bits - 1);
            if (value >= threshold) value -= maxv;
        }
        int count = value - 1;  // -1 = "less than 1" probability
        remaining -= count < 0 ? -count : count;
        if (n > max_symbol) throw Err{};
        counts[n++] = (int16_t)count;
        prev_zero = (count == 0);
        while (remaining < threshold) {
            nb_bits--;
            threshold >>= 1;
        }
    }
    if (remaining != 1) throw Err{};
    if (n > max_symbol + 1) throw Err{};
    return accuracy_log;
}

// Spread symbols and fill the decode table (fse.py _spread_symbols +
// build_dtable).
static void build_dtable(const int16_t* counts, unsigned nsym,
                         unsigned accuracy_log, FseDTable& dt) {
    int table_size = 1 << accuracy_log;
    dt.accuracy_log = accuracy_log;
    int check = 0;
    for (unsigned s = 0; s < nsym; s++)
        check += counts[s] < 0 ? 1 : counts[s];
    if (check != table_size) throw Err{};

    uint8_t spread[1 << 9];
    int high = table_size - 1;
    for (unsigned s = 0; s < nsym; s++)
        if (counts[s] == -1) spread[high--] = (uint8_t)s;
    int step = (table_size >> 1) + (table_size >> 3) + 3;
    int mask = table_size - 1;
    int pos = 0;
    for (unsigned s = 0; s < nsym; s++) {
        for (int c = 0; c < counts[s]; c++) {
            spread[pos] = (uint8_t)s;
            pos = (pos + step) & mask;
            while (pos > high) pos = (pos + step) & mask;
        }
    }
    if (pos != 0) throw Err{};

    int symbol_next[256];
    for (unsigned s = 0; s < nsym; s++)
        symbol_next[s] = counts[s] < 0 ? 1 : counts[s];
    for (int u = 0; u < table_size; u++) {
        unsigned s = spread[u];
        int next_state = symbol_next[s]++;
        unsigned nb = accuracy_log - (unsigned)highbit32((uint32_t)next_state);
        uint32_t base = (uint32_t)((next_state << nb) - table_size);
        dt.ent[u] = (base << 16) | (nb << 8) | s;
    }
}

static void build_rle_dtable(unsigned symbol, FseDTable& dt) {
    dt.accuracy_log = 0;
    dt.ent[0] = symbol;
}

// ---------------------------------------------------------------------------
// Huffman (literals): tree description + single-level decode table
// ---------------------------------------------------------------------------
struct HufDTable {
    // entry = symbol | (nbits << 8), indexed by table_log-bit prefix
    uint16_t table[1 << 12];
    unsigned table_log = 0;
    bool valid = false;
};

// huffman.py _fse_decode_weights
static unsigned fse_decode_weights(const uint8_t* payload, size_t n,
                                   uint8_t* weights /*256*/) {
    FwdBits r(payload, n);
    int16_t counts[256];
    unsigned acc_log = read_ncount(r, counts, 255, 6);
    size_t hdr = r.bytes_consumed();
    if (hdr > n) throw Err{};
    FseDTable dt;
    build_dtable(counts, 256, acc_log, dt);
    BackBits br;
    if (!br.init(payload + hdr, n - hdr)) throw Err{};
    uint32_t st[2];
    st[0] = br.read(acc_log);
    st[1] = br.read(acc_log);
    if (br.overread()) throw Err{};
    unsigned count = 0;
    for (unsigned i = 0;; i++) {
        if (count > 255) throw Err{};
        uint32_t s = st[i & 1];
        weights[count++] = dt.symbol(s);
        st[i & 1] = dt.base(s) + br.read(dt.nb_bits(s));
        if (br.overread()) {
            if (count > 255) throw Err{};
            weights[count++] = dt.symbol(st[(i + 1) & 1]);
            return count;
        }
    }
}

// huffman.py read_tree_description + build_decode_table. Returns bytes
// consumed.
static size_t read_huf_table(const uint8_t* src, size_t n, HufDTable& ht) {
    if (n < 1) throw Err{};
    unsigned hdr = src[0];
    uint8_t w[256];
    std::memset(w, 0, sizeof(w));
    unsigned nsym_explicit;
    size_t consumed;
    if (hdr >= 128) {
        unsigned num = hdr - 127;
        size_t nbytes = (num + 1) / 2;
        if (n < 1 + nbytes) throw Err{};
        for (unsigned i = 0; i < num; i++) {
            uint8_t b = src[1 + i / 2];
            w[i] = (i % 2 == 0) ? (b >> 4) : (b & 0xF);
        }
        consumed = 1 + nbytes;
        nsym_explicit = num;
    } else {
        size_t csize = hdr;
        if (n < 1 + csize) throw Err{};
        nsym_explicit = fse_decode_weights(src + 1, csize, w);
        consumed = 1 + csize;
    }
    // implied last weight completes a power of two
    uint32_t total = 0;
    for (unsigned i = 0; i < nsym_explicit; i++) {
        if (w[i] > 12) throw Err{};
        if (w[i] > 0) total += 1u << (w[i] - 1);
    }
    if (total == 0) throw Err{};
    unsigned table_log = highbit32(total) + 1;  // smallest L with 2^L > total
    if (table_log > 12) throw Err{};
    uint32_t rest = (1u << table_log) - total;
    if (rest & (rest - 1)) throw Err{};
    unsigned last_weight = highbit32(rest) + 1;
    if (nsym_explicit >= 256) throw Err{};
    w[nsym_explicit] = (uint8_t)last_weight;
    unsigned nsym = nsym_explicit + 1;

    // canonical layout: symbols by ascending (weight, symbol); a symbol of
    // weight wt occupies 2^(wt-1) consecutive slots, nbits = L + 1 - wt.
    ht.table_log = table_log;
    unsigned pos = 0;
    for (unsigned wt = 1; wt <= table_log; wt++) {
        unsigned span = 1u << (wt - 1);
        unsigned nb = table_log + 1 - wt;
        for (unsigned s = 0; s < nsym; s++) {
            if (w[s] != wt) continue;
            uint16_t e = (uint16_t)(s | (nb << 8));
            for (unsigned k = 0; k < span; k++) ht.table[pos + k] = e;
            pos += span;
        }
    }
    if (pos != (1u << table_log)) throw Err{};
    ht.valid = true;
    return consumed;
}

// Decode `count` symbols from one backward Huffman stream.
// Fast path decodes 4 symbols per 8-byte load: with table_log <= 12 and
// bitpos >= 57, the window loaded at byte (bitpos-57)>>3 covers all four
// peeks (4*12 + 12 = 60 <= 57+7 window top slack; see derivation in the
// loop). Mirrors the ILP structure of the reference's 4X decoder
// (huf_decompress.c:602) without copying it.
static void huf_decode_stream(const uint8_t* src, size_t n, const HufDTable& ht,
                              uint8_t* out, size_t count) {
    BackBits br;
    if (!br.init(src, n)) throw Err{};
    unsigned tl = ht.table_log;
    const uint16_t* tab = ht.table;
    const uint32_t mask = (1u << tl) - 1;
    size_t i = 0;
    std::ptrdiff_t pos = br.bitpos;
    // fast path: pos >= 57 guarantees byte window B=(pos-57)>>3 in range
    // (B+8 <= n) and 4 consecutive peeks of <= 12 bits stay inside it.
    while (i + 4 <= count && pos >= (std::ptrdiff_t)(48 + tl) && pos >= 57) {
        size_t B = (size_t)(pos - 57) >> 3;
        uint64_t acc;
        std::memcpy(&acc, src + B, 8);
        unsigned rel = (unsigned)(pos - 8 * B);
        uint16_t e0 = tab[(acc >> (rel - tl)) & mask];
        rel -= e0 >> 8;
        uint16_t e1 = tab[(acc >> (rel - tl)) & mask];
        rel -= e1 >> 8;
        uint16_t e2 = tab[(acc >> (rel - tl)) & mask];
        rel -= e2 >> 8;
        uint16_t e3 = tab[(acc >> (rel - tl)) & mask];
        rel -= e3 >> 8;
        out[i] = (uint8_t)e0;
        out[i + 1] = (uint8_t)e1;
        out[i + 2] = (uint8_t)e2;
        out[i + 3] = (uint8_t)e3;
        i += 4;
        pos = 8 * B + rel;
    }
    br.bitpos = pos;
    while (i < count) {
        uint16_t e = tab[br.peek(tl)];
        out[i++] = (uint8_t)e;
        br.consume(e >> 8);
    }
    // allowed to end with bitpos >= 0 slack (padding) but not deep overread
    if (br.bitpos < -(std::ptrdiff_t)tl) throw Err{};
}

// Decode the 4-stream literal section with the streams interleaved so the
// four serial bit-chain dependency chains overlap in the CPU pipeline —
// the ILP idea of the reference's HUF_decompress4X loop
// (huf_decompress.c:602), realised independently on top of this file's
// window-load scheme. Streams 0..2 decode `n123` symbols, stream 3 `n4`.
static void huf_decode_4streams(const uint8_t* const parts[4],
                                const size_t plens[4], size_t n123, size_t n4,
                                const HufDTable& ht, uint8_t* out) {
    BackBits br[4];
    for (int s = 0; s < 4; s++)
        if (!br[s].init(parts[s], plens[s])) throw Err{};
    const unsigned tl = ht.table_log;
    const uint16_t* tab = ht.table;
    const uint32_t mask = (1u << tl) - 1;
    uint8_t* o0 = out;
    uint8_t* o1 = out + n123;
    uint8_t* o2 = out + 2 * n123;
    uint8_t* o3 = out + 3 * n123;
    std::ptrdiff_t p0 = br[0].bitpos, p1 = br[1].bitpos;
    std::ptrdiff_t p2 = br[2].bitpos, p3 = br[3].bitpos;
    const uint8_t* s0 = parts[0];
    const uint8_t* s1 = parts[1];
    const uint8_t* s2 = parts[2];
    const uint8_t* s3 = parts[3];
    size_t i = 0;
    // interleaved fast path: 4 symbols per stream per round (16 total)
    while (i + 4 <= n4 && p0 >= 57 && p1 >= 57 && p2 >= 57 && p3 >= 57) {
        size_t B0 = (size_t)(p0 - 57) >> 3, B1 = (size_t)(p1 - 57) >> 3;
        size_t B2 = (size_t)(p2 - 57) >> 3, B3 = (size_t)(p3 - 57) >> 3;
        uint64_t a0, a1, a2, a3;
        std::memcpy(&a0, s0 + B0, 8);
        std::memcpy(&a1, s1 + B1, 8);
        std::memcpy(&a2, s2 + B2, 8);
        std::memcpy(&a3, s3 + B3, 8);
        unsigned r0 = (unsigned)(p0 - 8 * B0), r1 = (unsigned)(p1 - 8 * B1);
        unsigned r2 = (unsigned)(p2 - 8 * B2), r3 = (unsigned)(p3 - 8 * B3);
#define TZ_HUF_STEP(k)                                        \
        {                                                     \
            uint16_t e0 = tab[(a0 >> (r0 - tl)) & mask];      \
            uint16_t e1 = tab[(a1 >> (r1 - tl)) & mask];      \
            uint16_t e2 = tab[(a2 >> (r2 - tl)) & mask];      \
            uint16_t e3 = tab[(a3 >> (r3 - tl)) & mask];      \
            r0 -= e0 >> 8; r1 -= e1 >> 8;                     \
            r2 -= e2 >> 8; r3 -= e3 >> 8;                     \
            o0[i + k] = (uint8_t)e0; o1[i + k] = (uint8_t)e1; \
            o2[i + k] = (uint8_t)e2; o3[i + k] = (uint8_t)e3; \
        }
        TZ_HUF_STEP(0)
        TZ_HUF_STEP(1)
        TZ_HUF_STEP(2)
        TZ_HUF_STEP(3)
#undef TZ_HUF_STEP
        p0 = 8 * B0 + r0; p1 = 8 * B1 + r1;
        p2 = 8 * B2 + r2; p3 = 8 * B3 + r3;
        i += 4;
    }
    br[0].bitpos = p0; br[1].bitpos = p1;
    br[2].bitpos = p2; br[3].bitpos = p3;
    // per-stream tails (slow, bounds-checked reads)
    const size_t want[4] = {n123, n123, n123, n4};
    uint8_t* outs[4] = {o0, o1, o2, o3};
    for (int s = 0; s < 4; s++) {
        size_t j = i;
        // stream 3 may have fewer symbols than the interleave bound
        if (j > want[s]) throw Err{};
        while (j < want[s]) {
            uint16_t e = tab[br[s].peek(tl)];
            outs[s][j++] = (uint8_t)e;
            br[s].consume(e >> 8);
        }
        if (br[s].bitpos < -(std::ptrdiff_t)tl) throw Err{};
    }
}

// ---------------------------------------------------------------------------
// sequences: code tables (sequences.py)
// ---------------------------------------------------------------------------
static const uint8_t LL_BITS[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
    4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t LL_BASE[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 18, 20, 22,
    24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384,
    32768, 65536};
static const uint8_t ML_BITS[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10,
    11, 12, 13, 14, 15, 16};
static const uint32_t ML_BASE[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22,
    23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 37, 39, 41, 43, 47,
    51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
    65539};

static const int16_t LL_DEF_NORM[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
    2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t ML_DEF_NORM[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1,
    -1, -1, -1, -1, -1, -1};
static const int16_t OF_DEF_NORM[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    -1, -1, -1, -1, -1};

enum { MAX_LL_CODE = 35, MAX_ML_CODE = 52, MAX_OF_CODE = 31 };
enum { MAX_LL_LOG = 9, MAX_ML_LOG = 9, MAX_OF_LOG = 8 };

// ---------------------------------------------------------------------------
// frame decoder state
// ---------------------------------------------------------------------------
struct DecState {
    HufDTable huf;        // carried across blocks (treeless literals)
    FseDTable ll, of, ml;
    bool tables_valid = false;
    uint64_t rep[3] = {1, 4, 8};
    std::vector<uint8_t> lits;  // literal scratch (128K + slack)
    std::vector<uint32_t> seq_ll, seq_ml;
    std::vector<uint64_t> seq_of;
    // packed 64-bit decode entries (value base/bits fused into the FSE
    // entry, the reference's ZSTD_seqSymbol idea): one load per state
    // per sequence. Layout: vbase<<32 | vbits<<24 | nb<<16 | nextbase.
    uint64_t llp[1 << MAX_LL_LOG];
    uint64_t mlp[1 << MAX_ML_LOG];
    uint64_t ofp[1 << MAX_OF_LOG];
    unsigned max_ofb = 0;  // max offset value-bits in ofp
};

static void pack_table(const FseDTable& dt, uint64_t* out,
                       const uint32_t* vbase, const uint8_t* vbits) {
    unsigned size = 1u << dt.accuracy_log;
    for (unsigned s = 0; s < size; s++) {
        uint32_t e = dt.ent[s];
        unsigned sym = e & 0xFF;
        out[s] = ((uint64_t)vbase[sym] << 32) | ((uint64_t)vbits[sym] << 24)
                 | ((uint64_t)((e >> 8) & 0xFF) << 16) | (e >> 16);
    }
}

static unsigned pack_of_table(const FseDTable& dt, uint64_t* out) {
    unsigned size = 1u << dt.accuracy_log;
    unsigned maxb = 0;
    for (unsigned s = 0; s < size; s++) {
        uint32_t e = dt.ent[s];
        unsigned sym = e & 0xFF;        // of_code: vbits = sym, vbase = 1<<sym
        if (sym > MAX_OF_CODE) throw Err{};
        if (sym > maxb) maxb = sym;
        out[s] = ((uint64_t)(1u << sym) << 32) | ((uint64_t)sym << 24)
                 | ((uint64_t)((e >> 8) & 0xFF) << 16) | (e >> 16);
    }
    return maxb;
}

// literals.py decode()
static size_t decode_literals(const uint8_t* src, size_t n, DecState& st,
                              size_t* lit_size) {
    if (n < 1) throw Err{};
    unsigned b0 = src[0];
    unsigned ltype = b0 & 3;
    unsigned size_format = (b0 >> 2) & 3;

    if (ltype <= 1) {  // RAW / RLE
        size_t regen, hdr;
        if (size_format == 0 || size_format == 2) {
            regen = b0 >> 3;
            hdr = 1;
        } else if (size_format == 1) {
            if (n < 2) throw Err{};
            regen = (b0 >> 4) | ((size_t)src[1] << 4);
            hdr = 2;
        } else {
            if (n < 3) throw Err{};
            regen = (b0 >> 4) | ((size_t)src[1] << 4) | ((size_t)src[2] << 12);
            hdr = 3;
        }
        if (regen > (1u << 20)) throw Err{};
        st.lits.resize(regen + 32);
        *lit_size = regen;
        if (ltype == 0) {
            if (n < hdr + regen) throw Err{};
            std::memcpy(st.lits.data(), src + hdr, regen);
            return hdr + regen;
        }
        if (n < hdr + 1) throw Err{};
        std::memset(st.lits.data(), src[hdr], regen);
        return hdr + 1;
    }

    // Compressed / Treeless
    size_t regen, csize, hdr;
    unsigned streams;
    if (size_format == 0) {
        if (n < 3) throw Err{};
        uint32_t h = b0 | ((uint32_t)src[1] << 8) | ((uint32_t)src[2] << 16);
        regen = (h >> 4) & 0x3FF;
        csize = (h >> 14) & 0x3FF;
        hdr = 3;
        streams = 1;
    } else if (size_format == 1) {
        if (n < 3) throw Err{};
        uint32_t h = b0 | ((uint32_t)src[1] << 8) | ((uint32_t)src[2] << 16);
        regen = (h >> 4) & 0x3FF;
        csize = (h >> 14) & 0x3FF;
        hdr = 3;
        streams = 4;
    } else if (size_format == 2) {
        if (n < 4) throw Err{};
        uint32_t h = b0 | ((uint32_t)src[1] << 8) | ((uint32_t)src[2] << 16)
                     | ((uint32_t)src[3] << 24);
        regen = (h >> 4) & 0x3FFF;
        csize = (h >> 18) & 0x3FFF;
        hdr = 4;
        streams = 4;
    } else {
        if (n < 5) throw Err{};
        uint64_t h = (uint64_t)b0 | ((uint64_t)src[1] << 8)
                     | ((uint64_t)src[2] << 16) | ((uint64_t)src[3] << 24)
                     | ((uint64_t)src[4] << 32);
        regen = (h >> 4) & 0x3FFFF;
        csize = (h >> 22) & 0x3FFFF;
        hdr = 5;
        streams = 4;
    }
    if (n < hdr + csize) throw Err{};
    const uint8_t* payload = src + hdr;
    size_t pn = csize;

    if (ltype == 2) {  // fresh Huffman table
        size_t used = read_huf_table(payload, pn, st.huf);
        payload += used;
        pn -= used;
    } else if (!st.huf.valid) {
        throw Err{};
    }

    st.lits.resize(regen + 32);
    *lit_size = regen;
    if (streams == 1) {
        huf_decode_stream(payload, pn, st.huf, st.lits.data(), regen);
    } else {
        if (pn < 6) throw Err{};
        size_t s1 = payload[0] | ((size_t)payload[1] << 8);
        size_t s2 = payload[2] | ((size_t)payload[3] << 8);
        size_t s3 = payload[4] | ((size_t)payload[5] << 8);
        const uint8_t* body = payload + 6;
        size_t bn = pn - 6;
        if (s1 + s2 + s3 > bn) throw Err{};
        size_t n123 = (regen + 3) / 4;
        if (regen < 3 * n123) throw Err{};
        size_t n4 = regen - 3 * n123;
        const uint8_t* parts[4] = {body, body + s1, body + s1 + s2,
                                   body + s1 + s2 + s3};
        size_t plens[4] = {s1, s2, s3, bn - s1 - s2 - s3};
        if (n4 == 0) {
            // degenerate tiny-literal case: decode streams serially
            size_t counts[4] = {n123, n123, n123, n4};
            size_t off = 0;
            for (int k = 0; k < 4; k++) {
                if (counts[k])
                    huf_decode_stream(parts[k], plens[k], st.huf,
                                      st.lits.data() + off, counts[k]);
                off += counts[k];
            }
        } else {
            huf_decode_4streams(parts, plens, n123, n4, st.huf,
                                st.lits.data());
        }
    }
    return hdr + csize;
}

// sequences.py _read_table
static size_t read_seq_table(unsigned mode, const uint8_t* src, size_t n,
                             size_t pos, const int16_t* def_norm,
                             unsigned def_nsym, unsigned def_log,
                             unsigned max_sym, unsigned max_log,
                             FseDTable& dt, bool have_prev, bool* rebuilt) {
    *rebuilt = true;
    if (mode == 0) {
        build_dtable(def_norm, def_nsym, def_log, dt);
        return pos;
    }
    if (mode == 1) {
        if (pos >= n) throw Err{};
        unsigned sym = src[pos];
        if (sym > max_sym) throw Err{};
        build_rle_dtable(sym, dt);
        return pos + 1;
    }
    if (mode == 2) {
        FwdBits r(src + pos, n - pos);
        int16_t counts[64];
        unsigned log = read_ncount(r, counts, max_sym, max_log);
        build_dtable(counts, max_sym + 1, log, dt);
        return pos + r.bytes_consumed();
    }
    if (!have_prev) throw Err{};
    *rebuilt = false;
    return pos;  // repeat: keep dt as-is
}


// Execute one sequence: literal run then match copy. Shared by the hot
// sequence loop and the careful tail; must stay always_inline so each
// caller's register allocation absorbs it.
static inline __attribute__((always_inline)) void exec_seq(
    uint8_t* out, size_t& op, size_t cap, size_t frame_base,
    const uint8_t*& lp, size_t& lit_left,
    uint64_t ll, uint64_t ml, uint64_t off) {
        // execute: literal run then match copy
        if (ll > lit_left) throw Err{};
        if (op + ll + ml > cap) throw Err{};
        if (ll <= 16 && op + 16 <= cap) {
            // unconditional 16-byte copy (even ll == 0): bytes past ll
            // are scratch above op and are overwritten by later writes;
            // the lits buffer has slack. Avoids a data-dependent branch.
            std::memcpy(out + op, lp, 16);
        } else {
            std::memcpy(out + op, lp, ll);
        }
        lp += ll; lit_left -= ll; op += ll;
        // offsets must stay within the current frame's window: a corrupt
        // second frame in a concatenation must error, not copy bytes
        // from the previous frame's output
        if (off > op - frame_base || off == 0) throw Err{};
        size_t start = op - (size_t)off;
        if (op + ml + 32 <= cap) {
            uint8_t* d = out + op;
            const uint8_t* s = out + start;
            if (off >= 16) {
                std::memcpy(d, s, 16);
                if (ml > 16) {
                    size_t done = 16;
                    do {
                        std::memcpy(d + done, s + done, 16);
                        done += 16;
                    } while (done < ml);
                }
            } else if (off >= 8) {
                // period 8..15: 8-byte steps never read past the write head
                size_t done = 0;
                do {
                    std::memcpy(d + done, s + done, 8);
                    done += 8;
                } while (done < ml);
            } else {
                // period < 8: seed 16 bytes byte-by-byte, then stride by
                // m = largest multiple of off <= 16. Each stride writes 16
                // bytes of which the first m are final; the tail garbage
                // (16-m <= 8 bytes) is overwritten by the next stride or
                // falls beyond ml into the 32-byte slack. Loads complete
                // before stores (two u64 temporaries), so overlap is safe.
                size_t m = (16 / off) * off;
                size_t k = 0;
                size_t seed = ml < 16 ? ml : 16;
                for (; k < seed; k++) d[k] = s[k];
                while (k < ml) {
                    uint64_t a, b;
                    std::memcpy(&a, d + k - m, 8);
                    std::memcpy(&b, d + k - m + 8, 8);
                    std::memcpy(d + k, &a, 8);
                    std::memcpy(d + k + 8, &b, 8);
                    k += m;
                }
            }
            op += ml;
        } else {
            // near end of buffer: safe byte copy
            for (size_t k = 0; k < ml; k++) out[op + k] = out[start + k];
            op += ml;
        }
}

// Hot sequence loop state. decode_seqs_hot is deliberately noinline:
// inlined into decode_frame it shares one giant stack frame and the
// register allocator spills the loop-carried state (measured ~50
// cycles/seq from store-forwarding traffic); as a standalone function
// everything lives in registers.
struct HotCtx {
    const uint8_t* bd;
    std::ptrdiff_t bitpos;
    uint32_t ll_state, of_state, ml_state;
    uint64_t r0, r1, r2;
    const uint8_t* lp;
    size_t lit_left;
    size_t op;
    const uint64_t *llp, *mlp, *ofp;
    uint8_t* out;
    size_t cap;
    size_t frame_base;
    size_t nseq;
    bool long_mode;
};

// Returns the number of sequences consumed (the careful tail in
// decode_block finishes the rest).
static __attribute__((noinline)) size_t decode_seqs_hot(HotCtx& c) {
    const uint8_t* const bd = c.bd;
    std::ptrdiff_t bitpos = c.bitpos;
    uint32_t ll_state = c.ll_state, of_state = c.of_state,
             ml_state = c.ml_state;
    uint64_t r0 = c.r0, r1 = c.r1, r2 = c.r2;
    const uint8_t* lp = c.lp;
    size_t lit_left = c.lit_left;
    size_t op = c.op;
    const uint64_t* llp = c.llp;
    const uint64_t* mlp = c.mlp;
    const uint64_t* ofp = c.ofp;
    uint8_t* out = c.out;
    const size_t cap = c.cap, frame_base = c.frame_base, nseq = c.nseq;
    const bool long_mode = c.long_mode;

    constexpr size_t ADV = 8;
    struct SeqD { uint64_t ll, ml, off; } ring[ADV];
    uint64_t vop = op;  // output position at the decode-ahead head
    size_t i = 0;
    while (i + 1 < nseq && bitpos >= 114) {
        uint64_t el = llp[ll_state];
        uint64_t em = mlp[ml_state];
        uint64_t eo = ofp[of_state];
        unsigned ofb = (uint8_t)(eo >> 24);
        unsigned mlb = (uint8_t)(em >> 24);
        unsigned llb = (uint8_t)(el >> 24);
        size_t B = (size_t)(bitpos - 57) >> 3;
        uint64_t w = rd64le(bd + B) << (unsigned)(8 * B + 64 - bitpos);
        uint64_t vof = w >> 1 >> (63 - ofb); w <<= ofb;
        uint64_t vml = w >> 1 >> (63 - mlb); w <<= mlb;
        uint64_t vll = w >> 1 >> (63 - llb);
        bitpos -= ofb + mlb + llb;
        unsigned nbl = (uint8_t)(el >> 16);
        unsigned nbm = (uint8_t)(em >> 16);
        unsigned nbo = (uint8_t)(eo >> 16);
        B = (size_t)(bitpos - 57) >> 3;
        uint64_t w2 = rd64le(bd + B) << (unsigned)(8 * B + 64 - bitpos);
        ll_state = (uint32_t)(el & 0xFFFF)
                   + (uint32_t)(w2 >> 1 >> (63 - nbl));
        w2 <<= nbl;
        ml_state = (uint32_t)(em & 0xFFFF)
                   + (uint32_t)(w2 >> 1 >> (63 - nbm));
        w2 <<= nbm;
        of_state = (uint32_t)(eo & 0xFFFF)
                   + (uint32_t)(w2 >> 1 >> (63 - nbo));
        bitpos -= nbl + nbm + nbo;
        uint64_t ll = (el >> 32) + vll;
        uint64_t ml = (em >> 32) + vml;
        uint64_t of_value = (eo >> 32) + vof;
        // branchless repeat-offset resolution (cmov chain)
        unsigned rep_idx = (unsigned)of_value + (ll == 0 ? 1u : 0u);
        unsigned idx = of_value <= 3 ? rep_idx : 0u;
        uint64_t off = of_value - 3;
        off = (idx == 1) ? r0 : off;
        off = (idx == 2) ? r1 : off;
        off = (idx == 3) ? r2 : off;
        off = (idx == 4) ? r0 - 1 : off;
        if (__builtin_expect(off == 0, 0)) throw Err{};
        bool rot2 = (idx == 0) | (idx >= 3);
        bool rot1 = (idx != 1);
        r2 = rot2 ? r1 : r2;
        r1 = rot1 ? r0 : r1;
        r0 = rot1 ? off : r0;
        if (long_mode) {
            if (off <= vop + ll - frame_base) {
                const uint8_t* a = out + (vop + ll - off);
                __builtin_prefetch(a);
                __builtin_prefetch(a + 64);
            }
            vop += ll + ml;
            if (i >= ADV) {
                SeqD cseq = ring[i & (ADV - 1)];
                exec_seq(out, op, cap, frame_base, lp, lit_left,
                         cseq.ll, cseq.ml, cseq.off);
            }
            ring[i & (ADV - 1)] = SeqD{ll, ml, off};
        } else {
            exec_seq(out, op, cap, frame_base, lp, lit_left, ll, ml, off);
        }
        i++;
    }
    if (long_mode) {  // flush pending ring entries in order
        size_t first = i >= ADV ? i - ADV : 0;
        for (size_t j = first; j < i; j++) {
            SeqD cseq = ring[j & (ADV - 1)];
            exec_seq(out, op, cap, frame_base, lp, lit_left,
                     cseq.ll, cseq.ml, cseq.off);
        }
    }
    c.bitpos = bitpos;
    c.ll_state = ll_state; c.of_state = of_state; c.ml_state = ml_state;
    c.r0 = r0; c.r1 = r1; c.r2 = r2;
    c.lp = lp; c.lit_left = lit_left; c.op = op;
    return i;
}

// Decode a compressed block's sequences + execute into out[op..].
// Returns new op.
static size_t decode_block(const uint8_t* src, size_t n, DecState& st,
                           uint8_t* out, size_t op, size_t cap,
                           size_t frame_base, bool long_mode) {
    size_t lit_size = 0;
    size_t used = decode_literals(src, n, st, &lit_size);
    if (used > n) throw Err{};
    const uint8_t* sp = src + used;
    size_t sn = n - used;

    // sequence count
    if (sn == 0) throw Err{};
    unsigned b0 = sp[0];
    size_t pos = 1;
    size_t nseq;
    if (b0 < 128) {
        nseq = b0;
    } else if (b0 < 255) {
        if (sn < 2) throw Err{};
        nseq = ((size_t)(b0 - 128) << 8) + sp[1];
        pos = 2;
    } else {
        if (sn < 3) throw Err{};
        nseq = sp[1] + ((size_t)sp[2] << 8) + 0x7F00;
        pos = 3;
    }

    if (nseq == 0) {
        // all-literal block
        if (op + lit_size > cap) throw Err{};
        std::memcpy(out + op, st.lits.data(), lit_size);
        return op + lit_size;
    }

    if (pos >= sn) throw Err{};
    unsigned modes = sp[pos++];
    if (modes & 3) throw Err{};
    unsigned ll_mode = (modes >> 6) & 3;
    unsigned of_mode = (modes >> 4) & 3;
    unsigned ml_mode = (modes >> 2) & 3;

    bool rb_ll, rb_of, rb_ml;
    pos = read_seq_table(ll_mode, sp, sn, pos, LL_DEF_NORM, 36, 6,
                         MAX_LL_CODE, MAX_LL_LOG, st.ll, st.tables_valid,
                         &rb_ll);
    pos = read_seq_table(of_mode, sp, sn, pos, OF_DEF_NORM, 29, 5,
                         MAX_OF_CODE, MAX_OF_LOG, st.of, st.tables_valid,
                         &rb_of);
    pos = read_seq_table(ml_mode, sp, sn, pos, ML_DEF_NORM, 53, 6,
                         MAX_ML_CODE, MAX_ML_LOG, st.ml, st.tables_valid,
                         &rb_ml);
    if (rb_ll || !st.tables_valid) pack_table(st.ll, st.llp, LL_BASE, LL_BITS);
    if (rb_ml || !st.tables_valid) pack_table(st.ml, st.mlp, ML_BASE, ML_BITS);
    if (rb_of || !st.tables_valid) st.max_ofb = pack_of_table(st.of, st.ofp);
    st.tables_valid = true;
    if (pos > sn) throw Err{};

    BackBits br;
    if (!br.init(sp + pos, sn - pos)) throw Err{};
    uint32_t ll_state = br.read(st.ll.accuracy_log);
    uint32_t of_state = br.read(st.of.accuracy_log);
    uint32_t ml_state = br.read(st.ml.accuracy_log);

    // decode + execute fused: literals copied from st.lits as we go
    const uint8_t* lp = st.lits.data();
    size_t lit_left = lit_size;
    uint64_t r0 = st.rep[0], r1 = st.rep[1], r2 = st.rep[2];

    const uint32_t* llt = st.ll.ent;
    const uint32_t* oft = st.of.ent;
    const uint32_t* mlt = st.ml.ent;

    uint64_t s_ll, s_ml, s_off;  // decode_one outputs
    auto decode_one = [&](size_t i) __attribute__((always_inline)) {
        // one packed load per state: symbol | nb_bits<<8 | base<<16
        uint32_t el = llt[ll_state];
        uint32_t eo = oft[of_state];
        uint32_t em = mlt[ml_state];
        unsigned ll_code = el & 0xFF;
        unsigned of_code = eo & 0xFF;
        unsigned ml_code = em & 0xFF;
        if (of_code > MAX_OF_CODE) throw Err{};
        unsigned ofb = of_code;
        unsigned mlb = ML_BITS[ml_code];
        unsigned llb = LL_BITS[ll_code];

        // Two independently-guarded 8-byte windows per sequence. The
        // value fields total ofb+mlb+llb <= 31+16+16 = 63, but with
        // window_log <= 25 (every practical stream) <= 57, so one
        // window covers them; the state-reload fields total <= 26.
        // Guarding each on bitpos alone (true until the stream tail)
        // keeps both branches perfectly predicted, unlike a combined
        // 6-field window whose <=57 test fails data-dependently.
        uint32_t vof, vml, vll;
        unsigned vtot = ofb + mlb + llb;
        if (br.bitpos >= 64 && vtot <= 57) {
            size_t B = (size_t)(br.bitpos - 57) >> 3;
            uint64_t acc;
            std::memcpy(&acc, br.data + B, 8);
            // shift-chain extraction: each field peels off the top
            uint64_t w = acc << (unsigned)(8 * B + 64 - br.bitpos);
            vof = (uint32_t)(w >> 1 >> (63 - ofb)); w <<= ofb;
            vml = (uint32_t)(w >> 1 >> (63 - mlb)); w <<= mlb;
            vll = (uint32_t)(w >> 1 >> (63 - llb));
            br.bitpos -= vtot;
        } else {
            br.read3(ofb, mlb, llb, &vof, &vml, &vll);
        }
        if (i + 1 < nseq) {
            unsigned nbl = (el >> 8) & 0xFF;
            unsigned nbm = (em >> 8) & 0xFF;
            unsigned nbo = (eo >> 8) & 0xFF;
            uint32_t bll, bml, bof;
            if (br.bitpos >= 57) {
                // B = (bitpos-57)>>3 guarantees B+8 <= len (57 = 64-8+1)
                size_t B = (size_t)(br.bitpos - 57) >> 3;
                uint64_t acc;
                std::memcpy(&acc, br.data + B, 8);
                uint64_t w = acc << (unsigned)(8 * B + 64 - br.bitpos);
                bll = (uint32_t)(w >> 1 >> (63 - nbl)); w <<= nbl;
                bml = (uint32_t)(w >> 1 >> (63 - nbm)); w <<= nbm;
                bof = (uint32_t)(w >> 1 >> (63 - nbo));
                br.bitpos -= nbl + nbm + nbo;
            } else {
                br.read3(nbl, nbm, nbo, &bll, &bml, &bof);
            }
            ll_state = (el >> 16) + bll;
            ml_state = (em >> 16) + bml;
            of_state = (eo >> 16) + bof;
        }
        uint64_t of_value = ((uint64_t)1 << of_code) + vof;
        uint64_t ml = ML_BASE[ml_code] + vml;
        uint64_t ll = LL_BASE[ll_code] + vll;

        // resolve repeat offsets (sequences.py resolve_offsets),
        // branchless: new-vs-repeat is data-dependent at high levels, so
        // every select below must compile to cmov, not a jump.
        // idx: 0 = new offset; 1..3 = rep0/rep1/rep2; 4 = rep0 - 1
        unsigned rep_idx = (unsigned)of_value + (ll == 0 ? 1u : 0u);
        unsigned idx = of_value <= 3 ? rep_idx : 0u;
        uint64_t off = of_value - 3;
        off = (idx == 1) ? r0 : off;
        off = (idx == 2) ? r1 : off;
        off = (idx == 3) ? r2 : off;
        off = (idx == 4) ? r0 - 1 : off;
        if (off == 0) throw Err{};
        bool rot2 = (idx == 0) | (idx >= 3);
        bool rot1 = (idx != 1);
        r2 = rot2 ? r1 : r2;
        r1 = rot1 ? r0 : r1;
        r0 = rot1 ? off : r0;
        s_ll = ll; s_ml = ml; s_off = off;
    };

    auto exec_one = [&](uint64_t ll, uint64_t ml, uint64_t off)
                        __attribute__((always_inline)) {
        exec_seq(out, op, cap, frame_base, lp, lit_left, ll, ml, off);
    };

    // Fast region: packed-entry loop in its own noinline function (see
    // decode_seqs_hot). One combined guard (bitpos >= 114) makes both
    // per-sequence 8-byte windows unconditionally safe: window 1 reads
    // <= 57 value bits, leaving bitpos >= 57 for window 2 (<= 26 state
    // bits). Valid only when the offset table's value bits keep
    // ofb+16+16 <= 57 (window_log <= 25 streams, i.e. everything the
    // reference CLI emits). In long mode, sequences are decoded ADV
    // ahead and each match source prefetched, hiding far-reference
    // cache misses (ZSTD_decompressSequencesLong_body's STORED_SEQS
    // idea - zstd_decompress_block.c:1001 - realised over this split).
    size_t i = 0;
    if (st.max_ofb <= 25) {
        HotCtx c{br.data, br.bitpos, ll_state, of_state, ml_state,
                 r0, r1, r2, lp, lit_left, op,
                 st.llp, st.mlp, st.ofp, out, cap, frame_base,
                 nseq, long_mode};
        i = decode_seqs_hot(c);
        br.bitpos = c.bitpos;
        ll_state = c.ll_state; of_state = c.of_state; ml_state = c.ml_state;
        r0 = c.r0; r1 = c.r1; r2 = c.r2;
        lp = c.lp; lit_left = c.lit_left; op = c.op;
    }
    // careful tail (stream end / exotic tables / final sequence)
    for (; i < nseq; i++) {
        decode_one(i);
        exec_one(s_ll, s_ml, s_off);
    }
    if (br.overread()) throw Err{};
    // trailing literals
    if (lit_left) {
        if (op + lit_left > cap) throw Err{};
        std::memcpy(out + op, lp, lit_left);
        op += lit_left;
    }
    st.rep[0] = r0; st.rep[1] = r1; st.rep[2] = r2;
    return op;
}

struct DstSmall {};  // thrown when a fixed-capacity sink is exceeded

// Output sink: either wraps the caller's fixed buffer (owned = false;
// overflow throws DstSmall) or a malloc/realloc-grown buffer with NO
// zero-fill — a plain std::vector resize memsets every grown byte,
// which costs a full extra memory pass on large outputs.
struct Sink {
    uint8_t* p = nullptr;
    size_t cap = 0;
    size_t size = 0;  // logical bytes written (across frames)
    bool owned = false;

    void ensure(size_t need) {
        if (need <= cap) return;
        if (!owned) throw DstSmall{};
        size_t ncap = cap + (cap >> 1) + (1u << 20);
        if (ncap < need) ncap = need;
        uint8_t* np = (uint8_t*)std::realloc(p, ncap);
        if (!np) throw Err{};
        p = np;
        cap = ncap;
    }
    ~Sink() {
        if (owned) std::free(p);
    }
};

// Decode one zstd frame at src; appends to out. Returns bytes consumed.
static size_t decode_frame(const uint8_t* src, size_t n,
                           Sink& out, bool verify) {
    if (n < 8) throw Err{};
    uint32_t magic = rd32le(src);
    if (magic >= 0x184D2A50u && magic <= 0x184D2A5Fu) {
        uint32_t size = rd32le(src + 4);
        if (8 + (size_t)size > n) throw Err{};
        return 8 + size;
    }
    if (magic != 0xFD2FB528u) throw Err{};
    if (n < 5) throw Err{};
    unsigned fhd = src[4];
    size_t pos = 5;
    unsigned fcs_flag = fhd >> 6;
    bool single_segment = fhd & (1 << 5);
    if (fhd & (1 << 3)) throw Err{};
    bool checksum = fhd & (1 << 2);
    unsigned did_flag = fhd & 3;

    uint64_t window_size = 0;
    if (!single_segment) {
        if (n < pos + 1) throw Err{};
        unsigned wd = src[pos++];
        unsigned exponent = wd >> 3;
        unsigned mantissa = wd & 7;
        uint64_t base = 1ull << (10 + exponent);
        window_size = base + (base / 8) * mantissa;
        if (window_size > (1ull << 31)) throw Err{};
    }
    static const unsigned did_bytes_tab[4] = {0, 1, 2, 4};
    unsigned did_bytes = did_bytes_tab[did_flag];
    if (did_bytes) {
        if (n < pos + did_bytes) throw Err{};
        // dictionary IDs are parsed but external dictionaries are not
        // supported on the native tier; raw frames from the reference
        // encoder never use them.
        uint64_t dict_id = 0;
        for (unsigned i = 0; i < did_bytes; i++)
            dict_id |= (uint64_t)src[pos + i] << (8 * i);
        pos += did_bytes;
        if (dict_id != 0) throw Err{};
    }
    unsigned fcs_bytes;
    if (fcs_flag == 0) fcs_bytes = single_segment ? 1 : 0;
    else if (fcs_flag == 1) fcs_bytes = 2;
    else if (fcs_flag == 2) fcs_bytes = 4;
    else fcs_bytes = 8;
    bool have_csize = fcs_bytes != 0;
    uint64_t content_size = 0;
    if (have_csize) {
        if (n < pos + fcs_bytes) throw Err{};
        for (unsigned i = 0; i < fcs_bytes; i++)
            content_size |= (uint64_t)src[pos + i] << (8 * i);
        if (fcs_bytes == 2) content_size += 256;
        pos += fcs_bytes;
        if (content_size > (1ull << 40)) throw Err{};
    }

    size_t base_op = out.size;
    if (have_csize) out.ensure(base_op + content_size + 32);
    else out.ensure(base_op + (1u << 20));
    size_t op = base_op;

    DecState st;
    uint64_t block_cap = 128 * 1024;
    if (!single_segment && window_size && window_size < block_cap)
        block_cap = window_size;
    // far references escape L2: switch to the decode-ahead + prefetch
    // sequence loop when the window (or single-segment content) is big
    uint64_t span = single_segment ? content_size : window_size;
    bool long_mode = span > (1u << 20);

    for (;;) {
        if (pos + 3 > n) throw Err{};
        uint32_t bh = src[pos] | ((uint32_t)src[pos + 1] << 8)
                      | ((uint32_t)src[pos + 2] << 16);
        pos += 3;
        unsigned last = bh & 1;
        unsigned btype = (bh >> 1) & 3;
        size_t bsize = bh >> 3;
        if (btype == 3) throw Err{};
        // ensure capacity for the worst case (decoded block <= 128K)
        if (op + (128 * 1024) + 64 > out.cap)
            out.ensure(op + (op - base_op) + (1u << 20));
        // RFC 8878: Block_Maximum_Size caps every block type, including
        // raw and RLE (bsize is the regenerated size for RLE). Without
        // this check a crafted 21-bit bsize could overrun the 128K+64
        // slack guaranteed above.
        if (bsize > block_cap) throw Err{};
        if (btype == 0) {  // raw
            if (pos + bsize > n) throw Err{};
            std::memcpy(out.p + op, src + pos, bsize);
            op += bsize;
            pos += bsize;
        } else if (btype == 1) {  // RLE
            if (pos + 1 > n) throw Err{};
            std::memset(out.p + op, src[pos], bsize);
            op += bsize;
            pos += 1;
        } else {
            if (bsize > block_cap) throw Err{};
            if (pos + bsize > n) throw Err{};
            size_t op_before = op;
            op = decode_block(src + pos, bsize, st, out.p, op,
                              out.cap, base_op, long_mode);
            if (op - op_before > 128 * 1024) throw Err{};  // RFC block cap
            pos += bsize;
        }
        if (last) break;
    }

    if (have_csize && op - base_op != content_size) throw Err{};
    out.size = op;
    if (checksum) {
        if (pos + 4 > n) throw Err{};
        uint32_t want = rd32le(src + pos);
        pos += 4;
        if (verify) {
            uint32_t got = (uint32_t)tz_xxh64(out.p + base_op,
                                              op - base_op, 0);
            if (got != want) throw Err{};
        }
    }
    return pos;
}

}  // namespace zdec

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" long long tz_zstd_decode_alloc(const uint8_t* src, size_t n,
                                          uint8_t** out_ptr,
                                          int verify_checksum);

// Decode a concatenation of zstd frames into dst (capacity cap).
// Returns decoded size, or a negative error code.
extern "C" long long tz_zstd_decode(const uint8_t* src, size_t n,
                                    uint8_t* dst, size_t cap,
                                    int verify_checksum) {
    // Fast path: decode directly into dst (zero extra memory passes).
    // Frame slack demands (content_size + 32, 128K block headroom) can
    // exceed a tight-but-sufficient cap; on DstSmall retry through the
    // growable path to preserve the "fits means success" contract.
    try {
        zdec::Sink out;
        out.p = dst;
        out.cap = cap;
        size_t pos = 0;
        while (pos < n) {
            if (n - pos < 4) return zdec::ERR_CORRUPT;
            pos += zdec::decode_frame(src + pos, n - pos, out,
                                      verify_checksum != 0);
        }
        return (long long)out.size;
    } catch (zdec::DstSmall&) {
        uint8_t* buf = nullptr;
        long long r = tz_zstd_decode_alloc(src, n, &buf, verify_checksum);
        if (r < 0) return r;
        if ((size_t)r > cap) {
            std::free(buf);
            return zdec::ERR_DST_TOO_SMALL;
        }
        std::memcpy(dst, buf, (size_t)r);
        std::free(buf);
        return r;
    } catch (...) {
        return zdec::ERR_CORRUPT;
    }
}

// Variant returning a malloc'd buffer (for unknown decoded sizes).
// Caller frees with tz_buf_free.
extern "C" long long tz_zstd_decode_alloc(const uint8_t* src, size_t n,
                                          uint8_t** out_ptr,
                                          int verify_checksum) {
    try {
        zdec::Sink out;
        out.owned = true;
        size_t pos = 0;
        while (pos < n) {
            if (n - pos < 4) return zdec::ERR_CORRUPT;
            pos += zdec::decode_frame(src + pos, n - pos, out,
                                      verify_checksum != 0);
        }
        // hand the buffer to the caller (freed via tz_buf_free)
        *out_ptr = out.p ? out.p : (uint8_t*)std::malloc(1);
        out.p = nullptr;
        out.owned = false;
        return (long long)out.size;
    } catch (...) {
        return zdec::ERR_CORRUPT;
    }
}

extern "C" void tz_buf_free(uint8_t* p) { std::free(p); }
