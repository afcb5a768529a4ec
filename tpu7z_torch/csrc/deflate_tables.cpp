// DEFLATE's dynamic-block tables on the host (RFC 1951, 3.2.7): for every
// block of a stream in one call, from its literal/length and distance
// histograms, the length-limited code lengths (package-merge), the
// bit-reversed canonical codes of both alphabets and the block header's
// fields as (value, nbits) pairs in stream order. The numbers are tpu7z's
// (tpu7z/models/deflate/codec.py, `_compress_block` up to the body:
// `_lens_from_hist` over models/zstd/huffman.py's `_package_merge`,
// `_canonical_codes`, `_rev_bits`, `_write_dynamic_header`), ties
// included. A plain C interface for ctypes
// (tpu7z_torch/models/deflate/codec.py: `_tables`, `_code_lengths`).
//
// Build: c++ -O3 -fPIC -shared -std=c++17 (tpu7z_torch/ops/_build.py).

#include <algorithm>
#include <cstdint>
#include <numeric>

namespace {

constexpr int NLIT = 286;             // HLIT + 257, fixed
constexpr int NDIST = 30;             // HDIST + 1, fixed
constexpr int NALL = NLIT + NDIST;    // the code lengths a header codes
constexpr int NCLC = 19;              // the code-length alphabet
constexpr int MAX_SYMS = NLIT;        // the largest alphabet
constexpr int MAX_BITS = 15;          // literal/length and distance codes
constexpr int CLC_BITS = 7;           // code-length codes
// A header's fields: BFINAL, BTYPE; HLIT, HDIST, HCLEN; at most 19 3-bit
// code-length lengths; at most one run-length op a code length, each its
// code and at most one field of extra bits.
constexpr int CAP = 2 + 3 + NCLC + 2 * NALL;
constexpr int CLC_ORDER[NCLC] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2,
                                 14, 1, 15};

// Package-merge over the n >= 2 weights `w`: each one's code length,
// at most `max_bits`, into `lens`, tie for tie as `_package_merge`. The
// leaves are taken in a stable argsort of the weights. Each level merges
// the sorted leaves with the previous level's packages, a leaf before a
// package of equal weight and the packages in their order of creation
// (Python's stable `sorted` of leaves + packages), and pairs the merged
// items in order into the next level's packages. A leaf's length is the
// number of times it occurs in the last level's first 2n - 2 items.
// Those items are a prefix of the sorted leaves and a prefix of the
// packages, and the first p packages of a level hold its previous
// level's first 2p items, so one walk back through the levels counts
// them: a leaf's length is the number of levels whose prefix holds it.
void package_merge(const int64_t* w, int n, int max_bits, int64_t* lens) {
    int order[MAX_SYMS];
    std::iota(order, order + n, 0);
    std::stable_sort(order, order + n, [w](int a, int b) { return w[a] < w[b]; });
    // the sorted leaves' and the packages' weights, each list ended by a
    // weight above any sum, so that the merge needs no bounds test (a
    // level holds fewer than 2n items, so fewer than n packages)
    int64_t leaf[MAX_SYMS + 1], pkg[MAX_SYMS + 1], merged[2 * MAX_SYMS];
    for (int i = 0; i < n; i++) leaf[i] = w[order[i]];
    leaf[n] = INT64_MAX;
    pkg[0] = INT64_MAX;
    uint8_t is_leaf[MAX_BITS][2 * MAX_SYMS];
    int items[MAX_BITS];
    int npkg = 0;
    for (int level = 0; level < max_bits; level++) {
        const int m = n + npkg;
        for (int k = 0, i = 0, j = 0; k < m; k++) {
            const bool take_leaf = leaf[i] <= pkg[j];
            merged[k] = take_leaf ? leaf[i] : pkg[j];
            is_leaf[level][k] = take_leaf;
            i += take_leaf;
            j += !take_leaf;
        }
        items[level] = m;
        npkg = m / 2;
        for (int k = 0; k < npkg; k++) pkg[k] = merged[2 * k] + merged[2 * k + 1];
        pkg[npkg] = INT64_MAX;
    }
    int count[MAX_SYMS] = {};
    int take = 2 * n - 2;
    for (int level = max_bits - 1; level >= 0 && take > 0; level--) {
        take = std::min(take, items[level]);
        int leaves = 0;
        for (int k = 0; k < take; k++) leaves += is_leaf[level][k];
        for (int k = 0; k < leaves; k++) count[k]++;
        take = 2 * (take - leaves);
    }
    for (int i = 0; i < n; i++) lens[order[i]] = count[i];
}

// `_lens_from_hist`: the code lengths of the `size` symbols of `hist`,
// 0 for a count of 0, 1 for the one used symbol of a histogram with one.
void lens_from_hist(const int64_t* hist, int size, int max_bits, int64_t* lens) {
    int64_t w[MAX_SYMS], got[MAX_SYMS];
    int sym[MAX_SYMS];
    int n = 0;
    for (int s = 0; s < size; s++) {
        lens[s] = 0;
        if (hist[s] != 0) {
            w[n] = hist[s];
            sym[n++] = s;
        }
    }
    if (n == 1) {
        lens[sym[0]] = 1;
    } else if (n > 1) {
        package_merge(w, n, max_bits, got);
        for (int i = 0; i < n; i++) lens[sym[i]] = got[i];
    }
}

// `_rev_bits(_canonical_codes(lens)[s], lens[s])` of every symbol: RFC
// 1951's canonical codes, each bit-reversed over its length (0 where the
// length is 0), as an LSB-first writer sends them.
void reversed_codes(const int64_t* lens, int size, int64_t* out) {
    int64_t bl_count[MAX_BITS + 1] = {};
    for (int s = 0; s < size; s++) bl_count[lens[s]]++;
    bl_count[0] = 0;
    int64_t next_code[MAX_BITS + 1] = {};
    int64_t code = 0;
    for (int bits = 1; bits <= MAX_BITS; bits++) {
        code = (code + bl_count[bits - 1]) << 1;
        next_code[bits] = code;
    }
    for (int s = 0; s < size; s++) {
        const int64_t ln = lens[s];
        int64_t v = ln ? next_code[ln]++ : 0, r = 0;
        for (int64_t i = 0; i < ln; i++, v >>= 1) r = (r << 1) | (v & 1);
        out[s] = r;
    }
}

struct Fields {
    int64_t* values;
    int64_t* nbits;
    int64_t n;
    void write(int64_t value, int bits) {
        values[n] = value & ((int64_t(1) << bits) - 1);
        nbits[n++] = bits;
    }
};

// `_write_dynamic_header` (after BFINAL and BTYPE): HLIT 286 and HDIST 30,
// the 316 code lengths run-length coded (18 for 11-138 zeros, 17 for 3-10
// zeros, 16 for 3-6 repeats after one literal length), their code (7-bit
// package-merge) and HCLEN trimmed of trailing zero lengths in CLC_ORDER,
// down to no fewer than 4.
void write_header(Fields& f, const int64_t* lit_lens, const int64_t* dist_lens) {
    int64_t all[NALL];
    std::copy(lit_lens, lit_lens + NLIT, all);
    std::copy(dist_lens, dist_lens + NDIST, all + NLIT);
    // each op its symbol and extra bits' value and width (0: none)
    int op_sym[NALL], op_arg[NALL], op_bits[NALL];
    int nops = 0;
    auto op = [&](int s, int arg, int bits) {
        op_sym[nops] = s;
        op_arg[nops] = arg;
        op_bits[nops++] = bits;
    };
    for (int i = 0; i < NALL;) {
        const int v = int(all[i]);
        int j = i;
        while (j < NALL && all[j] == v) j++;
        int run = j - i;
        if (v == 0) {
            for (; run >= 11; run -= std::min(run, 138)) op(18, std::min(run, 138) - 11, 7);
            for (; run >= 3; run -= std::min(run, 10)) op(17, std::min(run, 10) - 3, 3);
        } else {
            op(v, 0, 0);
            for (run--; run >= 3; run -= std::min(run, 6)) op(16, std::min(run, 6) - 3, 2);
        }
        for (; run > 0; run--) op(v, 0, 0);
        i = j;
    }
    int64_t clc_hist[NCLC] = {}, clc_lens[NCLC], clc_rev[NCLC];
    for (int k = 0; k < nops; k++) clc_hist[op_sym[k]]++;
    lens_from_hist(clc_hist, NCLC, CLC_BITS, clc_lens);
    reversed_codes(clc_lens, NCLC, clc_rev);
    int hclen = NCLC;
    while (hclen > 4 && clc_lens[CLC_ORDER[hclen - 1]] == 0) hclen--;
    f.write(NLIT - 257, 5);
    f.write(NDIST - 1, 5);
    f.write(hclen - 4, 4);
    for (int i = 0; i < hclen; i++) f.write(clc_lens[CLC_ORDER[i]], 3);
    for (int k = 0; k < nops; k++) {
        f.write(clc_rev[op_sym[k]], int(clc_lens[op_sym[k]]));
        if (op_bits[k]) f.write(op_arg[k], op_bits[k]);
    }
}

}  // namespace

extern "C" {

// The most header fields one block can have.
int tz_deflate_header_cap() { return CAP; }

// One alphabet's code lengths: `_lens_from_hist(hist, size, max_bits)`.
// Returns 0, or -1 (lens untouched) for a size over 286, a max_bits
// outside 1-15, or more used symbols than 2^max_bits codes can hold.
int tz_deflate_lengths(const int64_t* hist, int size, int max_bits, int64_t* lens) {
    if (size < 0 || size > MAX_SYMS || max_bits < 1 || max_bits > MAX_BITS) return -1;
    const int used = int(std::count_if(hist, hist + size, [](int64_t c) { return c != 0; }));
    if (used > (1 << max_bits)) return -1;
    lens_from_hist(hist, size, max_bits, lens);
    return 0;
}

// The tables of `nb` blocks: lit_hist (nb, 286) with EOB's count (symbol
// 256) already 1, and dist_hist (nb, 30), each row-major int64. Writes,
// row-major int64: lit_lens and lit_rev (nb, 286); dist_lens and
// dist_rev (nb, 30), an all-zero distance histogram giving distance 0
// length 1 and negative counts taken as 0; and every block's header
// fields one after another into hvals and hbits (room for nb * CAP),
// heads[b] of them for block b, BFINAL 1 on every block with `streams`,
// else on the last only. Returns the number of header fields written.
int64_t tz_deflate_tables(const int64_t* lit_hist, const int64_t* dist_hist, int64_t nb,
                          int streams, int64_t* lit_lens, int64_t* dist_lens,
                          int64_t* lit_rev, int64_t* dist_rev, int64_t* heads,
                          int64_t* hvals, int64_t* hbits) {
    Fields f{hvals, hbits, 0};
    for (int64_t b = 0; b < nb; b++) {
        const int64_t* dh = dist_hist + b * NDIST;
        int64_t* ll = lit_lens + b * NLIT;
        int64_t* dl = dist_lens + b * NDIST;
        lens_from_hist(lit_hist + b * NLIT, NLIT, MAX_BITS, ll);
        int64_t sum = 0, used[NDIST];
        for (int s = 0; s < NDIST; s++) {
            sum += dh[s];
            used[s] = std::max<int64_t>(dh[s], 0);
        }
        if (sum == 0) {
            std::fill(dl, dl + NDIST, 0);
            dl[0] = 1;
        } else {
            lens_from_hist(used, NDIST, MAX_BITS, dl);
        }
        reversed_codes(ll, NLIT, lit_rev + b * NLIT);
        reversed_codes(dl, NDIST, dist_rev + b * NDIST);
        const int64_t start = f.n;
        f.write(streams || b == nb - 1 ? 1 : 0, 1);
        f.write(2, 2);
        write_header(f, ll, dl);
        heads[b] = f.n - start;
    }
    return f.n;
}

}  // extern "C"
