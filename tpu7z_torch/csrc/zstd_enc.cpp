// Native host-tier zstd encoder (frame format per RFC 8878).
//
// Role-equivalent of the reference's C encoder (C/zstd/zstd_compress.c)
// but an independent design: a single hash-chain match finder with
// repeat-offset probes and lazy deferral feeds per-block entropy
// sections (length-limited Huffman literals, FSE sequences). The tensor
// encoder (tpu7z_torch/models/zstd/compressor.py) is the data-parallel
// path; this is the host fast path the CLI uses. It is tpu7z's host
// encoder (tpu7z/native/src/zstd_enc.cpp), byte for byte.
//
// Bit-level layout choices (stream framing, ncount serialization,
// canonical Huffman layout) mirror tpu7z_torch/models/zstd/{fse,huffman}.py,
// which are themselves written from the RFC.
//
// Build: c++ -O3 -fPIC -shared -std=c++17 (tpu7z_torch/ops/_build.py).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>
#include <algorithm>

#include "xxh64.h"

extern "C" uint64_t tz_xxh64(const uint8_t* p, size_t len, uint64_t seed) {
    return tz_xxh::xxh64(p, len, seed);
}

namespace {

constexpr size_t kBlockSize = 128 * 1024;
constexpr int kMinMatch = 3;        // format minimum (reps can use it)
constexpr int kMinChainMatch = 4;   // hash-chain matches

// ---------------------------------------------------------------- bitio ---
// LSB-first forward writer; close() appends the 1-bit end marker and pads.
// (Decoder reads the finished buffer backward: zstd entropy framing.)
// LSB-first bit packer. The hot loops (per-literal Huffman, per-seq
// FSE) commit 4 bytes at a time into a preallocated buffer; callers
// that stream an unbounded number of bits call grow() periodically.
struct BitWriter {
    std::vector<uint8_t> buf;
    uint64_t acc = 0;
    unsigned nbits = 0;
    size_t pos = 0;  // committed bytes; valid output is buf[0..pos)

    // make room for at least n more output bytes (plus slack)
    void grow(size_t n) {
        if (buf.size() < pos + n + 16) buf.resize(pos + n + 16);
    }
    inline void put(uint64_t v, int n) {
        acc |= (v & ((n == 64) ? ~0ULL : ((1ULL << n) - 1))) << nbits;
        nbits += unsigned(n);
        if (nbits >= 32) {
            std::memcpy(buf.data() + pos, &acc, 4);
            pos += 4;
            acc >>= 32;
            nbits -= 32;
        }
    }
    void close_marker() {
        put(1, 1);
        while (nbits) {
            buf[pos++] = uint8_t(acc);
            acc >>= 8;
            nbits = nbits >= 8 ? nbits - 8 : 0;
        }
        acc = 0;
        buf.resize(pos);
    }
    void close_pad() {  // pad to byte without marker (ncount framing)
        while (nbits) {
            buf[pos++] = uint8_t(acc);
            acc >>= 8;
            nbits = nbits >= 8 ? nbits - 8 : 0;
        }
        acc = 0;
        buf.resize(pos);
    }
};

// ------------------------------------------------------------------ FSE ---
struct CTable {
    std::vector<int32_t> state_table;     // size 1<<log
    std::vector<int32_t> delta_nb;        // per symbol
    std::vector<int32_t> delta_fs;        // per symbol
    int log = 0;
};

static int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// slot spread shared with decode (fse.py _spread_symbols)
static bool spread_symbols(const int32_t* counts, int nsym, int log,
                           std::vector<int32_t>& table) {
    int size = 1 << log;
    table.assign(size, 0);
    int high = size - 1;
    for (int s = 0; s < nsym; s++)
        if (counts[s] == -1) table[high--] = s;
    int step = (size >> 1) + (size >> 3) + 3;
    int mask = size - 1;
    int pos = 0;
    for (int s = 0; s < nsym; s++) {
        for (int c = 0; c < counts[s]; c++) {
            table[pos] = s;
            pos = (pos + step) & mask;
            while (pos > high) pos = (pos + step) & mask;
        }
    }
    return pos == 0;
}

static bool build_ctable(const int32_t* counts, int nsym, int log,
                         CTable& ct) {
    int size = 1 << log;
    std::vector<int32_t> spread;
    if (!spread_symbols(counts, nsym, log, spread)) return false;
    std::vector<int32_t> cumul(nsym + 1, 0);
    int acc = 0;
    for (int s = 0; s < nsym; s++) {
        cumul[s] = acc;
        acc += counts[s] == -1 ? 1 : counts[s];
    }
    cumul[nsym] = acc;
    ct.state_table.assign(size, 0);
    std::vector<int32_t> fill(cumul.begin(), cumul.begin() + nsym);
    for (int u = 0; u < size; u++) {
        int s = spread[u];
        ct.state_table[fill[s]++] = size + u;
    }
    ct.delta_nb.assign(nsym, 0);
    ct.delta_fs.assign(nsym, 0);
    int total = 0;
    for (int s = 0; s < nsym; s++) {
        int c = counts[s];
        if (c == 0) {
            ct.delta_nb[s] = ((log + 1) << 16) - (1 << log);
            ct.delta_fs[s] = 0;
        } else if (c == -1 || c == 1) {
            ct.delta_nb[s] = (log << 16) - (1 << log);
            ct.delta_fs[s] = total - 1;
            total += 1;
        } else {
            int max_bits = log - highbit(c - 1);
            int min_state_plus = c << max_bits;
            ct.delta_nb[s] = (max_bits << 16) - min_state_plus;
            ct.delta_fs[s] = total - c;
            total += c;
        }
    }
    ct.log = log;
    return true;
}

struct FseEnc {
    const CTable* ct = nullptr;
    int32_t state = 0;
    void init(const CTable& t, int first_sym) {
        ct = &t;
        int dnb = t.delta_nb[first_sym];
        int nb = (dnb + (1 << 15)) >> 16;
        int st = (nb << 16) - dnb;
        state = t.state_table[(st >> nb) + t.delta_fs[first_sym]];
    }
    inline void encode(int sym, BitWriter& w) {
        int dnb = ct->delta_nb[sym];
        int nb = (state + dnb) >> 16;
        w.put(uint64_t(state) & ((1u << nb) - 1), nb);
        state = ct->state_table[(state >> nb) + ct->delta_fs[sym]];
    }
    inline void flush(BitWriter& w) {
        w.put(uint64_t(state) & ((1u << ct->log) - 1), ct->log);
    }
};

// exact largest-remainder normalization (fse.py _normalize_fallback)
static bool normalize_counts(const uint32_t* hist, int nsym, int log,
                             int64_t total, std::vector<int32_t>& norm) {
    int size = 1 << log;
    norm.assign(nsym, 0);
    int nz = 0;
    for (int s = 0; s < nsym; s++) if (hist[s]) nz++;
    if (nz == 0 || nz > size) return false;
    int64_t sum = 0;
    std::vector<double> frac(nsym, 0.0);
    for (int s = 0; s < nsym; s++) {
        if (!hist[s]) continue;
        double ideal = double(hist[s]) * size / double(total);
        int v = int(ideal);
        if (v < 1) v = 1;
        norm[s] = v;
        frac[s] = ideal - v;
        sum += v;
    }
    int64_t diff = size - sum;
    // distribute by largest remainder / shave smallest
    std::vector<int> order(nsym);
    for (int s = 0; s < nsym; s++) order[s] = s;
    for (int guard = 0; diff != 0 && guard < 64; guard++) {
        if (diff > 0) {
            std::sort(order.begin(), order.end(), [&](int a, int b) {
                return frac[a] > frac[b];
            });
            for (int s : order) {
                if (diff == 0) break;
                if (norm[s] > 0) { norm[s]++; frac[s] -= 1.0; diff--; }
            }
        } else {
            std::sort(order.begin(), order.end(), [&](int a, int b) {
                return frac[a] < frac[b];
            });
            for (int s : order) {
                if (diff == 0) break;
                if (norm[s] > 1) { norm[s]--; frac[s] += 1.0; diff++; }
            }
        }
    }
    return diff == 0;
}

// ncount serialization (fse.py write_ncount)
static void write_ncount(const int32_t* counts, int n, int log,
                         BitWriter& w) {
    w.grow(4 + size_t(n) * 3);
    w.put(log - 5, 4);
    int size = 1 << log;
    int remaining = size + 1;
    int threshold = size;
    int nb_bits = log + 1;
    int i = 0;
    while (remaining > 1 && i < n) {
        int c = counts[i];
        int maxv = 2 * threshold - 1 - remaining;
        int value = c + 1;
        if (value < maxv) w.put(value, nb_bits - 1);
        else w.put(value < threshold ? value : value + maxv, nb_bits);
        remaining -= c < 0 ? -c : c;
        i++;
        if (c == 0) {
            int j = i;
            while (remaining > 1) {
                int run = 0;
                while (j < n && counts[j] == 0 && run < 3) { run++; j++; }
                w.put(run, 2);
                if (run < 3) break;
            }
            i = j;
        }
        while (remaining < threshold) { nb_bits--; threshold >>= 1; }
    }
}

// ------------------------------------------------------------- Huffman ---
// Length-limited code build: plain Huffman then height clamp to 11 bits
// (the huffman.py package-merge twin; the clamp redistribution is the
// classic overflow-repair and is within a fraction of a percent).
static bool huf_build_lengths(const uint32_t* hist, int* len /*256*/,
                              int max_bits) {
    struct Node { uint64_t f; int l, r, sym; };
    std::vector<Node> nodes;
    std::vector<int> heap;  // indices, min-heap by freq
    for (int s = 0; s < 256; s++)
        if (hist[s]) nodes.push_back({hist[s], -1, -1, s});
    int nleaf = int(nodes.size());
    if (nleaf < 2) return false;
    auto cmp = [&](int a, int b) { return nodes[a].f > nodes[b].f; };
    for (int i = 0; i < nleaf; i++) heap.push_back(i);
    std::make_heap(heap.begin(), heap.end(), cmp);
    while (heap.size() > 1) {
        std::pop_heap(heap.begin(), heap.end(), cmp);
        int a = heap.back(); heap.pop_back();
        std::pop_heap(heap.begin(), heap.end(), cmp);
        int b = heap.back(); heap.pop_back();
        nodes.push_back({nodes[a].f + nodes[b].f, a, b, -1});
        heap.push_back(int(nodes.size()) - 1);
        std::push_heap(heap.begin(), heap.end(), cmp);
    }
    // depths via iterative DFS
    std::vector<std::pair<int, int>> st;  // (node, depth)
    st.push_back({heap[0], 0});
    std::fill(len, len + 256, 0);
    std::vector<int> depth_cnt(64, 0);
    while (!st.empty()) {
        auto [ni, d] = st.back(); st.pop_back();
        const Node& nd = nodes[ni];
        if (nd.sym >= 0) {
            int dd = d < 1 ? 1 : d;
            len[nd.sym] = dd;
            depth_cnt[std::min(dd, 63)]++;
        } else {
            st.push_back({nd.l, d + 1});
            st.push_back({nd.r, d + 1});
        }
    }
    // clamp to max_bits: push overflowed leaves up, repair Kraft sum
    bool overflow = false;
    for (int s = 0; s < 256; s++)
        if (len[s] > max_bits) { len[s] = max_bits; overflow = true; }
    if (overflow) {
        // Kraft sum in units of 2^-max_bits
        int64_t k = 0;
        for (int s = 0; s < 256; s++)
            if (len[s]) k += 1LL << (max_bits - len[s]);
        int64_t target = 1LL << max_bits;
        // demote shortest-excess codes until the sum fits
        while (k > target) {
            // find a max_bits-1 or shorter code to lengthen (cheapest:
            // the longest code < max_bits)
            int pick = -1, plen = 0;
            for (int s = 0; s < 256; s++)
                if (len[s] && len[s] < max_bits && len[s] > plen) {
                    plen = len[s]; pick = s;
                }
            if (pick < 0) return false;
            k -= 1LL << (max_bits - len[pick]);
            len[pick]++;
            k += 1LL << (max_bits - len[pick]);
        }
        // promote codes while there is slack (shortens the stream)
        bool changed = true;
        while (k < target && changed) {
            changed = false;
            for (int s = 0; s < 256 && k < target; s++) {
                if (len[s] > 1 &&
                    k + (1LL << (max_bits - len[s])) <= target) {
                    k += 1LL << (max_bits - len[s]);
                    len[s]--;
                    changed = true;
                }
            }
        }
        if (k != target) return false;
    }
    return true;
}

// canonical encode table per huffman.py build_encode_table
static void huf_encode_table(const int* weights, int table_log,
                             uint32_t* code_val, int* code_bits) {
    int pos = 0;
    std::fill(code_bits, code_bits + 256, 0);
    std::fill(code_val, code_val + 256, 0u);
    for (int w = 1; w <= table_log; w++) {
        int span = 1 << (w - 1);
        int nbits = table_log + 1 - w;
        for (int s = 0; s < 256; s++) {
            if (weights[s] == w) {
                code_val[s] = uint32_t(pos >> (table_log - nbits));
                code_bits[s] = nbits;
                pos += span;
            }
        }
    }
}

// --- FSE-weights round-trip verifier ---------------------------------
// The backward-stream end detection can overshoot when the final state
// transitions read 0 bits; mirror huffman.py by decoding the candidate
// payload and rejecting it on any mismatch.
struct FwdReader {
    const uint8_t* p;
    size_t len;
    size_t bit = 0;
    bool fail = false;
    uint32_t read(int nb) {
        uint64_t acc = 0;
        size_t byte0 = bit >> 3;
        for (int k = 0; k < 8; k++)
            acc |= uint64_t(byte0 + k < len ? p[byte0 + k] : 0) << (8 * k);
        uint32_t v = uint32_t((acc >> (bit & 7)) & ((1ULL << nb) - 1));
        bit += nb;
        if (bit > len * 8) fail = true;
        return v;
    }
    size_t bytes_consumed() const { return (bit + 7) >> 3; }
};

struct BackReader {
    const uint8_t* p;
    size_t len;
    long bitpos;
    void init(const uint8_t* s, size_t l) {
        p = s; len = l;
        int last = l ? s[l - 1] : 0;
        if (!last) { bitpos = -1; return; }
        bitpos = long(l - 1) * 8 + highbit(uint32_t(last));
    }
    uint32_t read(int nb) {
        bitpos -= nb;
        if (nb == 0) return 0;
        long b0 = bitpos >> 3;
        uint64_t acc = 0;
        for (int k = 0; k < 8; k++) {
            long idx = b0 + k;
            if (idx >= 0 && size_t(idx) < len)
                acc |= uint64_t(p[idx]) << (8 * k);
        }
        int sh = int(bitpos - (b0 << 3));
        return uint32_t((acc >> sh) & ((1ULL << nb) - 1));
    }
};

static bool read_ncount_c(FwdReader& r, int max_sym, int max_log,
                          std::vector<int32_t>& counts, int& log) {
    log = int(r.read(4)) + 5;
    if (log > max_log || r.fail) return false;
    int size = 1 << log;
    int remaining = size + 1;
    int threshold = size;
    int nb_bits = log + 1;
    counts.clear();
    bool prev_zero = false;
    while (remaining > 1) {
        if (int(counts.size()) > max_sym + 1 || r.fail) return false;
        if (prev_zero) {
            for (;;) {
                int rep = int(r.read(2));
                for (int k = 0; k < rep; k++) counts.push_back(0);
                if (rep < 3) break;
                if (int(counts.size()) > max_sym + 1) return false;
            }
            prev_zero = false;
            continue;
        }
        int maxv = 2 * threshold - 1 - remaining;
        int value = int(r.read(nb_bits - 1));
        if (value >= maxv) {
            value |= int(r.read(1)) << (nb_bits - 1);
            if (value >= threshold) value -= maxv;
        }
        int c = value - 1;
        remaining -= c < 0 ? -c : c;
        counts.push_back(c);
        prev_zero = c == 0;
        while (remaining < threshold) { nb_bits--; threshold >>= 1; }
    }
    return remaining == 1 && !r.fail;
}

static bool fse_weights_roundtrip(const uint8_t* payload, size_t plen,
                                  const int* weights, int nwrite) {
    FwdReader r{payload, plen};
    std::vector<int32_t> counts;
    int log;
    if (!read_ncount_c(r, 255, 6, counts, log)) return false;
    int nsym = int(counts.size());
    int size = 1 << log;
    std::vector<int32_t> spread;
    if (!spread_symbols(counts.data(), nsym, log, spread)) return false;
    std::vector<int32_t> sym(size), nb(size), base(size), nxt(nsym);
    for (int s = 0; s < nsym; s++)
        nxt[s] = counts[s] < 0 ? 1 : counts[s];
    for (int u = 0; u < size; u++) {
        int s = spread[u];
        int ns = nxt[s]++;
        int b = log - highbit(uint32_t(ns));
        sym[u] = s; nb[u] = b; base[u] = (ns << b) - size;
    }
    size_t hdr = r.bytes_consumed();
    if (hdr >= plen) return false;
    BackReader br;
    br.init(payload + hdr, plen - hdr);
    if (br.bitpos < 0) return false;
    int st[2];
    st[0] = int(br.read(log));
    st[1] = int(br.read(log));
    if (br.bitpos < 0) return false;
    std::vector<int> outw;
    for (int i = 0; int(outw.size()) <= 255; i ^= 1) {
        outw.push_back(sym[st[i]]);
        st[i] = base[st[i]] + int(br.read(nb[st[i]]));
        if (br.bitpos < 0) { outw.push_back(sym[st[i ^ 1]]); break; }
    }
    if (int(outw.size()) != nwrite) return false;
    for (int k = 0; k < nwrite; k++)
        if (outw[k] != weights[k]) return false;
    return true;
}

// weights serialization: direct nibbles, or FSE-compressed when needed
static bool huf_write_tree(const int* weights, int nsym_total,
                           std::vector<uint8_t>& out) {
    int last = -1;
    for (int s = 0; s < nsym_total; s++) if (weights[s] > 0) last = s;
    if (last < 0) return false;
    int nwrite = last;  // weights[0..last-1]; last is implied
    if (nwrite < 128) {
        out.push_back(uint8_t(127 + nwrite));
        for (int i = 0; i < nwrite; i += 2) {
            int hi = weights[i] & 0xF;
            int lo = (i + 1 < nwrite) ? (weights[i + 1] & 0xF) : 0;
            out.push_back(uint8_t((hi << 4) | lo));
        }
        return true;
    }
    // FSE-compressed weights (huffman.py _write_weights_fse)
    uint32_t hist[16] = {0};
    int max_w = 0;
    for (int i = 0; i < nwrite; i++) {
        hist[weights[i] & 0xF]++;
        if (weights[i] > max_w) max_w = weights[i];
    }
    int distinct = 0;
    for (int v = 0; v <= max_w; v++) if (hist[v]) distinct++;
    if (distinct < 2) return false;
    int log = 0;
    while ((1 << log) < distinct) log++;
    if (log < 5) log = 5;
    if (log > 6) log = 6;
    std::vector<int32_t> norm;
    if (!normalize_counts(hist, max_w + 1, log, nwrite, norm)) return false;
    CTable ct;
    if (!build_ctable(norm.data(), max_w + 1, log, ct)) return false;
    BitWriter hw;
    write_ncount(norm.data(), max_w + 1, log, hw);
    hw.close_pad();
    BitWriter sw;
    // two interleaved states; decoder order: init1, init2, then one
    // transition per decoded symbol k (k = 0..n-3). Encoder writes
    // trans(n-3)..trans(0), then init2, then init1.
    int n = nwrite;
    sw.grow(8 + size_t(n));
    FseEnc e1, e2;
    // state1 owns even positions; its symbols last-first
    int last_even = (n - 1) & ~1;
    int last_odd = ((n - 2) >= 0) ? (((n - 1) & 1) ? (n - 1) : (n - 2)) : -1;
    e1.init(ct, weights[last_even]);
    bool has2 = last_odd >= 1;
    if (has2) e2.init(ct, weights[last_odd]);
    for (int k = n - 3; k >= 0; k--) {
        if ((k & 1) == 0) e1.encode(weights[k], sw);
        else e2.encode(weights[k], sw);
    }
    if (has2) e2.flush(sw);
    e1.flush(sw);
    sw.close_marker();
    size_t payload = hw.buf.size() + sw.buf.size();
    if (payload >= 128 || payload >= size_t(n)) return false;
    std::vector<uint8_t> pbuf(hw.buf);
    pbuf.insert(pbuf.end(), sw.buf.begin(), sw.buf.end());
    if (!fse_weights_roundtrip(pbuf.data(), pbuf.size(), weights, n))
        return false;
    out.push_back(uint8_t(payload));
    out.insert(out.end(), pbuf.begin(), pbuf.end());
    return true;
}

// one backward-decoded Huffman stream: symbols emitted in reverse
static void huf_stream(const uint8_t* lits, size_t n,
                       const uint32_t* code_val, const int* code_bits,
                       std::vector<uint8_t>& out) {
    BitWriter w;
    w.grow(2 * n + 16);
    for (size_t i = n; i-- > 0;) {
        int s = lits[i];
        w.put(code_val[s], code_bits[s]);
    }
    w.close_marker();
    out.insert(out.end(), w.buf.begin(), w.buf.end());
}

// ------------------------------------------------- sequence code tables ---
static const int kLLbits[36] = {0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
                                1,1,1,1,2,2,3,3,4,6,7,8,9,10,11,12,13,14,15,16};
static const uint32_t kLLbase[36] = {0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15,
                                     16,18,20,22,24,28,32,40,48,64,128,256,512,
                                     1024,2048,4096,8192,16384,32768,65536};
static const int kMLbits[53] = {0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
                                0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,0,
                                1,1,1,1,2,2,3,3,4,4,5,7,8,9,10,11,12,13,14,15,16};
static const uint32_t kMLbase[53] = {3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,
                                     19,20,21,22,23,24,25,26,27,28,29,30,31,32,33,34,
                                     35,37,39,41,43,47,51,59,67,83,99,131,259,515,
                                     1027,2051,4099,8195,16387,32771,65539};
static const int32_t kLLdef[36] = {4,3,2,2,2,2,2,2,2,2,2,2,2,1,1,1,
                                   2,2,2,2,2,2,2,2,2,3,2,1,1,1,1,1,-1,-1,-1,-1};
static const int32_t kMLdef[53] = {1,4,3,2,2,2,2,2,2,1,1,1,1,1,1,1,
                                   1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,1,
                                   1,1,1,1,1,1,1,1,1,1,1,1,1,1,-1,-1,-1,-1,-1,-1,-1};
static const int32_t kOFdef[29] = {1,1,1,1,1,1,2,2,2,1,1,1,1,1,1,1,
                                   1,1,1,1,1,1,1,1,-1,-1,-1,-1,-1};
constexpr int kLLdefLog = 6, kMLdefLog = 6, kOFdefLog = 5;
constexpr int kMaxLLlog = 9, kMaxMLlog = 9, kMaxOFlog = 8;

static inline int ll_code(uint32_t ll) {
    if (ll < 16) return ll;
    int c = 16;
    while (c + 1 < 36 && kLLbase[c + 1] <= ll) c++;
    return c;
}
static inline int ml_code(uint32_t ml) {
    if (ml < 35) return int(ml) - 3;
    int c = 32;
    while (c + 1 < 53 && kMLbase[c + 1] <= ml) c++;
    return c;
}

// --------------------------------------------------------- seq encoding ---
struct Seq { uint32_t ll, ml, ofv; };  // ofv = Offset_Value (rep-resolved)

enum Mode { PREDEF = 0, RLE = 1, FSE_M = 2 };

struct TableChoice {
    Mode mode;
    std::vector<uint8_t> header;
    CTable ct;
};

static void choose_table(const uint8_t* codes, int nseq, int max_sym,
                         int max_log, const int32_t* def_norm, int def_n,
                         int def_log, TableChoice& tc) {
    std::vector<uint32_t> hist(max_sym + 1, 0);
    int last_used = 0;
    for (int i = 0; i < nseq; i++) {
        hist[codes[i]]++;
        if (codes[i] > last_used) last_used = codes[i];
    }
    int used = 0;
    for (int s = 0; s <= max_sym; s++) if (hist[s]) used++;
    if (used == 1) {
        tc.mode = RLE;
        tc.header.assign(1, uint8_t(last_used));
        return;
    }
    bool predef_ok = last_used < def_n;
    if (predef_ok)
        for (int s = 0; s <= last_used; s++)
            if (hist[s] && def_norm[s] == 0) { predef_ok = false; break; }
    if (nseq < 32 && predef_ok) {
        tc.mode = PREDEF;
        build_ctable(def_norm, def_n, def_log, tc.ct);
        return;
    }
    int tl = std::max(5, 32 - __builtin_clz(uint32_t(std::max(nseq - 1, 1))) - 2);
    int min_tl = 0;
    while ((1 << min_tl) < used) min_tl++;
    tl = std::min(std::max(tl, std::max(min_tl, 1)), max_log);
    std::vector<int32_t> norm;
    if (!normalize_counts(hist.data(), last_used + 1, tl, nseq, norm)) {
        tc.mode = PREDEF;
        build_ctable(def_norm, def_n, def_log, tc.ct);
        return;
    }
    BitWriter hw;
    write_ncount(norm.data(), last_used + 1, tl, hw);
    hw.close_pad();
    // entropy comparison vs predefined
    if (predef_ok) {
        double pd_cost = 0, cu_cost = 8.0 * hw.buf.size();
        for (int s = 0; s <= last_used; s++) {
            if (!hist[s]) continue;
            double pdp = (def_norm[s] < 0 ? 0.5 : def_norm[s]) /
                         double(1 << def_log);
            double cup = (norm[s] < 0 ? 0.5 : double(norm[s])) /
                         double(1 << tl);
            pd_cost -= hist[s] * std::log2(pdp);
            cu_cost -= hist[s] * std::log2(std::max(cup, 1e-9));
        }
        // log2 of a probability is negative; -= accumulates positive bits
        if (pd_cost <= cu_cost) {
            tc.mode = PREDEF;
            build_ctable(def_norm, def_n, def_log, tc.ct);
            return;
        }
    }
    tc.mode = FSE_M;
    tc.header = hw.buf;
    build_ctable(norm.data(), last_used + 1, tl, tc.ct);
}

static void encode_sequences(const std::vector<Seq>& seqs,
                             std::vector<uint8_t>& out) {
    int nseq = int(seqs.size());
    if (nseq < 128) out.push_back(uint8_t(nseq));
    else if (nseq < 0x7F00) {
        out.push_back(uint8_t(128 + (nseq >> 8)));
        out.push_back(uint8_t(nseq & 0xFF));
    } else {
        out.push_back(255);
        out.push_back(uint8_t((nseq - 0x7F00) & 0xFF));
        out.push_back(uint8_t(((nseq - 0x7F00) >> 8) & 0xFF));
    }
    if (!nseq) return;
    std::vector<uint8_t> llc(nseq), ofc(nseq), mlc(nseq);
    for (int i = 0; i < nseq; i++) {
        llc[i] = uint8_t(ll_code(seqs[i].ll));
        mlc[i] = uint8_t(ml_code(seqs[i].ml));
        ofc[i] = uint8_t(highbit(seqs[i].ofv));
    }
    TableChoice tll, tof, tml;
    choose_table(llc.data(), nseq, 35, kMaxLLlog, kLLdef, 36, kLLdefLog, tll);
    choose_table(ofc.data(), nseq, 31, kMaxOFlog, kOFdef, 29, kOFdefLog, tof);
    choose_table(mlc.data(), nseq, 52, kMaxMLlog, kMLdef, 53, kMLdefLog, tml);
    out.push_back(uint8_t((tll.mode << 6) | (tof.mode << 4) | (tml.mode << 2)));
    out.insert(out.end(), tll.header.begin(), tll.header.end());
    out.insert(out.end(), tof.header.begin(), tof.header.end());
    out.insert(out.end(), tml.header.begin(), tml.header.end());

    BitWriter w;
    w.grow(16 * size_t(nseq) + 64);
    FseEnc ell, eof_, eml;
    bool fll = tll.mode != RLE, fof = tof.mode != RLE, fml = tml.mode != RLE;
    int last = nseq - 1;
    if (fml) eml.init(tml.ct, mlc[last]);
    if (fof) eof_.init(tof.ct, ofc[last]);
    if (fll) ell.init(tll.ct, llc[last]);
    auto put_extras = [&](int i) {
        w.put(seqs[i].ll - kLLbase[llc[i]], kLLbits[llc[i]]);
        w.put(seqs[i].ml - kMLbase[mlc[i]], kMLbits[mlc[i]]);
        w.put(seqs[i].ofv - (1u << ofc[i]), ofc[i]);
    };
    put_extras(last);
    for (int i = nseq - 2; i >= 0; i--) {
        if (fof) eof_.encode(ofc[i], w);
        if (fml) eml.encode(mlc[i], w);
        if (fll) ell.encode(llc[i], w);
        put_extras(i);
    }
    if (fml) eml.flush(w);
    if (fof) eof_.flush(w);
    if (fll) ell.flush(w);
    w.close_marker();
    out.insert(out.end(), w.buf.begin(), w.buf.end());
}

// -------------------------------------------------------- literals enc ---
static void literals_raw(const uint8_t* lits, size_t n,
                         std::vector<uint8_t>& out) {
    if (n < 32) out.push_back(uint8_t((n << 3) | 0));
    else if (n < 4096) {
        out.push_back(uint8_t(((n & 0xF) << 4) | (1 << 2) | 0));
        out.push_back(uint8_t((n >> 4) & 0xFF));
    } else {
        out.push_back(uint8_t(((n & 0xF) << 4) | (3 << 2) | 0));
        out.push_back(uint8_t((n >> 4) & 0xFF));
        out.push_back(uint8_t((n >> 12) & 0xFF));
    }
    out.insert(out.end(), lits, lits + n);
}

static void literals_rle(uint8_t byte, size_t n, std::vector<uint8_t>& out) {
    if (n < 32) out.push_back(uint8_t((n << 3) | 1));
    else if (n < 4096) {
        out.push_back(uint8_t(((n & 0xF) << 4) | (1 << 2) | 1));
        out.push_back(uint8_t((n >> 4) & 0xFF));
    } else {
        out.push_back(uint8_t(((n & 0xF) << 4) | (3 << 2) | 1));
        out.push_back(uint8_t((n >> 4) & 0xFF));
        out.push_back(uint8_t((n >> 12) & 0xFF));
    }
    out.push_back(byte);
}

static bool literals_comp_header(size_t regen, size_t csize, bool four,
                                 std::vector<uint8_t>& out) {
    if (!four) {
        if (regen > 1023 || csize > 1023) return false;
        uint32_t h = 2 | (0u << 2) | (uint32_t(regen) << 4) |
                     (uint32_t(csize) << 14);
        out.push_back(h & 0xFF); out.push_back((h >> 8) & 0xFF);
        out.push_back((h >> 16) & 0xFF);
        return true;
    }
    if (regen <= 1023 && csize <= 1023) {
        uint32_t h = 2 | (1u << 2) | (uint32_t(regen) << 4) |
                     (uint32_t(csize) << 14);
        out.push_back(h & 0xFF); out.push_back((h >> 8) & 0xFF);
        out.push_back((h >> 16) & 0xFF);
        return true;
    }
    if (regen <= 0x3FFF && csize <= 0x3FFF) {
        uint32_t h = 2 | (2u << 2) | (uint32_t(regen) << 4) |
                     (uint32_t(csize) << 18);
        for (int b = 0; b < 4; b++) out.push_back((h >> (8 * b)) & 0xFF);
        return true;
    }
    if (regen <= 0x3FFFF && csize <= 0x3FFFF) {
        uint64_t h = 2 | (3u << 2) | (uint64_t(regen) << 4) |
                     (uint64_t(csize) << 22);
        for (int b = 0; b < 5; b++) out.push_back((h >> (8 * b)) & 0xFF);
        return true;
    }
    return false;
}

static void encode_literals(const uint8_t* lits, size_t n,
                            std::vector<uint8_t>& out) {
    if (n == 0) { literals_raw(lits, n, out); return; }
    bool all_same = true;
    for (size_t i = 1; i < n; i++)
        if (lits[i] != lits[0]) { all_same = false; break; }
    if (all_same) { literals_rle(lits[0], n, out); return; }
    if (n < 32) { literals_raw(lits, n, out); return; }
    uint32_t hist[256] = {0};
    for (size_t i = 0; i < n; i++) hist[lits[i]]++;
    int lens[256];
    if (!huf_build_lengths(hist, lens, 11)) { literals_raw(lits, n, out); return; }
    int max_len = 0;
    for (int s = 0; s < 256; s++) max_len = std::max(max_len, lens[s]);
    int weights[256];
    int nsym = 0;
    for (int s = 0; s < 256; s++) {
        weights[s] = lens[s] ? (max_len + 1 - lens[s]) : 0;
        if (lens[s]) nsym = s + 1;
    }
    std::vector<uint8_t> tree;
    if (!huf_write_tree(weights, nsym, tree)) { literals_raw(lits, n, out); return; }
    uint32_t code_val[256]; int code_bits[256];
    huf_encode_table(weights, max_len, code_val, code_bits);
    bool four = n >= 256;
    std::vector<uint8_t> payload(tree);
    if (four) {
        size_t n123 = (n + 3) / 4;
        std::vector<uint8_t> s1, s2, s3, s4;
        huf_stream(lits, n123, code_val, code_bits, s1);
        huf_stream(lits + n123, n123, code_val, code_bits, s2);
        huf_stream(lits + 2 * n123, n123, code_val, code_bits, s3);
        huf_stream(lits + 3 * n123, n - 3 * n123, code_val, code_bits, s4);
        for (auto* s : {&s1, &s2, &s3}) {
            payload.push_back(uint8_t(s->size() & 0xFF));
            payload.push_back(uint8_t((s->size() >> 8) & 0xFF));
        }
        payload.insert(payload.end(), s1.begin(), s1.end());
        payload.insert(payload.end(), s2.begin(), s2.end());
        payload.insert(payload.end(), s3.begin(), s3.end());
        payload.insert(payload.end(), s4.begin(), s4.end());
    } else {
        huf_stream(lits, n, code_val, code_bits, payload);
    }
    std::vector<uint8_t> hdr;
    if (!literals_comp_header(n, payload.size(), four, hdr) ||
        hdr.size() + payload.size() >= n + (n < 32 ? 1 : n < 4096 ? 2 : 3)) {
        literals_raw(lits, n, out);
        return;
    }
    out.insert(out.end(), hdr.begin(), hdr.end());
    out.insert(out.end(), payload.begin(), payload.end());
}

// --------------------------------------------------------- match finder ---
struct Rep { uint32_t r0 = 1, r1 = 4, r2 = 8; };

struct Params {
    int hash_log;
    int depth;       // chain walk budget
    int lazy;        // 0/1/2
    int accel_shift; // literal-run skip acceleration (zstd_fast style)
    int ins_step;    // match-interior indexing stride threshold
    uint32_t window; // max offset
};

static Params level_params(int level, size_t n) {
    Params p;
    if (level <= 1)       { p.hash_log = 17; p.depth = 4;   p.lazy = 0;
                            p.accel_shift = 7;  p.ins_step = 32; }
    else if (level <= 3)  { p.hash_log = 16; p.depth = 8;   p.lazy = 0;
                            p.accel_shift = 8;  p.ins_step = 64; }
    else if (level <= 6)  { p.hash_log = 18; p.depth = 32;  p.lazy = 1;
                            p.accel_shift = 10; p.ins_step = 256; }
    else if (level <= 11) { p.hash_log = 19; p.depth = 64;  p.lazy = 1;
                            p.accel_shift = 12; p.ins_step = 1024; }
    else if (level <= 16) { p.hash_log = 20; p.depth = 64;  p.lazy = 2;
                            p.accel_shift = 14; p.ins_step = 4096; }
    else if (level <= 19) { p.hash_log = 22; p.depth = 48;  p.lazy = 2;
                            p.accel_shift = 30; p.ins_step = 4096; }
    else                  { p.hash_log = 22; p.depth = 512; p.lazy = 2;
                            p.accel_shift = 30; p.ins_step = 4096; }
    uint64_t w = 1ULL << (level <= 1 ? 21 : level <= 11 ? 23 : 27);
    p.window = uint32_t(std::min<uint64_t>(w, n ? n : 1));
    return p;
}

static inline uint32_t load32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}
static inline uint64_t load64(const uint8_t* p) {
    uint64_t v; memcpy(&v, p, 8); return v;
}

static inline size_t match_len(const uint8_t* a, const uint8_t* b,
                               const uint8_t* end) {
    const uint8_t* a0 = a;
    while (a + 8 <= end) {
        uint64_t x = load64(a) ^ load64(b);
        if (x) return size_t(a - a0) + (__builtin_ctzll(x) >> 3);
        a += 8; b += 8;
    }
    while (a < end && *a == *b) { a++; b++; }
    return size_t(a - a0);
}

// candidate match for the optimal parse (ascending length)
struct MCand { uint32_t len, off; int repidx; };  // repidx 1..3, 0 = offset

struct Matcher {
    static constexpr bool kBT = false;
    std::vector<int32_t> head;
    std::vector<int32_t> prev;
    uint32_t hl;
    const uint8_t* base;
    size_t n;
    void init(const uint8_t* src, size_t len, int hash_log) {
        base = src; n = len; hl = hash_log;
        head.assign(size_t(1) << hash_log, -1);
        prev.assign(len, -1);
    }
    inline uint32_t hash_at(size_t i) const {
        return (load32(base + i) * 2654435761u) >> (32 - hl);
    }
    inline void insert(size_t i) {
        uint32_t h = hash_at(i);
        prev[i] = head[h];
        head[h] = int32_t(i);
    }
    // search prior positions for ascending-length candidates, optionally
    // inserting i; returns count appended to out (strictly > min_len).
    int insert_search(size_t i, size_t end_pos, int depth, uint32_t window,
                      MCand* out, int cap, uint32_t min_len, bool do_insert) {
        int nc = 0;
        if (i + 8 <= end_pos) {
            uint32_t v = load32(base + i);
            int32_t c = head[hash_at(i)];
            size_t min_pos = i > window ? i - window : 0;
            uint32_t found = min_len;
            const uint8_t* end = base + end_pos;
            for (int d = 0; d < depth && c >= 0 && size_t(c) >= min_pos;
                 d++, c = prev[c]) {
                if (load32(base + c) != v) continue;
                if (i + found < end_pos && base[c + found] != base[i + found])
                    continue;
                uint32_t len = uint32_t(
                    4 + match_len(base + i + 4, base + c + 4, end));
                if (len > found && nc < cap) {
                    out[nc++] = {len, uint32_t(i - c), 0};
                    found = len;
                }
            }
        }
        if (do_insert && i + 4 <= n) insert(i);
        return nc;
    }
    // best chain match at i (capped at `end_pos`); returns length, sets off
    inline size_t best(size_t i, size_t end_pos, int depth, uint32_t window,
                       uint32_t& off) const {
        if (i + 8 > end_pos) return 0;
        const uint8_t* end = base + end_pos;
        uint32_t v = load32(base + i);
        int32_t c = head[hash_at(i)];
        size_t best_len = 0;
        long best_score = -1;
        size_t min_pos = i > window ? i - window : 0;
        for (int d = 0; d < depth && c >= 0 && size_t(c) >= min_pos;
             d++, c = prev[c]) {
            if (load32(base + c) != v) continue;
            size_t len = 4 + match_len(base + i + 4, base + c + 4, end);
            long score = long(8 * len) - highbit(uint32_t(i - c));
            if (score > best_score) {
                best_score = score;
                best_len = len;
                off = uint32_t(i - c);
            }
        }
        return best_len >= kMinChainMatch ? best_len : 0;
    }
};

// Binary-tree match finder for the optimal-parse tier.  Each hash bucket
// holds a binary tree of positions ordered by suffix; inserting a new
// position re-hangs the walked nodes beneath it, so a single walk both
// inserts and collects the nearest-offset candidate per strictly longer
// length — exactly the ascending candidate list the DP relaxes.  Role
// analog of the reference's BT finders (C/zstd/zstd_opt.c
// ZSTD_insertBtAndGetAllMatches, C/LzFind.c GetMatchesSpec1), re-derived
// from the classic suffix-ordered-tree scheme rather than translated.
struct BTMatcher {
    static constexpr bool kBT = true;
    static constexpr int kH3Log = 17;
    static constexpr uint32_t kH3MaxOff = 1u << 17;
    std::vector<int32_t> head;  // hash -> tree root (most recent pos)
    std::vector<int32_t> lr;    // lr[2i] = left child, lr[2i+1] = right
    std::vector<int32_t> head3; // 3-byte hash -> most recent pos
    uint32_t hl;
    const uint8_t* base;
    size_t n;

    void init(const uint8_t* src, size_t len, int hash_log) {
        base = src; n = len; hl = hash_log;
        head.assign(size_t(1) << hl, -1);
        lr.assign(2 * len + 2, -1);
        head3.assign(size_t(1) << kH3Log, -1);
    }
    inline uint32_t hash_at(size_t i) const {
        return (load32(base + i) * 2654435761u) >> (32 - hl);
    }
    inline uint32_t hash3_at(size_t i) const {
        return ((load32(base + i) & 0xFFFFFFu) * 2654435761u)
               >> (32 - kH3Log);
    }
    // Length-3 stride matches (structured records, e.g. fixed-size binary
    // rows) are invisible to a 4-byte-min finder but carry entire blocks
    // once rep-chained; the reference keeps a dedicated 3-byte hash for
    // exactly this (zstd_opt.c ZSTD_insertAndFindFirstIndexHash3).  One
    // most-recent slot, small offsets only (long-offset 3-byte matches
    // never price in).
    int probe3(size_t i, size_t end_pos, MCand* out, uint32_t min_len,
               bool do_insert) {
        int nc = 0;
        if (i + 3 <= end_pos && i + 4 <= n) {
            int32_t c = head3[hash3_at(i)];
            if (c >= 0 && size_t(c) < i && i - size_t(c) <= kH3MaxOff &&
                out != nullptr) {
                const uint8_t* a = base + i;
                const uint8_t* b = base + c;
                if (a[0] == b[0] && a[1] == b[1] && a[2] == b[2]) {
                    uint32_t len = uint32_t(
                        3 + match_len(a + 3, b + 3, base + end_pos));
                    if (len > min_len && len >= 3)
                        out[nc++] = {len, uint32_t(i - size_t(c)), 0};
                }
            }
            if (do_insert) head3[hash3_at(i)] = int32_t(i);
        }
        return nc;
    }
    // insert-only walk (match interiors, skipped stretches)
    inline void insert(size_t i) {
        insert_search(i, n, 256, 0xFFFFFFFFu, nullptr, 0, 0xFFFFFFFFu, true);
    }
    int insert_search(size_t i, size_t end_pos, int depth, uint32_t window,
                      MCand* out, int cap, uint32_t min_len, bool do_insert) {
        if (i + 4 > n) return 0;
        if (!do_insert)
            return search_ro(i, end_pos, depth, window, out, cap, min_len);
        int nc = probe3(i, end_pos, out, min_len, true);
        if (nc) min_len = out[0].len;
        uint32_t h = hash_at(i);
        int32_t cur = head[h];
        head[h] = int32_t(i);
        int32_t* pr = &lr[2 * i + 1];  // subtree of suffixes > suffix(i)
        int32_t* pl = &lr[2 * i];      // subtree of suffixes < suffix(i)
        size_t len_l = 0, len_r = 0;   // proven common prefixes at bounds
        size_t min_pos = i > window ? i - window : 0;
        // Comparison horizon: no recordable match exceeds the 128K block,
        // so compares past i+128K only serve tree ordering — and letting
        // them run to the input end is quadratic on data with multi-MB
        // exact repeats (measured 273K compare-bytes/position on such a
        // corpus).  Cap the compare and treat a tie at the cap as a full
        // extension, dropping the walked node like the reference's BT
        // does at its block horizon (zstd_compress.c ZSTD_insertBt1
        // breaks at iend); the mild mis-ordering beyond the cap only
        // weakens far matches that could not be emitted anyway.
        const size_t cmp_cap = std::min(n, i + (128u << 10) + 64);
        const uint8_t* lim = base + cmp_cap;
        size_t max_rec = end_pos - i;
        uint32_t best = min_len;
        for (;;) {
            if (depth-- == 0 || cur < 0 || size_t(cur) < min_pos) {
                *pl = -1;
                *pr = -1;
                break;
            }
            size_t len = std::min(len_l, len_r);
            len += match_len(base + i + len, base + cur + len, lim);
            size_t rec = len < max_rec ? len : max_rec;
            if (out && rec > best && rec >= 4) {
                if (nc < cap) out[nc++] = {uint32_t(rec),
                                           uint32_t(i - size_t(cur)), 0};
                best = uint32_t(rec);
            }
            if (i + len >= cmp_cap) {
                // full extension to the horizon: replace cur with its
                // children and stop (no byte left to distinguish on)
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
    // read-only descent: search without re-hanging (query positions the
    // caller does not want indexed, e.g. lazy lookahead probes)
    int search_ro(size_t i, size_t end_pos, int depth, uint32_t window,
                  MCand* out, int cap, uint32_t min_len) {
        int nc = probe3(i, end_pos, out, min_len, false);
        if (nc) min_len = out[0].len;
        int32_t cur = head[hash_at(i)];
        size_t len_l = 0, len_r = 0;
        size_t min_pos = i > window ? i - window : 0;
        const size_t cmp_cap = std::min(n, i + (128u << 10) + 64);
        const uint8_t* lim = base + cmp_cap;
        size_t max_rec = end_pos - i;
        uint32_t best_len = min_len;
        while (depth-- > 0 && cur >= 0 && size_t(cur) >= min_pos) {
            size_t len = std::min(len_l, len_r);
            len += match_len(base + i + len, base + cur + len, lim);
            size_t rec = len < max_rec ? len : max_rec;
            // the tree may hold positions AT or AFTER i (inserted by an
            // earlier parse pass over this block): descend through them
            // but never record them as candidates
            if (out && size_t(cur) < i && rec > best_len && rec >= 4) {
                if (nc < cap) out[nc++] = {uint32_t(rec),
                                           uint32_t(i - size_t(cur)), 0};
                best_len = uint32_t(rec);
            }
            if (i + len >= cmp_cap) break;
            if (base[cur + len] < base[i + len]) {
                cur = lr[2 * cur + 1];
                len_l = len;
            } else {
                cur = lr[2 * cur];
                len_r = len;
            }
        }
        return nc;
    }
    // greedy-path shim (only tiny tail blocks reach it at opt levels):
    // longest candidate, nearest offset
    size_t best(size_t i, size_t end_pos, int depth, uint32_t window,
                uint32_t& off) {
        if (i + 8 > end_pos || i + 4 > n) return 0;
        MCand c[32];
        int nc = search_ro(i, end_pos, depth, window, c, 32, 3);
        if (!nc) return 0;
        off = c[nc - 1].off;
        return c[nc - 1].len >= kMinChainMatch ? c[nc - 1].len : 0;
    }
};

// offset -> Offset_Value with repeat codes (compressor.py
// _offset_values_with_reps; RFC 3.1.1.3.2.1.1 update rules)
static inline uint32_t ofv_of(uint32_t off, uint32_t ll, Rep& rep) {
    if (ll != 0) {
        if (off == rep.r0) return 1;
        if (off == rep.r1) { rep.r1 = rep.r0; rep.r0 = off; return 2; }
        if (off == rep.r2) {
            rep.r2 = rep.r1; rep.r1 = rep.r0; rep.r0 = off; return 3;
        }
    } else {
        if (off == rep.r1) { rep.r1 = rep.r0; rep.r0 = off; return 1; }
        if (off == rep.r2) {
            rep.r2 = rep.r1; rep.r1 = rep.r0; rep.r0 = off; return 2;
        }
        if (off == rep.r0 - 1) {
            rep.r2 = rep.r1; rep.r1 = rep.r0; rep.r0 = off; return 3;
        }
    }
    rep.r2 = rep.r1; rep.r1 = rep.r0; rep.r0 = off;
    return off + 3;
}

// ----------------------------------------------------- optimal parse ---
// Forward shortest-path DP over bit prices (the role of the reference's
// btopt/btultra2, C/zstd/zstd_opt.c, re-derived): per position the best
// predecessor among {literal step, rep0/1/2 probes, hash-chain matches},
// with per-cell repeat-offset state and literal-run tracking. Prices are
// adaptive: each block reuses the previous block's code statistics
// (ZSTD_rescaleFreqs analog at block granularity).
struct Costs {
    int32_t lit[256];   // bits << 5
    int32_t llp[36], mlp[53], ofp[32];
    void defaults(const uint8_t* blk, size_t blen) {
        // flat ~6-bit literal seed (the reference's zop_predef posture,
        // zstd_opt.c ZSTD_rescaleFreqs): a data-adaptive literal price
        // here lands the parse in a literal-favoring equilibrium where
        // 3-byte rep matches never become cheap; the per-block second
        // pass then re-prices from the match-seeded statistics.
        (void)blk;
        (void)blen;
        for (int s = 0; s < 256; s++) lit[s] = 6 * 32;
        for (int c = 0; c < 36; c++) llp[c] = (5 + kLLbits[c]) << 5;
        for (int c = 0; c < 53; c++) mlp[c] = (5 + kMLbits[c]) << 5;
        for (int c = 0; c < 32; c++) ofp[c] = (5 + c) << 5;
    }
    // estimated encoded bits of a parse under THIS table (self-consistent
    // when the table came from from_stats of the same parse) — used to
    // pick the best of the per-block re-pricing passes
    int64_t parse_bits(const std::vector<Seq>& seqs,
                       const std::vector<uint8_t>& ls) const {
        int64_t b = 0;
        for (uint8_t v : ls) b += lit[v];
        for (const Seq& q : seqs)
            b += llp[ll_code(q.ll)] + mlp[ml_code(q.ml)] +
                 ofp[highbit(q.ofv)];
        return b;
    }
    void from_stats(const std::vector<Seq>& seqs,
                    const std::vector<uint8_t>& lits) {
        if (!lits.empty()) {
            uint32_t h[256] = {0};
            for (uint8_t v : lits) h[v]++;
            for (int s = 0; s < 256; s++) {
                double p = h[s] ? double(h[s]) / lits.size()
                                : 0.5 / (lits.size() + 1);
                lit[s] = int32_t(
                    std::min(14.0, std::max(1.0, -std::log2(p))) * 32);
            }
        }
        if (seqs.empty()) return;
        uint32_t hll[36] = {0}, hml[53] = {0}, hof[32] = {0};
        for (const Seq& q : seqs) {
            hll[ll_code(q.ll)]++;
            hml[ml_code(q.ml)]++;
            hof[highbit(q.ofv)]++;
        }
        double tot = double(seqs.size());
        for (int c = 0; c < 36; c++)
            llp[c] = int32_t((std::min(12.0, hll[c] ?
                -std::log2(hll[c] / tot) : 9.0) + kLLbits[c]) * 32);
        for (int c = 0; c < 53; c++)
            mlp[c] = int32_t((std::min(12.0, hml[c] ?
                -std::log2(hml[c] / tot) : 9.0) + kMLbits[c]) * 32);
        for (int c = 0; c < 32; c++)
            ofp[c] = int32_t((std::min(12.0, hof[c] ?
                -std::log2(hof[c] / tot) : 9.0) + c) * 32);
    }
};

struct Cell {
    int64_t price;
    int32_t mlen;    // 0 = literal step reached this cell
    uint32_t off;    // actual offset when mlen > 0
    int32_t seq_ll;  // literal run folded into the sequence (mlen > 0)
    int32_t litrun;  // literals accumulated since last match end
    Rep rep;         // repeat state after this cell
};

template <class MF>
static void parse_block_optimal(const uint8_t* src, size_t n,
                                size_t bs, size_t be, MF& M,
                                size_t& next_ins, size_t ins_max,
                                const Params& P, Rep& rep, Costs& costs,
                                std::vector<Seq>& seqs,
                                std::vector<uint8_t>& lits,
                                bool try_defaults) {
    size_t blen = be - bs;
    // catch up indexing for positions skipped before this block
    for (size_t p = next_ins; p < std::min(bs, ins_max); p++) M.insert(p);
    next_ins = std::max(next_ins, bs);
    static thread_local std::vector<Cell> cells;
    constexpr int kRelaxBudget = 24;
    // Two passes per block: the first parses with carried-over (or
    // default) prices and refreshes the statistics from its own result;
    // the second re-parses with prices that match THIS block's data —
    // the role of the reference's btultra2 first-block double pass
    // (zstd_opt.c ZSTD_compressBlock_btultra2), applied every block.
    const Rep rep_in = rep;
    // per-position matcher candidates, found once in pass 0 and replayed
    // in pass 1 (the tree then contains this block's own positions, so a
    // re-query would surface self/future matches)
    static thread_local std::vector<MCand> cand_pool;
    static thread_local std::vector<uint32_t> cand_at;  // start index per j
    cand_pool.clear();
    cand_at.assign(blen + 1, 0);
    static thread_local std::vector<Seq> best_seqs;
    static thread_local std::vector<uint8_t> best_lits;
    int64_t best_bits = INT64_MAX;
    Rep best_rep = rep_in;
    // Dominant-stride detection: structured data (fixed-size records)
    // compresses via short matches at the record stride, but rep-probe
    // candidates exist only while the DP path holds the stride in its
    // repeat set — one epsilon tie-break loses it and every downstream
    // probe misses.  Detect the block's top repeat distances up front and
    // probe them at EVERY position as regular-offset candidates, making
    // chain continuation path-independent (role of the reference's hash3
    // + adaptive offset statistics, achieved statically per block).
    uint32_t strides[3] = {0, 0, 0};
    {
        static thread_local std::vector<int32_t> last3;
        last3.assign(1u << 15, -1);
        static thread_local std::vector<uint32_t> dist_count;
        dist_count.assign(4096, 0);
        for (size_t p = bs; p + 4 <= be; p++) {
            uint32_t h = ((load32(src + p) & 0xFFFFFFu) * 2654435761u)
                         >> (32 - 15);
            int32_t prev = last3[h];
            last3[h] = int32_t(p);
            if (prev < 0) continue;
            size_t d = p - size_t(prev);
            if (d < 4096 && src[prev] == src[p] &&
                src[prev + 1] == src[p + 1] && src[prev + 2] == src[p + 2])
                dist_count[d]++;
        }
        uint32_t cmin = uint32_t(blen / 64) + 1;
        for (int k = 0; k < 3; k++) {
            uint32_t bi = 0, bc = cmin;
            for (uint32_t d = 2; d < 4096; d++) {
                bool taken = false;
                for (int t = 0; t < k; t++) taken |= (strides[t] == d);
                if (!taken && dist_count[d] > bc) { bc = dist_count[d]; bi = d; }
            }
            strides[k] = bi;
            if (!bi) break;
        }
    }
    // Pass plan: pass 0 parses with the carried (or default) prices and
    // fills the candidate pool; every later pass replays the pool under a
    // different price seed.  Seeds: kDefaults re-parses from flat predef
    // prices (after a content cut, carried stats can trap a changed block
    // in the old content's equilibrium — yet dropping warm stats
    // unconditionally loses where they help, so BOTH are scored);
    // kCoverage prices matches near-free to produce a maximal-coverage
    // parse whose statistics then seed a kRefine pass (appended when the
    // best parse so far covers little of the block — the reference
    // escapes this trap with on-line price updates inside zstd_opt.c,
    // here realised as an extra seeded pass); kRefine re-parses with
    // prices fit to the best parse so far.  Best parse by self-consistent
    // estimated size wins (the iteration is not monotone: rep-chain
    // candidates are path-dependent, so a later pass can collapse).
    // kRefineLast re-parses with costs as fitted to the PREVIOUS pass's
    // parse (used after kCoverage: refining from the coverage parse's
    // chain-heavy statistics finds parses neither seed finds alone)
    enum Seed : uint8_t { kCarried, kDefaults, kCoverage, kRefine,
                          kRefineLast };
    uint8_t plan[6] = {kCarried, kRefine, 0, 0, 0, 0};
    int np = 2;
    if (try_defaults) { plan[1] = kDefaults; plan[2] = kRefine; np = 3; }
    bool coverage_tried = false;
    int64_t best_matched = 0;  // matched bytes of the best parse
    for (int pass = 0; pass < np; pass++) {
    const uint8_t seed = plan[pass];
    if (seed == kDefaults) {
        costs.defaults(src + bs, blen);
    } else if (seed == kRefine) {
        costs.from_stats(best_seqs, best_lits);
    } else if (seed == kRefineLast) {
        // costs already hold from_stats of the previous pass's parse
    } else if (seed == kCoverage) {
        for (int s = 0; s < 256; s++) costs.lit[s] = 9 * 32;
        for (int c = 0; c < 36; c++) costs.llp[c] = 0;
        for (int c = 0; c < 53; c++) costs.mlp[c] = 32;
        for (int c = 0; c < 32; c++) costs.ofp[c] = 32;
    }
    cells.assign(blen + 1, Cell{INT64_MAX, 0, 0, 0, 0, Rep{}});
    cells[0] = Cell{0, 0, 0, 0, 0, rep_in};
    // Long-match fast path: inside a found match of >= kLongImmediate
    // bytes, neither searching nor indexing the interior is useful (any
    // future position can match the earlier copy instead), and on
    // dup-heavy data per-position searches there are quadratic — the
    // role of the reference's sufficient_len immediate-encode + skip
    // (zstd_opt.c) and ZSTD_insertBt1's forward skip return.
    constexpr uint32_t kLongImmediate = 128;
    size_t gather_skip = 0;  // absolute pos: skip gathering below this
    for (size_t j = 0; j < blen; j++) {
        const Cell& cur = cells[j];
        size_t pos = bs + j;
        // literal step
        {
            int64_t cand = cur.price + costs.lit[src[pos]];
            Cell& nx = cells[j + 1];
            if (cand < nx.price) {
                nx.price = cand; nx.mlen = 0; nx.off = 0; nx.seq_ll = 0;
                nx.litrun = cur.litrun + 1; nx.rep = cur.rep;
            }
        }
        if (pos < gather_skip) {  // every pass: probes there are quadratic
            if (pass == 0) cand_at[j + 1] = uint32_t(cand_pool.size());
            continue;
        }
        // gather candidates (ascending length)
        MCand cands[32];
        int nc = 0;
        bool has_lit = cur.litrun > 0;
        uint32_t probes[3] = {
            has_lit ? cur.rep.r0 : cur.rep.r1,
            has_lit ? cur.rep.r1 : cur.rep.r2,
            has_lit ? cur.rep.r2 : cur.rep.r0 - 1,
        };
        uint32_t best_rep_len = 0;
        for (int k = 0; k < 3; k++) {
            uint32_t o = probes[k];
            if (o == 0 || pos < o || pos + 3 > be) continue;
            const uint8_t* a = src + pos;
            const uint8_t* bb = a - o;
            if (a[0] != bb[0] || a[1] != bb[1] || a[2] != bb[2]) continue;
            uint32_t len =
                uint32_t(3 + match_len(a + 3, bb + 3, src + be));
            if (nc < 3) cands[nc++] = {len, o, k + 1};
            best_rep_len = std::max(best_rep_len, len);
        }
        // static stride probes (dominant record distances, see above);
        // skip ones already covered by a rep probe this position
        for (int k = 0; k < 3 && strides[k]; k++) {
            uint32_t s = strides[k];
            if (s == probes[0] || s == probes[1] || s == probes[2]) continue;
            if (pos < s || pos + 3 > be) continue;
            const uint8_t* a = src + pos;
            const uint8_t* bb = a - s;
            if (a[0] != bb[0] || a[1] != bb[1] || a[2] != bb[2]) continue;
            uint32_t len =
                uint32_t(3 + match_len(a + 3, bb + 3, src + be));
            if (nc < 6) cands[nc++] = {len, s, 0};
        }
        if (pass == 0) {
            bool fresh = pos >= next_ins && pos < ins_max;
            int nm = M.insert_search(pos, be, P.depth, P.window, cands + nc,
                                     28, 2, fresh);
            if (fresh) next_ins = pos + 1;
            for (int k = 0; k < nm; k++) cand_pool.push_back(cands[nc + k]);
            cand_at[j + 1] = uint32_t(cand_pool.size());
            nc += nm;
        } else {
            for (uint32_t k = cand_at[j]; k < cand_at[j + 1] && nc < 31; k++)
                cands[nc++] = cand_pool[k];
        }
        if (!nc) continue;
        std::sort(cands, cands + nc, [](const MCand& a, const MCand& b) {
            return a.len < b.len;
        });
        int32_t ll_cost = costs.llp[ll_code(uint32_t(cur.litrun))];
        int budget = kRelaxBudget;
        uint32_t lo = 3;
        for (int k = 0; k < nc; k++) {
            const MCand& cd = cands[k];
            // price the offset code for this candidate
            uint32_t ofv = cd.repidx ? uint32_t(cd.repidx) : cd.off + 3;
            int32_t of_cost = costs.ofp[highbit(ofv)];
            // format minimum is 3 for any offset (RFC 8878 §3.1.1.3.2.1);
            // pricing, not a gate, decides whether a 3-byte match wins
            uint32_t lmin = 3;
            uint32_t start = std::max(lo, lmin);
            // always relax the full length; fill downward within budget
            for (uint32_t l = cd.len;
                 l >= start && (budget > 0 || l == cd.len); l--) {
                budget--;
                int64_t cand_price = cur.price + ll_cost + of_cost +
                                     costs.mlp[ml_code(l)];
                Cell& nx = cells[j + l];
                if (cand_price < nx.price) {
                    nx.price = cand_price;
                    nx.mlen = int32_t(l);
                    nx.off = cd.off;
                    nx.seq_ll = cur.litrun;
                    nx.litrun = 0;
                    Rep r = cur.rep;
                    (void)ofv_of(cd.off, uint32_t(cur.litrun), r);
                    nx.rep = r;
                }
            }
            lo = std::max(lo, cd.len + 1);
        }
        if (nc) {
            uint32_t maxlen = 0;
            for (int k = 0; k < nc; k++)
                maxlen = std::max(maxlen, cands[k].len);
            if (maxlen >= kLongImmediate) {
                gather_skip = pos + maxlen;
                // leave a re-indexed tail so the next region still links
                // (8 positions, the reference's ZSTD_insertBt1 margin)
                size_t ins_to = gather_skip > 8 ? gather_skip - 8 : pos;
                next_ins = std::max(next_ins, std::min(ins_to, ins_max));
            }
        }
    }
    // backtrack
    std::vector<Seq> rev;
    size_t j = blen;
    while (j > 0) {
        const Cell& c = cells[j];
        if (c.mlen == 0) { j--; continue; }
        Seq q;
        q.ll = uint32_t(c.seq_ll);
        q.ml = uint32_t(c.mlen);
        q.ofv = c.off;  // actual offset; mapped to Offset_Value below
        rev.push_back(q);
        j -= size_t(c.mlen) + size_t(c.seq_ll);
    }
    // emit forward: literals + rep-code mapping against the true history
    seqs.clear();
    lits.clear();
    Rep rcur = rep_in;
    size_t cursor = bs;
    for (size_t k = rev.size(); k-- > 0;) {
        Seq q = rev[k];
        lits.insert(lits.end(), src + cursor, src + cursor + q.ll);
        uint32_t off = q.ofv;
        q.ofv = ofv_of(off, q.ll, rcur);
        seqs.push_back(q);
        cursor += q.ll + q.ml;
    }
    lits.insert(lits.end(), src + cursor, src + be);
    costs.from_stats(seqs, lits);
    {   // every parse competes, scored by its EXACT encoded body size
        // (a self-consistent entropy estimate systematically undervalues
        // skewed parses — the coverage parse on structured data encodes
        // several percent smaller than its estimate — so encode for real;
        // both section encoders are pure functions of the parse)
        static thread_local std::vector<uint8_t> scratch;
        scratch.clear();
        encode_literals(lits.data(), lits.size(), scratch);
        encode_sequences(seqs, scratch);
        int64_t bytes = int64_t(scratch.size());
        int64_t mb = 0;
        for (const Seq& q : seqs) mb += q.ml;
        if (bytes < best_bits) {
            best_bits = bytes;
            best_seqs = seqs;
            best_lits = lits;
            best_rep = rcur;
            best_matched = mb;
        }
    }
    // plan exhausted but the block barely matched: the prices never let a
    // match-rich parse form — probe for one with a coverage+refine round
    if (pass + 1 == np && !coverage_tried && np + 2 <= 6 &&
        best_matched * 2 < int64_t(blen)) {
        coverage_tried = true;
        plan[np++] = kCoverage;
        plan[np++] = kRefineLast;
    }
    }  // pass loop (each pass re-parses with re-priced statistics)
    seqs = best_seqs;
    lits = best_lits;
    rep = best_rep;  // rep MUST track the emitted stream (ofv_of mapping)
    costs.from_stats(seqs, lits);
    // index whatever the scan did not reach (tail guard)
    for (size_t p = next_ins; p < std::min(be, ins_max); p++) M.insert(p);
    next_ins = std::max(next_ins, be);
}

// Fast tier (levels <= 4): single-table most-recent-candidate greedy
// with rep-first probing, miss-streak acceleration and backward match
// extension — the role of the reference's fast/dfast strategies
// (C/zstd/zstd_fast.c, zstd_double_fast.c), re-derived.  `table` holds
// absolute positions and persists across blocks of a region.
static void parse_block_fast(const uint8_t* src, size_t n, size_t bs,
                             size_t be, std::vector<uint32_t>& table,
                             std::vector<uint32_t>& ltable,
                             uint32_t hl, uint32_t window, Rep& rep,
                             std::vector<Seq>& seqs,
                             std::vector<uint8_t>& lits) {
    (void)n;
    auto hash5 = [&](size_t p) {
        uint64_t v = load64(src + p);
        return (uint32_t)(((v & 0xFFFFFFFFFFull) * 0x9E3779B185EBCA87ull)
                          >> (64 - hl));
    };
    const uint32_t hl8 = hl + 1;  // long table gets double the slots
    auto hash8 = [&](size_t p) {
        return (uint32_t)((load64(src + p) * 0xCF1BBCDCB7A56463ull)
                          >> (64 - hl8));
    };
    const bool dfast = !ltable.empty();
    const size_t mflimit = be >= 12 ? be - 12 : bs;
    const uint8_t* lim = src + be;
    constexpr unsigned kSkip = 6;
    unsigned miss = 1u << kSkip;
    size_t i = bs, anchor = bs;
    while (i < mflimit) {
        size_t mstart = i, mpos = 0;
        bool have = false;
        uint32_t r0 = rep.r0;
        // rep probe only at i+1: a rep hit at i is recovered one byte
        // later by the backward extension below (measured byte-identical
        // output, ~13% faster)
        if (false) {
        } else if (r0 && i + 1 < mflimit && i + 1 >= r0 &&
                   load32(src + i + 1) == load32(src + i + 1 - r0)) {
            // rep one byte later (the reference's ip+1 rep probe)
            mstart = i + 1;
            mpos = i + 1 - r0;
            have = true;
        }
        if (!have && dfast) {
            // long-match table first (8-byte prefix): longer matches and
            // fewer false probes — the double-fast strategy's core idea
            uint32_t h8 = hash8(i);
            uint32_t cand = ltable[h8];
            ltable[h8] = (uint32_t)i;
            if (cand != 0xFFFFFFFFu && i - cand <= window &&
                load64(src + cand) == load64(src + i)) {
                mpos = cand;
                have = true;
            }
        }
        if (!have) {
            uint32_t h = hash5(i);
            // 1-way bucket: the 2-way variant measured ZERO csize gain
            // on the corpus and cost ~12% encode speed
            uint32_t cand = table[2 * h];
            uint32_t cand2 = 0xFFFFFFFFu;
            table[2 * h] = (uint32_t)i;
            if (cand != 0xFFFFFFFFu && i - cand <= window &&
                load32(src + cand) == load32(src + i)) {
                mpos = cand;
                have = true;
                if (dfast && i + 1 < mflimit) {
                    // a long match starting one later usually beats a
                    // short one here (dfast's ip+1 long probe)
                    uint32_t h8 = hash8(i + 1);
                    uint32_t lc = ltable[h8];
                    ltable[h8] = (uint32_t)(i + 1);
                    if (lc != 0xFFFFFFFFu && i + 1 - lc <= window &&
                        load64(src + lc) == load64(src + i + 1)) {
                        size_t l_long = 8 + match_len(src + i + 9,
                                                      src + lc + 8, lim);
                        size_t l_short = 4 + match_len(
                            src + i + 4, src + mpos + 4, lim);
                        if (l_long > l_short + 1) {
                            mstart = i + 1;
                            mpos = lc;
                        }
                    }
                }
            } else if (cand2 != 0xFFFFFFFFu && i - cand2 <= window &&
                       load32(src + cand2) == load32(src + i)) {
                mpos = cand2;  // 2-way bucket: previous occupant
                have = true;
            }
        }
        if (!have) {
            i += miss++ >> kSkip;
            continue;
        }
        while (mstart > anchor && mpos > 0 &&
               src[mstart - 1] == src[mpos - 1]) { mstart--; mpos--; }
        miss = 1u << kSkip;
        size_t mlen = 4 + match_len(src + mstart + 4, src + mpos + 4, lim);
        uint32_t ll = uint32_t(mstart - anchor);
        lits.insert(lits.end(), src + anchor, src + mstart);
        Seq q;
        q.ll = ll;
        q.ml = uint32_t(mlen);
        q.ofv = ofv_of(uint32_t(mstart - mpos), ll, rep);
        seqs.push_back(q);
        size_t e = mstart + mlen;
        if (e >= 2 && e - 2 < mflimit) {
            uint32_t h = hash5(e - 2);
            table[2 * h + 1] = table[2 * h];
            table[2 * h] = uint32_t(e - 2);
            if (dfast) ltable[hash8(e - 2)] = uint32_t(e - 2);
        }
        if (mstart + 1 < mflimit) {
            uint32_t h = hash5(mstart + 1);
            table[2 * h + 1] = table[2 * h];
            table[2 * h] = uint32_t(mstart + 1);
        }
        i = e;
        anchor = e;
    }
    if (anchor < be)
        lits.insert(lits.end(), src + anchor, src + be);
}

}  // namespace

// Choose the end of the next block: scan up to 128K ahead in 16K chunks
// and cut at the strongest byte-distribution changepoint, so entropy
// tables never straddle a content transition (role of the reference's
// block splitter, C/zstd/zstd_preSplit.c, heuristic re-derived: coarse
// 64-bin histograms + normalized L1 distance between adjacent chunks).
static size_t choose_block_end(const uint8_t* src, size_t bs, size_t n,
                               size_t max_block, bool* cut) {
    if (cut) *cut = false;
    size_t lim = std::min(n, bs + max_block);
    if (lim - bs <= (32u << 10)) return lim;
    constexpr size_t kChunk = 16u << 10;
    size_t nch = (lim - bs) / kChunk;
    if (nch < 2) return lim;
    uint16_t prev_h[64], cur_h[64];
    for (size_t c = 0; c + 1 < nch; c++) {
        uint16_t* h = c == 0 ? prev_h : cur_h;
        std::memset(h, 0, sizeof(prev_h));
        const uint8_t* p = src + bs + c * kChunk;
        for (size_t i = 0; i < kChunk; i += 4) h[p[i] >> 2]++;
        if (c == 0) continue;
        uint32_t l1 = 0;
        for (int b = 0; b < 64; b++)
            l1 += uint32_t(std::abs(int(prev_h[b]) - int(cur_h[b])));
        // samples per chunk = kChunk/4; full divergence = 2*samples
        if (l1 * 2 > (kChunk / 4)) {  // > 25% mass moved
            if (cut) *cut = true;
            return bs + c * kChunk;   // cut before the divergent chunk
        }
        std::memcpy(prev_h, cur_h, sizeof(prev_h));
    }
    return lim;
}

// ------------------------------------------------------------- driver ---

// Encode blocks covering [start, n) of src as a zstd block stream into
// `out`. Positions [0, start) act as a window prefix: the match finder
// indexes them but no block is emitted for them — the zstdmt job model
// (C/zstd/zstdmt_compress.c:693-760: overlap prefix as rawContent dict,
// repcodes reset per job). The final block's `last` flag is set only
// when `final_last` (intermediate jobs of a sharded frame pass false).
template <class MF>
static void encode_blocks_region_impl(const uint8_t* src, size_t n,
                                      size_t start, int level,
                                      bool final_last,
                                      std::vector<uint8_t>& out) {
    {
        Params P = level_params(level, n);
        const bool fast_tier = level <= 4;
        MF M;
        std::vector<uint32_t> fast_table, fast_ltable;
        if (fast_tier) {
            fast_table.assign(size_t(2) << P.hash_log, 0xFFFFFFFFu);
            if (level >= 3)  // double-fast long table at 3-4
                fast_ltable.assign(size_t(2) << P.hash_log, 0xFFFFFFFFu);
        } else {
            M.init(src, n, P.hash_log);
        }
        Rep rep;
        if (start > 0) {
            // continuation job: the decoder's repcode history at this
            // point is unknown to us — invalidate (ZSTD_invalidateRepCodes
            // semantics, zstdmt_compress.c): zeroed slots are never
            // probed or emitted; slots repopulate as offsets are pushed,
            // identically on both sides.
            rep.r0 = rep.r1 = rep.r2 = 0;
        }
        std::vector<Seq> seqs;
        std::vector<uint8_t> lits, body;
        size_t next_ins = 0;  // chain-insertion cursor (each pos once)
        const size_t ins_max = n >= 4 ? n - 4 : 0;
        Costs costs;
        bool costs_ready = false;
        auto insert_to = [&](size_t k, size_t step) {
            if (fast_tier) { next_ins = std::max(next_ins, k); return; }
            size_t lim = std::min(k, ins_max);
            for (size_t j = next_ins; j < lim; j += step) M.insert(j);
            next_ins = std::max(next_ins, k);
        };
        size_t bs = start;
        bool at_cut = false;  // previous block ended on a content change
        while (bs < n) {
            bool cut = false;
            size_t be = level >= 13
                            ? choose_block_end(src, bs, n, kBlockSize, &cut)
                            : std::min(bs + kBlockSize, n);
            size_t blen = be - bs;
            bool reset_costs = at_cut;
            at_cut = cut;
            int lastf = (be == n && final_last) ? 1 : 0;
            // RLE block?
            bool uni = blen >= 8;
            for (size_t i = bs + 1; uni && i < be; i++)
                uni = src[i] == src[bs];
            if (uni) {
                // index only the run's edges (interior is redundant)
                insert_to(std::min(bs + 64, be), 1);
                if (be >= bs + 128) next_ins = be - 64;
                insert_to(be, 1);
                uint32_t bh = uint32_t(lastf) | (1u << 1) |
                              (uint32_t(blen) << 3);
                out.push_back(bh & 0xFF); out.push_back((bh >> 8) & 0xFF);
                out.push_back((bh >> 16) & 0xFF);
                out.push_back(src[bs]);
                bs = be;
                continue;
            }
            seqs.clear(); lits.clear(); body.clear();
            Rep rep_snap = rep;
            if (level >= 13 && blen >= 64) {
                if (!costs_ready) {
                    costs.defaults(src + bs, blen);
                    costs_ready = true;
                }
                // after a splitter cut, also try a defaults-seeded parse
                // (see parse_block_optimal pass plan)
                parse_block_optimal(src, n, bs, be, M, next_ins, ins_max,
                                    P, rep, costs, seqs, lits, reset_costs);
                goto assemble;
            }
            if (fast_tier) {
                parse_block_fast(src, n, bs, be, fast_table, fast_ltable,
                                 P.hash_log, P.window, rep, seqs, lits);
                goto assemble;
            }
            {
            size_t lit_anchor = bs;
            size_t i = bs;
            const size_t limit8 = be >= 8 ? be - 8 : 0;
            auto rep_probe = [&](size_t p, uint32_t r0) -> size_t {
                if (r0 == 0 || p < r0 || p + 3 > be) return 0;
                const uint8_t* a = src + p;
                const uint8_t* bb = a - r0;
                if (a[0] != bb[0] || a[1] != bb[1] || a[2] != bb[2])
                    return 0;
                return 3 + match_len(a + 3, bb + 3, src + be);
            };
            while (i < limit8) {
                insert_to(i, 1);  // positions strictly before the query
                size_t rlen = rep_probe(i, rep.r0);
                uint32_t coff = 0;
                size_t clen = M.best(i, be, P.depth, P.window, coff);
                // prefer rep unless the chain match is clearly longer
                bool use_rep = rlen >= 3 && (clen == 0 || rlen + 1 >= clen);
                size_t mlen = use_rep ? rlen : clen;
                uint32_t moff = use_rep ? rep.r0 : coff;
                if (mlen < 3) {
                    // accelerate through matchless stretches: the probed
                    // position is indexed, the skipped ones are not
                    // (zstd_fast semantics)
                    if (i >= next_ins && i < ins_max) {
                        M.insert(i);
                        next_ins = i + 1;
                    }
                    size_t skip = 1 + ((i - lit_anchor) >> P.accel_shift);
                    i += skip;
                    next_ins = std::max(next_ins, i);
                    continue;
                }
                // lazy: defer to a better match at i+1
                int lz = P.lazy;
                while (lz-- > 0 && i + 1 < limit8) {
                    insert_to(i + 1, 1);
                    uint32_t noff = 0;
                    size_t nlen = M.best(i + 1, be, P.depth, P.window, noff);
                    size_t nrlen = rep_probe(i + 1, rep.r0);
                    bool nrep = nrlen >= 3 && (nlen == 0 || nrlen + 1 >= nlen);
                    size_t cand_len = nrep ? nrlen : nlen;
                    uint32_t cand_off = nrep ? rep.r0 : noff;
                    long cur = long(8 * mlen) -
                               (use_rep ? 1 : highbit(moff));
                    long nxt = long(8 * cand_len) -
                               (nrep ? 1 : (cand_len ? highbit(cand_off) : 60));
                    if (cand_len >= 3 && nxt > cur + 6) {
                        i++;
                        mlen = cand_len; moff = cand_off; use_rep = nrep;
                    } else break;
                }
                uint32_t ll = uint32_t(i - lit_anchor);
                lits.insert(lits.end(), src + lit_anchor, src + i);
                Seq q;
                q.ll = ll; q.ml = uint32_t(mlen);
                q.ofv = ofv_of(moff, ll, rep);
                seqs.push_back(q);
                // index match interior (sparsely when long)
                size_t mend = i + mlen;
                insert_to(mend, mlen > size_t(P.ins_step) ? 16 : 1);
                i = mend;
                lit_anchor = i;
            }
            insert_to(be, 1);
            // trailing literals
            if (lit_anchor < be)
                lits.insert(lits.end(), src + lit_anchor, src + be);
            }
            // assemble block body
        assemble:
            encode_literals(lits.data(), lits.size(), body);
            encode_sequences(seqs, body);
            if (body.size() >= blen) {
                rep = rep_snap;  // decoder reps don't advance on raw
                uint32_t bh = uint32_t(lastf) | (0u << 1) |
                              (uint32_t(blen) << 3);
                out.push_back(bh & 0xFF); out.push_back((bh >> 8) & 0xFF);
                out.push_back((bh >> 16) & 0xFF);
                out.insert(out.end(), src + bs, src + be);
            } else {
                uint32_t bh = uint32_t(lastf) | (2u << 1) |
                              (uint32_t(body.size()) << 3);
                out.push_back(bh & 0xFF); out.push_back((bh >> 8) & 0xFF);
                out.push_back((bh >> 16) & 0xFF);
                out.insert(out.end(), body.begin(), body.end());
            }
            bs = be;
        }
    }
}

// matcher dispatch: optimal-parse levels use the binary-tree finder
static void encode_blocks_region(const uint8_t* src, size_t n,
                                 size_t start, int level, bool final_last,
                                 std::vector<uint8_t>& out) {
    if (level >= 13)
        encode_blocks_region_impl<BTMatcher>(src, n, start, level,
                                             final_last, out);
    else
        encode_blocks_region_impl<Matcher>(src, n, start, level,
                                           final_last, out);
}

static void write_frame_header(std::vector<uint8_t>& out, uint64_t n,
                               int checksum) {
    // single-segment + FCS (frame.py write_frame_header)
    uint32_t magic = 0xFD2FB528u;
    for (int b = 0; b < 4; b++) out.push_back((magic >> (8 * b)) & 0xFF);
    int fcs_flag, fcs_bytes;
    if (n < 256) { fcs_flag = 0; fcs_bytes = 1; }
    else if (n <= 0xFFFFull + 256) { fcs_flag = 1; fcs_bytes = 2; }
    else if (n <= 0xFFFFFFFFull) { fcs_flag = 2; fcs_bytes = 4; }
    else { fcs_flag = 3; fcs_bytes = 8; }
    uint8_t fhd = uint8_t((fcs_flag << 6) | (1 << 5) |
                          (checksum ? (1 << 2) : 0));
    out.push_back(fhd);
    uint64_t fcs = n;
    if (fcs_flag == 1) fcs -= 256;
    for (int b = 0; b < fcs_bytes; b++)
        out.push_back((fcs >> (8 * b)) & 0xFF);
}

extern "C" long long tz_zstd_encode(const uint8_t* src, size_t n,
                                    uint8_t* dst, size_t cap,
                                    int level, int checksum) {
    std::vector<uint8_t> out;
    out.reserve(n / 2 + 1024);
    write_frame_header(out, n, checksum);
    if (n == 0) {
        out.push_back(0x01); out.push_back(0x00); out.push_back(0x00);
    } else {
        encode_blocks_region(src, n, 0, level, true, out);
    }
    if (checksum) {
        uint64_t x = tz_xxh64(src, n, 0);
        for (int b = 0; b < 4; b++) out.push_back((x >> (8 * b)) & 0xFF);
    }
    if (out.size() > cap) return -1;
    memcpy(dst, out.data(), out.size());
    return (long long)out.size();
}

// One zstdmt-style job: src points at the job's window prefix; the job
// emits blocks for [prefix_len, n). `kind`: 0 = middle job (no header,
// no last flag), 1 = final job (last flag), 2 = first job (emits the
// frame header for total_size, no last flag unless also final: 3).
extern "C" long long tz_zstd_encode_job(const uint8_t* src, size_t n,
                                        size_t prefix_len,
                                        uint64_t total_size,
                                        int level, int kind, int checksum,
                                        uint8_t* dst, size_t cap) {
    if (prefix_len % kBlockSize != 0 || prefix_len >= n)
        return -2;
    std::vector<uint8_t> out;
    out.reserve((n - prefix_len) / 2 + 1024);
    bool first = kind & 2, last = kind & 1;
    if (first) write_frame_header(out, total_size, checksum);
    encode_blocks_region(src, n, prefix_len, level, last, out);
    if (out.size() > cap) return -1;
    memcpy(dst, out.data(), out.size());
    return (long long)out.size();
}
