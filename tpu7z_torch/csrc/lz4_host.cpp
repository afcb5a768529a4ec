// The LZ4 block codec on the host: the decoder of every block the port
// reads back, and the greedy encoder of the host tier, written from the
// public LZ4 block format (lz4_Block_format). A block is a run of
// sequences: a token (literal count in its high nibble, match length - 4
// in its low nibble, 15 meaning that bytes of 255 and one last byte
// follow), the literals, then a u16le offset and the match, except in
// the last sequence, which holds literals only.
//
// lz4_decode takes a window: the first `prefix` bytes of dst are output
// already decoded (the previous blocks of a linked-block frame), decoding
// starts after them and a match may reach back into them. prefix = 0 is
// the independent-block decoder.
//
// Build: c++ -O3 -fPIC -shared -std=c++17 (tpu7z_torch/ops/_build.py).

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr long long TRUNCATED = -1;    // a length, literal run or offset cut short
constexpr long long BAD_OFFSET = -2;   // offset 0, or before the start of dst
constexpr long long PAST_END = -3;     // output past dstn

}  // namespace

// Decode the block src[0, srcn) into dst[prefix, dstn). Returns the number
// of bytes decoded after the prefix, or one of the negative codes above.
extern "C" long long lz4_decode(const uint8_t* src, size_t srcn, uint8_t* dst,
                                size_t prefix, size_t dstn) {
  size_t ip = 0, op = prefix;
  if (prefix > dstn) return PAST_END;
  while (ip < srcn) {
    const unsigned token = src[ip++];
    size_t lit = token >> 4;
    if (lit == 15) {
      unsigned b;
      do {
        if (ip >= srcn) return TRUNCATED;
        b = src[ip++];
        lit += b;
      } while (b == 255);
    }
    if (ip + lit > srcn) return TRUNCATED;
    if (op + lit > dstn) return PAST_END;
    std::memcpy(dst + op, src + ip, lit);
    ip += lit;
    op += lit;
    if (ip == srcn) break;  // the last sequence has no match
    if (ip + 2 > srcn) return TRUNCATED;
    const size_t offset = src[ip] | (static_cast<size_t>(src[ip + 1]) << 8);
    ip += 2;
    if (offset == 0 || offset > op) return BAD_OFFSET;
    size_t ml = token & 15;
    if (ml == 15) {
      unsigned b;
      do {
        if (ip >= srcn) return TRUNCATED;
        b = src[ip++];
        ml += b;
      } while (b == 255);
    }
    ml += 4;
    if (op + ml > dstn) return PAST_END;
    const uint8_t* m = dst + op - offset;
    if (offset >= ml) {
      std::memcpy(dst + op, m, ml);
    } else {
      // overlapping: each byte copies one written `offset` bytes before
      for (size_t k = 0; k < ml; k++) dst[op + k] = m[k];
    }
    op += ml;
  }
  return static_cast<long long>(op - prefix);
}

// Encode src[start, n) as one LZ4 block into dst[0, cap); matches may reach
// back into src[0, start), the window of a linked block. start = 0 is the
// independent-block encoder. Greedy: a 16-bit table of the last position
// of each 5-byte hash, a match taken when its 4 bytes verify, extended
// back over pending literals and forward 8 bytes at a time; a miss
// streak widens the scan step. Returns the block's size, or -1 when cap
// is too small.
extern "C" long long lz4_encode_region(const uint8_t* src, size_t n, size_t start,
                                       uint8_t* dst, size_t cap) {
  if (n <= start) {
    if (cap < 1) return -1;
    dst[0] = 0;
    return 1;
  }
  constexpr size_t HASH_LOG = 16, HSIZE = size_t(1) << HASH_LOG;
  static thread_local uint32_t* table = nullptr;
  if (!table) table = static_cast<uint32_t*>(std::malloc(HSIZE * sizeof(uint32_t)));
  if (!table) return -1;
  for (size_t i = 0; i < HSIZE; i++) table[i] = 0xFFFFFFFFu;

  size_t ip = start, op = 0, anchor = start;
  const size_t mflimit = n >= 12 ? n - 12 : 0;     // no match starts in the last 12
  const size_t matchlimit = n >= 5 ? n - 5 : 0;    // the last 5 bytes are literals

  auto hash5 = [&](size_t p) {
    uint64_t v;
    std::memcpy(&v, src + p, 8);
    return static_cast<uint32_t>(((v & 0xFFFFFFFFFFull) * 0x9E3779B185EBCA87ull)
                                 >> (64 - HASH_LOG));
  };
  auto fwd_count = [&](size_t a, size_t b) {
    size_t len = 0;
    while (a + len + 8 <= matchlimit) {
      uint64_t x, y;
      std::memcpy(&x, src + a + len, 8);
      std::memcpy(&y, src + b + len, 8);
      const uint64_t d = x ^ y;
      if (d) return len + (__builtin_ctzll(d) >> 3);
      len += 8;
    }
    while (a + len < matchlimit && src[a + len] == src[b + len]) len++;
    return len;
  };
  auto put_length = [&](size_t l) {
    l -= 15;
    while (l >= 255) { dst[op++] = 255; l -= 255; }
    dst[op++] = static_cast<uint8_t>(l);
  };
  auto emit = [&](size_t lit_start, size_t lit_len, size_t offset, size_t mlen) {
    const size_t need = 1 + lit_len / 255 + 1 + lit_len + 2 + mlen / 255 + 1;
    if (op + need + 8 > cap) return false;
    uint8_t* tok = dst + op++;
    *tok = static_cast<uint8_t>((lit_len >= 15 ? 15 : lit_len) << 4);
    if (lit_len >= 15) put_length(lit_len);
    std::memcpy(dst + op, src + lit_start, lit_len);
    op += lit_len;
    dst[op++] = static_cast<uint8_t>(offset);
    dst[op++] = static_cast<uint8_t>(offset >> 8);
    const size_t m = mlen - 4;
    *tok |= static_cast<uint8_t>(m >= 15 ? 15 : m);
    if (m >= 15) put_length(m);
    return true;
  };

  // the window seeds the table, nearest occurrence last
  if (start) {
    const size_t wfrom = start > 0xFFFF ? start - 0xFFFF : 0;
    const size_t wlim = start < mflimit ? start : mflimit;
    for (size_t p = wfrom; p < wlim; p++) table[hash5(p)] = static_cast<uint32_t>(p);
  }
  constexpr unsigned SKIP_STRENGTH = 6;
  unsigned miss = 1u << SKIP_STRENGTH;
  while (ip < mflimit) {
    const uint32_t h = hash5(ip);
    const uint32_t cand = table[h];
    table[h] = static_cast<uint32_t>(ip);
    if (cand != 0xFFFFFFFFu && ip - cand <= 0xFFFF) {
      uint32_t v0, v1;
      std::memcpy(&v0, src + cand, 4);
      std::memcpy(&v1, src + ip, 4);
      if (v0 == v1) {
        miss = 1u << SKIP_STRENGTH;
        size_t mp = cand;
        while (ip > anchor && mp > 0 && src[ip - 1] == src[mp - 1]) { ip--; mp--; }
        const size_t mlen = 4 + fwd_count(ip + 4, mp + 4);
        if (!emit(anchor, ip - anchor, ip - mp, mlen)) return -1;
        const size_t e = ip + mlen;
        // index the match's end - 2 and its middle, so long matches link on
        if (e >= 3 && e - 2 < mflimit) table[hash5(e - 2)] = static_cast<uint32_t>(e - 2);
        const size_t mid = ip + mlen / 2;
        if (mid < mflimit) table[hash5(mid)] = static_cast<uint32_t>(mid);
        ip = anchor = e;
        continue;
      }
    }
    ip += miss++ >> SKIP_STRENGTH;
  }
  const size_t lit = n - anchor;
  if (op + 1 + lit / 255 + 1 + lit > cap) return -1;
  uint8_t* tok = dst + op++;
  *tok = static_cast<uint8_t>((lit >= 15 ? 15 : lit) << 4);
  if (lit >= 15) put_length(lit);
  std::memcpy(dst + op, src + anchor, lit);
  op += lit;
  return static_cast<long long>(op);
}

// Encode src[0, n) as one independent LZ4 block (lz4_encode_region at 0).
extern "C" long long lz4_encode(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  return lz4_encode_region(src, n, 0, dst, cap);
}
