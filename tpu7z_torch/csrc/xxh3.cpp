// XXH3-64 and XXH3-128 of a byte buffer on the host, seed 0 and the
// default 192-byte secret: the `h`, `t -scrc` and `b` hashers of those
// names. Written from the public xxHash specification (XXH3, v0.8): inputs
// of 0-16 bytes are mixed whole, 17-128 and 129-240 bytes as 16-byte
// (64-bit) or 32-byte (128-bit) pairs against the secret, and longer
// inputs as 64-byte stripes into eight accumulators, scrambled every
// 1024 bytes (16 stripes), the last stripe taken from the input's end and
// the accumulators merged. A serial chain over the input, so it is host
// code.
//
// Build: c++ -O3 -fPIC -shared -std=c++17 (tpu7z_torch/ops/_build.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "lanes are read in the host's byte order");

namespace {

constexpr uint32_t P32_1 = 0x9E3779B1u;
constexpr uint32_t P32_2 = 0x85EBCA77u;
constexpr uint32_t P32_3 = 0xC2B2AE3Du;
constexpr uint64_t P64_1 = 0x9E3779B185EBCA87ull;
constexpr uint64_t P64_2 = 0xC2B2AE3D27D4EB4Full;
constexpr uint64_t P64_3 = 0x165667B19E3779F9ull;
constexpr uint64_t P64_4 = 0x85EBCA77C2B2AE63ull;
constexpr uint64_t P64_5 = 0x27D4EB2F165667C5ull;
constexpr uint64_t PMX_1 = 0x165667919E3779F9ull;
constexpr uint64_t PMX_2 = 0x9FB21C651E98DF25ull;

constexpr size_t SECRET_SIZE = 192;
constexpr size_t SECRET_SIZE_MIN = 136;
constexpr size_t STRIPE = 64;
constexpr size_t CONSUME = 8;                       // secret bytes a stripe
constexpr size_t STRIPES_PER_BLOCK = (SECRET_SIZE - STRIPE) / CONSUME;  // 16
constexpr size_t BLOCK = STRIPE * STRIPES_PER_BLOCK;                    // 1024
constexpr size_t LASTACC_START = 7;
constexpr size_t MERGEACCS_START = 11;
constexpr size_t MIDSIZE_START = 3;
constexpr size_t MIDSIZE_LAST = 17;

constexpr uint8_t SECRET[SECRET_SIZE] = {
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c, 0xf7, 0x21, 0xad, 0x1c,
    0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb, 0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f,
    0xcb, 0x79, 0xe6, 0x4e, 0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6, 0x81, 0x3a, 0x26, 0x4c,
    0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb, 0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3,
    0x71, 0x64, 0x48, 0x97, 0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7, 0xc7, 0x0b, 0x4f, 0x1d,
    0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31, 0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64,
    0xea, 0xc5, 0xac, 0x83, 0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26, 0x29, 0xd4, 0x68, 0x9e,
    0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc, 0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce,
    0x45, 0xcb, 0x3a, 0x8f, 0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
};

struct U128 {
  uint64_t lo, hi;
};

inline uint64_t r64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t r32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline U128 mul128(uint64_t a, uint64_t b) {
  unsigned __int128 p = static_cast<unsigned __int128>(a) * b;
  return {static_cast<uint64_t>(p), static_cast<uint64_t>(p >> 64)};
}

inline uint64_t fold64(uint64_t a, uint64_t b) {
  U128 p = mul128(a, b);
  return p.lo ^ p.hi;
}

inline uint64_t xxh64_avalanche(uint64_t h) {
  h ^= h >> 33;
  h *= P64_2;
  h ^= h >> 29;
  h *= P64_3;
  return h ^ (h >> 32);
}

inline uint64_t avalanche(uint64_t h) {
  h ^= h >> 37;
  h *= PMX_1;
  return h ^ (h >> 32);
}

inline uint64_t rrmxmx(uint64_t h, uint64_t len) {
  h ^= rotl64(h, 49) ^ rotl64(h, 24);
  h *= PMX_2;
  h ^= (h >> 35) + len;
  h *= PMX_2;
  return h ^ (h >> 28);
}

inline uint64_t mix16(const uint8_t* in, const uint8_t* sec, uint64_t seed) {
  return fold64(r64(in) ^ (r64(sec) + seed), r64(in + 8) ^ (r64(sec + 8) - seed));
}

// the long inputs' accumulators: every stripe, a scramble every block,
// the last stripe from the input's end
void accumulate_512(uint64_t* acc, const uint8_t* in, const uint8_t* sec) {
  for (int i = 0; i < 8; ++i) {
    uint64_t v = r64(in + 8 * i);
    uint64_t k = v ^ r64(sec + 8 * i);
    acc[i ^ 1] += v;
    acc[i] += (k & 0xFFFFFFFFull) * (k >> 32);
  }
}

void scramble(uint64_t* acc, const uint8_t* sec) {
  for (int i = 0; i < 8; ++i) {
    uint64_t a = acc[i];
    a ^= a >> 47;
    a ^= r64(sec + 8 * i);
    acc[i] = a * P32_1;
  }
}

void long_accs(uint64_t* acc, const uint8_t* in, size_t n) {
  const uint64_t init[8] = {P32_3, P64_1, P64_2, P64_3, P64_4, P32_2, P64_5, P32_1};
  std::memcpy(acc, init, sizeof(init));
  size_t blocks = (n - 1) / BLOCK;
  for (size_t b = 0; b < blocks; ++b) {
    for (size_t s = 0; s < STRIPES_PER_BLOCK; ++s)
      accumulate_512(acc, in + b * BLOCK + s * STRIPE, SECRET + s * CONSUME);
    scramble(acc, SECRET + SECRET_SIZE - STRIPE);
  }
  size_t stripes = ((n - 1) - BLOCK * blocks) / STRIPE;
  for (size_t s = 0; s < stripes; ++s)
    accumulate_512(acc, in + blocks * BLOCK + s * STRIPE, SECRET + s * CONSUME);
  accumulate_512(acc, in + n - STRIPE, SECRET + SECRET_SIZE - STRIPE - LASTACC_START);
}

uint64_t merge_accs(const uint64_t* acc, const uint8_t* sec, uint64_t start) {
  uint64_t h = start;
  for (int i = 0; i < 4; ++i)
    h += fold64(acc[2 * i] ^ r64(sec + 16 * i), acc[2 * i + 1] ^ r64(sec + 16 * i + 8));
  return avalanche(h);
}

uint64_t xxh3_64(const uint8_t* in, size_t n) {
  const uint8_t* s = SECRET;
  if (n == 0) return xxh64_avalanche(r64(s + 56) ^ r64(s + 64));
  if (n <= 3) {
    uint32_t c = (uint32_t(in[0]) << 16) | (uint32_t(in[n >> 1]) << 24) | in[n - 1] |
                 (uint32_t(n) << 8);
    return xxh64_avalanche(uint64_t(c) ^ uint64_t(r32(s) ^ r32(s + 4)));
  }
  if (n <= 8) {
    uint64_t v = r32(in + n - 4) + (uint64_t(r32(in)) << 32);
    return rrmxmx(v ^ (r64(s + 8) ^ r64(s + 16)), n);
  }
  if (n <= 16) {
    uint64_t lo = r64(in) ^ (r64(s + 24) ^ r64(s + 32));
    uint64_t hi = r64(in + n - 8) ^ (r64(s + 40) ^ r64(s + 48));
    return avalanche(n + __builtin_bswap64(lo) + hi + fold64(lo, hi));
  }
  if (n <= 128) {
    uint64_t acc = n * P64_1;
    if (n > 32) {
      if (n > 64) {
        if (n > 96) {
          acc += mix16(in + 48, s + 96, 0);
          acc += mix16(in + n - 64, s + 112, 0);
        }
        acc += mix16(in + 32, s + 64, 0);
        acc += mix16(in + n - 48, s + 80, 0);
      }
      acc += mix16(in + 16, s + 32, 0);
      acc += mix16(in + n - 32, s + 48, 0);
    }
    acc += mix16(in, s, 0);
    acc += mix16(in + n - 16, s + 16, 0);
    return avalanche(acc);
  }
  if (n <= 240) {
    uint64_t acc = n * P64_1;
    for (size_t i = 0; i < 8; ++i) acc += mix16(in + 16 * i, s + 16 * i, 0);
    uint64_t end = mix16(in + n - 16, s + SECRET_SIZE_MIN - MIDSIZE_LAST, 0);
    acc = avalanche(acc);
    for (size_t i = 8; i < n / 16; ++i) end += mix16(in + 16 * i, s + 16 * (i - 8) + MIDSIZE_START, 0);
    return avalanche(acc + end);
  }
  uint64_t acc[8];
  long_accs(acc, in, n);
  return merge_accs(acc, s + MERGEACCS_START, n * P64_1);
}

U128 mix32(U128 acc, const uint8_t* a, const uint8_t* b, const uint8_t* sec, uint64_t seed) {
  acc.lo += mix16(a, sec, seed);
  acc.lo ^= r64(b) + r64(b + 8);
  acc.hi += mix16(b, sec + 16, seed);
  acc.hi ^= r64(a) + r64(a + 8);
  return acc;
}

U128 finish128(U128 acc, uint64_t n) {
  U128 h;
  h.lo = avalanche(acc.lo + acc.hi);
  h.hi = 0 - avalanche(acc.lo * P64_1 + acc.hi * P64_4 + n * P64_2);
  return h;
}

U128 xxh3_128(const uint8_t* in, size_t n) {
  const uint8_t* s = SECRET;
  if (n == 0) return {xxh64_avalanche(r64(s + 64) ^ r64(s + 72)),
                      xxh64_avalanche(r64(s + 80) ^ r64(s + 88))};
  if (n <= 3) {
    uint32_t cl = (uint32_t(in[0]) << 16) | (uint32_t(in[n >> 1]) << 24) | in[n - 1] |
                  (uint32_t(n) << 8);
    uint32_t ch = rotl32(__builtin_bswap32(cl), 13);
    uint64_t kl = uint64_t(cl) ^ uint64_t(r32(s) ^ r32(s + 4));
    uint64_t kh = uint64_t(ch) ^ uint64_t(r32(s + 8) ^ r32(s + 12));
    return {xxh64_avalanche(kl), xxh64_avalanche(kh)};
  }
  if (n <= 8) {
    uint64_t v = r32(in) + (uint64_t(r32(in + n - 4)) << 32);
    U128 m = mul128(v ^ (r64(s + 16) ^ r64(s + 24)), P64_1 + (uint64_t(n) << 2));
    m.hi += m.lo << 1;
    m.lo ^= m.hi >> 3;
    m.lo ^= m.lo >> 35;
    m.lo *= PMX_2;
    m.lo ^= m.lo >> 28;
    m.hi = avalanche(m.hi);
    return m;
  }
  if (n <= 16) {
    uint64_t fl = r64(s + 32) ^ r64(s + 40);
    uint64_t fh = r64(s + 48) ^ r64(s + 56);
    uint64_t lo = r64(in), hi = r64(in + n - 8);
    U128 m = mul128(lo ^ hi ^ fl, P64_1);
    m.lo += uint64_t(n - 1) << 54;
    hi ^= fh;
    m.hi += hi + (hi & 0xFFFFFFFFull) * uint64_t(P32_2 - 1);
    m.lo ^= __builtin_bswap64(m.hi);
    U128 h = mul128(m.lo, P64_2);
    h.hi += m.hi * P64_2;
    return {avalanche(h.lo), avalanche(h.hi)};
  }
  if (n <= 128) {
    U128 acc{n * P64_1, 0};
    if (n > 32) {
      if (n > 64) {
        if (n > 96) acc = mix32(acc, in + 48, in + n - 64, s + 96, 0);
        acc = mix32(acc, in + 32, in + n - 48, s + 64, 0);
      }
      acc = mix32(acc, in + 16, in + n - 32, s + 32, 0);
    }
    acc = mix32(acc, in, in + n - 16, s, 0);
    return finish128(acc, n);
  }
  if (n <= 240) {
    U128 acc{n * P64_1, 0};
    for (size_t i = 0; i < 4; ++i) acc = mix32(acc, in + 32 * i, in + 32 * i + 16, s + 32 * i, 0);
    acc.lo = avalanche(acc.lo);
    acc.hi = avalanche(acc.hi);
    for (size_t i = 4; i < n / 32; ++i)
      acc = mix32(acc, in + 32 * i, in + 32 * i + 16, s + MIDSIZE_START + 32 * (i - 4), 0);
    acc = mix32(acc, in + n - 16, in + n - 32, s + SECRET_SIZE_MIN - MIDSIZE_LAST - 16, 0);
    return finish128(acc, n);
  }
  uint64_t acc[8];
  long_accs(acc, in, n);
  return {merge_accs(acc, s + MERGEACCS_START, n * P64_1),
          merge_accs(acc, s + SECRET_SIZE - STRIPE - MERGEACCS_START, ~(n * P64_2))};
}

}  // namespace

extern "C" uint64_t tz_xxh3_64(const uint8_t* data, size_t n) { return xxh3_64(data, n); }

// out[0] = the low 64 bits, out[1] = the high 64 bits
extern "C" void tz_xxh3_128(const uint8_t* data, size_t n, uint64_t* out) {
  U128 h = xxh3_128(data, n);
  out[0] = h.lo;
  out[1] = h.hi;
}
