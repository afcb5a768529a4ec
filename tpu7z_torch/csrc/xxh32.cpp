// XXH32 of a byte buffer on the host: the content checksum of the .lz4
// frames the port writes and verifies; and tz_xxh64 (xxh64.h), whose low
// 32 bits are the .zst frame's. Written from the public xxHash
// specification (XXH32): four accumulators take the buffer's 16-byte
// stripes, one 4-byte little-endian lane each; their rotations are summed,
// the length added, the 4-byte and then the 1-byte tail mixed in, and the
// result avalanched. A serial chain over the input, so it is host code.
//
// Build: c++ -O3 -fPIC -shared -std=c++17 (tpu7z_torch/ops/_build.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

#include "xxh64.h"

static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__,
              "lanes are read in the host's byte order");

namespace {

constexpr uint32_t P1 = 0x9E3779B1u;
constexpr uint32_t P2 = 0x85EBCA77u;
constexpr uint32_t P3 = 0xC2B2AE3Du;
constexpr uint32_t P4 = 0x27D4EB2Fu;
constexpr uint32_t P5 = 0x165667B1u;

inline uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

inline uint32_t read_lane(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t stripe_round(uint32_t acc, uint32_t lane) {
  return rotl(acc + lane * P2, 13) * P1;
}

}  // namespace

extern "C" uint32_t tz_xxh32(const uint8_t* data, size_t n, uint32_t seed) {
  const uint8_t* p = data;
  const uint8_t* const end = data + n;
  uint32_t h;
  if (n >= 16) {
    uint32_t v1 = seed + P1 + P2;
    uint32_t v2 = seed + P2;
    uint32_t v3 = seed;
    uint32_t v4 = seed - P1;
    for (; end - p >= 16; p += 16) {
      v1 = stripe_round(v1, read_lane(p));
      v2 = stripe_round(v2, read_lane(p + 4));
      v3 = stripe_round(v3, read_lane(p + 8));
      v4 = stripe_round(v4, read_lane(p + 12));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint32_t>(n);
  for (; end - p >= 4; p += 4) h = rotl(h + read_lane(p) * P3, 17) * P4;
  for (; p < end; ++p) h = rotl(h + *p * P5, 11) * P1;
  h ^= h >> 15;
  h *= P2;
  h ^= h >> 13;
  h *= P3;
  h ^= h >> 16;
  return h;
}

extern "C" uint64_t tz_xxh64(const uint8_t* data, size_t n, uint64_t seed) {
  return tz_xxh::xxh64(data, n, seed);
}
