// XXH32 of a byte buffer on the host: the content checksum of the .lz4
// frames the port writes and verifies; and tz_xxh64 (xxh64.h), whose low
// 32 bits are the .zst frame's. Written from the public xxHash
// specification (XXH32): four accumulators take the buffer's 16-byte
// stripes, one 4-byte little-endian lane each; their rotations are summed,
// the length added, the 4-byte and then the 1-byte tail mixed in, and the
// result avalanched. A serial chain over the input, so it is host code.
// The streaming form (tz_xxh32_reset, _update, _digest) takes the input
// in pieces, as the streaming extract decodes a frame's content, and
// gives the same digest as tz_xxh32 of the pieces joined.
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

// The digest from the accumulators' sum `h` (or seed + P5 below 16
// bytes) and the total length: the tail in [p, end) mixed in, then the
// avalanche.
inline uint32_t finish(uint32_t h, uint64_t total, const uint8_t* p, const uint8_t* end) {
  h += static_cast<uint32_t>(total);
  for (; end - p >= 4; p += 4) h = rotl(h + read_lane(p) * P3, 17) * P4;
  for (; p < end; ++p) h = rotl(h + *p * P5, 11) * P1;
  h ^= h >> 15;
  h *= P2;
  h ^= h >> 13;
  h *= P3;
  h ^= h >> 16;
  return h;
}

}  // namespace

// The streaming state: the four accumulators, the seed, the length so
// far and the bytes of a stripe not yet complete.
struct tz_xxh32_state {
  uint32_t v[4];
  uint32_t seed;
  uint32_t buffered;
  uint64_t total;
  uint8_t buf[16];
};

extern "C" size_t tz_xxh32_state_size() { return sizeof(tz_xxh32_state); }

extern "C" void tz_xxh32_reset(tz_xxh32_state* s, uint32_t seed) {
  s->v[0] = seed + P1 + P2;
  s->v[1] = seed + P2;
  s->v[2] = seed;
  s->v[3] = seed - P1;
  s->seed = seed;
  s->buffered = 0;
  s->total = 0;
}

extern "C" void tz_xxh32_update(tz_xxh32_state* s, const uint8_t* p, size_t n) {
  const uint8_t* const end = p + n;
  s->total += n;
  if (s->buffered + n < 16) {
    std::memcpy(s->buf + s->buffered, p, n);
    s->buffered += static_cast<uint32_t>(n);
    return;
  }
  if (s->buffered) {
    const size_t take = 16 - s->buffered;
    std::memcpy(s->buf + s->buffered, p, take);
    p += take;
    for (int k = 0; k < 4; ++k) s->v[k] = stripe_round(s->v[k], read_lane(s->buf + 4 * k));
    s->buffered = 0;
  }
  for (; end - p >= 16; p += 16)
    for (int k = 0; k < 4; ++k) s->v[k] = stripe_round(s->v[k], read_lane(p + 4 * k));
  std::memcpy(s->buf, p, end - p);
  s->buffered = static_cast<uint32_t>(end - p);
}

extern "C" uint32_t tz_xxh32_digest(const tz_xxh32_state* s) {
  const uint32_t h = s->total >= 16
      ? rotl(s->v[0], 1) + rotl(s->v[1], 7) + rotl(s->v[2], 12) + rotl(s->v[3], 18)
      : s->seed + P5;
  return finish(h, s->total, s->buf, s->buf + s->buffered);
}

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
  return finish(h, n, p, end);
}

extern "C" uint64_t tz_xxh64(const uint8_t* data, size_t n, uint64_t seed) {
  return tz_xxh::xxh64(data, n, seed);
}
