// XXH64 of a byte buffer on the host, written from the public xxHash
// specification: four 64-bit accumulators take the buffer's 32-byte
// stripes, one 8-byte little-endian lane each; their rotations are summed
// and each accumulator merged in, the length added, the 8-, 4- and 1-byte
// tails mixed in, and the result avalanched. The low 32 bits are the .zst
// frame's content checksum.
//
// Each library that needs it defines the C symbol tz_xxh64 from this one
// definition (csrc/xxh32.cpp, zstd_enc.cpp, zstd_dec.cpp): _build.py makes
// one library a source, and ctypes loads each with its symbols local.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace tz_xxh {

constexpr uint64_t P1 = 11400714785074694791ULL;
constexpr uint64_t P2 = 14029467366897019727ULL;
constexpr uint64_t P3 = 1609587929392839161ULL;
constexpr uint64_t P4 = 9650029242287828579ULL;
constexpr uint64_t P5 = 2870177450012600261ULL;

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t lane64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint64_t round64(uint64_t acc, uint64_t lane) {
  return rotl64(acc + lane * P2, 31) * P1;
}

inline uint64_t merge64(uint64_t h, uint64_t acc) {
  return (h ^ round64(0, acc)) * P1 + P4;
}

inline uint64_t xxh64(const uint8_t* p, size_t len, uint64_t seed) {
  const uint8_t* const end = p + len;
  uint64_t h;
  if (len >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; end - p >= 32; p += 32) {
      v1 = round64(v1, lane64(p));
      v2 = round64(v2, lane64(p + 8));
      v3 = round64(v3, lane64(p + 16));
      v4 = round64(v4, lane64(p + 24));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge64(h, v1);
    h = merge64(h, v2);
    h = merge64(h, v3);
    h = merge64(h, v4);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint64_t>(len);
  for (; end - p >= 8; p += 8) h = rotl64(h ^ round64(0, lane64(p)), 27) * P1 + P4;
  if (end - p >= 4) {
    uint32_t k;
    std::memcpy(&k, p, 4);
    h = rotl64(h ^ (static_cast<uint64_t>(k) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl64(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

}  // namespace tz_xxh
