// Host CRC-32 (IEEE, reflected, poly 0xEDB88320; zlib's crc32) and
// CRC-64 (ECMA-182 reflected, poly 0xC96C5795D7870F42; the .xz check),
// slice-by-8 and slice-by-4 tables: a copy of tpu7z/native's tz_crc32 and
// tz_crc64, with a plain C interface for ctypes
// (tpu7z_torch/ops/hashing.py: crc32_native, crc64_native).
//
// Build: c++ -O3 -fPIC -shared -std=c++17 (tpu7z_torch/ops/_build.py).

#include <cstdint>
#include <cstring>

extern "C" {

static uint32_t crc32_tab[8][256];
static uint64_t crc64_tab[4][256];
static int crc_init_done = 0;

static void crc_init() {
    if (crc_init_done) return;
    for (int i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320U & (0u - (c & 1)));
        crc32_tab[0][i] = c;
        uint64_t d = i;
        for (int k = 0; k < 8; k++) d = (d >> 1) ^ (0xC96C5795D7870F42ULL & (0ull - (d & 1)));
        crc64_tab[0][i] = d;
    }
    for (int t = 1; t < 8; t++)
        for (int i = 0; i < 256; i++)
            crc32_tab[t][i] = (crc32_tab[t-1][i] >> 8) ^ crc32_tab[0][crc32_tab[t-1][i] & 0xFF];
    for (int t = 1; t < 4; t++)
        for (int i = 0; i < 256; i++)
            crc64_tab[t][i] = (crc64_tab[t-1][i] >> 8) ^ crc64_tab[0][crc64_tab[t-1][i] & 0xFF];
    crc_init_done = 1;
}

uint32_t tz_crc32(const uint8_t* p, size_t len, uint32_t crc) {
    crc_init();
    uint32_t c = crc ^ 0xFFFFFFFFU;
    while (len >= 8) {
        uint32_t lo; memcpy(&lo, p, 4);
        lo ^= c;
        c = crc32_tab[7][lo & 0xFF] ^ crc32_tab[6][(lo >> 8) & 0xFF]
          ^ crc32_tab[5][(lo >> 16) & 0xFF] ^ crc32_tab[4][lo >> 24]
          ^ crc32_tab[3][p[4]] ^ crc32_tab[2][p[5]]
          ^ crc32_tab[1][p[6]] ^ crc32_tab[0][p[7]];
        p += 8; len -= 8;
    }
    while (len--) c = (c >> 8) ^ crc32_tab[0][(c ^ *p++) & 0xFF];
    return c ^ 0xFFFFFFFFU;
}

uint64_t tz_crc64(const uint8_t* p, size_t len, uint64_t crc) {
    crc_init();
    uint64_t c = crc ^ 0xFFFFFFFFFFFFFFFFULL;
    while (len >= 4) {
        c ^= (uint64_t)p[0] | ((uint64_t)p[1] << 8)
           | ((uint64_t)p[2] << 16) | ((uint64_t)p[3] << 24);
        c = crc64_tab[3][c & 0xFF] ^ crc64_tab[2][(c >> 8) & 0xFF]
          ^ crc64_tab[1][(c >> 16) & 0xFF] ^ crc64_tab[0][(c >> 24) & 0xFF]
          ^ (c >> 32);
        p += 4; len -= 4;
    }
    while (len--) c = (c >> 8) ^ crc64_tab[0][(c ^ *p++) & 0xFF];
    return c ^ 0xFFFFFFFFFFFFFFFFULL;
}

// ---------------------------------------------------------------------------
// LZ4 raw block decode (format per lz4_Block_format; own implementation)

}  // extern "C"
