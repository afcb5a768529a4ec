// Host AES CBC encryption for the .7z writer: the bytes of
// tpu7z/containers/sevenzip/aes7z.py aes_encrypt, whose Python loop
// encrypts one 16-byte block at a time. CBC chains each block to the one
// before, so encryption stays serial on the host; decryption, which is
// data-parallel, is tensor code on the card (aes7z.py _decrypt_blocks).
//
// The caller (tpu7z_torch/containers/sevenzip/aes7z.py) gives the S-box,
// the expanded round keys (nr + 1 of 16 bytes, in a block's byte order),
// the IV and a whole number of blocks, already zero-padded. FIPS-197:
// AddRoundKey, then nr rounds of SubBytes, ShiftRows, MixColumns (all but
// the last) and AddRoundKey. The state's byte 4 * column + row is the
// block's byte at the same index.
//
// Build: c++ -O3 -fPIC -shared -std=c++17 (tpu7z_torch/ops/_build.py).

#include <cstddef>
#include <cstdint>
#include <cstring>

static inline uint8_t xtime(uint8_t a) {
    return (uint8_t)((a << 1) ^ ((a & 0x80) ? 0x1B : 0));
}

extern "C" int tz_aes_cbc_encrypt(const uint8_t* sbox, const uint8_t* rk, int nr,
                                  const uint8_t* iv, const uint8_t* src, size_t n,
                                  uint8_t* dst) {
    if (n % 16 != 0 || nr < 1 || nr > 14) return -1;
    uint8_t prev[16];
    memcpy(prev, iv, 16);
    for (size_t off = 0; off < n; off += 16) {
        uint8_t s[16], t[16];
        for (int i = 0; i < 16; i++) s[i] = src[off + i] ^ prev[i] ^ rk[i];
        for (int r = 1; r <= nr; r++) {
            // SubBytes and ShiftRows: row i turns left by i
            for (int c = 0; c < 4; c++)
                for (int row = 0; row < 4; row++)
                    t[4 * c + row] = sbox[s[4 * ((c + row) & 3) + row]];
            if (r < nr) {
                for (int c = 0; c < 4; c++) {
                    uint8_t a0 = t[4 * c], a1 = t[4 * c + 1], a2 = t[4 * c + 2], a3 = t[4 * c + 3];
                    uint8_t x0 = xtime(a0), x1 = xtime(a1), x2 = xtime(a2), x3 = xtime(a3);
                    s[4 * c + 0] = x0 ^ x1 ^ a1 ^ a2 ^ a3;
                    s[4 * c + 1] = a0 ^ x1 ^ x2 ^ a2 ^ a3;
                    s[4 * c + 2] = a0 ^ a1 ^ x2 ^ x3 ^ a3;
                    s[4 * c + 3] = x0 ^ a0 ^ a1 ^ a2 ^ x3;
                }
            } else {
                memcpy(s, t, 16);
            }
            const uint8_t* k = rk + 16 * r;
            for (int i = 0; i < 16; i++) s[i] ^= k[i];
        }
        memcpy(dst + off, s, 16);
        memcpy(prev, s, 16);
    }
    return 0;
}
