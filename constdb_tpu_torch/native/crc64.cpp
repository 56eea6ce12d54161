// CRC-64/XZ (reflected, poly 0x42F0E1EBA9EA3693) — slice-by-8.
// The port's own copy of the reference package's native/crc64.cpp: the
// native CRC of constdb_tpu_torch/utils/checksum.py, included by pyext.cpp
// and called through its `crc64` method.
#include <cstdint>
#include <cstddef>

namespace {

constexpr uint64_t kPoly = 0xC96C5795D7870F42ULL;

struct Tables {
    uint64_t t[8][256];
    Tables() {
        for (int i = 0; i < 256; i++) {
            uint64_t crc = (uint64_t)i;
            for (int k = 0; k < 8; k++)
                crc = (crc & 1) ? (crc >> 1) ^ kPoly : crc >> 1;
            t[0][i] = crc;
        }
        for (int i = 0; i < 256; i++)
            for (int s = 1; s < 8; s++)
                t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
    }
};

const Tables kTables;

}  // namespace

inline uint64_t cst_crc64(uint64_t crc, const unsigned char* data, size_t len) {
    crc = ~crc;
    const uint64_t(*t)[256] = kTables.t;
    while (len >= 8) {
        crc ^= (uint64_t)data[0] | ((uint64_t)data[1] << 8) | ((uint64_t)data[2] << 16) |
               ((uint64_t)data[3] << 24) | ((uint64_t)data[4] << 32) | ((uint64_t)data[5] << 40) |
               ((uint64_t)data[6] << 48) | ((uint64_t)data[7] << 56);
        crc = t[7][crc & 0xFF] ^ t[6][(crc >> 8) & 0xFF] ^ t[5][(crc >> 16) & 0xFF] ^
              t[4][(crc >> 24) & 0xFF] ^ t[3][(crc >> 32) & 0xFF] ^ t[2][(crc >> 40) & 0xFF] ^
              t[1][(crc >> 48) & 0xFF] ^ t[0][crc >> 56];
        data += 8;
        len -= 8;
    }
    while (len--) crc = kTables.t[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
    return ~crc;
}
