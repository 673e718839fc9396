// CRC-32C (Castagnoli, polynomial 0x82F63B78, reflected) for the recovery
// tier's WAL records and checkpoint bodies (recovery/blockio.py).
//
// Portable slicing-by-8: eight 256-entry tables fold eight input bytes a
// step with table lookups and XORs, no CPU intrinsics.  Bytes are combined
// into words by shifts, so the result does not depend on the host's byte
// order.  qt_crc32c(data, n, crc) continues a run exactly as the Python
// table walk does: crc ^= ~0, fold every byte, return crc ^ ~0.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (cpp/native.py).

#include <cstdint>

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? 0x82F63B78u : 0u);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      for (int s = 1; s < 8; ++s) {
        const uint32_t prev = t[s - 1][i];
        t[s][i] = (prev >> 8) ^ t[0][prev & 0xFFu];
      }
    }
  }
};

const Tables kTables;  // built once, at load

inline uint32_t word_le(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

}  // namespace

extern "C" uint32_t qt_crc32c(const uint8_t* data, int64_t n, uint32_t crc) {
  const auto& t = kTables.t;
  crc ^= 0xFFFFFFFFu;
  const uint8_t* p = data;
  while (n >= 8) {
    const uint32_t lo = crc ^ word_le(p);
    const uint32_t hi = word_le(p + 4);
    crc = t[7][lo & 0xFFu] ^ t[6][(lo >> 8) & 0xFFu] ^
          t[5][(lo >> 16) & 0xFFu] ^ t[4][lo >> 24] ^ t[3][hi & 0xFFu] ^
          t[2][(hi >> 8) & 0xFFu] ^ t[1][(hi >> 16) & 0xFFu] ^ t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) crc = (crc >> 8) ^ t[0][(crc ^ *p++) & 0xFFu];
  return crc ^ 0xFFFFFFFFu;
}
