// Native AES-128-CTR block generator for the CSPRNG hot path (client-side
// keygen/encryption mask streams).  Equivalent of the
// reference's hardware AES backends (ref: concrete-csprng/src/generators/
// implem/{aesni,aarch64}/block_cipher.rs).  Uses AES-NI when the CPU has it,
// otherwise a portable table-based fallback.  Counters are encrypted as their
// little-endian 16-byte encoding.
//
// Built at first use by tfhe_tpu_torch/prng/aes.py into tfhe_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <cstddef>

#if defined(__x86_64__)
#include <cpuid.h>
#include <wmmintrin.h>
#define HAVE_AESNI_COMPILED 1
#endif

namespace {

// ---------------- portable AES-128 ----------------

const uint8_t SBOX[256] = {
    0x63,0x7c,0x77,0x7b,0xf2,0x6b,0x6f,0xc5,0x30,0x01,0x67,0x2b,0xfe,0xd7,0xab,0x76,
    0xca,0x82,0xc9,0x7d,0xfa,0x59,0x47,0xf0,0xad,0xd4,0xa2,0xaf,0x9c,0xa4,0x72,0xc0,
    0xb7,0xfd,0x93,0x26,0x36,0x3f,0xf7,0xcc,0x34,0xa5,0xe5,0xf1,0x71,0xd8,0x31,0x15,
    0x04,0xc7,0x23,0xc3,0x18,0x96,0x05,0x9a,0x07,0x12,0x80,0xe2,0xeb,0x27,0xb2,0x75,
    0x09,0x83,0x2c,0x1a,0x1b,0x6e,0x5a,0xa0,0x52,0x3b,0xd6,0xb3,0x29,0xe3,0x2f,0x84,
    0x53,0xd1,0x00,0xed,0x20,0xfc,0xb1,0x5b,0x6a,0xcb,0xbe,0x39,0x4a,0x4c,0x58,0xcf,
    0xd0,0xef,0xaa,0xfb,0x43,0x4d,0x33,0x85,0x45,0xf9,0x02,0x7f,0x50,0x3c,0x9f,0xa8,
    0x51,0xa3,0x40,0x8f,0x92,0x9d,0x38,0xf5,0xbc,0xb6,0xda,0x21,0x10,0xff,0xf3,0xd2,
    0xcd,0x0c,0x13,0xec,0x5f,0x97,0x44,0x17,0xc4,0xa7,0x7e,0x3d,0x64,0x5d,0x19,0x73,
    0x60,0x81,0x4f,0xdc,0x22,0x2a,0x90,0x88,0x46,0xee,0xb8,0x14,0xde,0x5e,0x0b,0xdb,
    0xe0,0x32,0x3a,0x0a,0x49,0x06,0x24,0x5c,0xc2,0xd3,0xac,0x62,0x91,0x95,0xe4,0x79,
    0xe7,0xc8,0x37,0x6d,0x8d,0xd5,0x4e,0xa9,0x6c,0x56,0xf4,0xea,0x65,0x7a,0xae,0x08,
    0xba,0x78,0x25,0x2e,0x1c,0xa6,0xb4,0xc6,0xe8,0xdd,0x74,0x1f,0x4b,0xbd,0x8b,0x8a,
    0x70,0x3e,0xb5,0x66,0x48,0x03,0xf6,0x0e,0x61,0x35,0x57,0xb9,0x86,0xc1,0x1d,0x9e,
    0xe1,0xf8,0x98,0x11,0x69,0xd9,0x8e,0x94,0x9b,0x1e,0x87,0xe9,0xce,0x55,0x28,0xdf,
    0x8c,0xa1,0x89,0x0d,0xbf,0xe6,0x42,0x68,0x41,0x99,0x2d,0x0f,0xb0,0x54,0xbb,0x16,
};

const uint8_t RCON[10] = {0x01,0x02,0x04,0x08,0x10,0x20,0x40,0x80,0x1b,0x36};

inline uint8_t xtime(uint8_t x) { return (uint8_t)((x << 1) ^ ((x >> 7) * 0x1b)); }

void key_expansion_soft(const uint8_t key[16], uint8_t rk[11][16]) {
  std::memcpy(rk[0], key, 16);
  uint8_t w[44][4];
  std::memcpy(w, key, 16);
  for (int i = 4; i < 44; i++) {
    uint8_t t[4] = {w[i-1][0], w[i-1][1], w[i-1][2], w[i-1][3]};
    if (i % 4 == 0) {
      uint8_t tmp = t[0];
      t[0] = (uint8_t)(SBOX[t[1]] ^ RCON[i/4 - 1]);
      t[1] = SBOX[t[2]]; t[2] = SBOX[t[3]]; t[3] = SBOX[tmp];
    }
    for (int j = 0; j < 4; j++) w[i][j] = (uint8_t)(w[i-4][j] ^ t[j]);
  }
  std::memcpy(rk, w, 176);
}

void encrypt_block_soft(const uint8_t rk[11][16], const uint8_t in[16], uint8_t out[16]) {
  uint8_t s[16];
  for (int i = 0; i < 16; i++) s[i] = (uint8_t)(in[i] ^ rk[0][i]);
  for (int rnd = 1; rnd <= 10; rnd++) {
    uint8_t t[16];
    // SubBytes + ShiftRows (column-major layout: byte i -> row i%4, col i/4)
    static const int SHIFT[16] = {0,5,10,15,4,9,14,3,8,13,2,7,12,1,6,11};
    for (int i = 0; i < 16; i++) t[i] = SBOX[s[SHIFT[i]]];
    if (rnd < 10) {
      for (int c = 0; c < 4; c++) {
        uint8_t a0=t[4*c],a1=t[4*c+1],a2=t[4*c+2],a3=t[4*c+3];
        uint8_t x = (uint8_t)(a0^a1^a2^a3);
        s[4*c]   = (uint8_t)(a0 ^ x ^ xtime((uint8_t)(a0^a1)));
        s[4*c+1] = (uint8_t)(a1 ^ x ^ xtime((uint8_t)(a1^a2)));
        s[4*c+2] = (uint8_t)(a2 ^ x ^ xtime((uint8_t)(a2^a3)));
        s[4*c+3] = (uint8_t)(a3 ^ x ^ xtime((uint8_t)(a3^a0)));
      }
      for (int i = 0; i < 16; i++) s[i] ^= rk[rnd][i];
    } else {
      for (int i = 0; i < 16; i++) s[i] = (uint8_t)(t[i] ^ rk[10][i]);
    }
  }
  std::memcpy(out, s, 16);
}

#ifdef HAVE_AESNI_COMPILED

bool cpu_has_aesni() {
  unsigned a, b, c, d;
  if (!__get_cpuid(1, &a, &b, &c, &d)) return false;
  return (c & bit_AES) != 0;
}

__attribute__((target("aes,sse2")))
inline __m128i aes128_keygen_assist(__m128i temp1, __m128i temp2) {
  __m128i temp3;
  temp2 = _mm_shuffle_epi32(temp2, 0xff);
  temp3 = _mm_slli_si128(temp1, 0x4);
  temp1 = _mm_xor_si128(temp1, temp3);
  temp3 = _mm_slli_si128(temp3, 0x4);
  temp1 = _mm_xor_si128(temp1, temp3);
  temp3 = _mm_slli_si128(temp3, 0x4);
  temp1 = _mm_xor_si128(temp1, temp3);
  return _mm_xor_si128(temp1, temp2);
}

__attribute__((target("aes,sse2")))
void key_expansion_ni(const uint8_t key[16], __m128i rk[11]) {
  rk[0] = _mm_loadu_si128((const __m128i*)key);
  rk[1] = aes128_keygen_assist(rk[0], _mm_aeskeygenassist_si128(rk[0], 0x01));
  rk[2] = aes128_keygen_assist(rk[1], _mm_aeskeygenassist_si128(rk[1], 0x02));
  rk[3] = aes128_keygen_assist(rk[2], _mm_aeskeygenassist_si128(rk[2], 0x04));
  rk[4] = aes128_keygen_assist(rk[3], _mm_aeskeygenassist_si128(rk[3], 0x08));
  rk[5] = aes128_keygen_assist(rk[4], _mm_aeskeygenassist_si128(rk[4], 0x10));
  rk[6] = aes128_keygen_assist(rk[5], _mm_aeskeygenassist_si128(rk[5], 0x20));
  rk[7] = aes128_keygen_assist(rk[6], _mm_aeskeygenassist_si128(rk[6], 0x40));
  rk[8] = aes128_keygen_assist(rk[7], _mm_aeskeygenassist_si128(rk[7], 0x80));
  rk[9] = aes128_keygen_assist(rk[8], _mm_aeskeygenassist_si128(rk[8], 0x1b));
  rk[10] = aes128_keygen_assist(rk[9], _mm_aeskeygenassist_si128(rk[9], 0x36));
}

__attribute__((target("aes,sse2")))
void ctr_blocks_ni(const uint8_t key[16], uint64_t lo, uint64_t hi,
                   size_t n, uint8_t* out) {
  __m128i rk[11];
  key_expansion_ni(key, rk);
  // 8-way interleave: aesenc latency (~4 cycles) is hidden by keeping 8
  // independent counter blocks in flight, matching the reference's
  // aes_encrypt_many 8-block pipeline (ref: concrete-csprng aesni
  // block_cipher.rs aes_encrypt_many).
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    __m128i b[8];
    for (int k = 0; k < 8; k++) {
      alignas(16) uint64_t ctr[2] = {lo, hi};
      b[k] = _mm_xor_si128(_mm_load_si128((const __m128i*)ctr), rk[0]);
      lo++; if (lo == 0) hi++;
    }
    for (int r = 1; r < 10; r++)
      for (int k = 0; k < 8; k++) b[k] = _mm_aesenc_si128(b[k], rk[r]);
    for (int k = 0; k < 8; k++) {
      b[k] = _mm_aesenclast_si128(b[k], rk[10]);
      _mm_storeu_si128((__m128i*)(out + 16 * (i + k)), b[k]);
    }
  }
  for (; i < n; i++) {
    alignas(16) uint64_t ctr[2] = {lo, hi};
    __m128i block = _mm_load_si128((const __m128i*)ctr);
    block = _mm_xor_si128(block, rk[0]);
    for (int r = 1; r < 10; r++) block = _mm_aesenc_si128(block, rk[r]);
    block = _mm_aesenclast_si128(block, rk[10]);
    _mm_storeu_si128((__m128i*)(out + 16 * i), block);
    lo++;
    if (lo == 0) hi++;
  }
}
#endif

}  // namespace

extern "C" void aes128_ctr_blocks(const char* key, uint64_t start_lo,
                                  uint64_t start_hi, size_t n, char* out) {
#ifdef HAVE_AESNI_COMPILED
  static const bool has_ni = cpu_has_aesni();
  if (has_ni) {
    ctr_blocks_ni((const uint8_t*)key, start_lo, start_hi, n, (uint8_t*)out);
    return;
  }
#endif
  uint8_t rk[11][16];
  key_expansion_soft((const uint8_t*)key, rk);
  uint64_t lo = start_lo, hi = start_hi;
  for (size_t i = 0; i < n; i++) {
    uint8_t in[16];
    std::memcpy(in, &lo, 8);
    std::memcpy(in + 8, &hi, 8);
    encrypt_block_soft(rk, in, (uint8_t*)out + 16 * i);
    lo++;
    if (lo == 0) hi++;
  }
}
