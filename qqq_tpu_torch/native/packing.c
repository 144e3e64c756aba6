/* Host-side INT4 packing kernels for checkpoint conversion.
 *
 * The port's own copy of qqq_tpu/native/packing.c.  Converting a 70B-class
 * checkpoint moves ~35 G nibbles through the packing layout
 * (core/packing.py); the NumPy path makes ~6 full passes over int32
 * temporaries.  These single-pass OpenMP loops do the same transforms at
 * memory speed.  Built on demand by native/build.py (cc -O3 -fopenmp) and
 * loaded with ctypes; the NumPy twin serves where no C compiler exists.
 *
 * Layout contract (must match core/packing.py exactly, verified by
 * tests/test_torch_eval.py against the JAX package's packer):
 *   word row 16b + r, little-endian byte i:
 *     low  nibble = code k = 128b + 4r + i
 *     high nibble = code k = 128b + 64 + 4r + i
 *   codes stored offset-unsigned (q + 8).
 */

#include <stdint.h>

#ifdef _OPENMP
#include <omp.h>
#endif

/* q: (K, N) signed int4 codes in [-8, 7]; out: (K/8, N) int32 words. */
void pack_int4(const int8_t *q, int32_t *out, long K, long N) {
    long n_blocks = K / 128;
#pragma omp parallel for schedule(static)
    for (long b = 0; b < n_blocks; ++b) {
        const int8_t *lo_base = q + (b * 128) * N;      /* k = 128b + ...   */
        const int8_t *hi_base = q + (b * 128 + 64) * N; /* k = 128b + 64 +. */
        for (long r = 0; r < 16; ++r) {
            int32_t *dst = out + (b * 16 + r) * N;
            for (long n = 0; n < N; ++n) {
                uint32_t word = 0;
                for (long i = 0; i < 4; ++i) {
                    uint32_t lo = (uint32_t)(lo_base[(4 * r + i) * N + n] + 8) & 0xF;
                    uint32_t hi = (uint32_t)(hi_base[(4 * r + i) * N + n] + 8) & 0xF;
                    word |= (lo | (hi << 4)) << (8 * i);
                }
                dst[n] = (int32_t)word;
            }
        }
    }
}

/* packed: (K/8, N) int32; q: (K, N) signed int4 codes out. */
void unpack_int4(const int32_t *packed, int8_t *q, long K, long N) {
    long n_blocks = K / 128;
#pragma omp parallel for schedule(static)
    for (long b = 0; b < n_blocks; ++b) {
        int8_t *lo_base = q + (b * 128) * N;
        int8_t *hi_base = q + (b * 128 + 64) * N;
        for (long r = 0; r < 16; ++r) {
            const int32_t *src = packed + (b * 16 + r) * N;
            for (long n = 0; n < N; ++n) {
                uint32_t word = (uint32_t)src[n];
                for (long i = 0; i < 4; ++i) {
                    uint32_t byte = (word >> (8 * i)) & 0xFF;
                    lo_base[(4 * r + i) * N + n] = (int8_t)((byte & 0xF) - 8);
                    hi_base[(4 * r + i) * N + n] = (int8_t)((byte >> 4) - 8);
                }
            }
        }
    }
}
