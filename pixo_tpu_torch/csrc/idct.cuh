// jidctint 8x8 integer inverse DCT, shared by the decode-tail kernel and the
// standalone IDCT entry point (idct.cu).
//
// The algebra of the JAX package's ops/jpeg_decode.py::_idct_pass and
// idct8x8_int (CONST_BITS 13, PASS1_BITS 2): a column pass descaled by 11
// bits, a row pass descaled by 18 bits, +128 and a clamp to [0, 255]. The
// reference runs it in int32 and lets every product and sum wrap modulo
// 2**32, which dequantized coefficients of a corrupt or hostile stream do
// (an int16 coefficient times a 16-bit table entry, times 25172, exceeds
// 2**31). Signed overflow is undefined in C++, so every product, sum and
// `<< 13` here is taken in uint32_t, which wraps by definition, and the
// value is cast back to int32_t only for the descale's `>>`: nvcc shifts a
// negative signed int arithmetically, as jnp.int32's `>>` does.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kIdctPass1Shift = 13 - 2;         // CONST_BITS - PASS1_BITS
constexpr int kIdctPass2Shift = 13 + 2 + 3;     // CONST_BITS + PASS1_BITS + 3
constexpr uint32_t kIdctRound1 = 1u << (kIdctPass1Shift - 1);
constexpr uint32_t kIdctRound2 = 1u << (kIdctPass2Shift - 1);

// One 1-D butterfly over d[0], d[S], ..., d[7 * S], mod 2**32, with the
// FIX_* constants of ops/jpeg_decode.py (negated ones as uint32 residues).
// It writes its eight outputs before the descale to o[0], o[T], ...,
// o[7 * T]. Called with compile-time offsets only, so the block stays in
// registers.
template <int S, int T>
__device__ __forceinline__ void idct_butterfly(const uint32_t* d, uint32_t* o) {
  const uint32_t d0 = d[0], d1 = d[S], d2 = d[2 * S], d3 = d[3 * S];
  const uint32_t d4 = d[4 * S], d5 = d[5 * S], d6 = d[6 * S], d7 = d[7 * S];

  // Even part
  uint32_t z1 = (d2 + d6) * 4433u;             // FIX_0_541196100
  const uint32_t tmp2 = z1 - d6 * 15137u;      // FIX_1_847759065
  const uint32_t tmp3 = z1 + d2 * 6270u;       // FIX_0_765366865
  const uint32_t tmp0 = (d0 + d4) << 13;
  const uint32_t tmp1 = (d0 - d4) << 13;
  const uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  const uint32_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

  // Odd part
  z1 = d7 + d1;
  uint32_t z2 = d5 + d3, z3 = d7 + d3, z4 = d5 + d1;
  const uint32_t z5 = (z3 + z4) * 9633u;       // FIX_1_175875602
  uint32_t t0 = d7 * 2446u;                    // FIX_0_298631336
  uint32_t t1 = d5 * 16819u;                   // FIX_2_053119869
  uint32_t t2 = d3 * 25172u;                   // FIX_3_072711026
  uint32_t t3 = d1 * 12299u;                   // FIX_1_501321110
  z1 *= (0u - 7373u);                 // FIX_0_899976223
  z2 *= (0u - 20995u);                // FIX_2_562915447
  z3 = z3 * (0u - 16069u) + z5;       // FIX_1_961570560
  z4 = z4 * (0u - 3196u) + z5;        // FIX_0_390180644
  t0 += z1 + z3;
  t1 += z2 + z4;
  t2 += z2 + z3;
  t3 += z1 + z4;

  o[0] = tmp10 + t3;
  o[T] = tmp11 + t2;
  o[2 * T] = tmp12 + t1;
  o[3 * T] = tmp13 + t0;
  o[4 * T] = tmp13 - t0;
  o[5 * T] = tmp12 - t1;
  o[6 * T] = tmp11 - t2;
  o[7 * T] = tmp10 - t3;
}

// (v + round) >> shift, the add wrapping, the shift arithmetic.
template <int SHIFT, uint32_t ROUND>
__device__ __forceinline__ int32_t idct_descale(uint32_t v) {
  return static_cast<int32_t>(v + ROUND) >> SHIFT;
}

// x: one block of natural-order dequantized coefficients (int32 values as
// their uint32 residues), row-major; out: its 64 pixels, row-major.
__device__ __forceinline__ void idct8x8_jidctint(const uint32_t* x, uint8_t* out) {
  uint32_t o[64], ws[64];
#pragma unroll
  for (int c = 0; c < 8; ++c) idct_butterfly<8, 8>(x + c, o + c);  // columns
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    ws[i] = static_cast<uint32_t>(idct_descale<kIdctPass1Shift, kIdctRound1>(o[i]));
  }
#pragma unroll
  for (int r = 0; r < 8; ++r) idct_butterfly<1, 1>(ws + 8 * r, o + 8 * r);  // rows
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int32_t v = idct_descale<kIdctPass2Shift, kIdctRound2>(o[i]) + 128;
    out[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

}  // namespace pixo
