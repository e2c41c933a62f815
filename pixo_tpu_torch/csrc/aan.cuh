// Forward float AAN 8x8 DCT butterfly, shared by the coefficient kernel and
// the standalone DCT entry point (coeffs.cu).
//
// Same operation order as the JAX package's ops/dct.py::_aan_1d (and the
// reference's aan_dct_1d, pixo src/jpeg/dct.rs:588-700): rows then columns,
// 5 multiplies and 29 adds per 1-D pass, then the post-scale S[k]. Every
// step is an explicitly rounded intrinsic (__fadd_rn, __fsub_rn, __fmul_rn),
// which nvcc never contracts into a fused multiply-add; the library is also
// built with -fmad=false. One rounding fewer anywhere changes the quantized
// coefficients and so the bytes of the JPEG.
#pragma once

#include <cuda_runtime.h>

namespace pixo {

// The f32 constants of ops/dct.py, written as hex literals so that no
// decimal-to-float rounding can differ from numpy's.
constexpr float kA1 = 0x1.6a09e6p-1f;  // 1/sqrt(2)
constexpr float kA2 = 0x1.1517a8p-1f;  // 0.5411961
constexpr float kA3 = kA1;
constexpr float kA4 = 0x1.4e7ae8p+0f;  // 1.3065629
constexpr float kA5 = 0x1.87de2ap-2f;  // 0.38268343

constexpr float kS0 = 0x1.6a09e8p-2f;  // 0.3535534
constexpr float kS1 = 0x1.0503eep-2f;  // 0.2548978
constexpr float kS2 = 0x1.1517acp-2f;  // 0.2705981
constexpr float kS3 = 0x1.33e378p-2f;  // 0.3006724
constexpr float kS4 = 0x1.6a09e8p-2f;  // 0.3535534
constexpr float kS5 = 0x1.ccc9aep-2f;  // 0.4499881
constexpr float kS6 = 0x1.4e7aeap-1f;  // 0.6532815
constexpr float kS7 = 0x1.480d9ep+0f;  // 1.2814578

// One 1-D pass over v[0], v[STRIDE], ..., v[7 * STRIDE], in place. Called
// with compile-time offsets only, so the block stays in registers.
template <int STRIDE>
__device__ __forceinline__ void aan_1d(float* v) {
  const float d0 = v[0 * STRIDE], d1 = v[1 * STRIDE], d2 = v[2 * STRIDE], d3 = v[3 * STRIDE];
  const float d4 = v[4 * STRIDE], d5 = v[5 * STRIDE], d6 = v[6 * STRIDE], d7 = v[7 * STRIDE];

  const float tmp0 = __fadd_rn(d0, d7);
  const float tmp7 = __fsub_rn(d0, d7);
  const float tmp1 = __fadd_rn(d1, d6);
  const float tmp6 = __fsub_rn(d1, d6);
  const float tmp2 = __fadd_rn(d2, d5);
  const float tmp5 = __fsub_rn(d2, d5);
  const float tmp3 = __fadd_rn(d3, d4);
  const float tmp4 = __fsub_rn(d3, d4);

  const float tmp10 = __fadd_rn(tmp0, tmp3);
  const float tmp13 = __fsub_rn(tmp0, tmp3);
  const float tmp11 = __fadd_rn(tmp1, tmp2);
  const float tmp12 = __fsub_rn(tmp1, tmp2);

  const float o0 = __fadd_rn(tmp10, tmp11);
  const float o4 = __fsub_rn(tmp10, tmp11);

  const float z1 = __fmul_rn(__fadd_rn(tmp12, tmp13), kA1);
  const float o2 = __fadd_rn(tmp13, z1);
  const float o6 = __fsub_rn(tmp13, z1);

  const float t10 = __fadd_rn(tmp4, tmp5);
  const float t11 = __fadd_rn(tmp5, tmp6);
  const float t12 = __fadd_rn(tmp6, tmp7);

  const float z5 = __fmul_rn(__fsub_rn(t10, t12), kA5);
  const float z2 = __fadd_rn(__fmul_rn(t10, kA2), z5);
  const float z4 = __fadd_rn(__fmul_rn(t12, kA4), z5);
  const float z3 = __fmul_rn(t11, kA3);

  const float z11 = __fadd_rn(tmp7, z3);
  const float z13 = __fsub_rn(tmp7, z3);

  const float o5 = __fadd_rn(z13, z2);
  const float o3 = __fsub_rn(z13, z2);
  const float o1 = __fadd_rn(z11, z4);
  const float o7 = __fsub_rn(z11, z4);

  v[0 * STRIDE] = __fmul_rn(o0, kS0);
  v[1 * STRIDE] = __fmul_rn(o1, kS1);
  v[2 * STRIDE] = __fmul_rn(o2, kS2);
  v[3 * STRIDE] = __fmul_rn(o3, kS3);
  v[4 * STRIDE] = __fmul_rn(o4, kS4);
  v[5 * STRIDE] = __fmul_rn(o5, kS5);
  v[6 * STRIDE] = __fmul_rn(o6, kS6);
  v[7 * STRIDE] = __fmul_rn(o7, kS7);
}

// 2-D DCT of one row-major 8x8 block x[64], in place: rows, then columns.
__device__ __forceinline__ void dct8x8_aan(float* x) {
#pragma unroll
  for (int r = 0; r < 8; ++r) aan_1d<1>(x + 8 * r);
#pragma unroll
  for (int c = 0; c < 8; ++c) aan_1d<8>(x + c);
}

}  // namespace pixo
