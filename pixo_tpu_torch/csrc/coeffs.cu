// JPEG coefficient kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel dct8x8_aan_pallas (the JAX package's
// ops/pallas_kernels.py:169), widened to the whole per-block chain of
// jpeg/encoder.py::_device_coeffs: clamp-pad -> fixed-point YCbCr -> chroma
// average (4:2:0, 4:2:2) -> level shift -> AAN DCT rows then columns ->
// q = dct / table -> round half away from zero -> int16 -> zigzag. It reads
// [B, H, W, C] uint8 pixels and writes [B, nblocks, 64] int16 zigzag blocks
// in scan order, the layout the host packer and the compaction kernel read.
//
// What bounds it on the card: memory. Per pixel it moves about 3 bytes in
// (1 for gray) and 2 x 64 / 64 = 2 bytes per coefficient out, against some
// 20 float operations per coefficient: far below the H100's
// operations-per-byte balance. Design: one thread per 8x8 output block,
// working in registers (the block, the butterfly, the quantizer), with the
// pixel reads left to the L1/L2 caches: threads of one MCU read the same
// source rows. The quantization tables travel by value in the kernel's
// parameters, so a launch needs no table copy to the device. Each thread
// writes its 128-byte zigzag row with eight 16-byte stores.
//
// The second entry point, pixo_dct8x8_aan, is the standalone [N, 8, 8] f32
// DCT: the direct counterpart of dct8x8_aan_pallas, sharing the butterfly.

#include <cstdint>
#include <cstring>
#include <utility>

#include <cuda_runtime.h>

#include "aan.cuh"

namespace pixo {

struct QTables {
  float lum[64];  // natural order
  float chrom[64];
};

enum Mode { kGray = 0, k444 = 1, k420 = 2, k422 = 3 };

struct Image {
  const uint8_t* px;  // [h, w, c] of one image
  int64_t h, w;
  int c;

  __device__ __forceinline__ const uint8_t* at(int64_t y, int64_t x) const {
    y = y < h ? y : h - 1;  // clamp-pad: repeat the last row and column
    x = x < w ? x : w - 1;
    return px + (y * w + x) * c;
  }
};

// Fixed-point BT.601 (pixo src/color.rs:60-77): arithmetic shift, clamp.
__device__ __forceinline__ int clamp255(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }
__device__ __forceinline__ int luma(const uint8_t* p) {
  return clamp255((77 * p[0] + 150 * p[1] + 29 * p[2] + 128) >> 8);
}
__device__ __forceinline__ int chroma(const uint8_t* p, int which) {  // 0 = Cb, 1 = Cr
  const int r = p[0], g = p[1], b = p[2];
  const int v = which == 0 ? ((-43 * r - 85 * g + 128 * b + 128) >> 8)
                           : ((128 * r - 107 * g - 21 * b + 128) >> 8);
  return clamp255(v + 128);
}

__device__ __forceinline__ float shifted(int v) { return __fsub_rn(static_cast<float>(v), 128.0f); }

// 8x8 block of level-shifted samples whose top-left pixel is (y0, x0);
// comp -1 = the raw first channel (gray), 0 = Y, 1 = Cb, 2 = Cr.
__device__ __forceinline__ void load_full(const Image& im, int64_t y0, int64_t x0, int comp,
                                          float* x) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const uint8_t* p = im.at(y0 + r, x0 + c);
      const int v = comp < 0 ? p[0] : (comp == 0 ? luma(p) : chroma(p, comp - 1));
      x[8 * r + c] = shifted(v);
    }
  }
}

// 4:2:0 chroma block: each sample is the f32 mean of a 2x2 pixel quad of the
// u8 chroma plane, (((a + b) + c) + d) * 0.25 - 128 in that order.
__device__ __forceinline__ void load_420_chroma(const Image& im, int64_t y0, int64_t x0,
                                                int which, float* x) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int64_t y = y0 + 2 * r, xx = x0 + 2 * c;
      const float a = static_cast<float>(chroma(im.at(y, xx), which));
      const float b = static_cast<float>(chroma(im.at(y, xx + 1), which));
      const float cc = static_cast<float>(chroma(im.at(y + 1, xx), which));
      const float d = static_cast<float>(chroma(im.at(y + 1, xx + 1), which));
      const float s = __fadd_rn(__fadd_rn(__fadd_rn(a, b), cc), d);
      x[8 * r + c] = __fsub_rn(__fmul_rn(s, 0.25f), 128.0f);
    }
  }
}

// 4:2:2 chroma block: horizontal pair mean, (a + b) * 0.5 - 128.
__device__ __forceinline__ void load_422_chroma(const Image& im, int64_t y0, int64_t x0,
                                                int which, float* x) {
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float a = static_cast<float>(chroma(im.at(y0 + r, x0 + 2 * c), which));
      const float b = static_cast<float>(chroma(im.at(y0 + r, x0 + 2 * c + 1), which));
      x[8 * r + c] = __fsub_rn(__fmul_rn(__fadd_rn(a, b), 0.5f), 128.0f);
    }
  }
}

__device__ __forceinline__ uint32_t pack2(int16_t lo, int16_t hi) {
  return static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
}

// Writes q (natural order) as one 64-entry zigzag row; Z... is the zigzag
// order, so every register index below is a compile-time constant.
template <int... Z>
__device__ __forceinline__ void store_zigzag(const int16_t* q, int16_t* dst,
                                             std::integer_sequence<int, Z...>) {
  const int16_t zz[64] = {q[Z]...};
  int4* out = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int16_t* s = zz + 8 * k;
    out[k] = make_int4(static_cast<int>(pack2(s[0], s[1])), static_cast<int>(pack2(s[2], s[3])),
                       static_cast<int>(pack2(s[4], s[5])), static_cast<int>(pack2(s[6], s[7])));
  }
}

using Zigzag = std::integer_sequence<
    int, 0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63>;

template <int MODE>
__global__ void __launch_bounds__(128) coeffs_kernel(const uint8_t* __restrict__ imgs,
                                                     int64_t batch, int64_t h, int64_t w, int c,
                                                     int64_t n_mcu_x, int64_t nblocks, QTables qt,
                                                     int16_t* __restrict__ out) {
  constexpr int kBpm = MODE == kGray ? 1 : (MODE == k444 ? 3 : (MODE == k420 ? 6 : 4));
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= batch * nblocks) return;
  const int64_t img_idx = gid / nblocks;
  const int64_t k = gid - img_idx * nblocks;
  const Image im{imgs + img_idx * h * w * c, h, w, c};
  const int64_t mcu = k / kBpm;
  const int comp = static_cast<int>(k - mcu * kBpm);
  const int64_t my = mcu / n_mcu_x, mx = mcu - my * n_mcu_x;

  float x[64];
  bool is_chroma = false;
  if (MODE == kGray) {
    load_full(im, my * 8, mx * 8, -1, x);
  } else if (MODE == k444) {
    load_full(im, my * 8, mx * 8, comp, x);
    is_chroma = comp > 0;
  } else if (MODE == k420) {
    if (comp < 4) {
      load_full(im, my * 16 + (comp >> 1) * 8, mx * 16 + (comp & 1) * 8, 0, x);
    } else {
      load_420_chroma(im, my * 16, mx * 16, comp - 4, x);
      is_chroma = true;
    }
  } else {
    if (comp < 2) {
      load_full(im, my * 8, mx * 16 + comp * 8, 0, x);
    } else {
      load_422_chroma(im, my * 8, mx * 16, comp - 2, x);
      is_chroma = true;
    }
  }

  dct8x8_aan(x);

  int16_t q[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float t = is_chroma ? qt.chrom[i] : qt.lum[i];
    // IEEE division, then roundf: round half away from zero (Rust f32::round)
    q[i] = static_cast<int16_t>(static_cast<int>(roundf(__fdiv_rn(x[i], t))));
  }
  store_zigzag(q, out + gid * 64, Zigzag{});
}

__global__ void __launch_bounds__(128) dct8x8_aan_kernel(const float* __restrict__ in,
                                                         float* __restrict__ out, int64_t n) {
  const int64_t gid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (gid >= n) return;
  const float4* src = reinterpret_cast<const float4*>(in + gid * 64);
  float x[64];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float4 v = src[k];
    x[4 * k] = v.x;
    x[4 * k + 1] = v.y;
    x[4 * k + 2] = v.z;
    x[4 * k + 3] = v.w;
  }
  dct8x8_aan(x);
  float4* dst = reinterpret_cast<float4*>(out + gid * 64);
#pragma unroll
  for (int k = 0; k < 16; ++k) dst[k] = make_float4(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3]);
}

constexpr int kThreads = 128;

inline unsigned grid_for(int64_t n) { return static_cast<unsigned>((n + kThreads - 1) / kThreads); }

}  // namespace pixo

extern "C" {

// imgs: [batch, h, w, c] uint8 on the device (c = 1 for gray, 3 otherwise);
// lum/chrom: natural-order [64] f32 in HOST memory (passed by value to the
// kernel); out: [batch, nblocks, 64] int16 on the device, 16-byte aligned.
// Returns cudaGetLastError() after the launch.
int pixo_coeffs(const uint8_t* imgs, int64_t batch, int64_t h, int64_t w, int32_t c,
                int32_t mode, const float* lum, const float* chrom, int16_t* out,
                void* stream) {
  using namespace pixo;
  QTables qt;
  std::memcpy(qt.lum, lum, sizeof(qt.lum));
  std::memcpy(qt.chrom, chrom, sizeof(qt.chrom));
  int64_t n_mcu_x, n_mcu_y, bpm;
  switch (mode) {
    case kGray: n_mcu_x = (w + 7) / 8; n_mcu_y = (h + 7) / 8; bpm = 1; break;
    case k444: n_mcu_x = (w + 7) / 8; n_mcu_y = (h + 7) / 8; bpm = 3; break;
    case k420: n_mcu_x = (w + 15) / 16; n_mcu_y = (h + 15) / 16; bpm = 6; break;
    case k422: n_mcu_x = (w + 15) / 16; n_mcu_y = (h + 7) / 8; bpm = 4; break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nblocks = n_mcu_x * n_mcu_y * bpm;
  const int64_t total = batch * nblocks;
  if (total <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = grid_for(total);
  switch (mode) {
    case kGray:
      coeffs_kernel<kGray><<<grid, kThreads, 0, s>>>(imgs, batch, h, w, c, n_mcu_x, nblocks, qt, out);
      break;
    case k444:
      coeffs_kernel<k444><<<grid, kThreads, 0, s>>>(imgs, batch, h, w, c, n_mcu_x, nblocks, qt, out);
      break;
    case k420:
      coeffs_kernel<k420><<<grid, kThreads, 0, s>>>(imgs, batch, h, w, c, n_mcu_x, nblocks, qt, out);
      break;
    default:
      coeffs_kernel<k422><<<grid, kThreads, 0, s>>>(imgs, batch, h, w, c, n_mcu_x, nblocks, qt, out);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// in/out: [n, 8, 8] f32 on the device, 16-byte aligned.
int pixo_dct8x8_aan(const float* in, float* out, int64_t n, void* stream) {
  using namespace pixo;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  dct8x8_aan_kernel<<<grid_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

const char* pixo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
