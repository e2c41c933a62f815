// The redmean distance and the nearest palette entry, shared by the three
// quantization kernels of csrc/quantize.cu.
//
// Counterpart of the JAX package's ops/quantize_device.py::_redmean_dist and
// nearest_palette_device (:46, :60), and of the host library's
// nearest_palette_batch (pixo_tpu/native/core.cpp:1278): pixo
// src/png/mod.rs:1405-1430. Integer arithmetic throughout, so every version
// agrees exactly: the weighted terms stay under 2^28 and the distance under
// 2^20, so int32 cannot overflow.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

// A palette as the kernels keep it in shared memory: one int4 {r, g, b, a}
// an entry (4 KB for 256 entries), so that an entry is one 16-byte load and
// needs no byte extraction. src: [k, 4] uint8 at any byte offset.
__device__ __forceinline__ void load_palette(int4* dst, const uint8_t* src, int k) {
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    dst[i] = make_int4(src[4 * i], src[4 * i + 1], src[4 * i + 2], src[4 * i + 3]);
}

// ((512 + rm) dr^2 + 1024 dg^2 + (767 - rm) db^2) >> 8 + da^2, rm = (r + p.r) >> 1.
__device__ __forceinline__ int redmean(int r, int g, int b, int a, const int4 p) {
  const int dr = r - p.x, dg = g - p.y, db = b - p.z, da = a - p.w;
  const int rm = (r + p.x) >> 1;
  return (((512 + rm) * dr * dr + 1024 * dg * dg + (767 - rm) * db * db) >> 8) + da * da;
}

// The argmin over pal[0, k), k >= 1: a strict-< scan in index order, so ties
// go to the first index (why duplicates of entry 0 padded behind a palette
// never win, png/quantize.py::_pad_palette).
__device__ __forceinline__ int nearest(int r, int g, int b, int a, const int4* pal, int k) {
  int best = 0, best_d = redmean(r, g, b, a, pal[0]);
  for (int i = 1; i < k; ++i) {
    const int d = redmean(r, g, b, a, pal[i]);
    if (d < best_d) {
      best_d = d;
      best = i;
    }
  }
  return best;
}

}  // namespace pixo
