// Separable Lanczos3 resize kernel for Hopper (sm_90a).
//
// Replaces the jit-compiled _lanczos_pass pair of the JAX package's
// ops/resize_kernels.py (:154, under resize_lanczos3_batch :146); that
// package has no Pallas kernel for the resize and leaves the two passes to
// XLA as a lax.scan over the taps. For [batch, h, w, c] uint8 images and the
// tap tables of lanczos_taps for each axis (starts [dst] int32, weights
// [dst, k] f32, windows right-padded with zero weights) it computes the
// horizontal pass into a uint8 intermediate [batch, h, dst_w, c], then the
// vertical pass into [batch, dst_h, dst_w, c].
//
// What decides the bytes, and so the design: every output is a serial f32
// accumulation acc = acc + px * w over its window's taps in index order from
// +0.0, the source index clamped to the axis, then rounded half away from
// zero (roundf), clamped to 0..255 and stored as uint8; the intermediate
// between the passes is uint8 too (pixo resize.rs:459-513). A product with
// the dense weight matrix, a tree reduction over the taps or an FMA would
// round elsewhere, so one thread walks the taps of its outputs in order and
// the file is built with -fmad=false (the multiply and the add are written
// as __fmul_rn and __fadd_rn as well). A padded zero-weight tap adds +0.0,
// which changes no sum, so every window runs its table's full k taps.
//
// What bounds it on the card: memory, by the bytes it must move (the source
// read once, the result written once); the taps' arithmetic is 2 f32
// operations a tap a sample, far under the f32 rate. The intermediate
// (batch * h * dst_w * c bytes, written by the first launch and read by the
// second) is this design's own traffic on top of the bound; it stays in the
// 50 MB L2 for a chunk of thumbnails. Two launches on one stream:
//
// - horizontal: a thread an output pixel, all its channels, so the taps'
//   index and weight are read once a pixel; neighbouring threads take
//   neighbouring output pixels of one row, whose windows overlap, so the
//   source row's bytes come through L1 and the stores of a warp are one
//   contiguous run;
// - vertical: a thread four consecutive bytes of an output row (one where
//   the row's length or an alignment does not allow four), so a warp reads
//   128 contiguous bytes of each source row of its window and the weight is
//   one broadcast load a tap.

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kResizeThreads = 256;

__device__ __forceinline__ uint8_t round_clamp_u8(float acc) {
  return static_cast<uint8_t>(fminf(fmaxf(roundf(acc), 0.0f), 255.0f));
}

__device__ __forceinline__ float tap(float acc, uint32_t px, float w) {
  return __fadd_rn(acc, __fmul_rn(static_cast<float>(px), w));
}

// src: [rows, w, C] (rows = batch * h); out: [rows, dw, C].
template <int C>
__global__ void __launch_bounds__(kResizeThreads) resize_lanczos3_h_kernel(
    const uint8_t* __restrict__ src, int64_t rows, int w, const int32_t* __restrict__ starts,
    const float* __restrict__ weights, int k, int dw, uint8_t* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kResizeThreads + threadIdx.x;
  if (t >= rows * dw) return;
  const int dx = static_cast<int>(t % dw);
  const uint8_t* row = src + (t / dw) * static_cast<int64_t>(w) * C;
  const float* wr = weights + static_cast<int64_t>(dx) * k;
  const int start = __ldg(starts + dx);
  float acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  for (int i = 0; i < k; ++i) {
    const int idx = min(max(start + i, 0), w - 1);
    const float wv = __ldg(wr + i);
    const uint8_t* p = row + static_cast<int64_t>(idx) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = tap(acc[c], p[c], wv);
  }
  uint8_t* o = out + t * C;
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = round_clamp_u8(acc[c]);
}

// src: [batch, h, n] (n = dw * c bytes a row); out: [batch, dh, n]. A thread
// takes V consecutive bytes of an output row; V = 4 needs n % 4 == 0 and both
// buffers 4-byte aligned.
template <int V>
__global__ void __launch_bounds__(kResizeThreads) resize_lanczos3_v_kernel(
    const uint8_t* __restrict__ src, int64_t batch, int h, int64_t n,
    const int32_t* __restrict__ starts, const float* __restrict__ weights, int k, int dh,
    uint8_t* __restrict__ out) {
  const int64_t per_row = n / V;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kResizeThreads + threadIdx.x;
  if (t >= batch * dh * per_row) return;
  const int64_t col = (t % per_row) * V;
  const int64_t r = t / per_row;
  const int dy = static_cast<int>(r % dh);
  const uint8_t* base = src + (r / dh) * h * n + col;
  const float* wr = weights + static_cast<int64_t>(dy) * k;
  const int start = __ldg(starts + dy);
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;
  for (int i = 0; i < k; ++i) {
    const int idx = min(max(start + i, 0), h - 1);
    const float wv = __ldg(wr + i);
    const uint8_t* p = base + static_cast<int64_t>(idx) * n;
    if (V == 4) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = tap(acc[v], (word >> (8 * v)) & 0xFFu, wv);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = tap(acc[v], p[v], wv);
    }
  }
  uint8_t* o = out + r * n + col;
  if (V == 4) {
    uint32_t word = 0;
#pragma unroll
    for (int v = 0; v < V; ++v) word |= static_cast<uint32_t>(round_clamp_u8(acc[v])) << (8 * v);
    *reinterpret_cast<uint32_t*>(o) = word;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = round_clamp_u8(acc[v]);
  }
}

inline bool grid_for(int64_t threads, unsigned* blocks) {
  const int64_t b = (threads + kResizeThreads - 1) / kResizeThreads;
  if (b < 1 || b > 0x7FFFFFFF) return false;
  *blocks = static_cast<unsigned>(b);
  return true;
}

}  // namespace pixo

extern "C" {

// src: [batch, h, w, c] uint8 on the device, c 1 to 4. sx [dw] int32 and wx
// [dw, kx] f32, sy [dh] int32 and wy [dh, ky] f32: the tap tables of each
// axis, on the device. tmp: [batch, h, dw, c] uint8 scratch; out: [batch, dh,
// dw, c] uint8; both on the device. Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for a shape it does not take.
int pixo_resize_lanczos3(const void* src, int64_t batch, int64_t h, int64_t w, int32_t c,
                         const void* sx, const void* wx, int32_t kx, int64_t dw, const void* sy,
                         const void* wy, int32_t ky, int64_t dh, void* tmp, void* out,
                         void* stream) {
  using namespace pixo;
  const int64_t limit = 1 << 24;  // resize.py's MAX_RESIZE_DIMENSION: indices stay in int32
  if (batch < 1 || h < 1 || w < 1 || dw < 1 || dh < 1 || kx < 1 || ky < 1 || c < 1 || c > 4 ||
      h > limit || w > limit || dw > limit || dh > limit)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  uint8_t* mid = static_cast<uint8_t*>(tmp);
  uint8_t* res = static_cast<uint8_t*>(out);
  const int32_t* sxp = static_cast<const int32_t*>(sx);
  const int32_t* syp = static_cast<const int32_t*>(sy);
  const float* wxp = static_cast<const float*>(wx);
  const float* wyp = static_cast<const float*>(wy);

  unsigned blocks;
  const int64_t rows = batch * h;
  if (!grid_for(rows * dw, &blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const int wi = static_cast<int>(w), dwi = static_cast<int>(dw);
  switch (c) {
    case 1:
      resize_lanczos3_h_kernel<1><<<blocks, kResizeThreads, 0, s>>>(in, rows, wi, sxp, wxp, kx, dwi, mid);
      break;
    case 2:
      resize_lanczos3_h_kernel<2><<<blocks, kResizeThreads, 0, s>>>(in, rows, wi, sxp, wxp, kx, dwi, mid);
      break;
    case 3:
      resize_lanczos3_h_kernel<3><<<blocks, kResizeThreads, 0, s>>>(in, rows, wi, sxp, wxp, kx, dwi, mid);
      break;
    default:
      resize_lanczos3_h_kernel<4><<<blocks, kResizeThreads, 0, s>>>(in, rows, wi, sxp, wxp, kx, dwi, mid);
      break;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int64_t n = dw * c;
  const bool words = n % 4 == 0 && reinterpret_cast<uintptr_t>(mid) % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(res) % 4 == 0;
  if (!grid_for(batch * dh * (words ? n / 4 : n), &blocks))
    return static_cast<int>(cudaErrorInvalidValue);
  const int hi = static_cast<int>(h), dhi = static_cast<int>(dh);
  if (words)
    resize_lanczos3_v_kernel<4><<<blocks, kResizeThreads, 0, s>>>(mid, batch, hi, n, syp, wyp, ky, dhi, res);
  else
    resize_lanczos3_v_kernel<1><<<blocks, kResizeThreads, 0, s>>>(mid, batch, hi, n, syp, wyp, ky, dhi, res);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
