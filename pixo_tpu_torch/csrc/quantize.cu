// The lossy PNG's three kernels for Hopper (sm_90a): weighted k-means
// refinement, the 6-6-6 palette LUT and wavefront Floyd-Steinberg dithering.
//
// They replace the jit functions of the JAX package's ops/quantize_device.py,
// which have no Pallas kernel: kmeans_refine_device (:67), palette_lut_device
// (:118) and dither_fs_device (:138), batched over images as
// png/quantize.py::quantize_batch (:434) calls them. Every kernel is exact
// (integer arithmetic), so each equals its plain PyTorch version
// (ops/quantize_device.py), the JAX functions and the host library
// (core.cpp's palette_lut_build and dither_fs) bit for bit. The redmean
// argmin they share is csrc/redmean.cuh.
//
// pixo_palette_lut: [B, K, 4] palettes -> [B, 262144] LUTs. One thread a grid
// colour, its 8-bit value computed from the index ((v6 << 2) | (v6 >> 4),
// alpha 255), never read; the palette in shared memory, each entry a
// broadcast load. It scans each image's first k_valid entries: the padding
// behind them (png/quantize.py::_pad_palette) copies entry 0 and never wins
// a first-min tie, so a 64-colour palette costs 64 distances a grid colour,
// not 256. Bound by integer issue: 262,144 x k_valid distances an image,
// about 20 integer operations each, against 4.2 MB of output at 16 images.
//
// pixo_kmeans_refine: two iterations, each (1) the argmin of every weighted
// colour over the first k_valid entries, (2) the per-entry sums of colour x
// weight and of weight, (3) new = sums / totals where totals > 0, the old
// entry otherwise. The colours of an image are split over CTAs of 1024 (8
// CTAs an image at M = 8192, so a batch of 16 fills 128 of the 132 SMs);
// a CTA sums in shared memory and adds its sums to global ones with 64-bit
// integer atomics, which are exact in any order; a second small launch
// divides and clears the sums for the next iteration. Colours of weight 0
// (the padding of png/quantize.py::_pad_hist) are skipped: they add nothing.
// Bound by integer issue: M x k_valid distances an image an iteration.
//
// pixo_dither_fs: the error diffusion is a recurrence along each row and
// from row to row, so it runs as the reference's wavefront: step t handles
// pixel (y, t - 2y) of every row, and row y needs only the last three errors
// of row y - 1 as the previous step left them. One CTA an image (rows never
// cross CTAs: blocks cannot wait on each other), rows strided over its
// threads; each row's three last errors (3 channels, int16: an error is an
// integer in [-255, 255]) in one of two buffers, read from one and written
// to the other, one __syncthreads a step. The buffers live in shared memory
// up to ~6,300 rows (36 bytes a row) and in global memory beyond
// (ops/kernels.py::dither_plan). The incoming error is 16 times an integer
// sum (7/16, 1/16, 5/16, 3/16 of integers), so the reference's f32
// floor(clip(px + e, 0, 255)) is the integer clamp((16 px + 16 e) >> 4);
// the LUT (256 KB an image, L2-resident) takes alpha-255 pixels, the direct
// redmean over the palette's first k_valid entries the others. Bound by its critical path: W + 2(H -
// 1) dependent steps, each a LUT load from L2 and a barrier.

#include <cstdint>

#include <cuda_runtime.h>

#include "redmean.cuh"

namespace pixo {

constexpr int kLutSize = 64 * 64 * 64;
constexpr int kLutThreads = 256;
constexpr int kKmeansThreads = 256;
constexpr int kKmeansColors = 1024;  // colours a CTA of the assignment takes
constexpr int kKmeansIterations = 2;  // the reference's refinement (mod.rs:1346-1390)
constexpr int kMaxPalette = 256;
constexpr int kDitherMaxThreads = 1024;
constexpr int kLagShorts = 9;  // a row's state: 3 last errors x 3 channels

// The entries of image b that a scan takes: its k_valid clamped to 1..k, or
// all k without k_valid.
__device__ __forceinline__ int valid_entries(const int32_t* k_valid, int64_t b, int k) {
  return k_valid ? min(max(k_valid[b], 1), k) : k;
}

__global__ void __launch_bounds__(kLutThreads) palette_lut_kernel(const uint8_t* __restrict__ palette,
                                                                  int k, const int32_t* __restrict__ k_valid,
                                                                  uint8_t* __restrict__ lut) {
  __shared__ int4 s_pal[kMaxPalette];
  const int64_t b = blockIdx.y;
  const int kv = valid_entries(k_valid, b, k);
  load_palette(s_pal, palette + b * k * 4, kv);
  __syncthreads();
  const int i = blockIdx.x * kLutThreads + threadIdx.x;
  const int r6 = i >> 12, g6 = (i >> 6) & 63, b6 = i & 63;
  lut[b * kLutSize + i] = static_cast<uint8_t>(
      nearest((r6 << 2) | (r6 >> 4), (g6 << 2) | (g6 >> 4), (b6 << 2) | (b6 >> 4), 255, s_pal, kv));
}

// acc: [B, K, 5] unsigned 64-bit sums (r, g, b, a, weight), zero on entry.
__global__ void __launch_bounds__(kKmeansThreads) kmeans_refine_assign_kernel(
    const uint8_t* __restrict__ palette, int k, const int32_t* __restrict__ k_valid,
    const uint8_t* __restrict__ colors, const int32_t* __restrict__ weights, int64_t m,
    unsigned long long* __restrict__ acc) {
  __shared__ int4 s_pal[kMaxPalette];
  __shared__ unsigned long long s_acc[kMaxPalette * 5];
  const int64_t b = blockIdx.y;
  const int kv = valid_entries(k_valid, b, k);
  load_palette(s_pal, palette + b * k * 4, kv);
  for (int i = threadIdx.x; i < kv * 5; i += kKmeansThreads) s_acc[i] = 0;
  __syncthreads();
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kKmeansColors;
  const int64_t last = first + kKmeansColors < m ? first + kKmeansColors : m;
  for (int64_t i = first + threadIdx.x; i < last; i += kKmeansThreads) {
    const unsigned long long w = static_cast<uint32_t>(weights[b * m + i]);
    if (w == 0) continue;
    const uint8_t* c = colors + 4 * (b * m + i);
    const int r = c[0], g = c[1], bl = c[2], al = c[3];
    unsigned long long* a = s_acc + 5 * nearest(r, g, bl, al, s_pal, kv);
    atomicAdd(a, r * w);
    atomicAdd(a + 1, g * w);
    atomicAdd(a + 2, bl * w);
    atomicAdd(a + 3, al * w);
    atomicAdd(a + 4, w);
  }
  __syncthreads();
  unsigned long long* g = acc + b * k * 5;
  for (int i = threadIdx.x; i < kv * 5; i += kKmeansThreads)
    if (s_acc[i]) atomicAdd(g + i, s_acc[i]);
}

// One CTA an image, a thread an entry: the new entry from the sums, which it
// then clears for the next iteration. out may be palette (in place).
__global__ void __launch_bounds__(kMaxPalette) kmeans_refine_update_kernel(
    const uint8_t* palette, int k, unsigned long long* __restrict__ acc, uint8_t* out) {
  const int64_t b = blockIdx.x;
  const int j = threadIdx.x;
  if (j >= k) return;
  unsigned long long* a = acc + (b * k + j) * 5;
  const int64_t at = 4 * (b * k + j);
  const unsigned long long total = a[4];
  for (int c = 0; c < 4; ++c)
    out[at + c] = total > 0 ? static_cast<uint8_t>(a[c] / total) : palette[at + c];
  for (int c = 0; c < 5; ++c) a[c] = 0;
}

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// lags: two buffers of (h + 1) rows of kLagShorts int16 each, zero on entry
// (buffer row 0 is the zero row above the image; row y is buffer row y + 1):
// dynamic shared memory with kSharedLags, else this image's part of glags.
template <bool kSharedLags>
__global__ void __launch_bounds__(kDitherMaxThreads) dither_fs_kernel(
    const uint8_t* __restrict__ rgba, int64_t h, int64_t w, const uint8_t* __restrict__ palette,
    int k, const int32_t* __restrict__ k_valid, const uint8_t* __restrict__ lut, int16_t* glags,
    uint8_t* __restrict__ out) {
  extern __shared__ int16_t s_lags[];
  __shared__ int4 s_pal[kMaxPalette];
  const int64_t b = blockIdx.x;
  const int64_t buf = (h + 1) * kLagShorts;
  const int kv = valid_entries(k_valid, b, k);
  int16_t* lags = kSharedLags ? s_lags : glags + b * 2 * buf;
  load_palette(s_pal, palette + b * k * 4, k);  // all k: a LUT entry may name any of them
  if (kSharedLags)
    for (int64_t i = threadIdx.x; i < 2 * buf; i += blockDim.x) lags[i] = 0;
  __syncthreads();
  const uint8_t* img = rgba + 4 * b * h * w;
  const uint8_t* tab = lut + b * kLutSize;
  uint8_t* dst = out + b * h * w;
  const int64_t nt = blockDim.x, steps = w + 2 * (h - 1);
  for (int64_t t = 0; t < steps; ++t) {
    const int16_t* cur = lags + (t & 1) * buf;
    int16_t* nxt = lags + ((t + 1) & 1) * buf;
    // the rows with 0 <= x = t - 2y <= w: a pixel for x < w; at x = w the
    // shift that the row below still reads (a zero error past the row's end)
    const int64_t lo = t <= w ? 0 : (t - w + 1) >> 1;
    const int64_t hi = (t >> 1) < h - 1 ? (t >> 1) : h - 1;
    for (int64_t y = lo + ((threadIdx.x - lo) % nt + nt) % nt; y <= hi; y += nt) {
      const int64_t x = t - 2 * y;
      const int16_t* up = cur + y * kLagShorts;  // er(y-1, x+1), er(y-1, x), er(y-1, x-1)
      const int16_t* me = cur + (y + 1) * kLagShorts;  // er(y, x-1), er(y, x-2), er(y, x-3)
      int16_t* nx = nxt + (y + 1) * kLagShorts;
      int e0 = 0, e1 = 0, e2 = 0;
      if (x < w) {
        const uint8_t* px = img + 4 * (y * w + x);
        const int a0 = clamp255((16 * px[0] + 7 * me[0] + up[6] + 5 * up[3] + 3 * up[0]) >> 4);
        const int a1 = clamp255((16 * px[1] + 7 * me[1] + up[7] + 5 * up[4] + 3 * up[1]) >> 4);
        const int a2 = clamp255((16 * px[2] + 7 * me[2] + up[8] + 5 * up[5] + 3 * up[2]) >> 4);
        const int alpha = px[3];
        const int idx = alpha == 255 ? tab[((a0 >> 2) << 12) | ((a1 >> 2) << 6) | (a2 >> 2)]
                                     : nearest(a0, a1, a2, alpha, s_pal, kv);
        dst[y * w + x] = static_cast<uint8_t>(idx);
        const int4 p = s_pal[idx];
        e0 = a0 - p.x;
        e1 = a1 - p.y;
        e2 = a2 - p.z;
      }
      nx[0] = static_cast<int16_t>(e0);
      nx[1] = static_cast<int16_t>(e1);
      nx[2] = static_cast<int16_t>(e2);
      for (int c = 0; c < 6; ++c) nx[3 + c] = me[c];
    }
    __syncthreads();
  }
}

}  // namespace pixo

extern "C" {

// Every tensor may start at any byte offset (the kernels read bytes; the
// weights and k_valid at their int32 alignment).
//
// palette: [batch, k, 4] uint8 on the device, k 1 to 256; k_valid: [batch]
// int32 on the device (the entries each scan takes, clamped to 1..k), or
// null for all k; lut: [batch, 262144] uint8 on the device. Returns
// cudaGetLastError() after the launch.
int pixo_palette_lut(const void* palette, int64_t batch, int32_t k, const void* k_valid, void* lut,
                     void* stream) {
  using namespace pixo;
  if (batch < 1 || batch > 65535 || k < 1 || k > kMaxPalette)
    return static_cast<int>(cudaErrorInvalidValue);
  palette_lut_kernel<<<dim3(kLutSize / kLutThreads, static_cast<unsigned>(batch)), kLutThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(palette), k, static_cast<const int32_t*>(k_valid),
      static_cast<uint8_t*>(lut));
  return static_cast<int>(cudaGetLastError());
}

// palette: [batch, k, 4] uint8, k 1 to 256; k_valid: [batch] int32 (the
// entries that take colours, clamped to 1..k); colors: [batch, m, 4] uint8;
// weights: [batch, m] int32, non-negative; acc: [batch, k, 5] uint64 scratch,
// zero (and zero again after the call); out: [batch, k, 4] uint8 (it may not
// be the palette): all on the device. Two launches an iteration.
int pixo_kmeans_refine(const void* palette, int64_t batch, int32_t k, const void* k_valid,
                       const void* colors, const void* weights, int64_t m, void* acc, void* out,
                       void* stream) {
  using namespace pixo;
  if (batch < 1 || batch > 65535 || k < 1 || k > kMaxPalette || m < 1 || palette == out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t chunks = (m + kKmeansColors - 1) / kKmeansColors;
  if (chunks > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  auto* sums = static_cast<unsigned long long*>(acc);
  auto* res = static_cast<uint8_t*>(out);
  for (int it = 0; it < kKmeansIterations; ++it) {
    const uint8_t* cur = it == 0 ? static_cast<const uint8_t*>(palette) : res;
    kmeans_refine_assign_kernel<<<dim3(static_cast<unsigned>(chunks), static_cast<unsigned>(batch)),
                           kKmeansThreads, 0, s>>>(cur, k, static_cast<const int32_t*>(k_valid),
                                                  static_cast<const uint8_t*>(colors),
                                                  static_cast<const int32_t*>(weights), m, sums);
    kmeans_refine_update_kernel<<<static_cast<unsigned>(batch), kMaxPalette, 0, s>>>(cur, k, sums, res);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// rgba: [batch, h, w, 4] uint8; palette: [batch, k, 4] uint8, k 1 to 256;
// k_valid: [batch] int32 (the entries the direct redmean takes, clamped to
// 1..k) or null for all k; lut: [batch, 262144] uint8 (each image's LUT of
// its palette); out: [batch, h, w] uint8: all on the device. threads and
// smem: the plan's (ops/kernels.py::dither_plan); smem 0 takes the global
// route, with lags [batch, 2, h + 1, 9] int16 scratch on the device, zero.
int pixo_dither_fs(const void* rgba, int64_t batch, int64_t h, int64_t w, const void* palette,
                   int32_t k, const void* k_valid, const void* lut, int32_t threads, int64_t smem,
                   void* lags, void* out, void* stream) {
  using namespace pixo;
  if (batch < 1 || batch > 0x7FFFFFFF || h < 1 || w < 1 || k < 1 || k > kMaxPalette ||
      threads < 32 || threads > kDitherMaxThreads || threads % 32 || smem < 0 ||
      (smem == 0 && lags == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem && smem != 2 * (h + 1) * kLagShorts * 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* px = static_cast<const uint8_t*>(rgba);
  const auto* pal = static_cast<const uint8_t*>(palette);
  const auto* valid = static_cast<const int32_t*>(k_valid);
  const auto* tab = static_cast<const uint8_t*>(lut);
  auto* res = static_cast<uint8_t*>(out);
  const unsigned blocks = static_cast<unsigned>(batch);
  if (smem) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          dither_fs_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    dither_fs_kernel<true><<<blocks, threads, static_cast<size_t>(smem), s>>>(px, h, w, pal, k, valid,
                                                                             tab, nullptr, res);
  } else {
    dither_fs_kernel<false><<<blocks, threads, 0, s>>>(px, h, w, pal, k, valid, tab,
                                                       static_cast<int16_t*>(lags), res);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
