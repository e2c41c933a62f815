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
// entry otherwise. Bound by integer issue: a distance a real colour and
// entry. An image's real colours vary from a few hundred to 8192, so the
// work is split over them and not over slots: the host's plan
// (ops/kernels.py::kmeans_plan) cuts each image's first counts[i] colours
// into chunks of 64 to 1024, about 8 an SM over the batch, and a CTA of two
// warps takes a chunk, so SMs hold several CTAs and none waits on one full
// image. A thread takes a colour at a time (a word load where the colours
// are 4-byte aligned) and scans the palette in shared memory (int4 entries,
// each a broadcast) in order, strict-<, so ties go to the first index. A
// colour adds its sums to the CTA's with shared atomics: 32-bit, native,
// where the chunk's total weight w keeps 255 w under 2^32 (checked a CTA,
// so exact for any weights; png/quantize.py's weights keep the image's
// under 2^31), 64-bit otherwise. (Summing a warp's colours on one entry
// first, by __match_any_sync, saved nothing at (q1) or (q2): the shared
// atomics are not what the kernel waits on.) A CTA adds its
// sums to global 64-bit ones with atomics, exact in any order, fences, and
// takes a ticket of its image; the image's last CTA divides, writes the
// entries and clears the sums and the ticket, so the scratch is zero again
// after each launch and a call is one launch an iteration.
//
// pixo_dither_fs: the error diffusion is a recurrence along each row and from
// row to row, so it runs as the reference's wavefront: step t handles pixel
// (y, t - 2y) of every row, and row y needs its own last error and the last
// three errors of row y - 1 as the previous step left them. Its bytes
// (pixels, LUTs, indices) take 7 us at (q1); what bounds it is the critical
// path of W + 2(H - 1) dependent steps, each a chain of integer operations, a
// LUT load and a palette read, so the design keeps that chain short and free
// of barriers. One CTA an image (blocks cannot wait on each other). A warp
// takes a band of 32 rows, a lane a row, fixed for the band, so a row's own
// error and the three errors of the row above stay in the lane's registers;
// each step one __shfl_up_sync hands every lane's new error (three channels
// packed in a word) to the lane below. Lane 0 takes the row above its band
// from a ring in shared memory that lane 31 of the band above fills, a slot a
// column, one step ahead of its use (so bands start 65 steps apart, and the
// path is one step a band longer). A slot holds the packed error or a free
// mark, so data and flag are one word and no fence is needed: the reader
// waits for a slot to fill and frees it, the writer waits (once every 32
// columns) for free slots. Warp j takes bands j, j + warps, ...; the last
// warp's ring feeds warp 0. A warp waits only where it catches up with the
// band above or fills the ring of the one below; the step loop has no
// __syncthreads and every branch in it but the direct redmean is uniform over
// the warp. Every per-step index is 32-bit (the plan refuses images past 2^29
// pixels). Each lane loads its pixel four steps ahead, as a word where the
// image is 4-byte aligned; the LUT (256 KB an image) is read through the
// read-only path, with the L1 carveout at its largest. On an H100 80GB HBM3
// at 700 W a step takes ~690 SM clocks at (q1), ~490 without the LUT load,
// ~520 without the ring waits, ~550 without the pixel loads and ~405 without
// all three (chip_smoke.py --dither-parts): a latency chain, not a throughput
// limit, a step as long with 2 warps an SM as with 9. The warps, ring slots
// and where the rings live (shared memory, or a global scratch for rows past
// ~54,000 pixels) are ops/kernels.py::dither_plan's. The incoming error is 16
// times an integer sum (7/16, 1/16, 5/16, 3/16 of integers), so the
// reference's f32 floor(clip(px + e, 0, 255)) is the integer clamp((16 px +
// 16 e) >> 4); the LUT takes alpha-255 pixels, the direct redmean over the
// palette's first k_valid entries the others.

#include <cstdint>

#include <cuda_runtime.h>

#include "redmean.cuh"

namespace pixo {

constexpr int kLutSize = 64 * 64 * 64;
constexpr int kLutThreads = 256;
constexpr int kKmeansThreads = 64;  // two warps a chunk of colours
constexpr int kKmeansIterations = 2;  // the reference's refinement (mod.rs:1346-1390)
constexpr int kMaxPalette = 256;
constexpr int kDitherBand = 32;  // rows a warp takes at once, a lane a row
constexpr int kDitherMaxWarps = 32;
constexpr int kDitherLag = 65;  // steps between two bands' starts
constexpr uint32_t kRingFree = 0x80000000u;  // no packed error has bit 31 set

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

// A colour of the histogram, r | g << 8 | b << 16 | a << 24: one word load
// where the colours are 4-byte aligned, else four bytes.
template <bool kWords>
__device__ __forceinline__ uint32_t load_colour(const uint8_t* c) {
  if (kWords) return __ldg(reinterpret_cast<const uint32_t*>(c));
  return __ldg(c) | (__ldg(c + 1) << 8) | (__ldg(c + 2) << 16) | (static_cast<uint32_t>(__ldg(c + 3)) << 24);
}

// One colour's sums (r, g, b, a, weight) x w onto entry idx of the CTA's
// sums, 32-bit with kNarrow, else 64-bit.
template <bool kNarrow>
__device__ __forceinline__ void add_sums(unsigned long long* sums, int idx, int r, int g, int bl, int al,
                                         uint32_t w) {
  if (!w) return;
  if (kNarrow) {
    uint32_t* s = reinterpret_cast<uint32_t*>(sums) + 5 * idx;
    atomicAdd(s, r * w);
    atomicAdd(s + 1, g * w);
    atomicAdd(s + 2, bl * w);
    atomicAdd(s + 3, al * w);
    atomicAdd(s + 4, w);
  } else {
    unsigned long long* s = sums + 5 * idx;
    const unsigned long long w64 = w;
    atomicAdd(s, r * w64);
    atomicAdd(s + 1, g * w64);
    atomicAdd(s + 2, bl * w64);
    atomicAdd(s + 3, al * w64);
    atomicAdd(s + 4, w64);
  }
}

// The chunk's colours: each warp takes 32 at a time, a lane one; the whole
// warp skips 32 colours of no weight (the padding past an image's colours).
template <bool kWords, bool kNarrow>
__device__ __forceinline__ void assign_chunk(const int4* s_pal, int kv, const uint8_t* colors,
                                             const int32_t* wt, int first, int last,
                                             unsigned long long* sums) {
  const int lane = threadIdx.x & 31;
  for (int base = first + (threadIdx.x & ~31); base < last; base += kKmeansThreads) {
    const int i = base + lane;
    const uint32_t w = i < last ? static_cast<uint32_t>(wt[i]) : 0;
    if (!__any_sync(0xFFFFFFFFu, w != 0)) continue;
    const uint32_t c = i < last ? load_colour<kWords>(colors + 4 * static_cast<int64_t>(i)) : 0;
    const int r = c & 255, g = (c >> 8) & 255, bl = (c >> 16) & 255, al = c >> 24;
    const int idx = nearest(r, g, bl, al, s_pal, kv);
    add_sums<kNarrow>(sums, idx, r, g, bl, al, w);
  }
}

// One k-means iteration, a CTA a chunk: chunks[blockIdx.x] = (image, first
// colour, end, chunks of that image), from ops/kernels.py::kmeans_plan.
// cur: the palettes this iteration reads; out: where it writes them (cur
// itself in the second iteration: an image's entries are written by its
// last CTA, after every CTA of the image has read them). acc: [B, K, 5]
// 64-bit sums (r, g, b, a, weight) and done: [B] tickets, zero on entry and
// left zero.
template <bool kWords>
__global__ void __launch_bounds__(kKmeansThreads) kmeans_refine_kernel(
    const uint8_t* cur, int k, const int32_t* __restrict__ k_valid, const uint8_t* __restrict__ colors,
    const int32_t* __restrict__ weights, int64_t m, const int4* __restrict__ chunks,
    unsigned long long* acc, unsigned* done, uint8_t* out) {
  __shared__ int4 s_pal[kMaxPalette];
  __shared__ unsigned long long s_sums[kMaxPalette * 5];  // the first half as 32-bit sums when narrow
  __shared__ unsigned long long s_weight[kKmeansThreads / 32];
  __shared__ bool s_last;
  const int4 chunk = chunks[blockIdx.x];
  const int64_t b = chunk.x;
  const int kv = valid_entries(k_valid, b, k);
  load_palette(s_pal, cur + b * k * 4, kv);
  for (int i = threadIdx.x; i < kv * 5; i += kKmeansThreads) s_sums[i] = 0;
  const int32_t* wt = weights + b * m;
  unsigned long long w = 0;  // the chunk's total weight decides the sums' width
  for (int i = chunk.y + threadIdx.x; i < chunk.z; i += kKmeansThreads) w += static_cast<uint32_t>(wt[i]);
  for (int o = 16; o; o >>= 1) w += __shfl_xor_sync(0xFFFFFFFFu, w, o);
  if ((threadIdx.x & 31) == 0) s_weight[threadIdx.x >> 5] = w;
  __syncthreads();
  w = 0;
  for (int i = 0; i < kKmeansThreads / 32; ++i) w += s_weight[i];
  const bool narrow = w <= 0xFFFFFFFFull / 255;
  const uint8_t* col = colors + 4 * b * m;
  if (narrow)
    assign_chunk<kWords, true>(s_pal, kv, col, wt, chunk.y, chunk.z, s_sums);
  else
    assign_chunk<kWords, false>(s_pal, kv, col, wt, chunk.y, chunk.z, s_sums);
  __syncthreads();
  unsigned long long* a = acc + b * k * 5;
  const uint32_t* s32 = reinterpret_cast<const uint32_t*>(s_sums);
  for (int i = threadIdx.x; i < kv * 5; i += kKmeansThreads) {
    const unsigned long long v = narrow ? s32[i] : s_sums[i];
    if (v) atomicAdd(a + i, v);
  }
  __threadfence();  // this thread's sums before the ticket
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done + b, 1u) == static_cast<unsigned>(chunk.w - 1);
  __syncthreads();
  if (!s_last) return;
  __threadfence();  // every CTA of the image has added its sums: read them through L2, all at once
  constexpr int kSumsPerThread = kMaxPalette * 5 / kKmeansThreads;
  unsigned long long got[kSumsPerThread];
#pragma unroll
  for (int u = 0; u < kSumsPerThread; ++u) {
    const int i = threadIdx.x + u * kKmeansThreads;
    got[u] = i < kv * 5 ? __ldcg(a + i) : 0;
  }
#pragma unroll
  for (int u = 0; u < kSumsPerThread; ++u) {
    const int i = threadIdx.x + u * kKmeansThreads;
    if (i < kv * 5) s_sums[i] = got[u], a[i] = 0;
  }
  if (threadIdx.x == 0) done[b] = 0;
  __syncthreads();
  uint8_t* dst = out + b * k * 4;
  for (int j = threadIdx.x; j < kv; j += kKmeansThreads) {  // the old entry from shared memory
    const unsigned long long* sj = s_sums + 5 * j;
    const int4 p = s_pal[j];
    const int old[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dst[4 * j + c] = static_cast<uint8_t>(
          !sj[4] ? old[c]
                 : (sj[c] | sj[4]) >> 32 ? sj[c] / sj[4]
                                         : static_cast<uint32_t>(sj[c]) / static_cast<uint32_t>(sj[4]));
  }
  if (cur != out) {  // the first iteration: the entries past kv as they were, loaded all at once
    constexpr int kBytesPerThread = kMaxPalette * 4 / kKmeansThreads;
    const uint8_t* src = cur + b * k * 4;
    uint8_t pad[kBytesPerThread];
#pragma unroll
    for (int u = 0; u < kBytesPerThread; ++u) {
      const int i = kv * 4 + threadIdx.x + u * kKmeansThreads;
      pad[u] = i < k * 4 ? src[i] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBytesPerThread; ++u) {
      const int i = kv * 4 + threadIdx.x + u * kKmeansThreads;
      if (i < k * 4) dst[i] = pad[u];
    }
  }
}

__device__ __forceinline__ int clamp255(int v) { return min(max(v, 0), 255); }

// Three errors in [-255, 255] as 10-bit fields of one word, bits 30-31 clear.
__device__ __forceinline__ uint32_t pack_errors(int e0, int e1, int e2) {
  return (e0 & 0x3FF) | ((e1 & 0x3FF) << 10) | ((e2 & 0x3FF) << 20);
}

// Channel c of a packed word, sign-extended.
template <int C>
__device__ __forceinline__ int packed_error(uint32_t v) {
  return static_cast<int>(v << (22 - 10 * C)) >> 22;
}

// A warp's ring: one 32-bit slot a column, each holding a packed error or
// kRingFree, so data and flag are one word and no fence orders it against
// another location. In shared memory through its 32-bit shared address;
// with kGlobal, a scratch in global memory (volatile, so through L2).
template <bool kGlobal>
struct Ring;

template <>
struct Ring<false> {
  uint32_t base;
  __device__ __forceinline__ explicit Ring(uint32_t* p)
      : base(static_cast<uint32_t>(__cvta_generic_to_shared(p))) {}
  __device__ __forceinline__ uint32_t get(int i) const {
    uint32_t v;
    asm volatile("ld.volatile.shared.u32 %0, [%1];" : "=r"(v) : "r"(base + 4 * i));
    return v;
  }
  __device__ __forceinline__ void put(int i, uint32_t v) const {
    asm volatile("st.volatile.shared.u32 [%0], %1;" ::"r"(base + 4 * i), "r"(v));
  }
};

template <>
struct Ring<true> {
  volatile uint32_t* base;
  __device__ __forceinline__ explicit Ring(uint32_t* p) : base(p) {}
  __device__ __forceinline__ uint32_t get(int i) const { return base[i]; }
  __device__ __forceinline__ void put(int i, uint32_t v) const { base[i] = v; }
};

// The pixel of column x of a row as a word r | g << 8 | b << 16 | a << 24;
// outside [0, w) or past the image 0xFF000000 (black, opaque: the LUT route,
// whose result is not kept). A word load where the image is 4-byte aligned.
template <bool kWords>
__device__ __forceinline__ uint32_t load_pixel(const uint8_t* row, int x, int w, bool row_ok) {
  if (!row_ok || static_cast<unsigned>(x) >= static_cast<unsigned>(w)) return 0xFF000000u;
  const uint8_t* q = row + 4 * x;
  if (kWords) return __ldg(reinterpret_cast<const uint32_t*>(q));
  return __ldg(q) | (__ldg(q + 1) << 8) | (__ldg(q + 2) << 16) | (static_cast<uint32_t>(__ldg(q + 3)) << 24);
}

// rings: warps rings of ring_slots words (ring j feeds warp j), in dynamic
// shared memory, or with kGlobalRings this image's part of gring. Every
// branch of the step but the direct redmean is uniform over the warp: the
// ring slots are read by all lanes (one broadcast) and written by one lane.
// kThreads: the launch's bound, 512 up to 16 warps (128 registers a thread
// to spare; a step 12% shorter than under the bound of 1024 on an H100 at
// 700 W), else 1024.
template <bool kWords, bool kGlobalRings, int kThreads>
__global__ void __launch_bounds__(kThreads) dither_fs_kernel(
    const uint8_t* __restrict__ rgba, int h, int w, const uint8_t* __restrict__ palette, int k,
    const int32_t* __restrict__ k_valid, const uint8_t* __restrict__ lut, int ring_slots,
    uint32_t* gring, uint8_t* __restrict__ out) {
  extern __shared__ uint32_t s_ring[];
  __shared__ int4 s_pal[kMaxPalette];
  const int64_t b = blockIdx.x;
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kv = valid_entries(k_valid, b, k);
  uint32_t* rings = kGlobalRings ? gring + b * warps * ring_slots : s_ring;
  load_palette(s_pal, palette + b * k * 4, k);  // all k: a LUT entry may name any of them
  for (int i = threadIdx.x; i < warps * ring_slots; i += blockDim.x) rings[i] = kRingFree;
  __syncthreads();  // the only barrier: the palette and the free rings
  const int64_t pixels = static_cast<int64_t>(h) * w;
  const uint8_t* img = rgba + 4 * b * pixels;
  const uint8_t* tab = lut + b * kLutSize;
  uint8_t* dst = out + b * pixels;
  const Ring<kGlobalRings> ring_in(rings + warp * ring_slots);
  const Ring<kGlobalRings> ring_out(rings + (warp + 1 == warps ? 0 : warp + 1) * ring_slots);
  const int bands = (h + kDitherBand - 1) / kDitherBand;
  int rs = 0, ws = 0;  // the next slot this warp reads and writes, across its bands
  for (int c = warp; c < bands; c += warps) {
    const int y = c * kDitherBand + lane;
    const bool row_ok = y < h, reads = c > 0, writes = c + 1 < bands;
    const int steps = w + 2 * (min(kDitherBand, h - c * kDitherBand) - 1);
    const uint8_t* row = img + 4 * (row_ok ? y * w : 0);
    uint8_t* row_dst = dst + (row_ok ? y * w : 0);
    // er(y-1, x+1), er(y-1, x), er(y-1, x-1) and er(y, x-1), by channel
    int up0[3] = {0, 0, 0}, up1[3] = {0, 0, 0}, up2[3] = {0, 0, 0}, me[3] = {0, 0, 0};
    uint32_t recv = 0;  // the lane above's newest error, packed, from the shuffle
    // Lane 0's er(y-1, x+1) for the next step, read a step ahead so that the
    // slot's latency stays off the chain: bands start 65 steps apart.
    uint32_t above = 0;
    if (reads) {  // er(y-1, 0), which the first step shifts to up1, and er(y-1, 1)
      uint32_t v;
      while ((v = ring_in.get(rs)) == kRingFree) {
      }
      if (lane == 0) {
        ring_in.put(rs, kRingFree);
        up0[0] = packed_error<0>(v), up0[1] = packed_error<1>(v), up0[2] = packed_error<2>(v);
      }
      rs = rs + 1 == ring_slots ? 0 : rs + 1;
      if (w > 1) {
        while ((above = ring_in.get(rs)) == kRingFree) {
        }
        if (lane == 0) ring_in.put(rs, kRingFree);
        rs = rs + 1 == ring_slots ? 0 : rs + 1;
      }
    }
    int x = -2 * lane;  // this lane's column at step s: s - 2 lane
    uint32_t px[4];  // the pixels of the next four steps, each loaded four steps ahead
#pragma unroll
    for (int j = 0; j < 4; ++j) px[j] = load_pixel<kWords>(row, x + j, w, row_ok);
    for (int s0 = 0; s0 < steps; s0 += 4) {
#pragma unroll
      for (int i = 0; i < 4; ++i, ++x) {
        const int s = s0 + i;
        const bool ahead = reads && s + 2 < w;  // er(y-1, s + 2), for the next step
        uint32_t next = ahead ? ring_in.get(rs) : 0;
        const uint32_t v = lane == 0 ? above : recv;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) up2[ch] = up1[ch], up1[ch] = up0[ch];
        up0[0] = packed_error<0>(v), up0[1] = packed_error<1>(v), up0[2] = packed_error<2>(v);
        const bool on = row_ok && static_cast<unsigned>(x) < static_cast<unsigned>(w);
        const uint32_t p = px[i];
        px[i] = load_pixel<kWords>(row, x + 4, w, row_ok);
        int a[3];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch)
          a[ch] = clamp255((16 * static_cast<int>((p >> (8 * ch)) & 255) + 7 * me[ch] + up2[ch] +
                            5 * up1[ch] + 3 * up0[ch]) >> 4);
        int idx = __ldg(tab + (((a[0] >> 2) << 12) | ((a[1] >> 2) << 6) | (a[2] >> 2)));
        const int alpha = p >> 24;
        if (alpha != 255) idx = nearest(a[0], a[1], a[2], alpha, s_pal, kv);
        if (on) row_dst[x] = static_cast<uint8_t>(idx);
        const int4 q = s_pal[idx];
        me[0] = on ? a[0] - q.x : 0, me[1] = on ? a[1] - q.y : 0, me[2] = on ? a[2] - q.z : 0;
        const uint32_t mine = pack_errors(me[0], me[1], me[2]);
        recv = __shfl_up_sync(0xFFFFFFFFu, mine, 1);  // for the next step, before the rings' work
        const int x31 = s - 2 * (kDitherBand - 1);  // lane 31's column: it hands er(y, x31) on
        if (writes && static_cast<unsigned>(x31) < static_cast<unsigned>(w)) {
          if ((x31 & 31) == 0) {  // slot ws + 31 free: the reader is past ws .. ws + 31
            const int far = ws + 31 < ring_slots ? ws + 31 : ws + 31 - ring_slots;
            while (ring_out.get(far) != kRingFree) {
            }
          }
          if (lane == kDitherBand - 1) ring_out.put(ws, mine);
          ws = ws + 1 == ring_slots ? 0 : ws + 1;
        }
        if (ahead) {  // the band above has written it by now, but for a slower band
          while (next == kRingFree) next = ring_in.get(rs);
          if (lane == 0) ring_in.put(rs, kRingFree);
          rs = rs + 1 == ring_slots ? 0 : rs + 1;
        }
        above = next;
      }
    }
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
// weights: [batch, m] int32, non-negative; chunks: [n_chunks, 4] int32,
// 16-byte aligned (image, first colour, end, chunks of that image: every
// image's colours of non-zero weight in its chunks, each image in at least
// one; ops/kernels.py::kmeans_plan); acc: [batch, k, 5] uint64 and done:
// [batch] uint32 scratch, zero (and zero again after the call); out: [batch,
// k, 4] uint8 (it may not be the palette): all on the device. One launch an
// iteration.
int pixo_kmeans_refine(const void* palette, int64_t batch, int32_t k, const void* k_valid,
                       const void* colors, const void* weights, int64_t m, const void* chunks,
                       int64_t n_chunks, void* acc, void* done, void* out, void* stream) {
  using namespace pixo;
  if (batch < 1 || k < 1 || k > kMaxPalette || m < 1 || m > 0x7FFFFFFF || palette == out ||
      n_chunks < batch || n_chunks > 0x7FFFFFFF || reinterpret_cast<uintptr_t>(chunks) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* kernel = reinterpret_cast<uintptr_t>(colors) % 4 == 0 ? &kmeans_refine_kernel<true>
                                                              : &kmeans_refine_kernel<false>;
  auto* res = static_cast<uint8_t*>(out);
  for (int it = 0; it < kKmeansIterations; ++it) {
    kernel<<<static_cast<unsigned>(n_chunks), kKmeansThreads, 0, s>>>(
        it == 0 ? static_cast<const uint8_t*>(palette) : res, k, static_cast<const int32_t*>(k_valid),
        static_cast<const uint8_t*>(colors), static_cast<const int32_t*>(weights), m,
        static_cast<const int4*>(chunks), static_cast<unsigned long long*>(acc),
        static_cast<unsigned*>(done), res);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// rgba: [batch, h, w, 4] uint8; palette: [batch, k, 4] uint8, k 1 to 256;
// k_valid: [batch] int32 (the entries the direct redmean takes, clamped to
// 1..k) or null for all k; lut: [batch, 262144] uint8 (each image's LUT of
// its palette); out: [batch, h, w] uint8: all on the device. warps and
// ring_slots: the plan's (ops/kernels.py::dither_plan); ring: null for the
// rings in shared memory, else [batch, warps, ring_slots] int32 scratch on
// the device. Where bands wrap round the warps the rings must hold a row,
// warps x (ring_slots - 64) >= w, or the CTA could deadlock: refused.
int pixo_dither_fs(const void* rgba, int64_t batch, int64_t h, int64_t w, const void* palette,
                   int32_t k, const void* k_valid, const void* lut, int32_t warps, int32_t ring_slots,
                   void* ring, void* out, void* stream) {
  using namespace pixo;
  if (batch < 1 || batch > 0x7FFFFFFF || h < 1 || w < 1 || h * w > 0x7FFFFFFF / 4 || k < 1 ||
      k > kMaxPalette || warps < 1 || warps > kDitherMaxWarps || ring_slots < 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t bands = (h + kDitherBand - 1) / kDitherBand;
  if (warps > bands || (bands > warps && static_cast<int64_t>(warps) * (ring_slots - kDitherLag) < w))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t smem = ring ? 0 : static_cast<int64_t>(warps) * ring_slots * 4;
  if (smem > 232448 - static_cast<int64_t>(sizeof(int4)) * kMaxPalette)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool words = reinterpret_cast<uintptr_t>(rgba) % 4 == 0, wide = warps > 16;
  auto* kernel = words ? (ring ? (wide ? &dither_fs_kernel<true, true, 1024> : &dither_fs_kernel<true, true, 512>)
                               : (wide ? &dither_fs_kernel<true, false, 1024> : &dither_fs_kernel<true, false, 512>))
                       : (ring ? (wide ? &dither_fs_kernel<false, true, 1024> : &dither_fs_kernel<false, true, 512>)
                               : (wide ? &dither_fs_kernel<false, false, 1024> : &dither_fs_kernel<false, false, 512>));
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxL1);
  if (err == cudaSuccess && smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(batch), warps * 32, static_cast<size_t>(smem),
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgba), static_cast<int>(h), static_cast<int>(w),
      static_cast<const uint8_t*>(palette), k, static_cast<const int32_t*>(k_valid),
      static_cast<const uint8_t*>(lut), ring_slots, static_cast<uint32_t*>(ring), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
