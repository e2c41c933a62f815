// Per-block coefficient compaction kernel for Hopper (sm_90a).
//
// Replaces the lax.top_k of the JAX package's
// ops/sparse_pack.py::sparsify_blocks_padded (:117). The reference sorts a
// packed key with top_k only because a scatter serializes on the TPU
// (sparse_pack.py:94-97); here the lanes of each block count its nonzero
// coefficients and place them by a prefix sum. For every [64] int16 zigzag
// block it writes the DC, the number of nonzero ACs (uint8) and the first
// `cap` nonzero (position, value) pairs, zero-filled after them, the layout
// the host's jpeg_pack_scan_padded reads. Per image it also writes the total
// of the counts and their maximum: the caller escalates the cap
// (8 -> 16 -> 32) or falls back to the dense stream when maxcount > cap.
//
// What bounds it on the card: memory. It reads 128 bytes per block and
// writes 3 + 3 * cap bytes, with a compare per coefficient. Design, so that
// every load and store is coalesced:
//
// - eight lanes take one block, each lane one 16-byte chunk of 8 zigzag
//   coefficients, so a warp reads 4 whole blocks, 512 contiguous bytes;
// - each lane forms the nonzero mask of its chunk (without the DC) and an
//   exclusive prefix sum of the popcounts over the block's 8 lanes
//   (__shfl_up_sync, width 8) gives it its first slot; it walks only its
//   set bits, writes its pairs in zigzag order into the thread block's
//   (CTA's) tile in shared memory, and the lanes zero-fill the slots from
//   the count up to the cap;
// - a CTA of 128 threads takes 128 consecutive blocks of the flattened
//   [batch * n] rows, eight for each group of 8 lanes, whose eight loads
//   are all issued before the first is used (one load a lane left too few
//   bytes in flight to reach the card's bandwidth); its dc, counts, poss
//   and vals rows are four contiguous ranges, staged in shared memory and
//   written with 16-byte stores;
// - the per-image total and maximum are reduced in shared memory (a CTA's
//   rows may span several images) and combined across CTAs with one int32
//   atomicAdd/atomicMax per image, which give the same result in any order.

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kCompactThreads = 128;
constexpr int kCompactPasses = 8;  // blocks each group of 8 lanes takes
constexpr int kCompactRows = kCompactThreads / 8 * kCompactPasses;  // blocks a CTA takes

// Copies nbytes from shared memory to a 16-byte aligned destination.
__device__ __forceinline__ void copy_out(uint8_t* __restrict__ dst, const uint8_t* src, int nbytes) {
  const int full = nbytes / 16;
  for (int k = threadIdx.x; k < full; k += kCompactThreads)
    reinterpret_cast<int4*>(dst)[k] = reinterpret_cast<const int4*>(src)[k];
  for (int b = 16 * full + threadIdx.x; b < nbytes; b += kCompactThreads) dst[b] = src[b];
}

template <int CAP>
__global__ void __launch_bounds__(kCompactThreads) compact_kernel(
    const int16_t* __restrict__ zz, int64_t n, int64_t rows, int16_t* __restrict__ dc,
    uint8_t* __restrict__ counts, uint8_t* __restrict__ poss, int16_t* __restrict__ vals,
    int32_t* __restrict__ total, int32_t* __restrict__ maxcount) {
  __shared__ __align__(16) uint8_t s_poss[kCompactRows * CAP];
  __shared__ __align__(16) int16_t s_vals[kCompactRows * CAP];
  __shared__ __align__(16) int16_t s_dc[kCompactRows];
  __shared__ __align__(16) uint8_t s_cnt[kCompactRows];
  __shared__ int s_sum[kCompactRows], s_max[kCompactRows];  // per image of the CTA

  const int tid = threadIdx.x, lane = tid & 7;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kCompactRows;
  const int nrows = static_cast<int>(rows - row0 < kCompactRows ? rows - row0 : kCompactRows);
  // the CTA's first image, and its rows before the next image begins;
  // 32-bit divisions where they do (a 64-bit one is some 70 instructions)
  const int64_t img0 = row0 + n <= 0xFFFFFFFFll
                           ? static_cast<uint32_t>(row0) / static_cast<uint32_t>(n)
                           : row0 / n;
  const int64_t to_next = (img0 + 1) * n - row0;
  const int nn = n < (1 << 30) ? static_cast<int>(n) : (1 << 30);
  // the image of the CTA's row g, counted from img0
  auto image_of = [&](int g) { return g < to_next ? 0 : 1 + (g - static_cast<int>(to_next)) / nn; };
  for (int i = tid; i < kCompactRows; i += kCompactThreads) s_sum[i] = s_max[i] = 0;

  // every load first: eight 16-byte chunks in flight per lane
  int4 t[kCompactPasses];
#pragma unroll
  for (int k = 0; k < kCompactPasses; ++k) {
    const int g = (tid >> 3) + k * (kCompactThreads / 8);
    t[k] = g < nrows ? __ldg(reinterpret_cast<const int4*>(zz + (row0 + g) * 64) + lane)
                     : make_int4(0, 0, 0, 0);
  }
  __syncthreads();  // s_sum and s_max are zeroed

#pragma unroll
  for (int k = 0; k < kCompactPasses; ++k) {
    const int g = (tid >> 3) + k * (kCompactThreads / 8);
    const uint32_t words[4] = {static_cast<uint32_t>(t[k].x), static_cast<uint32_t>(t[k].y),
                               static_cast<uint32_t>(t[k].z), static_cast<uint32_t>(t[k].w)};
    uint32_t mask = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mask |= ((words[e] & 0xFFFFu) != 0 ? 1u : 0u) << (2 * e);
      mask |= ((words[e] >> 16) != 0 ? 1u : 0u) << (2 * e + 1);
    }
    if (lane == 0) mask &= ~1u;  // the DC is not an AC
    const int cnt = __popc(mask);
    int incl = cnt;  // inclusive prefix over the block's 8 lanes
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d, 8);
      if (lane >= d) incl += up;
    }
    const int count = __shfl_sync(0xFFFFFFFFu, incl, 7, 8);
    if (g < nrows) {
      // this lane's nonzeros, in zigzag order, while slots are left
      for (int slot = incl - cnt; mask != 0 && slot < CAP; ++slot, mask &= mask - 1) {
        const int e = __ffs(mask) - 1;
        const uint32_t word = e < 4 ? (e < 2 ? words[0] : words[1]) : (e < 6 ? words[2] : words[3]);
        s_poss[g * CAP + slot] = static_cast<uint8_t>(8 * lane + e);
        s_vals[g * CAP + slot] = static_cast<int16_t>(e & 1 ? word >> 16 : word & 0xFFFFu);
      }
      for (int s = count + lane; s < CAP; s += 8) {  // zero-fill the absent slots
        s_poss[g * CAP + s] = 0;
        s_vals[g * CAP + s] = 0;
      }
      if (lane == 0) {
        s_dc[g] = static_cast<int16_t>(words[0] & 0xFFFFu);
        s_cnt[g] = static_cast<uint8_t>(count);
        atomicAdd(&s_sum[image_of(g)], count);
        atomicMax(&s_max[image_of(g)], count);
      }
    }
  }
  __syncthreads();

  copy_out(poss + row0 * CAP, s_poss, nrows * CAP);
  copy_out(reinterpret_cast<uint8_t*>(vals + row0 * CAP), reinterpret_cast<const uint8_t*>(s_vals),
           nrows * CAP * 2);
  copy_out(reinterpret_cast<uint8_t*>(dc + row0), reinterpret_cast<const uint8_t*>(s_dc), nrows * 2);
  copy_out(counts + row0, s_cnt, nrows);
  const int nimg = image_of(nrows - 1) + 1;
  for (int i = tid; i < nimg; i += kCompactThreads) {
    atomicAdd(total + img0 + i, s_sum[i]);
    atomicMax(maxcount + img0 + i, s_max[i]);
  }
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace pixo

extern "C" {

// zz: [batch, n, 64] int16 on the device. Outputs, all on the device: dc
// [batch, n] int16, counts [batch, n] uint8, poss [batch, n, cap] uint8, vals
// [batch, n, cap] int16, total [batch] int32, maxcount [batch] int32 (zeroed
// here on the stream before the kernel runs: with one memset where maxcount
// follows total directly). zz, dc, counts, poss and vals are 16-byte
// aligned. cap is 8, 16 or 32; 1 <= batch <= 65535; n >= 1. Returns
// cudaGetLastError().
int pixo_compact(const int16_t* zz, int64_t batch, int64_t n, int32_t cap, int16_t* dc,
                 uint8_t* counts, uint8_t* poss, int16_t* vals, int32_t* total,
                 int32_t* maxcount, void* stream) {
  using namespace pixo;
  if (batch < 1 || batch > 65535 || n < 1 || (cap != 8 && cap != 16 && cap != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(zz) || !aligned16(dc) || !aligned16(counts) || !aligned16(poss) || !aligned16(vals))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (maxcount == total + batch) {
    err = cudaMemsetAsync(total, 0, 2 * batch * sizeof(int32_t), s);
  } else {
    err = cudaMemsetAsync(total, 0, batch * sizeof(int32_t), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(maxcount, 0, batch * sizeof(int32_t), s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = batch * n;
  const unsigned grid = static_cast<unsigned>((rows + kCompactRows - 1) / kCompactRows);
  switch (cap) {
    case 8:
      compact_kernel<8><<<grid, kCompactThreads, 0, s>>>(zz, n, rows, dc, counts, poss, vals, total, maxcount);
      break;
    case 16:
      compact_kernel<16><<<grid, kCompactThreads, 0, s>>>(zz, n, rows, dc, counts, poss, vals, total, maxcount);
      break;
    case 32:
      compact_kernel<32><<<grid, kCompactThreads, 0, s>>>(zz, n, rows, dc, counts, poss, vals, total, maxcount);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
