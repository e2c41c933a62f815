// Per-block coefficient compaction kernel for Hopper (sm_90a).
//
// Replaces the lax.top_k of the JAX package's
// ops/sparse_pack.py::sparsify_blocks_padded (:117). The reference sorts a
// packed key with top_k only because a scatter serializes on the TPU
// (sparse_pack.py:94-97); here each thread simply walks its block's 63 AC
// coefficients in zigzag order. For every [64] int16 zigzag block it writes
// the DC, the number of nonzero ACs (uint8) and the first `cap` nonzero
// (position, value) pairs, zero-filled after them, the layout the host's
// jpeg_pack_scan_padded reads. Per image it also writes the total of the
// counts and their maximum: the caller escalates the cap (8 -> 16 -> 32)
// or falls back to the dense stream when maxcount > cap.
//
// What bounds it on the card: memory. It reads 128 bytes per block and
// writes 3 + 3 * cap bytes, with a compare per coefficient. Design: one
// thread per block, loading the block with eight 16-byte loads; the
// per-image total and maximum are reduced within the thread block (warp
// shuffles, then shared memory) and combined across thread blocks with one
// int32 atomicAdd/atomicMax each, which give the same result in any order.

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kCompactThreads = 256;

template <int CAP>
__global__ void __launch_bounds__(kCompactThreads) compact_kernel(
    const int16_t* __restrict__ zz, int64_t n, int16_t* __restrict__ dc,
    uint8_t* __restrict__ counts, uint8_t* __restrict__ poss, int16_t* __restrict__ vals,
    int32_t* __restrict__ total, int32_t* __restrict__ maxcount) {
  const int64_t img = blockIdx.y;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kCompactThreads + threadIdx.x;
  int cnt = 0;
  if (i < n) {
    const int64_t row = img * n + i;
    const int4* src = reinterpret_cast<const int4*>(zz + row * 64);
    int16_t v[64];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int4 t = src[k];
      const int words[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[8 * k + 2 * e] = static_cast<int16_t>(words[e] & 0xFFFF);
        v[8 * k + 2 * e + 1] = static_cast<int16_t>(static_cast<uint32_t>(words[e]) >> 16);
      }
    }
    uint8_t* prow = poss + row * CAP;
    int16_t* vrow = vals + row * CAP;
#pragma unroll
    for (int j = 1; j < 64; ++j) {
      if (v[j] != 0) {
        if (cnt < CAP) {
          prow[cnt] = static_cast<uint8_t>(j);
          vrow[cnt] = v[j];
        }
        ++cnt;
      }
    }
    for (int s = cnt; s < CAP; ++s) {  // zero-fill the absent slots
      prow[s] = 0;
      vrow[s] = 0;
    }
    dc[row] = v[0];
    counts[row] = static_cast<uint8_t>(cnt);
  }

  // thread-block reduction of (sum, max) of the counts, then one atomic each
  int sum = cnt, mx = cnt;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xFFFFFFFFu, sum, off);
    mx = max(mx, __shfl_down_sync(0xFFFFFFFFu, mx, off));
  }
  __shared__ int s_sum[kCompactThreads / 32], s_max[kCompactThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_sum[warp] = sum;
    s_max[warp] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int bs = 0, bm = 0;
#pragma unroll
    for (int w = 0; w < kCompactThreads / 32; ++w) {
      bs += s_sum[w];
      bm = max(bm, s_max[w]);
    }
    atomicAdd(total + img, bs);
    atomicMax(maxcount + img, bm);
  }
}

}  // namespace pixo

extern "C" {

// zz: [batch, n, 64] int16 on the device, 16-byte aligned. Outputs, all on
// the device: dc [batch, n] int16, counts [batch, n] uint8, poss [batch, n,
// cap] uint8, vals [batch, n, cap] int16, total [batch] int32, maxcount
// [batch] int32 (zeroed here on the stream before the kernel runs). cap is
// 8, 16 or 32; 1 <= batch <= 65535; n >= 1. Returns cudaGetLastError().
int pixo_compact(const int16_t* zz, int64_t batch, int64_t n, int32_t cap, int16_t* dc,
                 uint8_t* counts, uint8_t* poss, int16_t* vals, int32_t* total,
                 int32_t* maxcount, void* stream) {
  using namespace pixo;
  if (batch < 1 || batch > 65535 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(total, 0, batch * sizeof(int32_t), s);
  if (err == cudaSuccess) err = cudaMemsetAsync(maxcount, 0, batch * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kCompactThreads - 1) / kCompactThreads),
                  static_cast<unsigned>(batch));
  switch (cap) {
    case 8:
      compact_kernel<8><<<grid, kCompactThreads, 0, s>>>(zz, n, dc, counts, poss, vals, total, maxcount);
      break;
    case 16:
      compact_kernel<16><<<grid, kCompactThreads, 0, s>>>(zz, n, dc, counts, poss, vals, total, maxcount);
      break;
    case 32:
      compact_kernel<32><<<grid, kCompactThreads, 0, s>>>(zz, n, dc, counts, poss, vals, total, maxcount);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
