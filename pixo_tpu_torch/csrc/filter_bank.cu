// PNG filter kernels for Hopper (sm_90a).
//
// Replace the JAX package's filter_bank_pallas (pixo_tpu/ops/pallas_kernels.py:57,
// body _filter_bank_kernel :27), the TPU kernel of the batched PNG encode.
// PNG filtering reads the raw previous row and the raw pixel bpp bytes to the
// left, so every row and every filter is independent.
//
// - pixo_filter_bank: the TPU kernel's own contract, batched. For every row
//   of every image, the five candidates None/Sub/Up/Average/Paeth mod 256
//   (stored as uint8) and per row and filter the sum of |byte as i8|.
// - pixo_filter_rows: the encode's kernel. It fuses the scores, the
//   reference's selection rule and the write of the chosen filter with its
//   type byte: what ops/png_filters.py::filter_image_batch computes, laid out
//   as PNG rows [B, H, RB+1].
//
// What bounds it on the card: bytes. Each output byte costs a few integer
// operations; filter_rows reads each input byte about three times (its own
// row twice, and once more as the row above the next one; the second reads
// come from L1/L2) and writes it once. Design: one thread block per
// (image, row), rows on grid.x (B*H can exceed gridDim.y's 65,535). The
// threads stride the row byte by byte, neighbouring threads on neighbouring
// bytes; the five scores are reduced with warp shuffles and shared memory,
// and every thread applies the selection rule to the reduced sums. A row
// never has to fit in shared memory (a row may hold 65,535 x 4 bytes): the
// second sweep reads it again from global memory. With the sticky
// adaptive-fast rule (height <= 32) each block computes row 0's scores itself,
// so no block waits on another. All arithmetic is int32, as on the TPU:
// every result is exact.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kFilterThreads = 256;
constexpr int kFilters = 5;

// byte x filtered with filter F, from its left (a), up (b) and upper-left (c)
// neighbours, mod 256
template <int F>
__device__ __forceinline__ int filter_byte(int x, int a, int b, int c) {
  int pred;
  if (F == 0) {
    pred = 0;
  } else if (F == 1) {
    pred = a;
  } else if (F == 2) {
    pred = b;
  } else if (F == 3) {
    pred = (a + b) >> 1;
  } else {
    const int p = a + b - c;
    const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
  }
  return (x - pred) & 0xFF;
}

// |c as i8| for c in 0..255 (0 for 0)
__device__ __forceinline__ int score_of(int c) { return min(c, 256 - c); }

// The raw byte i of row `cur` and its neighbours; `prev` is null on row 0.
// left and upper-left are 0 for i < bpp (and so for the whole row when
// rb <= bpp).
__device__ __forceinline__ void neighbours(const uint8_t* __restrict__ cur,
                                           const uint8_t* __restrict__ prev, int64_t i, int bpp,
                                           int& x, int& a, int& b, int& c) {
  x = cur[i];
  const bool has_left = i >= bpp;
  a = has_left ? cur[i - bpp] : 0;
  b = prev != nullptr ? prev[i] : 0;
  c = (prev != nullptr && has_left) ? prev[i - bpp] : 0;
}

// Sums each of the five per-thread values over the block; every thread
// receives the sums. Called at most once per block.
__device__ __forceinline__ void block_sum5(int (&v)[kFilters]) {
  __shared__ int partial[kFilterThreads / 32][kFilters];
  __shared__ int total[kFilters];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int f = 0; f < kFilters; ++f) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[f] += __shfl_down_sync(0xFFFFFFFFu, v[f], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int f = 0; f < kFilters; ++f) partial[warp][f] = v[f];
  }
  __syncthreads();
  if (threadIdx.x < kFilters) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < kFilterThreads / 32; ++w) s += partial[w][threadIdx.x];
    total[threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < kFilters; ++f) v[f] = total[f];
}

// The five scores of one row, summed over the block.
__device__ void row_scores(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ prev,
                           int64_t rb, int bpp, int (&s)[kFilters]) {
#pragma unroll
  for (int f = 0; f < kFilters; ++f) s[f] = 0;
  for (int64_t i = threadIdx.x; i < rb; i += kFilterThreads) {
    int x, a, b, c;
    neighbours(cur, prev, i, bpp, x, a, b, c);
    s[0] += score_of(filter_byte<0>(x, a, b, c));
    s[1] += score_of(filter_byte<1>(x, a, b, c));
    s[2] += score_of(filter_byte<2>(x, a, b, c));
    s[3] += score_of(filter_byte<3>(x, a, b, c));
    s[4] += score_of(filter_byte<4>(x, a, b, c));
  }
  block_sum5(s);
}

// Reference adaptive_filter: None, Sub, Up, Average, Paeth in order, keep
// strict improvements, stop once the best is <= early.
__device__ __forceinline__ int select_adaptive(const int (&s)[kFilters], int early) {
  int best = INT_MAX, chosen = 0;
#pragma unroll
  for (int f = 0; f < kFilters; ++f) {
    if (s[f] < best) {
      best = s[f];
      chosen = f;
    }
    if (best <= early) break;
  }
  return chosen;
}

// Reference adaptive_filter_fast: Sub, then Up, then Paeth, with the cutoff.
__device__ __forceinline__ int select_adaptive_fast(const int (&s)[kFilters], int early) {
  if (s[1] <= early) return 1;
  const int best12 = s[2] < s[1] ? 2 : 1;
  const int sb12 = min(s[1], s[2]);
  if (sb12 <= early) return best12;
  return s[4] < sb12 ? 4 : best12;
}

template <int F>
__device__ void write_row(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ prev,
                          int64_t rb, int bpp, uint8_t* __restrict__ out) {
  for (int64_t i = threadIdx.x; i < rb; i += kFilterThreads) {
    int x, a, b, c;
    neighbours(cur, prev, i, bpp, x, a, b, c);
    out[i] = static_cast<uint8_t>(filter_byte<F>(x, a, b, c));
  }
}

__global__ void __launch_bounds__(kFilterThreads) filter_bank_kernel(
    const uint8_t* __restrict__ rows, int64_t h, int64_t rb, int bpp,
    uint8_t* __restrict__ cands, int32_t* __restrict__ scores) {
  const int64_t r = blockIdx.x;  // image * h + y
  const int64_t img = r / h, y = r - img * h;
  const uint8_t* cur = rows + r * rb;
  const uint8_t* prev = y > 0 ? cur - rb : nullptr;
  uint8_t* cand0 = cands + (img * kFilters * h + y) * rb;  // filter f at + f * h * rb
  const int64_t plane = h * rb;
  int s[kFilters] = {0, 0, 0, 0, 0};
  for (int64_t i = threadIdx.x; i < rb; i += kFilterThreads) {
    int x, a, b, c;
    neighbours(cur, prev, i, bpp, x, a, b, c);
    const int v[kFilters] = {filter_byte<0>(x, a, b, c), filter_byte<1>(x, a, b, c),
                             filter_byte<2>(x, a, b, c), filter_byte<3>(x, a, b, c),
                             filter_byte<4>(x, a, b, c)};
#pragma unroll
    for (int f = 0; f < kFilters; ++f) {
      cand0[f * plane + i] = static_cast<uint8_t>(v[f]);
      s[f] += score_of(v[f]);
    }
  }
  block_sum5(s);
  if (threadIdx.x < kFilters) scores[r * kFilters + threadIdx.x] = s[threadIdx.x];
}

__global__ void __launch_bounds__(kFilterThreads) filter_rows_kernel(
    const uint8_t* __restrict__ rows, int64_t h, int64_t rb, int bpp, int mode, int early,
    int sticky, uint8_t* __restrict__ out) {
  const int64_t r = blockIdx.x;  // image * h + y
  const int64_t img = r / h, y = r - img * h;
  const uint8_t* cur = rows + r * rb;
  const uint8_t* prev = y > 0 ? cur - rb : nullptr;
  int chosen = mode;
  if (mode >= 5) {
    // the sticky adaptive-fast rule takes row 0's choice for every row
    const int64_t sy = sticky ? 0 : y;
    const uint8_t* scur = rows + (img * h + sy) * rb;
    int s[kFilters];
    row_scores(scur, sy > 0 ? scur - rb : nullptr, rb, bpp, s);
    chosen = mode == 5 ? select_adaptive(s, early) : select_adaptive_fast(s, early);
  }
  uint8_t* orow = out + r * (rb + 1);
  if (threadIdx.x == 0) orow[0] = static_cast<uint8_t>(chosen);
  switch (chosen) {  // uniform over the block
    case 0: write_row<0>(cur, prev, rb, bpp, orow + 1); break;
    case 1: write_row<1>(cur, prev, rb, bpp, orow + 1); break;
    case 2: write_row<2>(cur, prev, rb, bpp, orow + 1); break;
    case 3: write_row<3>(cur, prev, rb, bpp, orow + 1); break;
    default: write_row<4>(cur, prev, rb, bpp, orow + 1); break;
  }
}

static bool valid_rows(int64_t batch, int64_t h, int64_t rb, int32_t bpp) {
  return batch >= 1 && h >= 1 && rb >= 1 && bpp >= 1 && bpp <= 8 && batch * h <= INT_MAX;
}

}  // namespace pixo

extern "C" {

// rows: [batch, h, rb] uint8 on the device; bpp 1..8. Outputs on the device:
// cands [batch, 5, h, rb] uint8, scores [batch, h, 5] int32. Returns
// cudaGetLastError().
int pixo_filter_bank(const uint8_t* rows, int64_t batch, int64_t h, int64_t rb, int32_t bpp,
                     uint8_t* cands, int32_t* scores, void* stream) {
  using namespace pixo;
  if (!valid_rows(batch, h, rb, bpp)) return static_cast<int>(cudaErrorInvalidValue);
  filter_bank_kernel<<<static_cast<unsigned>(batch * h), kFilterThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(rows, h, rb, bpp, cands, scores);
  return static_cast<int>(cudaGetLastError());
}

// rows: [batch, h, rb] uint8 on the device; bpp 1..8. mode: 0-4 a fixed
// filter, 5 adaptive/min-sum, 6 adaptive-fast; early: the selection's stop
// score (rb/4+1 for 5, rb/8+1 for 6); sticky (mode 6 only): every row takes
// row 0's choice. out: [batch, h, rb + 1] uint8 on the device, each row's
// filter id first. Returns cudaGetLastError().
int pixo_filter_rows(const uint8_t* rows, int64_t batch, int64_t h, int64_t rb, int32_t bpp,
                     int32_t mode, int32_t early, int32_t sticky, uint8_t* out, void* stream) {
  using namespace pixo;
  if (!valid_rows(batch, h, rb, bpp) || mode < 0 || mode > 6 || (sticky && mode != 6)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  filter_rows_kernel<<<static_cast<unsigned>(batch * h), kFilterThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(rows, h, rb, bpp, mode, early,
                                                            sticky, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
