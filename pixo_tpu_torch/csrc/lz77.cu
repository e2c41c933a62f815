// Device-assisted LZ77 match tables for Hopper (sm_90a).
//
// Replaces the JAX package's ops/lz77_assist.py: hash4 (:36),
// batched_match_lengths (:64) and chain_candidates (:85), the device half
// of the optimal parse's match tables under PIXO_TPU_LZ77=device. For every
// position p of a stream of n bytes, chain_candidates gives the k nearest
// earlier positions whose 4-byte hash equals p's, nearest first (-1 past the
// chain's end), and the exact match length against each: the first k steps
// of the host matcher's hash chain (core.cpp, Matcher::insert), which the
// host's assisted parse (deflate_compress_optimal_assisted) trusts as they
// are. A candidate out of order or a length off by one gives other bytes.
//
// What bounds it on the card: the tables. They are 8 * k bytes a position
// (n * k int32 candidates and as many lengths), 128 bytes a byte of input at
// k = 16, written once; the input is read once for the hashes and again,
// through the L1 and L2 caches, for the lengths. The design:
//
// - hash4_kernel: a thread a position; the 4 bytes at p come from two
//   aligned words and one __funnelshift_r, zero past the end.
// - The chain is the run of equal hashes in a STABLE sort of the positions
//   0..n-4 by their 16-bit hash (the last three positions are never inserted
//   by the host and join no chain). The sort is two 8-bit LSD counting
//   passes. Each pass: digit_hist_kernel counts each tile's 256 digits in
//   shared memory (atomics: a count has no order), written bin-major, so
//   that one exclusive scan (exclusive_scan_kernel, one CTA, each thread a
//   contiguous run) gives every (digit, tile) its first slot; then
//   digit_scatter_kernel walks its tile in position order, 256 elements a
//   round: __match_any_sync groups the lanes of a warp with the same digit,
//   a lane's rank is the count of its group's lower lanes, the warps'
//   counts go through shared memory in warp order, and a running slot a
//   digit is carried from round to round. Order within a digit is thus the
//   input order, which atomics on the slots would lose.
// - chain_kernel: a thread a sorted index i walks i - 1, i - 2, ... while
//   the hash is equal, up to k, and writes row spos[i] of the tables, each
//   length from match_len (below); rows of the last three positions are
//   -1 / 0. Rows are indexed in 64 bits (n * k passes 2^31 at n past
//   134,217,727).
// - match_len compares 4 bytes at a time: each side's word from two aligned
//   words and a funnel shift, the first mismatch from __ffs of the XOR. It
//   takes a byte loop where the JAX version's clipping matters
//   (cand + max_len > n, or a negative index): there the b side is clipped
//   to [0, n - 1] and does not end the match, as the JAX gather does.

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kLzThreads = 256;
constexpr int kSortRounds = 16;                      // elements a thread takes in a tile
constexpr int kSortTile = kLzThreads * kSortRounds;  // 4096 positions a tile
constexpr int kScanThreads = 1024;
constexpr int kMaxMatch = 258;
constexpr uint32_t kHashMul = 2654435761u;
constexpr int kHashShift = 16;  // 32 - HASH_BITS

// The 32-bit little-endian word of bytes 4w..4w+3 of d[0, n): one aligned
// load where it lies wholly inside, else its bytes below n and zeros.
__device__ __forceinline__ uint32_t word_at(const uint8_t* __restrict__ d, int64_t n, int64_t w) {
  const int64_t b = 4 * w;
  if (b + 4 <= n) return __ldg(reinterpret_cast<const uint32_t*>(d) + w);
  uint32_t v = 0;
  for (int i = 0; i < 4; i++)
    if (b + i < n) v |= static_cast<uint32_t>(d[b + i]) << (8 * i);
  return v;
}

// Bytes p..p+3 of d as a little-endian word, zero past n (p >= 0).
__device__ __forceinline__ uint32_t bytes_at(const uint8_t* __restrict__ d, int64_t n, int64_t p) {
  return __funnelshift_r(word_at(d, n, p >> 2), word_at(d, n, (p >> 2) + 1), 8 * static_cast<int>(p & 3));
}

__device__ __forceinline__ int32_t hash_of(uint32_t v) {
  return static_cast<int32_t>((v * kHashMul) >> kHashShift);
}

// The length of the match of d[pos..] against d[cand..], at most max_len:
// the first j where pos + j >= n or d[pos + j] != d[clip(cand + j, 0, n - 1)].
__device__ int match_len(const uint8_t* __restrict__ d, int64_t n, int64_t pos, int64_t cand,
                         int max_len) {
  if (n <= 0) return 0;
  if (pos >= 0 && cand >= 0 && cand + max_len <= n) {
    const int64_t room = n - pos;
    const int limit = room < max_len ? static_cast<int>(room > 0 ? room : 0) : max_len;
    int64_t wa = pos >> 2, wb = cand >> 2;
    const int sa = 8 * static_cast<int>(pos & 3), sb = 8 * static_cast<int>(cand & 3);
    uint32_t a0 = word_at(d, n, wa), b0 = word_at(d, n, wb);
    for (int j = 0; j < limit; j += 4) {
      const uint32_t a1 = word_at(d, n, ++wa), b1 = word_at(d, n, ++wb);
      const uint32_t x = __funnelshift_r(a0, a1, sa) ^ __funnelshift_r(b0, b1, sb);
      if (x) {
        const int m = j + ((__ffs(static_cast<int>(x)) - 1) >> 3);
        return m < limit ? m : limit;
      }
      a0 = a1;
      b0 = b1;
    }
    return limit;
  }
  for (int j = 0; j < max_len; j++) {
    const int64_t ai = pos + j, bi = cand + j;
    if (ai >= n) return j;
    if (d[ai < 0 ? 0 : ai] != d[bi < 0 ? 0 : (bi >= n ? n - 1 : bi)]) return j;
  }
  return max_len;
}

// out[p] for the first `count` positions of d[0, n).
__global__ void __launch_bounds__(kLzThreads) hash4_kernel(const uint8_t* __restrict__ d, int64_t n,
                                                          int64_t count, int32_t* __restrict__ out) {
  for (int64_t p = blockIdx.x * static_cast<int64_t>(kLzThreads) + threadIdx.x; p < count;
       p += static_cast<int64_t>(gridDim.x) * kLzThreads)
    out[p] = hash_of(bytes_at(d, n, p));
}

__global__ void __launch_bounds__(kLzThreads) match_lengths_kernel(
    const uint8_t* __restrict__ d, int64_t n, const int32_t* __restrict__ pos,
    const int32_t* __restrict__ cand, int64_t m, int max_len, int32_t* __restrict__ out) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kLzThreads) + threadIdx.x; i < m;
       i += static_cast<int64_t>(gridDim.x) * kLzThreads)
    out[i] = match_len(d, n, pos[i], cand[i], max_len);
}

// counts[bin * ntiles + tile]: the elements of the tile whose digit
// (key >> shift) & 255 is bin.
__global__ void __launch_bounds__(kLzThreads) digit_hist_kernel(const int32_t* __restrict__ keys,
                                                               int64_t m, int shift, int64_t ntiles,
                                                               int32_t* __restrict__ counts) {
  __shared__ int32_t hist[256];
  const int tid = threadIdx.x;
  hist[tid] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSortTile;
  for (int r = 0; r < kSortRounds; r++) {
    const int64_t i = base + r * kLzThreads + tid;
    if (i < m) atomicAdd(&hist[(keys[i] >> shift) & 255], 1);
  }
  __syncthreads();
  counts[tid * ntiles + blockIdx.x] = hist[tid];
}

// In place: v[i] <- v[0] + ... + v[i - 1], over total < 2^31 elements whose
// sum fits int32. One CTA; each thread a contiguous run.
__global__ void __launch_bounds__(kScanThreads) exclusive_scan_kernel(int32_t* __restrict__ v,
                                                                     int64_t total) {
  __shared__ int32_t warp_sums[kScanThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t run = (total + kScanThreads - 1) / kScanThreads;
  const int64_t lo = tid * run < total ? tid * run : total;
  const int64_t hi = lo + run < total ? lo + run : total;
  int32_t sum = 0;
  for (int64_t i = lo; i < hi; i++) sum += v[i];
  int32_t incl = sum;  // inclusive scan of the runs' sums across the CTA
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int32_t w = warp_sums[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t o = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += o;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int32_t acc = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int64_t i = lo; i < hi; i++) {
    const int32_t x = v[i];
    v[i] = acc;
    acc += x;
  }
}

// One stable counting pass: the tile's elements, in order, to
// offsets[digit * ntiles + tile] onwards. vals_in null: the values are the
// indices themselves (the positions, before the first pass).
__global__ void __launch_bounds__(kLzThreads) digit_scatter_kernel(
    const int32_t* __restrict__ keys_in, const int32_t* __restrict__ vals_in, int64_t m, int shift,
    int64_t ntiles, const int32_t* __restrict__ offsets, int32_t* __restrict__ keys_out,
    int32_t* __restrict__ vals_out) {
  constexpr int kWarps = kLzThreads / 32;
  __shared__ int32_t running[256];          // the digit's next slot
  __shared__ int32_t warp_cnt[kWarps][256];  // this round's count of the digit in each warp
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tile = blockIdx.x, base = tile * kSortTile;
  running[tid] = offsets[tid * ntiles + tile];
  for (int w = 0; w < kWarps; w++) warp_cnt[w][tid] = 0;
  __syncthreads();
  const uint32_t lower = (1u << lane) - 1;
  for (int r = 0; r < kSortRounds && base + r * kLzThreads < m; r++) {
    const int64_t i = base + r * kLzThreads + tid;
    const bool valid = i < m;
    const int32_t key = valid ? keys_in[i] : 0;
    const int32_t val = valid ? (vals_in ? vals_in[i] : static_cast<int32_t>(i)) : 0;
    const int digit = valid ? (key >> shift) & 255 : 256;  // 256: no element
    const uint32_t peers = __match_any_sync(0xffffffffu, digit);
    if (valid && lane == __ffs(peers) - 1) warp_cnt[warp][digit] = __popc(peers);
    __syncthreads();
    if (valid) {
      int32_t dest = running[digit] + __popc(peers & lower);
      for (int w = 0; w < warp; w++) dest += warp_cnt[w][digit];
      keys_out[dest] = key;
      vals_out[dest] = val;
    }
    __syncthreads();
    int32_t add = 0;
    for (int w = 0; w < kWarps; w++) {
      add += warp_cnt[w][tid];
      warp_cnt[w][tid] = 0;
    }
    running[tid] += add;
    __syncthreads();
  }
}

// Rows of the tables: a thread a sorted index i < m (row spos[i]), or a tail
// position i in [m, n) (-1 / 0).
__global__ void __launch_bounds__(kLzThreads) chain_kernel(
    const uint8_t* __restrict__ d, int64_t n, const int32_t* __restrict__ skey,
    const int32_t* __restrict__ spos, int64_t m, int k, int32_t* __restrict__ cand,
    int32_t* __restrict__ lens) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(kLzThreads) + threadIdx.x; i < n;
       i += static_cast<int64_t>(gridDim.x) * kLzThreads) {
    int kk = 0;
    int64_t row = i;
    if (i < m) {
      const int32_t key = skey[i];
      const int64_t p = spos[i];
      row = p;
      for (; kk < k && i - 1 - kk >= 0 && skey[i - 1 - kk] == key; kk++) {
        const int32_t c = spos[i - 1 - kk];
        cand[row * k + kk] = c;
        lens[row * k + kk] = match_len(d, n, p, c, kMaxMatch);
      }
    }
    for (; kk < k; kk++) {
      cand[row * k + kk] = -1;
      lens[row * k + kk] = 0;
    }
  }
}

inline unsigned lz_grid(int64_t items) {
  const int64_t blocks = (items + kLzThreads - 1) / kLzThreads;
  return static_cast<unsigned>(blocks < (1 << 20) ? (blocks > 0 ? blocks : 1) : (1 << 20));
}

inline bool aligned4(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 3) == 0; }

// The positions a chain sort takes and its tiles.
inline int64_t sorted_positions(int64_t n) { return n >= 4 ? n - 3 : 0; }
inline int64_t sort_tiles(int64_t m) { return (m + kSortTile - 1) / kSortTile; }

}  // namespace pixo

extern "C" {

// data: [n] uint8 on the device, 4-byte aligned; out: [n] int32.
int pixo_hash4(const uint8_t* data, int64_t n, int32_t* out, void* stream) {
  using namespace pixo;
  if (n <= 0 || !aligned4(data)) return static_cast<int>(cudaErrorInvalidValue);
  hash4_kernel<<<lz_grid(n), kLzThreads, 0, static_cast<cudaStream_t>(stream)>>>(data, n, n, out);
  return static_cast<int>(cudaGetLastError());
}

// data: [n] uint8 (n >= 0; 4-byte aligned); pos, cand, out: [m] int32, m >= 1.
int pixo_match_lengths(const uint8_t* data, int64_t n, const int32_t* pos, const int32_t* cand,
                       int64_t m, int32_t max_len, int32_t* out, void* stream) {
  using namespace pixo;
  if (n < 0 || m <= 0 || max_len < 0 || !aligned4(data)) return static_cast<int>(cudaErrorInvalidValue);
  match_lengths_kernel<<<lz_grid(m), kLzThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      data, n, pos, cand, m, max_len, out);
  return static_cast<int>(cudaGetLastError());
}

// int32 words of the workspace pixo_chain_candidates takes at n bytes.
int64_t pixo_chain_workspace(int64_t n) {
  using namespace pixo;
  const int64_t m = sorted_positions(n);
  return 5 * m + 256 * sort_tiles(m);
}

// data: [n] uint8 on the device (1 <= n < 2^31, 4-byte aligned); cand, lens:
// [n, k] int32; work: pixo_chain_workspace(n) int32 words. Launches the
// hashes, two counting passes of three kernels each and the rows' kernel.
int pixo_chain_candidates(const uint8_t* data, int64_t n, int32_t k, int32_t* work, int32_t* cand,
                          int32_t* lens, void* stream) {
  using namespace pixo;
  if (n <= 0 || n > 0x7fffffffll || k < 1 || !aligned4(data)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t m = sorted_positions(n), tiles = sort_tiles(m);
  int32_t* hash = work;  // [m]: the first m hashes; pass 1 reads them in place
  int32_t* key1 = hash + m;
  int32_t* pos1 = key1 + m;
  int32_t* skey = pos1 + m;
  int32_t* spos = skey + m;
  int32_t* counts = spos + m;  // [256, tiles]
  if (m > 0) {
    hash4_kernel<<<lz_grid(m), kLzThreads, 0, s>>>(data, n, m, hash);
    const int32_t* keys_in[2] = {hash, key1};
    const int32_t* vals_in[2] = {nullptr, pos1};
    int32_t* keys_out[2] = {key1, skey};
    int32_t* vals_out[2] = {pos1, spos};
    for (int pass = 0; pass < 2; pass++) {
      digit_hist_kernel<<<static_cast<unsigned>(tiles), kLzThreads, 0, s>>>(keys_in[pass], m, 8 * pass,
                                                                             tiles, counts);
      exclusive_scan_kernel<<<1, kScanThreads, 0, s>>>(counts, 256 * tiles);
      digit_scatter_kernel<<<static_cast<unsigned>(tiles), kLzThreads, 0, s>>>(
          keys_in[pass], vals_in[pass], m, 8 * pass, tiles, counts, keys_out[pass], vals_out[pass]);
    }
  }
  chain_kernel<<<lz_grid(n), kLzThreads, 0, s>>>(data, n, skey, spos, m, k, cand, lens);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
