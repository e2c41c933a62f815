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
// through the L1 and L2 caches, for the lengths. The design, 8 launches a
// call, each over the whole card:
//
// - hash4_kernel: a thread a position; the 4 bytes at p come from two
//   aligned words and one __funnelshift_r, zero past the end.
// - The chain is the run of equal hashes in a STABLE sort of the positions
//   0..n-4 by their 16-bit hash (the last three positions are never inserted
//   by the host and join no chain). The sort is two 8-bit LSD counting
//   passes of three launches each: digit_hist_kernel counts each
//   4096-position tile's 256 digits in shared memory (atomics: a count has
//   no order), written bin-major [256, tiles]; bin_scan_kernel, a CTA a bin,
//   scans its row of tiles in place with coalesced loads (a block scan of
//   256 counts a round, the carry from round to round) and writes the bin's
//   total; digit_scatter_kernel scans the 256 totals in shared memory for
//   each bin's first slot, adds its tile's offset within the bin, and walks
//   its tile in position order, 256 elements a round: __match_any_sync
//   groups the lanes of a warp with the same digit, a lane's rank is the
//   count of its group's lower lanes, the warps' counts go through shared
//   memory in warp order, and a running slot a digit is carried from round
//   to round. Order within a digit is thus the input order, which atomics on
//   the slots would lose. No state lives outside the call's workspace: the
//   PNG pool calls it from eight threads at once.
// - chain_rows_kernel: a CTA takes 512 consecutive sorted indices and the
//   32 before them and stages, a thread an index, its hash, its position p,
//   the 16 bytes from p and p's run (the bytes from p equal to d[p], at most
//   258 and up to n: from those 16 bytes, or, where all 16 are one byte, 16
//   lanes at once over the next 256) in shared memory, so that an index's k
//   neighbours share one read. A group of lanes (k rounded up to a power of
//   two, at most 32: half a warp at the route's k = 16) takes one sorted
//   index i: lane j finds candidate j (sorted index i - 1 - j, while the
//   hash is equal) and its length, and the group writes row spos[i]'s k
//   candidates and k lengths as two contiguous runs (64 bytes each at k =
//   16, whole sectors). A lane past 32 takes candidates j, j + 32, ... and
//   reads those more than 32 back from global memory. The last CTA writes
//   the rows of the last three positions (-1 / 0). Rows are indexed in 64
//   bits (n * k passes 2^31 at n past 134,217,727).
// - Lengths (cand_len): a candidate c of p lies before it (c < p), so its
//   side never passes the end before p's does and match_len's clipping never
//   acts. Where p and c start with the same byte and their runs differ, the
//   match ends where the shorter run does; where both reach 258 it is 258:
//   the long matches of filtered rows (runs of zeros) take no compare. Else
//   the first 16 bytes come from the staged windows, and where all match
//   chain_len goes on from global memory, 16 bytes a step (four aligned
//   words a side, loaded together, and four funnel shifts); within 276
//   bytes of the end, where those loads would pass it, match_len, which
//   reads no byte past n.
// - match_len (batched_match_lengths) compares 4 bytes at a time: each
//   side's word from two aligned words and a funnel shift, the first
//   mismatch from __ffs of the XOR. It takes a byte loop where the JAX
//   version's clipping matters (cand + max_len > n, or a negative index):
//   there the b side is clipped to [0, n - 1] and does not end the match, as
//   the JAX gather does.

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kLzThreads = 256;
constexpr int kSortRounds = 16;                      // elements a thread takes in a tile
constexpr int kSortTile = kLzThreads * kSortRounds;  // 4096 positions a tile
constexpr int kRowTile = 512;                        // sorted indices a CTA of the rows' kernel
constexpr int kStageBack = 32;                       // sorted indices it stages before its tile
constexpr int kMaxMatch = 258;
constexpr int kFastRoom = 276;  // bytes from p to the end that 17 steps of 16 bytes may load
constexpr int kWindow = 16;     // bytes of each staged position the rows' kernel keeps in shared memory
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

// The first byte where a and b differ, or 16.
__device__ __forceinline__ int first_diff(uint4 a, uint4 b) {
  const uint32_t x0 = a.x ^ b.x, x1 = a.y ^ b.y, x2 = a.z ^ b.z, x3 = a.w ^ b.w;
  if (!(x0 | x1 | x2 | x3)) return 16;
  const int q = x0 ? 0 : (x1 ? 1 : (x2 ? 2 : 3));
  const uint32_t x = x0 ? x0 : (x1 ? x1 : (x2 ? x2 : x3));
  return 4 * q + ((__ffs(static_cast<int>(x)) - 1) >> 3);
}

// match_len(d, n, p, c, max_len) for 0 <= c < p and max_len <= 258: 16
// bytes a step (four aligned words a side, loaded together, and four funnel
// shifts) where p + kFastRoom <= n (every word it loads lies below n).
__device__ __forceinline__ int chain_len(const uint8_t* __restrict__ d, int64_t n, int64_t p, int64_t c,
                                         int max_len) {
  if (p + kFastRoom > n) return match_len(d, n, p, c, max_len);
  const uint32_t* __restrict__ w = reinterpret_cast<const uint32_t*>(d);
  int64_t wa = p >> 2, wb = c >> 2;
  const int sa = 8 * static_cast<int>(p & 3), sb = 8 * static_cast<int>(c & 3);
  uint32_t a0 = __ldg(w + wa), b0 = __ldg(w + wb);
  for (int j = 0; j < max_len; j += 16, wa += 4, wb += 4) {
    const uint32_t a1 = __ldg(w + wa + 1), a2 = __ldg(w + wa + 2), a3 = __ldg(w + wa + 3), a4 = __ldg(w + wa + 4);
    const uint32_t b1 = __ldg(w + wb + 1), b2 = __ldg(w + wb + 2), b3 = __ldg(w + wb + 3), b4 = __ldg(w + wb + 4);
    const int m = j + first_diff(make_uint4(__funnelshift_r(a0, a1, sa), __funnelshift_r(a1, a2, sa),
                                            __funnelshift_r(a2, a3, sa), __funnelshift_r(a3, a4, sa)),
                                 make_uint4(__funnelshift_r(b0, b1, sb), __funnelshift_r(b1, b2, sb),
                                            __funnelshift_r(b2, b3, sb), __funnelshift_r(b3, b4, sb)));
    if (m < j + 16) return m < max_len ? m : max_len;
    a0 = a4;
    b0 = b4;
  }
  return max_len;
}

// Bytes p..p+15 of d[0, n) (p >= 0), zero past n: five aligned words and
// four funnel shifts where p + 20 <= n.
__device__ __forceinline__ uint4 bytes16_at(const uint8_t* __restrict__ d, int64_t n, int64_t p) {
  if (p + 20 > n)
    return make_uint4(bytes_at(d, n, p), bytes_at(d, n, p + 4), bytes_at(d, n, p + 8), bytes_at(d, n, p + 12));
  const uint32_t* __restrict__ w = reinterpret_cast<const uint32_t*>(d) + (p >> 2);
  const int sh = 8 * static_cast<int>(p & 3);
  const uint32_t w0 = __ldg(w), w1 = __ldg(w + 1), w2 = __ldg(w + 2), w3 = __ldg(w + 3), w4 = __ldg(w + 4);
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh), __funnelshift_r(w2, w3, sh),
                    __funnelshift_r(w3, w4, sh));
}

// The first byte of v that is not b (a byte repeated in each of a word's
// four), or 16.
__device__ __forceinline__ int first_other(uint4 v, uint32_t b) { return first_diff(v, make_uint4(b, b, b, b)); }

// The length of chain candidate c of p (0 <= c < p), at most 258, from the
// staged windows (bytes c.. and p.., zero past n) and runs (the bytes from
// c and from p equal to their first, at most 258 and up to n). Where both
// start with one byte and their runs differ in length, the match ends where
// the shorter run does; where both runs reach 258, it is 258. Else the
// first kWindow bytes come from the windows and the rest, where those all
// match, from global memory.
__device__ __forceinline__ int cand_len(const uint8_t* __restrict__ d, int64_t n, int64_t p, int64_t c,
                                        uint4 win_c, uint4 win_p, int run_c, int run_p) {
  if (((win_p.x ^ win_c.x) & 0xffu) == 0 && (run_p != run_c || run_p == kMaxMatch))
    return run_p < run_c ? run_p : run_c;
  const int limit = n - p < kMaxMatch ? static_cast<int>(n - p) : kMaxMatch;
  int m = first_diff(win_p, win_c);
  if (m == kWindow && limit > kWindow) m += chain_len(d, n, p + kWindow, c + kWindow, kMaxMatch - kWindow);
  return m < limit ? m : limit;
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

// The exclusive scan of v over the CTA's kLzThreads threads in thread
// order; total gets the sum of all. Every thread must call it.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v, int32_t* warp_sums, int32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int32_t before = 0;
  total = 0;
  for (int w = 0; w < kLzThreads / 32; w++) {
    const int32_t s = warp_sums[w];
    before += w < warp ? s : 0;
    total += s;
  }
  __syncthreads();  // warp_sums may be written again
  return before + incl - v;
}

// A CTA a bin: counts[bin * ntiles + t] <- the bin's count in tiles 0..t-1,
// in place, and totals[bin] <- the bin's count in all tiles.
__global__ void __launch_bounds__(kLzThreads) bin_scan_kernel(int32_t* __restrict__ counts, int64_t ntiles,
                                                             int32_t* __restrict__ totals) {
  __shared__ int32_t warp_sums[kLzThreads / 32];
  int32_t* row = counts + static_cast<int64_t>(blockIdx.x) * ntiles;
  int32_t carry = 0;
  for (int64_t base = 0; base < ntiles; base += kLzThreads) {
    const int64_t i = base + threadIdx.x;
    const int32_t v = i < ntiles ? row[i] : 0;
    int32_t total;
    const int32_t before = block_exclusive_scan(v, warp_sums, total);
    if (i < ntiles) row[i] = carry + before;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// One stable counting pass: the tile's elements, in order, to the digit's
// first slot (the bins below it, from totals) plus the tile's offset within
// the bin (offsets[digit * ntiles + tile]) onwards. vals_in null: the values
// are the indices themselves (the positions, before the first pass).
__global__ void __launch_bounds__(kLzThreads) digit_scatter_kernel(
    const int32_t* __restrict__ keys_in, const int32_t* __restrict__ vals_in, int64_t m, int shift,
    int64_t ntiles, const int32_t* __restrict__ offsets, const int32_t* __restrict__ totals,
    int32_t* __restrict__ keys_out, int32_t* __restrict__ vals_out) {
  constexpr int kWarps = kLzThreads / 32;
  __shared__ int32_t running[256];          // the digit's next slot
  __shared__ int32_t warp_cnt[kWarps][256];  // this round's count of the digit in each warp
  __shared__ int32_t warp_sums[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tile = blockIdx.x, base = tile * kSortTile;
  int32_t all;
  running[tid] = block_exclusive_scan(totals[tid], warp_sums, all) + offsets[tid * ntiles + tile];
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

// Rows of the tables: a CTA kRowTile sorted indices, a group of `group`
// lanes (a power of two, at most 32) a sorted index i < m (row spos[i]);
// the last CTA also writes the rows of the tail positions m..n-1 (-1 / 0).
__global__ void __launch_bounds__(kLzThreads) chain_rows_kernel(
    const uint8_t* __restrict__ d, int64_t n, const int32_t* __restrict__ skey,
    const int32_t* __restrict__ spos, int64_t m, int k, int group, int32_t* __restrict__ cand,
    int32_t* __restrict__ lens) {
  __shared__ int32_t s_key[kStageBack + kRowTile];
  __shared__ int32_t s_pos[kStageBack + kRowTile];
  __shared__ uint4 s_win[kStageBack + kRowTile];  // bytes p..p+15 of each (kWindow), zero past n
  __shared__ int32_t s_run[kStageBack + kRowTile];  // the bytes from p equal to d[p], at most 258
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kRowTile;
  const int back = k < kStageBack ? k : kStageBack;
  const int64_t lo = i0 > back ? i0 - back : 0;  // the first sorted index staged
  const int64_t hi = i0 + kRowTile < m ? i0 + kRowTile : m;
  const int staged = static_cast<int>(hi - lo);
  for (int e = threadIdx.x; e < staged; e += kLzThreads) {  // a thread a staged index
    const int64_t p = spos[lo + e];
    const uint4 win = bytes16_at(d, n, p);
    const int r = first_other(win, (win.x & 0xffu) * 0x01010101u);
    const int room = static_cast<int>(n - p < kWindow + 1 ? n - p : kWindow + 1);  // kWindow + 1: more
    s_key[e] = skey[lo + e];
    s_pos[e] = static_cast<int32_t>(p);
    s_win[e] = win;
    s_run[e] = r < kWindow || room <= kWindow ? (r < room ? r : room) : -1;  // -1: past the window
  }
  __syncthreads();
  for (int e0 = 0; e0 < staged; e0 += kLzThreads / 16) {  // runs past the window: 16 lanes a position
    const int e = e0 + static_cast<int>(threadIdx.x >> 4);
    if (e < staged && s_run[e] < 0) {
      const int64_t p = s_pos[e];
      const uint32_t b = (s_win[e].x & 0xffu) * 0x01010101u;
      const int rel = first_other(bytes16_at(d, n, p + kWindow + 16 * (threadIdx.x & 15)), b);
      const int half = threadIdx.x & 16;
      const unsigned mask = 0xffffu << half;
      const unsigned hit = (__ballot_sync(mask, rel < 16) >> half) & 0xffffu;
      int r = kMaxMatch;
      if (hit) {
        const int f = __ffs(static_cast<int>(hit)) - 1;
        r = kWindow + 16 * f + __shfl_sync(mask, rel, half + f);
      }
      const int64_t room = n - p;
      const int64_t cap = room < kMaxMatch ? room : kMaxMatch;
      if ((threadIdx.x & 15) == 0) s_run[e] = static_cast<int>(r < cap ? r : cap);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & (group - 1);
  const int groups = kLzThreads / group;
  for (int64_t i = i0 + threadIdx.x / group; i < hi; i += groups) {
    const int32_t key = s_key[i - lo];
    const int64_t p = s_pos[i - lo];
    int32_t* crow = cand + p * k;
    int32_t* lrow = lens + p * k;
    for (int j = lane; j < k; j += group) {
      const int64_t at = i - 1 - j;
      int32_t c = -1, len = 0;
      if (at >= lo) {
        if (s_key[at - lo] == key) {
          c = s_pos[at - lo];
          len = cand_len(d, n, p, c, s_win[at - lo], s_win[i - lo], s_run[at - lo], s_run[i - lo]);
        }
      } else if (at >= 0 && __ldg(skey + at) == key) {  // past kStageBack: k > 32
        c = __ldg(spos + at);
        len = chain_len(d, n, p, c, kMaxMatch);
      }
      __stcs(crow + j, c);
      __stcs(lrow + j, len);
    }
  }
  if (blockIdx.x == gridDim.x - 1)
    for (int64_t e = m * k + threadIdx.x; e < n * k; e += kLzThreads) {
      cand[e] = -1;
      lens[e] = 0;
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

// int32 words of the workspace pixo_chain_candidates takes at n bytes: the
// hashes, two keys and two values of m each, the [256, tiles] counts and
// the 256 bins' totals.
int64_t pixo_chain_workspace(int64_t n) {
  using namespace pixo;
  const int64_t m = sorted_positions(n);
  return 5 * m + 256 * sort_tiles(m) + 256;
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
  int32_t* counts = spos + m;             // [256, tiles]
  int32_t* totals = counts + 256 * tiles;  // [256]
  if (m > 0) {
    hash4_kernel<<<lz_grid(m), kLzThreads, 0, s>>>(data, n, m, hash);
    const int32_t* keys_in[2] = {hash, key1};
    const int32_t* vals_in[2] = {nullptr, pos1};
    int32_t* keys_out[2] = {key1, skey};
    int32_t* vals_out[2] = {pos1, spos};
    for (int pass = 0; pass < 2; pass++) {
      digit_hist_kernel<<<static_cast<unsigned>(tiles), kLzThreads, 0, s>>>(keys_in[pass], m, 8 * pass,
                                                                             tiles, counts);
      bin_scan_kernel<<<256, kLzThreads, 0, s>>>(counts, tiles, totals);
      digit_scatter_kernel<<<static_cast<unsigned>(tiles), kLzThreads, 0, s>>>(
          keys_in[pass], vals_in[pass], m, 8 * pass, tiles, counts, totals, keys_out[pass], vals_out[pass]);
    }
  }
  int group = 1;
  while (group < k && group < 32) group <<= 1;
  const int64_t row_ctas = (m + kRowTile - 1) / kRowTile;
  chain_rows_kernel<<<static_cast<unsigned>(row_ctas > 0 ? row_ctas : 1), kLzThreads, 0, s>>>(
      data, n, skey, spos, m, k, group, cand, lens);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
