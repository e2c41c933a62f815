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
//   as PNG rows [B, H, RB+1]. Mode 7 is the max preset's Bigrams, the JAX
//   package's _bigram_scores and argmin (pixo_tpu/ops/png_filters.py:85,161):
//   for each row the candidate with the fewest distinct byte pairs
//   (c[i], c[i+1]), the lowest filter id on a tie.
//
// What bounds it on the card: bytes by the count (each input byte read once,
// each output byte written once, a few integer operations a byte), but
// the instruction rate in fact: a byte-at-a-time kernel spends some 50
// instructions a byte.
//
// Design of pixo_filter_rows, the strip kernel (rows that fit the
// shared-memory budget; the wrapper picks it by shape alone,
// ops/kernels.py::filter_rows_plan):
// - a thread block takes a strip of up to 8 consecutive rows of one image and
//   the row above the strip. The strip is contiguous in device memory, so it
//   comes into shared memory as aligned 16-byte cp.async granules, landing at
//   the same offset modulo 16 as in device memory, with single bytes at the
//   two ends: any row length and any byte offset. Each input byte is fetched
//   from device memory once (the row above a strip twice);
// - a warp a row. A lane works on 32-bit words of four bytes: the row's words
//   and those of its left, upper and upper-left neighbours are unaligned
//   reads of shared memory (two aligned words and a funnel shift), the left
//   edge is a mask on the row's first two words, which, with the row's last
//   partial word, are taken apart from the loop over whole words. The
//   filters are per-byte SIMD arithmetic on the word (__vsub4, __vhaddu4 for
//   Average's floor, __vabsdiffu4); Paeth takes the order form: with pa = |b - c| and
//   pb = |a - c|, pc = |a + b - 2c| is pa + pb (never the least) unless c lies
//   between a and b, and there it is |pa - pb|, so every value fits a byte
//   and the tie order a, b, c holds. The scores are __vsadu4 sums, reduced
//   over the warp with shuffles: no barrier inside a row;
// - the rule reads the scores in its own order, so they are taken in two
//   sweeps of shared memory and the second is skipped where the rule has
//   stopped (adaptive: None, Sub, Up, then Average, Paeth; adaptive-fast:
//   Sub, then Up, Paeth);
// - the chosen filter is applied from shared memory into a staging copy of
//   the strip's output rows (contiguous in [B, H, RB+1], each type byte in
//   place), which leaves as aligned 16-byte stores with single bytes at the
//   two ends. Two block-wide barriers a strip: after the copy in, before the
//   copy out;
// - with the sticky adaptive-fast rule (height <= 32) every warp scores row 0
//   of its image itself (staged beside the strip), so no block waits on
//   another.
// - Bigrams (mode 7), its own instance of both kernels (the other modes' code
//   is as it was): a row's distinct pairs are counted in a bitmap of the
//   65,536 pair keys, 8 KB of shared memory a row in flight. The five
//   candidates take turns on one bitmap, a sweep each (count_pairs): a lane
//   computes each word of the candidate once and takes the byte one on from
//   the next lane's word by a shuffle; each pair is one atomicOr of its bit,
//   counted where the bit was clear; a pair whose key equals the pair's
//   before it is not marked (so a run of one residual pair marks once a
//   step), and such a lane ORs 0 into a spare word of its own bank instead,
//   so that no mark needs a branch. After a __syncwarp the warp empties the
//   bitmap with 16-byte zero stores for the next candidate. The counts stay
//   in registers, summed over the warp with shuffles. What bounds mode 7 is
//   the integer pipe: some 70 to 100 instructions a word and candidate, most
//   of them forming, filtering and addressing the four pairs.
// Rows above the budget (a row may hold 65,535 x 8 bytes) take the long-row
// kernel, the first design: one thread block a row, byte by byte from device
// memory in two sweeps, the scores reduced through shared memory. On the
// main path's rows of 1,536 bytes it gave each thread six bytes, fetched
// every byte with four 1-byte loads in each sweep and reached an eighth of
// the byte bound. pixo_filter_bank has the same two kernels: its strip kernel
// stages the rows alike and takes all five candidates of a word in one
// sweep. All arithmetic is integer, as on the TPU: every result is exact.
//
// Device times (NVIDIA H100 80GB HBM3, 700 W, one run of both designs):
// 8x512 rows of 1,536 bytes, adaptive: 0.0168 ms against the long-row
// design's 0.0300; 16x512 rows, adaptive-fast: 0.0249 against 0.0556. By
// strategy on the 8x512 rows: None, the skeleton (copy in, one sweep that
// moves the words, copy out), 5.5 us; Sub 6.1; Paeth 8.5; adaptive 16.9: its
// two scoring sweeps are half the time, at some 140 instructions a word over
// the three sweeps, so the instruction rate holds the kernel above its byte
// bound of 3.8 us. Tried, and no faster: strips of 1, 2, 3, 4 and 6 rows
// (all within a tenth of strips of 8: the staging is not what holds it).
// Tried and lost: the masks for the left edge and the last word
// computed for every word instead of for the edge words alone (18.5 us).
// Mode 7 on the same rows (PNG cell (e)'s device group): 52.9 us, 43.8 on
// noise rows, against 132.7 and 103.7 for its first design (every word
// computed four times, a pass that recomputed the keys to clear them, an
// atomic a pair); without its marks 37.2 us. Tried and lost: __match_any_sync
// to merge the lanes of one bitmap word (0.80 ms), counting by __popc in the
// clearing sweep (59.6), a test of the bit before each mark (65.5), a branch
// around each mark (63.7), the bank from the second byte (54.3), two steps
// an iteration (53.2), strips of 1 to 7 rows (52.2 to 65.7).
// Rows are named by offsets into the shared memory, not by pointers: with
// pointers in a struct the loads compiled to generic LD instead of LDS.

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kFilterThreads = 256;
constexpr int kFilters = 5;
constexpr int kBigramBytes = 8192;  // a bitmap of the 65,536 byte pairs (mode 7)

// The kernels' dynamic shared memory. Rows and bitmaps are named by their
// byte offset in it, so that every access is known to be a shared-memory one.
extern __shared__ __align__(16) uint8_t smem[];

// Sets the bit of pair `key` in the bitmap at offset `bits` of the shared
// memory; 1 if it was clear (the pair is new to the bitmap), else 0.
__device__ __forceinline__ int mark_pair(int bits, uint32_t key) {
  const uint32_t bit = 1u << (key & 31);
  return (atomicOr(reinterpret_cast<uint32_t*>(smem + bits) + (key >> 5), bit) & bit) ? 0 : 1;
}

// Clears the word of pair `key` in the bitmap at offset `bits`.
__device__ __forceinline__ void clear_pair(int bits, uint32_t key) {
  reinterpret_cast<uint32_t*>(smem + bits)[key >> 5] = 0u;
}

// The filter with the fewest distinct pairs, the lowest id on a tie (the host
// library's strict <, jnp.argmin).
__device__ __forceinline__ int select_fewest(const int (&s)[kFilters]) {
  int chosen = 0;
#pragma unroll
  for (int f = 1; f < kFilters; ++f) {
    if (s[f] < s[chosen]) chosen = f;
  }
  return chosen;
}

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

// The pair (byte i, byte i + 1) of the row filtered with F, as the key
// byte i << 8 | byte i + 1.
template <int F>
__device__ __forceinline__ uint32_t pair_key(const uint8_t* __restrict__ cur,
                                             const uint8_t* __restrict__ prev, int64_t i, int bpp) {
  int x, a, b, c;
  neighbours(cur, prev, i, bpp, x, a, b, c);
  const int first = filter_byte<F>(x, a, b, c);
  neighbours(cur, prev, i + 1, bpp, x, a, b, c);
  return static_cast<uint32_t>(first) << 8 | static_cast<uint32_t>(filter_byte<F>(x, a, b, c));
}

// Adds this thread's share of the row's distinct pairs under filter F to n;
// the bitmap (offset 0 of the shared memory) is empty before and after.
template <int F>
__device__ void count_pairs_long(const uint8_t* __restrict__ cur, const uint8_t* __restrict__ prev,
                                 int64_t rb, int bpp, int& n) {
  for (int64_t i = threadIdx.x; i + 1 < rb; i += kFilterThreads) {
    n += mark_pair(0, pair_key<F>(cur, prev, i, bpp));
  }
  __syncthreads();
  for (int64_t i = threadIdx.x; i + 1 < rb; i += kFilterThreads) {
    clear_pair(0, pair_key<F>(cur, prev, i, bpp));
  }
  __syncthreads();
}

// One thread block a row. BIGRAMS: mode 7, with kBigramBytes of dynamic
// shared memory for the bitmap.
template <bool BIGRAMS>
__global__ void __launch_bounds__(kFilterThreads) filter_rows_long_kernel(
    const uint8_t* __restrict__ rows, int64_t h, int64_t rb, int bpp, int mode, int early,
    int sticky, uint8_t* __restrict__ out) {
  const int64_t r = blockIdx.x;  // image * h + y
  const int64_t img = r / h, y = r - img * h;
  const uint8_t* cur = rows + r * rb;
  const uint8_t* prev = y > 0 ? cur - rb : nullptr;
  int chosen = mode;
  if (BIGRAMS) {
    for (int i = threadIdx.x; i < kBigramBytes / 4; i += kFilterThreads) {
      reinterpret_cast<uint32_t*>(smem)[i] = 0u;
    }
    __syncthreads();
    int s[kFilters] = {0, 0, 0, 0, 0};
    count_pairs_long<0>(cur, prev, rb, bpp, s[0]);
    count_pairs_long<1>(cur, prev, rb, bpp, s[1]);
    count_pairs_long<2>(cur, prev, rb, bpp, s[2]);
    count_pairs_long<3>(cur, prev, rb, bpp, s[3]);
    count_pairs_long<4>(cur, prev, rb, bpp, s[4]);
    block_sum5(s);
    chosen = select_fewest(s);
  } else if (mode >= 5) {
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

// ---- the strip kernel ----

constexpr int kStripRows = 8;                  // rows a strip, a warp each
constexpr int kStripMaxSmem = 200 * 1024;      // ops/kernels.py::FILTER_SMEM_BUDGET
constexpr uint32_t kHigh = 0x80808080u;

// Shared-memory bytes of a region that holds n staged bytes: 16 before them
// (the left neighbours of a row's first bytes are read, then masked), up to
// 15 of alignment, and room after them for a whole last word.
__host__ __device__ inline int64_t region_bytes(int64_t n) { return (n + 63) & ~int64_t(15); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// Copies g[0, n) into the 16-byte aligned region at offset `region` of the
// shared memory, at the same offset modulo 16 as in device memory, with
// every thread of the block; returns the offset where g[0] lands. The
// caller commits and waits for the cp.async group.
__device__ __forceinline__ int stage_in(int region, const uint8_t* __restrict__ g, int64_t n) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  uint8_t* dst = smem + region + 16 + mis;
  const int head = static_cast<int>(min(n, static_cast<int64_t>((16 - mis) & 15)));
  const int64_t body = (n - head) & ~int64_t(15);
  const int tail = static_cast<int>(n - head - body);
  const int tid = threadIdx.x;
  if (tid < head) dst[tid] = g[tid];
  for (int64_t i = 16 * int64_t(tid); i < body; i += 16 * int64_t(blockDim.x)) {
    cp_async16(dst + head + i, g + head + i);
  }
  if (tid < tail) dst[head + body + tid] = g[head + body + tid];
  return region + 16 + mis;
}

// Copies n bytes from offset `src` of the shared memory, which is the same
// modulo 16 as g, to g[0, n): aligned 16-byte stores, single bytes at the
// two ends.
__device__ __forceinline__ void stage_out(uint8_t* __restrict__ g, int src, int64_t n) {
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
  const int head = static_cast<int>(min(n, static_cast<int64_t>((16 - mis) & 15)));
  const int64_t body = (n - head) & ~int64_t(15);
  const int tail = static_cast<int>(n - head - body);
  const int tid = threadIdx.x;
  if (tid < head) g[tid] = smem[src + tid];
  for (int64_t i = 16 * int64_t(tid); i < body; i += 16 * int64_t(blockDim.x)) {
    *reinterpret_cast<uint4*>(g + head + i) = *reinterpret_cast<const uint4*>(smem + src + head + i);
  }
  if (tid < tail) g[head + body + tid] = smem[src + head + body + tid];
}

// A stream of unaligned 32-bit words of the shared memory: word k holds the
// bytes at offsets p + 4k .. p + 4k + 3, read as two aligned words and a
// funnel shift.
struct Words {
  int word;
  unsigned shift;
  __device__ __forceinline__ explicit Words(int p) : word(p >> 2), shift(8u * (p & 3)) {}
  __device__ __forceinline__ uint32_t operator[](int k) const {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(smem) + word + k;
    return __funnelshift_r(w[0], w[1], shift);
  }
};

// 0xFF in every byte j of word k of a row that has a left neighbour
// (4k + j >= bpp), and in every byte that lies inside the row (4k + j < rb).
__device__ __forceinline__ uint32_t left_mask(int k, int bpp) {
  const int t = bpp - 4 * k;
  return t <= 0 ? 0xFFFFFFFFu : (t >= 4 ? 0u : 0xFFFFFFFFu << (8 * t));
}
__device__ __forceinline__ uint32_t tail_mask(int k, int rb) {
  const int t = rb - 4 * k;
  return t >= 4 ? 0xFFFFFFFFu : (1u << (8 * t)) - 1u;
}

// Four bytes at once: x filtered with filter F from its neighbours, mod 256.
template <int F>
__device__ __forceinline__ uint32_t filter_word(uint32_t x, uint32_t a, uint32_t b, uint32_t c) {
  if (F == 0) return x;
  if (F == 1) return __vsub4(x, a);
  if (F == 2) return __vsub4(x, b);
  if (F == 3) return __vsub4(x, __vhaddu4(a, b));
  // Paeth. pa = |p - a| = |b - c|, pb = |p - b| = |a - c|; pc = |p - c| is
  // pa + pb, never below either, unless c lies between a and b, where it is
  // |pa - pb|. So: a or b by pa <= pb, and c instead where c lies between
  // and the lesser of pa and pb is above |pa - pb|.
  const uint32_t pa = __vabsdiffu4(b, c), pb = __vabsdiffu4(a, c), pc = __vabsdiffu4(pa, pb);
  const uint32_t between = __vcmpgtu4(a, c) ^ __vcmpgtu4(b, c);
  const uint32_t le = __vcmpleu4(pa, pb);
  const uint32_t ab = (a & le) | (b & ~le), least = (pa & le) | (pb & ~le);
  const uint32_t use_c = between & __vcmpgtu4(least, pc);
  return __vsub4(x, (c & use_c) | (ab & ~use_c));
}

// sum of |byte as i8| over the word's four bytes, added to acc
__device__ __forceinline__ int score_word(uint32_t d, int acc) {
  return static_cast<int>(__vsadu4(d ^ kHigh, kHigh)) + acc;
}

// One raw row in shared memory and the row above it (PREV false: none, zeros).
struct RowIn {
  int cur, prev;  // offsets in the shared memory
  int rb, bpp;
};

// Calls step(k, edge) for every word k of a row of rb bytes, the words dealt
// out to the warp's lanes. edge is std::true_type for the row's first two
// words, whose bytes may have no left neighbour (bpp <= 8), and for its
// last word where that is a partial one: only those pay for the masks.
template <class Step>
__device__ __forceinline__ void for_row_words(int rb, int lane, Step step) {
  const int nfull = rb >> 2, nwords = (rb + 3) >> 2;
  if (lane < 2 && lane < nwords) step(lane, std::true_type{});
  if (lane == 2 && nfull >= 2 && nwords > nfull) step(nfull, std::true_type{});
  for (int k = 2 + lane; k < nfull; k += 32) step(k, std::false_type{});
}

// Loads word k of the row and of the neighbours that the filters in MASK
// (bit f: filter f) read; the others are 0.
template <int MASK, bool PREV, bool EDGE>
__device__ __forceinline__ void load_words(const Words& xs, const Words& as, const Words& bs,
                                           const Words& cs, int k, int bpp, uint32_t& x,
                                           uint32_t& a, uint32_t& b, uint32_t& c) {
  constexpr bool kLeft = (MASK & 0b11010) != 0, kUp = PREV && (MASK & 0b11100) != 0;
  constexpr bool kUpLeft = PREV && (MASK & 0b10000) != 0;
  x = xs[k];
  a = kLeft ? as[k] : 0u;
  b = kUp ? bs[k] : 0u;
  c = kUpLeft ? cs[k] : 0u;
  if (EDGE && (kLeft || kUpLeft)) {
    const uint32_t m = left_mask(k, bpp);
    a &= m;
    c &= m;
  }
}

// Adds the row's scores of the filters in MASK to s, summed over the warp
// (every lane receives the sums).
template <int MASK, bool PREV>
__device__ __forceinline__ void score_row(const RowIn& r, int lane, int (&s)[kFilters]) {
  const Words xs(r.cur), as(r.cur - r.bpp), bs(r.prev), cs(r.prev - r.bpp);
  int t[kFilters] = {0, 0, 0, 0, 0};
  for_row_words(r.rb, lane, [&](int k, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    uint32_t x, a, b, c;
    load_words<MASK, PREV, kEdge>(xs, as, bs, cs, k, r.bpp, x, a, b, c);
    const uint32_t m = kEdge ? tail_mask(k, r.rb) : 0xFFFFFFFFu;
    if (MASK & 1) t[0] = score_word(filter_word<0>(x, a, b, c) & m, t[0]);
    if (MASK & 2) t[1] = score_word(filter_word<1>(x, a, b, c) & m, t[1]);
    if (MASK & 4) t[2] = score_word(filter_word<2>(x, a, b, c) & m, t[2]);
    if (MASK & 8) t[3] = score_word(filter_word<3>(x, a, b, c) & m, t[3]);
    if (MASK & 16) t[4] = score_word(filter_word<4>(x, a, b, c) & m, t[4]);
  });
#pragma unroll
  for (int f = 0; f < kFilters; ++f) {
    if (MASK >> f & 1) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) t[f] += __shfl_xor_sync(0xFFFFFFFFu, t[f], off);
      s[f] = t[f];
    }
  }
}

// The filter the selection rule of `mode` (5 adaptive, 6 adaptive-fast)
// picks for the row: the scores the rule reads first, then, unless it has
// stopped, the others.
template <bool PREV>
__device__ __forceinline__ int choose_filter(const RowIn& r, int mode, int early, int lane) {
  int s[kFilters] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  if (mode == 5) {
    score_row<0b00111, PREV>(r, lane, s);
    if (min(s[0], min(s[1], s[2])) > early) score_row<0b11000, PREV>(r, lane, s);
    return select_adaptive(s, early);
  }
  score_row<0b00010, PREV>(r, lane, s);
  if (s[1] <= early) return 1;
  score_row<0b10100, PREV>(r, lane, s);
  return select_adaptive_fast(s, early);
}

// Mode 7's strip kernel. Pair key (first byte << 8 | second) lies at word
// key >> 5 of a row's bitmap, bit key & 31 (one funnel shift, which takes
// the shift mod 32). spare_word(lane) is a word that only rare pairs take
// (first byte 128 to 131: a residual near -128), one bank a lane: a lane
// with no pair to mark ORs 0 into it, so that the marks need no branch.
__device__ __forceinline__ uint32_t pair_word(uint32_t key) { return key >> 5; }
__device__ __forceinline__ uint32_t pair_bit(uint32_t key) { return __funnelshift_l(0u, 1u, key); }
__device__ __forceinline__ uint32_t spare_word(int lane) { return 1024u + lane; }

// The row's distinct pairs under filter F, summed over the warp (every lane
// receives the sum); the row's bitmap at offset `bits` (16-byte aligned) is
// empty before and after. One sweep: lane l of step s takes word k = 32s + l
// of the candidate, computed once (the first step masks the left edge) and a
// step ahead; the word one byte on is funnel-shifted from word k + 1, lane
// l + 1's, and lane 31's is the next step's lane 0's. Bytes j of the two
// words are the pair that starts at byte 4k + j. Loads past the row's last
// word take that word: such words start no pair. Each pair is an atomicOr
// of its bit, counted where the bit was clear, but for a pair whose key
// equals the pair's just before it (in the lane's word, or the lane
// before's last): that pair marked it, or one before it did, so a run of one
// residual pair marks once a step instead of once a lane. A lane with no
// pair to mark ORs 0 into its spare word. Steps whose every lane holds four
// pairs skip the tests of the row's end. Then the warp sweeps the bitmap
// with 16-byte zero stores.
template <int F, bool PREV>
__device__ __forceinline__ int count_pairs(const RowIn& r, int lane, int bits) {
  constexpr uint32_t kFull = 0xFFFFFFFFu;
  const Words xs(r.cur), as(r.cur - r.bpp), bs(r.prev), cs(r.prev - r.bpp);
  const int pairs = r.rb - 1, nk = (pairs + 3) >> 2, last = (r.rb - 1) >> 2;
  if (pairs <= 0) return 0;  // uniform over the warp
  uint32_t* const map = reinterpret_cast<uint32_t*>(smem + bits);
  const auto word = [&](int k, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    uint32_t x, a, b, c;
    load_words<1 << F, PREV, kEdge>(xs, as, bs, cs, min(k, last), r.bpp, x, a, b, c);
    return filter_word<F>(x, a, b, c);
  };
  int n = 0;
  uint32_t d = word(lane, std::true_type{});
  const auto step = [&](int k0, auto whole) {
    constexpr bool kWhole = decltype(whole)::value;  // every lane's four pairs lie in the row
    const uint32_t next = word(k0 + 32 + lane, std::false_type{});
    const uint32_t up = __shfl_sync(kFull, lane == 0 ? next : d, (lane + 1) & 31);
    const uint32_t before = __shfl_up_sync(kFull, d, 1);  // the lane before's word
    const uint32_t e = __funnelshift_r(d, up, 8);
    // pairs j = 0, 1 and 2, 3 as the two halves of a word: (d_j << 8) | e_j
    const uint32_t lo = __byte_perm(e, d, 0x5140), hi = __byte_perm(e, d, 0x7362);
    const uint32_t key[4] = {lo & 0xFFFFu, lo >> 16, hi & 0xFFFFu, hi >> 16};
    // the key of the pair before the word's first: the lane before's last byte, then byte 0
    const uint32_t left = __byte_perm(d, before, 0x0070) & 0xFFFFu;
    const int m = kWhole ? 4 : pairs - 4 * (k0 + lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool run = key[j] == (j > 0 ? key[j - 1] : left) && (j > 0 || lane > 0);
      const bool on = (kWhole || j < m) && !run;
      const uint32_t bit = on ? pair_bit(key[j]) : 0u;
      n += (bit & ~atomicOr(map + (on ? pair_word(key[j]) : spare_word(lane)), bit)) ? 1 : 0;
    }
    d = next;
  };
  int k0 = 0;
#pragma unroll 1
  for (; k0 + 32 <= (pairs >> 2); k0 += 32) step(k0, std::true_type{});
  if (k0 < nk) step(k0, std::false_type{});
  __syncwarp();
  uint4* const map4 = reinterpret_cast<uint4*>(map);
#pragma unroll 4
  for (int i = lane; i < kBigramBytes / 16; i += 32) map4[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncwarp();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(kFull, n, off);
  return n;
}

// The filter of the fewest distinct pairs for the row (mode 7).
template <bool PREV>
__device__ __forceinline__ int choose_bigrams(const RowIn& r, int lane, int bits) {
  const int s[kFilters] = {count_pairs<0, PREV>(r, lane, bits), count_pairs<1, PREV>(r, lane, bits),
                           count_pairs<2, PREV>(r, lane, bits), count_pairs<3, PREV>(r, lane, bits),
                           count_pairs<4, PREV>(r, lane, bits)};
  return select_fewest(s);
}

// Filters the row with filter F into the rb bytes at offset `out` of the
// shared memory (any alignment: byte stores).
template <int F, bool PREV>
__device__ __forceinline__ void apply_row(const RowIn& r, int lane, int out) {
  const Words xs(r.cur), as(r.cur - r.bpp), bs(r.prev), cs(r.prev - r.bpp);
  for_row_words(r.rb, lane, [&](int k, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    uint32_t x, a, b, c;
    load_words<1 << F, PREV, kEdge>(xs, as, bs, cs, k, r.bpp, x, a, b, c);
    const uint32_t d = filter_word<F>(x, a, b, c);
    uint8_t* o = smem + out + 4 * k;
    if (!kEdge || 4 * k + 4 <= r.rb) {
      o[0] = static_cast<uint8_t>(d);
      o[1] = static_cast<uint8_t>(d >> 8);
      o[2] = static_cast<uint8_t>(d >> 16);
      o[3] = static_cast<uint8_t>(d >> 24);
    } else {
      for (int j = 0; j < r.rb - 4 * k; ++j) o[j] = static_cast<uint8_t>(d >> (8 * j));
    }
  });
}

template <bool PREV>
__device__ __forceinline__ void apply_chosen(const RowIn& r, int chosen, int lane, int out) {
  switch (chosen) {  // uniform over the warp
    case 0: apply_row<0, PREV>(r, lane, out); break;
    case 1: apply_row<1, PREV>(r, lane, out); break;
    case 2: apply_row<2, PREV>(r, lane, out); break;
    case 3: apply_row<3, PREV>(r, lane, out); break;
    default: apply_row<4, PREV>(r, lane, out); break;
  }
}

// One thread block: rows [y0, y0 + strip) of one image, a warp a row.
// BIGRAMS: mode 7, a bitmap of kBigramBytes a row after the output rows.
template <bool BIGRAMS>
__global__ void __launch_bounds__(32 * kStripRows) filter_rows_strip_kernel(
    const uint8_t* __restrict__ rows, int h, int rb, int bpp, int mode, int early, int sticky,
    int strip, int strips, uint8_t* __restrict__ out) {
  const int64_t img = blockIdx.x / strips;
  const int y0 = static_cast<int>(blockIdx.x - img * strips) * strip;
  const int ny = min(strip, h - y0);
  const int above = y0 > 0 ? 1 : 0;
  const uint8_t* image = rows + img * h * int64_t(rb);

  int region = 0;
  // raw is where row y0 - 1 lies (not staged, and not read, for y0 = 0)
  const int raw = stage_in(region, image + int64_t(y0 - above) * rb, int64_t(ny + above) * rb) -
                  (1 - above) * rb;
  region += static_cast<int>(region_bytes(int64_t(strip + 1) * rb));
  uint8_t* const out_g = out + (img * h + y0) * int64_t(rb + 1);
  const int staged = region + static_cast<int>(reinterpret_cast<uintptr_t>(out_g) & 15);
  region += static_cast<int>(region_bytes(int64_t(strip) * (rb + 1)));
  int row0 = raw + rb;  // the image's row 0, for the sticky rule
  if (sticky && y0 > 0) row0 = stage_in(region, image, rb);
  if (BIGRAMS) {  // never sticky: the bitmaps follow the output rows, swept once
    for (int i = threadIdx.x; i < strip * kBigramBytes / 16; i += blockDim.x) {
      reinterpret_cast<uint4*>(smem + region)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < ny) {
    const int y = y0 + warp;
    const RowIn r = {raw + (warp + 1) * rb, raw + warp * rb, rb, bpp};
    int chosen = mode;
    if (BIGRAMS) {
      const int bits = region + warp * kBigramBytes;
      chosen = y > 0 ? choose_bigrams<true>(r, lane, bits) : choose_bigrams<false>(r, lane, bits);
    } else if (mode >= 5) {
      if (sticky) {
        chosen = choose_filter<false>({row0, row0, rb, bpp}, mode, early, lane);
      } else {
        chosen = y > 0 ? choose_filter<true>(r, mode, early, lane)
                       : choose_filter<false>(r, mode, early, lane);
      }
    }
    const int o = staged + warp * (rb + 1);
    if (lane == 0) smem[o] = static_cast<uint8_t>(chosen);
    if (y > 0) {
      apply_chosen<true>(r, chosen, lane, o + 1);
    } else {
      apply_chosen<false>(r, chosen, lane, o + 1);
    }
  }
  __syncthreads();
  stage_out(out_g, staged, int64_t(ny) * (rb + 1));
}

// The contract's strip kernel: rows staged as in filter_rows_strip_kernel,
// a warp a row, one sweep that takes all five candidates of a word, stores
// them (as words where the rows are 4-byte aligned in the output, else as
// bytes) and sums their scores.
template <bool PREV>
__device__ __forceinline__ void bank_row(const RowIn& r, int lane, uint8_t* __restrict__ cand0,
                                         int64_t plane, int32_t* __restrict__ scores) {
  const Words xs(r.cur), as(r.cur - r.bpp), bs(r.prev), cs(r.prev - r.bpp);
  const bool aligned = ((reinterpret_cast<uintptr_t>(cand0) | static_cast<uintptr_t>(plane)) & 3) == 0;
  int t[kFilters] = {0, 0, 0, 0, 0};
  for_row_words(r.rb, lane, [&](int k, auto edge) {
    constexpr bool kEdge = decltype(edge)::value;
    uint32_t x, a, b, c;
    load_words<0b11111, PREV, kEdge>(xs, as, bs, cs, k, r.bpp, x, a, b, c);
    const uint32_t m = kEdge ? tail_mask(k, r.rb) : 0xFFFFFFFFu;
    const uint32_t d[kFilters] = {filter_word<0>(x, a, b, c), filter_word<1>(x, a, b, c),
                                  filter_word<2>(x, a, b, c), filter_word<3>(x, a, b, c),
                                  filter_word<4>(x, a, b, c)};
    const int nbytes = kEdge ? min(4, r.rb - 4 * k) : 4;
#pragma unroll
    for (int f = 0; f < kFilters; ++f) {
      t[f] = score_word(d[f] & m, t[f]);
      uint8_t* o = cand0 + f * plane + 4 * k;
      if (aligned && nbytes == 4) {
        *reinterpret_cast<uint32_t*>(o) = d[f];
      } else {
        for (int j = 0; j < nbytes; ++j) o[j] = static_cast<uint8_t>(d[f] >> (8 * j));
      }
    }
  });
#pragma unroll
  for (int f = 0; f < kFilters; ++f) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t[f] += __shfl_xor_sync(0xFFFFFFFFu, t[f], off);
    if (lane == f) scores[f] = t[f];
  }
}

__global__ void __launch_bounds__(32 * kStripRows) filter_bank_strip_kernel(
    const uint8_t* __restrict__ rows, int h, int rb, int bpp, int strip, int strips,
    uint8_t* __restrict__ cands, int32_t* __restrict__ scores) {
  const int64_t img = blockIdx.x / strips;
  const int y0 = static_cast<int>(blockIdx.x - img * strips) * strip;
  const int ny = min(strip, h - y0);
  const int above = y0 > 0 ? 1 : 0;
  const uint8_t* image = rows + img * h * int64_t(rb);
  const int raw = stage_in(0, image + int64_t(y0 - above) * rb, int64_t(ny + above) * rb) -
                  (1 - above) * rb;
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= ny) return;
  const int y = y0 + warp;
  const RowIn r = {raw + (warp + 1) * rb, raw + warp * rb, rb, bpp};
  const int64_t plane = int64_t(h) * rb;
  uint8_t* cand0 = cands + (img * kFilters * h + y) * int64_t(rb);  // filter f at + f * plane
  int32_t* s = scores + (img * h + y) * kFilters;
  if (y > 0) {
    bank_row<true>(r, lane, cand0, plane, s);
  } else {
    bank_row<false>(r, lane, cand0, plane, s);
  }
}

// Shared memory of a strip kernel launch (ops/kernels.py::filter_rows_plan).
inline int64_t strip_smem(int64_t strip, int64_t rb, bool sticky, bool bigrams) {
  return region_bytes((strip + 1) * rb) + region_bytes(strip * (rb + 1)) +
         (sticky ? region_bytes(rb) : 0) + (bigrams ? strip * kBigramBytes : 0);
}

static bool valid_rows(int64_t batch, int64_t h, int64_t rb, int32_t bpp) {
  return batch >= 1 && h >= 1 && rb >= 1 && bpp >= 1 && bpp <= 8 && batch * h <= INT_MAX;
}

// Sets the strip kernels' launch shape: thread blocks and dynamic shared
// memory (raised above the default limit where needed, per device, so on
// every such launch). Returns cudaSuccess or why the launch cannot be made.
template <class Kernel>
static cudaError_t strip_launch(Kernel kernel, int64_t batch, int64_t h, int32_t strip, int64_t smem,
                                int64_t* strips) {
  *strips = (h + strip - 1) / strip;
  if (smem > kStripMaxSmem || batch * *strips > INT_MAX) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kStripMaxSmem);
}

}  // namespace pixo

extern "C" {

// rows: [batch, h, rb] uint8 on the device; bpp 1..8. strip: rows a thread
// block of the strip kernel takes, 1 to 8, or 0 for the long-row kernel (as
// for pixo_filter_rows). Outputs on the device: cands [batch, 5, h, rb]
// uint8, 4-byte aligned, scores [batch, h, 5] int32. Returns
// cudaGetLastError().
int pixo_filter_bank(const uint8_t* rows, int64_t batch, int64_t h, int64_t rb, int32_t bpp,
                     int32_t strip, uint8_t* cands, int32_t* scores, void* stream) {
  using namespace pixo;
  if (!valid_rows(batch, h, rb, bpp) || strip < 0 || strip > kStripRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (strip == 0) {
    filter_bank_kernel<<<static_cast<unsigned>(batch * h), kFilterThreads, 0, s>>>(
        rows, h, rb, bpp, cands, scores);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t smem = region_bytes((strip + 1) * rb);
  int64_t strips;
  const cudaError_t e = strip_launch(filter_bank_strip_kernel, batch, h, strip, smem, &strips);
  if (e != cudaSuccess) return static_cast<int>(e);
  filter_bank_strip_kernel<<<static_cast<unsigned>(batch * strips), 32 * strip,
                             static_cast<size_t>(smem), s>>>(
      rows, static_cast<int>(h), static_cast<int>(rb), bpp, strip, static_cast<int>(strips), cands,
      scores);
  return static_cast<int>(cudaGetLastError());
}

// rows: [batch, h, rb] uint8 on the device; bpp 1..8. mode: 0-4 a fixed
// filter, 5 adaptive/min-sum, 6 adaptive-fast, 7 bigrams; early: the
// selection's stop score (rb/4+1 for 5, rb/8+1 for 6); sticky (mode 6 only):
// every row takes row 0's choice. strip: rows a thread block of the strip
// kernel takes, 1 to 8 (its shared memory, with mode 7's bitmaps, must fit
// the budget), or 0 for the long-row kernel. out: [batch, h, rb + 1] uint8
// on the device, each row's filter id first. Returns cudaGetLastError().
int pixo_filter_rows(const uint8_t* rows, int64_t batch, int64_t h, int64_t rb, int32_t bpp,
                     int32_t mode, int32_t early, int32_t sticky, int32_t strip, uint8_t* out,
                     void* stream) {
  using namespace pixo;
  if (!valid_rows(batch, h, rb, bpp) || mode < 0 || mode > 7 || (sticky && mode != 6) ||
      strip < 0 || strip > kStripRows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  const bool bigrams = mode == 7;
  if (strip == 0) {
    const auto kernel = bigrams ? filter_rows_long_kernel<true> : filter_rows_long_kernel<false>;
    kernel<<<static_cast<unsigned>(batch * h), kFilterThreads, bigrams ? kBigramBytes : 0, s>>>(
        rows, h, rb, bpp, mode, early, sticky, out);
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t smem = strip_smem(strip, rb, sticky != 0, bigrams);
  const auto kernel = bigrams ? filter_rows_strip_kernel<true> : filter_rows_strip_kernel<false>;
  int64_t strips;
  const cudaError_t e = strip_launch(kernel, batch, h, strip, smem, &strips);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<static_cast<unsigned>(batch * strips), 32 * strip, static_cast<size_t>(smem), s>>>(
      rows, static_cast<int>(h), static_cast<int>(rb), bpp, mode, early, sticky, strip,
      static_cast<int>(strips), out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
