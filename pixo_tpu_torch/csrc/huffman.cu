// Symbol-histogram kernel of the optimized-Huffman JPEG encode, for Hopper
// (sm_90a).
//
// Replaces the jit _count_device of the JAX package's
// ops/huffman_device.py (:73, behind count_symbols_device :98), which has no
// Pallas kernel. For every [64] int16 zigzag block of a baseline scan it
// counts, into its image's histograms, the DC size category of the
// difference to the block's predictor and the AC run/size symbols with their
// ZRL splits and the end-of-block, in two table classes (0 for component 0,
// 1 for the others): dc [2][12] and ac [2][256] per image, 64-bit, as the
// host library's jpeg_count_symbols counts them.
//
// What bounds it on the card: memory, at 128 bytes read per block and 536
// counters written per image. What bounds this design (chip_smoke.py
// --count-parts) is the issue of each warp's instructions: a pass's loads
// take about 40% of its time, the AC walk most of the rest. So the work is
// spread for issue and for the loads in flight:
//
// - one 1-D grid sized to the card (ops/kernels.py::count_plan: the card's
//   CTA slots where the batch allows): CTA c takes the flattened
//   [batch * n] blocks [c * share, (c + 1) * share), a contiguous, equal
//   share that may start inside an MCU, a restart segment or an image, and
//   walks it in passes of 128 blocks, a pass cut where an image ends; each
//   of its 8 warps takes a step of 16 of a pass's blocks;
// - in a step, eight lanes take a block and each lane one 16-byte chunk of
//   8 zigzag coefficients (single int16 loads where the input is not
//   16-byte aligned), in four rounds of 4 blocks, 512 contiguous bytes
//   each; the four rounds are independent, straight-line work;
// - a lane's runs need the last nonzero AC before its chunk: a vote finds
//   the nearest lane of its block before it that holds one, and one shuffle
//   brings that lane's last position; each lane counts its first two
//   nonzeros with runs under 16 in straight-line code, and the warp loops
//   over the rare rest (a third nonzero, a ZRL run);
// - lanes 0-3 of each block's eight take the DC of round 0-3's block: its
//   MCU, slot and place in its restart segment kept from pass to pass (a
//   division only where an image or a share begins), its DC and its
//   predictor's (the previous block of its component in the same restart
//   segment, at most 6 blocks back) loaded with the step, the end-of-block
//   from a vote, counted in registers;
// - the CTA counts into one 536 int32 row of shared memory (a row a warp
//   was no faster) and adds it to the image's 64-bit counts at each image
//   end it reaches and at its share's end, its non-zero counters with
//   global atomics; a memset on the stream zeroes the counts first (an
//   image's last CTA writing them, found by a ticket, cost more than the
//   memset: the serial tail of its fence, ticket and exchanges).
//
// Counts are exact integers: the order of the sums cannot change a result.
// A DC difference past category 11 (outside a baseline scan's range)
// counts in no bin, as the reference's scatter drops it; an AC value's
// category ORs into its run nibble as the reference's does.

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {
namespace count {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 4;          // blocks an eight-lane group takes in a step
constexpr int kStep = 4 * kRounds;  // blocks a warp takes in a pass
constexpr int kPass = kWarps * kStep;  // blocks a CTA takes in a pass
constexpr int kDcBins = 12;
constexpr int kAcBins = 256;
constexpr int kHistBins = 2 * kDcBins + 2 * kAcBins;  // dc [2][12], then ac [2][256]
constexpr int kEob = 2 * kDcBins;                     // ac class 0's end-of-block counter
// A share's sum of one counter is at most 63 a block: int32 stays exact.
constexpr int64_t kMaxShare = int64_t{1} << 24;
constexpr unsigned kAll = 0xFFFFFFFFu;

// The scan's MCU pattern as the kernel reads it: per slot k, 4-bit fields
// at bit 4k (shifts of registers, where an indexed array would go to the
// stack).
struct ScanLayout {
  int bpm;      // blocks per MCU, 1..6
  int chroma;   // bit k: slot k's component is not 0 (table class 1)
  int restart;  // restart interval in MCUs, 0 = none
  int prev;     // slot k: 1 + the previous slot of its component in the MCU, 0 for none
  int last;     // slot k: the last slot of its component in the MCU
};

// The launch's plan (ops/kernels.py::count_plan), by value.
struct Plan {
  int64_t total;  // blocks of the batch, batch * n
  int64_t share;  // blocks a CTA
  int n;          // blocks an image
};

__device__ __forceinline__ int bit_length(int v) { return 32 - __clz(v < 0 ? -v : v); }

// Bit e: coefficient e of the chunk (w[e / 2]'s low or high half) is
// nonzero. A half h has bit 15 of ((h & 0x7FFF) + 0x7FFF) | h set iff it is
// nonzero, and the sum carries into no other half.
__device__ __forceinline__ uint32_t nonzero_mask(const uint32_t (&w)[4]) {
  uint32_t u = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    u |= ((((w[e] & 0x7FFF7FFFu) + 0x7FFF7FFFu) | w[e]) & 0x80008000u) >> (15 - 2 * e);
  return (u | (u >> 15)) & 0xFFu;
}

// Counts the AC symbol of the lowest set bit of mask (coefficient 8 * c + e
// of chunk w, after the nonzero at position last) and its ZRL splits into
// ac, and clears the bit; with no bit set, nothing. kNear: only a symbol
// with a run under 16 (no ZRL), with no loop around it; a longer run stays
// in the mask.
template <bool kNear>
__device__ __forceinline__ void count_ac(uint32_t& mask, int& last, const uint32_t (&w)[4], int c,
                                         int* ac) {
  const int e = __ffs(mask) - 1;
  const uint32_t word = e < 4 ? (e < 2 ? w[0] : w[1]) : (e < 6 ? w[2] : w[3]);
  const int v = static_cast<int16_t>(e & 1 ? word >> 16 : word & 0xFFFFu);
  const int p = 8 * c + e, run = p - last - 1;
  const bool take = mask != 0 && (!kNear || run < 16);
  if (!kNear && run >= 16) atomicAdd(&ac[0xF0], run >> 4);  // ZRL splits
  if (take) atomicAdd(&ac[((run & 15) << 4) | bit_length(v)], 1);
  mask = take ? mask & (mask - 1) : mask;
  last = take ? p : last;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads, 3) count_symbols_kernel(
    const int16_t* __restrict__ zz, Plan plan, ScanLayout lay, unsigned long long* __restrict__ hist) {
  __shared__ int row[kHistBins];

  const int tid = threadIdx.x, lane = tid & 31, c = lane & 7, q = lane >> 3, warp = tid >> 5;
  const int n = plan.n, bpm = lay.bpm;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * plan.share;
  const int64_t end = begin + plan.share < plan.total ? begin + plan.share : plan.total;
  for (int i = tid; i < kHistBins; i += kThreads) row[i] = 0;

  // The pass cursor (uniform): the pass's first block, its image and its
  // index there. Lanes 0-3 of each group take the DC of round c's block of
  // the warp's step, j = pj0 + kStep * warp + 4c + q: they keep its MCU,
  // slot and the place of its MCU in its restart segment.
  int64_t prow = begin, pimg = begin / n;
  int pj0 = static_cast<int>(begin - pimg * n);
  int mcu = 0, slot = 0, seg = 0;
  bool fresh = true;  // the DC state is computed anew: a share's or an image's first pass
  const int pass_mcu = kPass / bpm, pass_slot = kPass - pass_mcu * bpm;
  const bool dc_lane = c < kRounds;
  const int o_dc = 4 * c + q;  // the DC lane's block in the step
  int eob0 = 0, eob1 = 0;      // a DC lane's end-of-block counts of the image, by class

  // Counts the warp's step of len blocks (w: this lane's chunks; dc and
  // pred: the DC lane's block's DC and its predictor's; cls its class).
  auto count = [&](const uint32_t (&w)[kRounds][4], int dc, int pred, int cls, int len) {
    // round r's block's class, from its DC lane (lane 8q + r)
    const unsigned classes = __ballot_sync(kAll, dc_lane && cls);
    uint32_t rest[kRounds];
    int last[kRounds];
    unsigned eob[kRounds];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      uint32_t mask = nonzero_mask(w[r]);
      if (c == 0) mask &= ~1u;  // the DC is not an AC
      // the last nonzero AC before this chunk: the nearest lane of the
      // block before this one that holds one, its highest
      const int hi = mask ? 8 * c + 31 - __clz(mask) : 0;
      const unsigned below = (__ballot_sync(kAll, mask != 0) >> (lane & 24)) & ((1u << c) - 1);
      const int got = __shfl_sync(kAll, hi, below ? (lane & 24) + 31 - __clz(below) : lane);
      last[r] = below ? got : 0;
      eob[r] = __ballot_sync(kAll, (w[r][3] >> 16) == 0);  // lane 8q + 7: zigzag 63 is zero
      int* const ac = row + kEob + ((classes >> ((lane & 24) + r)) & 1) * kAcBins;
      count_ac<true>(mask, last[r], w[r], c, ac);  // a lane's first two nonzeros
      count_ac<true>(mask, last[r], w[r], c, ac);
      rest[r] = mask;
    }
    uint32_t left = 0;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) left |= rest[r];
    if (__any_sync(kAll, left)) {  // the rare rest: a third nonzero of a chunk, or a ZRL run
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        int* const ac = row + kEob + ((classes >> ((lane & 24) + r)) & 1) * kAcBins;
        while (rest[r] != 0) count_ac<false>(rest[r], last[r], w[r], c, ac);
      }
    }
    // the DC lane's block: its end-of-block (zigzag 63 of lane 8q + 7) and DC
    const bool valid = dc_lane && o_dc < len;
    unsigned e = eob[0];
#pragma unroll
    for (int r = 1; r < kRounds; ++r) e = c == r ? eob[r] : e;
    const bool end_of_block = valid && ((e >> ((lane & 24) + 7)) & 1);
    eob0 += end_of_block && !cls;
    eob1 += end_of_block && cls;
    const int cat = bit_length(dc - pred);
    if (valid && cat < kDcBins) atomicAdd(&row[cls * kDcBins + cat], 1);
  };

  // Adds the CTA's counts of image img to its counts and zeroes them
  // (uniform).
  auto flush = [&](int64_t img) {
    const int e0 = __reduce_add_sync(kAll, eob0), e1 = __reduce_add_sync(kAll, eob1);
    eob0 = eob1 = 0;
    if (lane == 0) {
      atomicAdd(&row[kEob], e0);
      atomicAdd(&row[kEob + kAcBins], e1);
    }
    __syncthreads();
    unsigned long long* const out = hist + img * kHistBins;
    for (int i = tid; i < kHistBins; i += kThreads) {
      const int s = row[i];
      row[i] = 0;
      if (s != 0) atomicAdd(out + i, static_cast<unsigned long long>(s));
    }
    __syncthreads();
  };

  __syncthreads();  // the row is zeroed
  while (prow < end) {
    int plen = n - pj0 < kPass ? n - pj0 : kPass;  // the pass ends where its image or the share does
    if (end - prow < plen) plen = static_cast<int>(end - prow);
    const int len = min(max(plen - kStep * warp, 0), kStep);  // the warp's step
    const int16_t* const image = zz + pimg * n * 64;
    const int j0 = pj0 + kStep * warp;
    const int j = j0 + o_dc;
    if (fresh) {
      mcu = j / bpm;
      slot = j - mcu * bpm;
      seg = lay.restart ? mcu % lay.restart : 0;
    }
    if (len > 0) {
      uint32_t w[kRounds][4];
#pragma unroll
      for (int r = 0; r < kRounds; ++r) {
        const int o = 4 * r + q;
        const int16_t* const chunk = image + static_cast<int64_t>(j0 + o) * 64 + 8 * c;
        if (o >= len) {
          w[r][0] = w[r][1] = w[r][2] = w[r][3] = 0;
        } else if (kAligned) {
          const int4 t = __ldg(reinterpret_cast<const int4*>(chunk));
          w[r][0] = t.x, w[r][1] = t.y, w[r][2] = t.z, w[r][3] = t.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            w[r][e] = static_cast<uint16_t>(__ldg(chunk + 2 * e)) |
                      static_cast<uint32_t>(static_cast<uint16_t>(__ldg(chunk + 2 * e + 1))) << 16;
        }
      }
      // the DC lane's block, and its predictor: the previous block of its
      // component in the MCU, or the last one of the previous MCU in the
      // same restart segment
      int dc = 0, pred = 0;
      if (dc_lane && o_dc < len) {
        dc = __ldg(image + static_cast<int64_t>(j) * 64);
        const int in_mcu = (lay.prev >> (4 * slot)) & 15;
        int pj = -1;
        if (in_mcu != 0)
          pj = j - slot + in_mcu - 1;
        else if (mcu > 0 && (lay.restart == 0 || seg != 0))
          pj = j - slot - bpm + ((lay.last >> (4 * slot)) & 15);
        if (pj >= 0) pred = __ldg(image + static_cast<int64_t>(pj) * 64);
      }
      count(w, dc, pred, (lay.chroma >> slot) & 1, len);
    }
    const bool image_end = pj0 + plen == n;
    if (image_end || prow + plen == end) flush(pimg);
    prow += plen;
    if (image_end) {
      pj0 = 0;
      ++pimg;
      fresh = true;
    } else {  // the same image goes on, kPass blocks later
      pj0 += plen;
      fresh = false;
      slot += pass_slot;
      int dm = pass_mcu;
      if (slot >= bpm) {
        slot -= bpm;
        ++dm;
      }
      mcu += dm;
      if (lay.restart) {
        seg += dm;
        if (seg >= lay.restart) seg %= lay.restart;
      }
    }
  }
}

}  // namespace count
}  // namespace pixo

extern "C" {

// zz: [batch, n, 64] int16 zigzag blocks in scan order on the device, at any
// 2-byte aligned address. slots: in host memory, for each of the MCU's bpm
// slots, its table class (0 or 1), the previous slot of its component in
// the MCU (or -1) and the last slot of its component in the MCU
// (ops/kernels.py::count_layout). restart_interval: MCUs a segment, 0 =
// none. grid, share: the plan (ops/kernels.py::count_plan), CTA c taking
// blocks [c * share, (c + 1) * share) of the batch's batch * n, every CTA
// at least one. hist: [batch, 536] int64 on the device (per image dc
// [2][12], then ac [2][256]), zeroed here on the stream before the kernel
// runs. batch >= 1, 1 <= n < 2^31, n a multiple of bpm, 1 <= bpm <= 6,
// share <= 2^24. Returns cudaGetLastError().
int pixo_count_symbols(const int16_t* zz, int64_t batch, int64_t n, const int8_t* slots,
                       int32_t bpm, int32_t restart_interval, int64_t grid, int64_t share,
                       int64_t* hist, void* stream) {
  using namespace pixo::count;
  if (batch < 1 || batch > (int64_t{1} << 40) || n < 1 || n > 0x7FFFFFFFll || bpm < 1 || bpm > 6 ||
      n % bpm != 0 || restart_interval < 0 || (reinterpret_cast<uintptr_t>(zz) & 1) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t total = batch * n;
  if (grid < 1 || grid > 0x7FFFFFFF || share < 1 || share > kMaxShare || (grid - 1) * share >= total ||
      grid * share < total)
    return static_cast<int>(cudaErrorInvalidValue);
  ScanLayout lay{};
  lay.bpm = bpm;
  lay.restart = restart_interval;
  for (int k = 0; k < bpm; ++k) {
    const int cls = slots[3 * k], prev = slots[3 * k + 1], last = slots[3 * k + 2];
    if (cls < 0 || cls > 1 || prev < -1 || prev >= k || last < k || last >= bpm)
      return static_cast<int>(cudaErrorInvalidValue);
    lay.chroma |= cls << k;
    lay.prev |= (prev + 1) << (4 * k);
    lay.last |= last << (4 * k);
  }
  const Plan plan{total, share, static_cast<int>(n)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(hist, 0, batch * kHistBins * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* out = reinterpret_cast<unsigned long long*>(hist);
  if ((reinterpret_cast<uintptr_t>(zz) & 15) == 0)
    count_symbols_kernel<true><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(zz, plan, lay, out);
  else
    count_symbols_kernel<false><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(zz, plan, lay, out);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the count kernel an SM holds at once (its occupancy), or -1.
int pixo_count_ctas_per_sm(void) {
  int ctas = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, pixo::count::count_symbols_kernel<true>,
                                                    pixo::count::kThreads, 0) != cudaSuccess)
    return -1;
  return ctas;
}

}  // extern "C"
