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
// What bounds it on the card: memory. It reads 128 bytes per block and
// writes 536 counters per image; the work per nonzero coefficient is a bit
// length and a shared-memory add. Design:
//
// - the predictor is not a running state: it is the DC of the previous
//   block of the same component in the same restart segment, an index the
//   kernel computes from a table of the MCU's slots that the wrapper passes
//   by value (in 4:2:0 luma is four slots of six; a restart interval resets
//   it), so every block is independent;
// - eight lanes take one block, each lane one 16-byte chunk of 8 zigzag
//   coefficients (single int16 loads where the input is not 16-byte
//   aligned), so a warp reads 4 whole blocks, 512 contiguous bytes; a CTA of
//   128 threads issues all eight of its passes' loads before the first is
//   used, 128 consecutive blocks of one image (grid.y is the image);
// - a lane's runs need the last nonzero position before its chunk: an
//   exclusive max-scan over the block's 8 lanes (__shfl_up_sync, width 8);
//   each lane then walks only its set bits;
// - the counters of a CTA live in shared memory (536 int32); the
//   end-of-block, which almost every block adds to one counter of its class,
//   is summed by a warp ballot and one add; each CTA flushes its non-zero
//   counters with 64-bit global atomics, which give the same sums in any
//   order.
//
// A DC difference past category 11 (outside a baseline scan's range)
// counts in no bin, as the reference's scatter drops it; an AC value's
// category ORs into its run nibble as the reference's does.

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kCountThreads = 128;
constexpr int kCountPasses = 8;  // blocks each group of 8 lanes takes
constexpr int kCountRows = kCountThreads / 8 * kCountPasses;  // blocks a CTA takes
constexpr int kDcBins = 12;
constexpr int kAcBins = 256;
constexpr int kHistBins = 2 * kDcBins + 2 * kAcBins;  // dc [2][12], then ac [2][256]

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

__device__ __forceinline__ int bit_length(int v) { return 32 - __clz(v < 0 ? -v : v); }

template <bool kAligned>
__global__ void __launch_bounds__(kCountThreads) count_symbols_kernel(
    const int16_t* __restrict__ zz, int n, ScanLayout lay,
    unsigned long long* __restrict__ hist) {
  __shared__ int s_hist[kHistBins];
  int* const s_dc = s_hist;
  int* const s_ac = s_hist + 2 * kDcBins;

  const int tid = threadIdx.x, lane = tid & 7;
  const int row0 = blockIdx.x * kCountRows;
  const int nrows = n - row0 < kCountRows ? n - row0 : kCountRows;
  const int16_t* const image = zz + static_cast<int64_t>(blockIdx.y) * n * 64;
  for (int i = tid; i < kHistBins; i += kCountThreads) s_hist[i] = 0;

  // every load first: eight 16-byte chunks in flight per lane
  uint32_t words[kCountPasses][4];
#pragma unroll
  for (int k = 0; k < kCountPasses; ++k) {
    const int g = (tid >> 3) + k * (kCountThreads / 8);
    const int16_t* chunk = image + static_cast<int64_t>(row0 + g) * 64 + 8 * lane;
    if (g >= nrows) {
      words[k][0] = words[k][1] = words[k][2] = words[k][3] = 0;
    } else if (kAligned) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(chunk));
      words[k][0] = t.x, words[k][1] = t.y, words[k][2] = t.z, words[k][3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        words[k][e] = static_cast<uint16_t>(__ldg(chunk + 2 * e)) |
                      static_cast<uint32_t>(static_cast<uint16_t>(__ldg(chunk + 2 * e + 1))) << 16;
    }
  }
  __syncthreads();  // s_hist is zeroed

#pragma unroll
  for (int k = 0; k < kCountPasses; ++k) {
    const int g = (tid >> 3) + k * (kCountThreads / 8);
    const bool valid = g < nrows;
    const uint32_t w[4] = {words[k][0], words[k][1], words[k][2], words[k][3]};
    uint32_t mask = 0;  // bit e: the coefficient at zigzag 8 * lane + e is nonzero
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      mask |= ((w[e] & 0xFFFFu) != 0 ? 1u : 0u) << (2 * e);
      mask |= ((w[e] >> 16) != 0 ? 1u : 0u) << (2 * e + 1);
    }
    if (lane == 0) mask &= ~1u;  // the DC is not an AC
    // the last nonzero AC position at or before this lane's chunk (0 = none)
    int incl = mask ? 8 * lane + 31 - __clz(mask) : 0;
#pragma unroll
    for (int d = 1; d < 8; d <<= 1) {
      const int up = __shfl_up_sync(0xFFFFFFFFu, incl, d, 8);
      if (lane >= d) incl = max(incl, up);
    }
    int last = __shfl_up_sync(0xFFFFFFFFu, incl, 1, 8);
    if (lane == 0) last = 0;

    const int j = row0 + g;  // the block's index in its image
    const int mcu = j / lay.bpm, slot = j - mcu * lay.bpm;
    const int t = (lay.chroma >> slot) & 1;
    // end of block: the last AC (zigzag 63, this group's lane 7) is zero
    const bool eob = valid && lane == 7 && (w[3] >> 16) == 0;
    const unsigned eob0 = __ballot_sync(0xFFFFFFFFu, eob && t == 0);
    const unsigned eob1 = __ballot_sync(0xFFFFFFFFu, eob && t == 1);
    if ((tid & 31) == 0) {
      if (eob0) atomicAdd(&s_ac[0], __popc(eob0));
      if (eob1) atomicAdd(&s_ac[kAcBins], __popc(eob1));
    }
    if (!valid) continue;
    int* const ac = s_ac + t * kAcBins;
    for (; mask != 0; mask &= mask - 1) {
      const int e = __ffs(mask) - 1;
      const uint32_t word = e < 4 ? (e < 2 ? w[0] : w[1]) : (e < 6 ? w[2] : w[3]);
      const int v = static_cast<int16_t>(e & 1 ? word >> 16 : word & 0xFFFFu);
      const int p = 8 * lane + e, run = p - last - 1;
      if (run >= 16) atomicAdd(&ac[0xF0], run >> 4);  // ZRL splits
      atomicAdd(&ac[((run & 15) << 4) | bit_length(v)], 1);
      last = p;
    }
    if (lane == 0) {
      // the predictor: the previous block of this component in the MCU, or
      // the last one of the previous MCU in the same restart segment
      const int in_mcu = (lay.prev >> (4 * slot)) & 15;
      int prev = -1;
      if (in_mcu != 0)
        prev = j - slot + in_mcu - 1;
      else if (mcu > 0 && (lay.restart == 0 || mcu % lay.restart != 0))
        prev = j - slot - lay.bpm + ((lay.last >> (4 * slot)) & 15);
      const int pred = prev >= 0 ? __ldg(image + static_cast<int64_t>(prev) * 64) : 0;
      const int cat = bit_length(static_cast<int16_t>(w[0] & 0xFFFFu) - pred);
      if (cat < kDcBins) atomicAdd(&s_dc[t * kDcBins + cat], 1);
    }
  }
  __syncthreads();

  unsigned long long* const out = hist + static_cast<int64_t>(blockIdx.y) * kHistBins;
  for (int i = tid; i < kHistBins; i += kCountThreads)
    if (s_hist[i] != 0) atomicAdd(out + i, static_cast<unsigned long long>(s_hist[i]));
}

}  // namespace pixo

extern "C" {

// zz: [batch, n, 64] int16 zigzag blocks in scan order on the device, at any
// 2-byte aligned address. slots: in host memory, for each of the MCU's bpm
// slots, its table class (0 or 1), the previous slot of its component in
// the MCU (or -1) and the last slot of its component in the MCU
// (ops/kernels.py::count_layout). restart_interval: MCUs a segment, 0 =
// none. hist: [batch, 536] int64 on the device (per image dc [2][12], then
// ac [2][256]), zeroed here on the stream before the kernel runs.
// 1 <= batch <= 65535, 1 <= n < 2^31, n a multiple of bpm, 1 <= bpm <= 6.
// Returns cudaGetLastError().
int pixo_count_symbols(const int16_t* zz, int64_t batch, int64_t n, const int8_t* slots,
                       int32_t bpm, int32_t restart_interval, int64_t* hist, void* stream) {
  using namespace pixo;
  if (batch < 1 || batch > 65535 || n < 1 || n > 0x7FFFFFFFll || bpm < 1 || bpm > 6 ||
      n % bpm != 0 || restart_interval < 0 || (reinterpret_cast<uintptr_t>(zz) & 1) != 0)
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(hist, 0, batch * kHistBins * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kCountRows - 1) / kCountRows), static_cast<unsigned>(batch));
  auto* out = reinterpret_cast<unsigned long long*>(hist);
  if ((reinterpret_cast<uintptr_t>(zz) & 15) == 0)
    count_symbols_kernel<true><<<grid, kCountThreads, 0, s>>>(zz, static_cast<int>(n), lay, out);
  else
    count_symbols_kernel<false><<<grid, kCountThreads, 0, s>>>(zz, static_cast<int>(n), lay, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
