// Trellis quantization kernel for Hopper (sm_90a).
//
// Replaces the jit trellis_quantize_batch_device of the JAX package's
// ops/trellis_device.py:179 (a 63-step lax.scan with the whole batch in
// flight), which has no Pallas kernel. It reads [N, 64] f32 zigzag DCT blocks
// and writes [N, 64] int16: per block the Viterbi DP of the host library
// (core.cpp::trellis::trellis_block, whose bytes pixo_tpu.jpeg.encode emits),
// with its exact f32 order and tie-breaks, as the plain version
// (ops/trellis_device.py::trellis_quantize_batch_plain) has them:
//
// - candidates of a coefficient: 0, floor(fq), ceil(fq) and, where
//   |fq| > 1.5, one further from zero (fq = coef / q, IEEE division). The
//   plain version's round-half-away slot always equals floor or ceil and
//   sits between them in first-occurrence order, so it is not a slot here;
// - a nonzero candidate costs (cost[p] + rate[run[p]][cat]) + lambda * d^2
//   from each parent p, d = coef - v * q; the least, the lowest parent on a
//   tie, is its one state (v, run 0). The zero candidate gives each parent
//   a child (cost[p] + 0 or the ZRL's 10) + lambda * coef^2 of run
//   run[p] + 1 (16 wraps to 0), in insertion order 4 x the parent (children
//   of one run are not merged, as in the host library);
// - the at most 11 entries merge by (cost, order), and the 8 first are the
//   next states;
// - a state's history is a byte a step (its parent, and which candidate it
//   took: 0 for zero, 1 floor, 2 ceil, 3 the extension), so a step of 8
//   states is 8 bytes; the backtrack recomputes the candidate's value from
//   the coefficient;
// - the DC rounds as the host library does (floor(x + 0.5) or
//   ceil(x - 0.5) in f32); where every AC has 2|coef| < q the AC is all zero
//   (core.cpp's exact early exit: any nonzero costs more than it saves).
//
// What bounds it on the card: a thread's 63 dependent steps. A block moves
// 384 bytes (256 in, 128 out), and a thread runs its block's DP, a few
// hundred instructions a step, most of them compares and selects. Where a
// batch has some 80,000 blocks that run the DP, each of the card's
// schedulers holds 4 or 5 of their warps and instruction issue sets the
// pace; where it has 34,000, 2 or 3, and a step's latency does. The design
// spends as few instructions and branches a step as its structure allows:
//
// - the states leave every step sorted by (cost, order), so the zero
//   children are one sorted list where no ZRL reorders them (a ZRL child's
//   +10 only moves it later). An entry's new slot is counted, not searched:
//   a zero child's is its parent's index plus the nonzero entries before
//   it, a nonzero entry's the zero children and nonzero entries before it
//   (8 + 2 compares each). Only where a warp holds a block whose zero
//   children are out of order do they count each other (28 compares);
// - the nonzero slots are packed (floor, or ceil where floor is 0; ceil
//   beside floor; the extension), and a warp takes a slot's minimum over the
//   parents only where one of its blocks has that candidate; a warp where no
//   block has one and no ZRL reorders the children passes its states
//   through;
// - each entry writes (cost, run and history byte) to the slot of its rank
//   in a per-thread array in shared memory, ranks past 7 to a ninth slot,
//   and the thread reads the 8 back: no selection network, no branch;
// - each CTA packs its blocks that run the DP onto its first threads, so a
//   warp's 32 lanes all run a DP; the rest of the CTA's blocks are written
//   by their own threads (the DC and 63 zeros);
// - the division for the next step is taken before this step's merge, off
//   the step's dependent chain;
// - the backtrack loads its history 9 steps at a time and writes the path
//   into the tail of the block's staged row, whose coefficients it has read.
//
// The CTA's 128 blocks are staged in shared memory with coalesced loads at a
// pitch of 65 floats; the rate LUT is there transposed (category-major, a
// pitch of 17: a warp's lookups of one category fall in distinct banks), a
// row of zeros for categories past 15; the per-thread history (504 bytes)
// lives in local memory, which the L1 and L2 hold. The grid holds as many
// CTAs as the card holds at once (SMs x CTAs an SM) where the batch allows,
// each taking every grid-th block, up to 128: each SM gets as many CTAs and
// each CTA a sample of the whole batch, so no SM is left with the textured
// part of an image while others idle. A flat grid.x (N may exceed 65,535
// CTAs' worth of blocks).

#include <atomic>
#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace pixo {
namespace trellis {

constexpr int kStates = 8;
constexpr int kThreads = 128;  // blocks a CTA: a thread a block
constexpr int kWarps = kThreads / 32;
constexpr int kPitch = 65;     // floats a staged block takes: no bank conflicts
constexpr int kMaxPattern = 8;
constexpr int kRatePitch = 17;  // the transposed rate LUT: [category][run]
constexpr int kRateRows = 17;   // categories 0-15 and a row of zeros for 16 and over
// the history of a step that passes its states through: state i came from
// state i by the zero candidate
constexpr uint32_t kIdentityLo = 0x03020100u, kIdentityHi = 0x07060504u;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// Shared memory by 32-bit address: the rate LUT (read only in the DP), and a
// thread's placement slots (its own stores, then its own loads).
__device__ __forceinline__ float lds_f32(uint32_t at) {
  float v;
  asm("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(at));
  return v;
}
__device__ __forceinline__ void sts_u2(uint32_t at, uint32_t x, uint32_t y) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(at), "r"(x), "r"(y) : "memory");
}
__device__ __forceinline__ uint2 lds_u2(uint32_t at) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];" : "=r"(v.x), "=r"(v.y) : "r"(at) : "memory");
  return v;
}

struct Params {
  float rate[256];  // (run << 4) | category -> the rate estimate, as the plain version's LUT
  float q[2][64];   // lum, chrom tables in zigzag order
  uint8_t pattern[kMaxPattern];
  int bpm;
  float lam;
};

// A nonzero slot's candidate: 1 floor, 2 ceil, 3 the extension.
__device__ __forceinline__ float candidate(int which, float fq) {
  const float fl = floorf(fq), ce = ceilf(fq);
  if (which == 1) return fl;
  if (which == 2) return ce;
  return fq >= 0.0f ? __fadd_rn(ce, 1.0f) : __fsub_rn(fl, 1.0f);
}

__device__ __forceinline__ int category(float v) {
  const unsigned a = static_cast<unsigned>(fabsf(v));
  return a == 0 ? 0 : 32 - __clz(a);
}

__device__ __forceinline__ int16_t round_dc(float x0) {
  const float r = x0 >= 0.0f ? floorf(__fadd_rn(x0, 0.5f)) : ceilf(__fsub_rn(x0, 0.5f));
  return static_cast<int16_t>(static_cast<int>(r));
}

// A nonzero entry of candidate v (valid or not: an invalid one costs inf):
// its cost, the least (cost[p] + rate[run[p]][cat]) + lam * d^2, and
// history byte (which << 3 | its parent). The minimum is a tree whose lower
// half wins a tie: the lowest parent, as a scan with a strict compare.
__device__ __forceinline__ float nonzero_entry(const float* cost, const int* run, uint32_t s_rate,
                                               float coef, float qq, float lam, float v, bool ok,
                                               int which, int& code) {
  const float d = __fsub_rn(coef, __fmul_rn(v, qq));
  const float ld = ok ? __fmul_rn(lam, __fmul_rn(d, d)) : inf();
  const uint32_t rate = s_rate + 4 * min(category(v), kRateRows - 1) * kRatePitch;
  float c[kStates];
  int at[kStates];
#pragma unroll
  for (int p = 0; p < kStates; ++p) {
    c[p] = __fadd_rn(__fadd_rn(cost[p], lds_f32(rate + 4 * run[p])), ld);
    at[p] = p;
  }
#pragma unroll
  for (int w = 1; w < kStates; w *= 2) {
#pragma unroll
    for (int p = 0; p < kStates; p += 2 * w) {
      const bool right = c[p + w] < c[p];
      c[p] = right ? c[p + w] : c[p];
      at[p] = right ? at[p + w] : at[p];
    }
  }
  code = (which << 3) | at[0];
  return c[0];
}

// Counts a nonzero entry of cost cn into the ranks: the zero children before
// it (parent 0's on a tie, the others' only below it), and it before the
// others. Returns its rank among the zero children.
__device__ __forceinline__ int rank_nonzero(const float* zc, int* rz, float cn) {
  int first = 0;
#pragma unroll
  for (int p = 0; p < kStates; ++p) {
    const bool before = p == 0 ? cn < zc[0] : cn <= zc[p];
    rz[p] += before;
    first += before;
  }
  return kStates - first;
}

__global__ void __launch_bounds__(kThreads) trellis_quantize_kernel(const float* __restrict__ dct, int64_t n,
                                                           int per_cta, const Params prm,
                                                           int16_t* __restrict__ out) {
  __shared__ float s_rate[kRateRows * kRatePitch];
  __shared__ float s_q[2 * kPitch];  // chrom at kPitch: the two tables' entries in other banks
  __shared__ float s_x[kThreads * kPitch];
  __shared__ uint2 s_slot[kStates + 1][kThreads];  // a step's placement: (cost bits, run << 8 | history
                                                    // byte), and a slot for the entries past the 8th
  __shared__ int s_rows[kThreads];             // the CTA's blocks that run the DP, in order
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = tid; k < kRateRows * kRatePitch; k += kThreads) {
    const int cat = k / kRatePitch, r = k % kRatePitch;
    s_rate[k] = cat < 16 && r < 16 ? prm.rate[(r << 4) | cat] : 0.0f;
  }
  for (int k = tid; k < 128; k += kThreads) s_q[(k >> 6) * kPitch + (k & 63)] = prm.q[k >> 6][k & 63];
  // the CTA's blocks: every grid-th from its own index, per_cta of them
  const int64_t first = blockIdx.x, stride = gridDim.x;
  const int64_t mine = (n - first + stride - 1) / stride;
  const int rows = static_cast<int>(mine < per_cta ? mine : per_cta);
  for (int k = tid; k < rows * 16; k += kThreads) {
    const float4 v = reinterpret_cast<const float4*>(dct + (first + stride * (k >> 4)) * 64)[k & 15];
    float* d = s_x + (k >> 4) * kPitch + 4 * (k & 15);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();

  // the all-zero exit: such a block is written here, by its own thread
  bool dp = false;
  if (tid < rows) {
    const float* x = s_x + tid * kPitch;
    const int64_t row = first + stride * tid;
    const float* q = s_q + (prm.pattern[row % prm.bpm] != 0 ? kPitch : 0);
    for (int k = 1; k < 64; ++k) dp |= __fmul_rn(2.0f, fabsf(x[k])) >= q[k];
    if (!dp) {
      int4* dst = reinterpret_cast<int4*>(out + row * 64);
      dst[0] = make_int4(static_cast<uint16_t>(round_dc(__fdiv_rn(x[0], q[0]))), 0, 0, 0);
#pragma unroll
      for (int k = 1; k < 8; ++k) dst[k] = make_int4(0, 0, 0, 0);
    }
  }
  // the DP blocks onto the first threads
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, dp);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  int ndp = 0, before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    before += w < warp ? s_warp[w] : 0;
    ndp += s_warp[w];
  }
  if (dp) s_rows[before + __popc(ballot & ((1u << lane) - 1))] = tid;
  __syncthreads();
  if (tid >= ndp) return;
  const unsigned lanes = ndp - warp * 32 >= 32 ? 0xFFFFFFFFu : (1u << (ndp - warp * 32)) - 1;

  const int r = s_rows[tid];
  const int64_t row = first + stride * r;
  const float* x = s_x + r * kPitch;
  const float* q = s_q + (prm.pattern[row % prm.bpm] != 0 ? kPitch : 0);
  const float lam = prm.lam;
  const int16_t dc = round_dc(__fdiv_rn(x[0], q[0]));
  float cost[kStates];
  int run[kStates];
#pragma unroll
  for (int p = 0; p < kStates; ++p) {
    cost[p] = p == 0 ? 0.0f : inf();
    run[p] = 0;
  }
  uint2 hist[63];  // step zz - 1: byte i of (x, y) is state i's (candidate << 3) | parent
  const uint32_t slot = static_cast<uint32_t>(__cvta_generic_to_shared(&s_slot[0][tid]));
  const uint32_t rate_at = static_cast<uint32_t>(__cvta_generic_to_shared(s_rate));

  float fq = __fdiv_rn(x[1], q[1]);
  for (int zz = 1; zz < 64; ++zz) {
    const float coef = x[zz], qq = q[zz];
    const float fl = floorf(fq), ce = ceilf(fq), afq = fabsf(fq);
    const bool has_fl = fl != 0.0f, has_ce = ce != 0.0f && ce != fl;
    const float ext = fq >= 0.0f ? __fadd_rn(ce, 1.0f) : __fsub_rn(fl, 1.0f);
    const float ld0 = __fmul_rn(lam, __fmul_rn(coef, coef));

    // the zero children; out of order only where a ZRL's +10 moved one later
    float zc[kStates];
    int zrun[kStates];
    bool unsorted = false;
#pragma unroll
    for (int p = 0; p < kStates; ++p) {
      zc[p] = __fadd_rn(__fadd_rn(cost[p], run[p] == 15 ? 10.0f : 0.0f), ld0);
      zrun[p] = (run[p] + 1) & 15;
      if (p > 0) unsorted |= zc[p - 1] > zc[p];
    }
    // what any block of the warp needs: slot A (floor, or ceil where floor
    // is 0), B (ceil beside floor), C (the extension), the children's count
    const bool need_a = __any_sync(lanes, has_fl || has_ce), need_count = __any_sync(lanes, unsorted);
    const int at = zz < 63 ? zz + 1 : zz;
    const float fq_next = __fdiv_rn(x[at], q[at]);
    if (!need_a && !need_count) {  // no nonzero candidate, the children in order: the states pass through
#pragma unroll
      for (int p = 0; p < kStates; ++p) {
        cost[p] = zc[p];
        run[p] = zrun[p];
      }
      hist[zz - 1] = make_uint2(kIdentityLo, kIdentityHi);
      fq = fq_next;
      continue;
    }

    const bool need_b = __any_sync(lanes, has_fl && has_ce), need_c = __any_sync(lanes, afq > 1.5f);
    int rz[kStates];  // each zero child's rank: its parent's, where the children are in order
#pragma unroll
    for (int p = 0; p < kStates; ++p) rz[p] = p;
    if (need_count) {
#pragma unroll
      for (int p = 0; p < kStates; ++p) {
#pragma unroll
        for (int o = p + 1; o < kStates; ++o) {
          const bool o_first = zc[p] > zc[o];
          rz[p] += o_first;
          rz[o] -= o_first;
        }
      }
    }
    float ca = inf(), cb = inf(), cc = inf();
    int ma = 0, mb = 0, mc = 0, ra = kStates, rb = kStates, rc = kStates;
    if (need_a) {
      ca = nonzero_entry(cost, run, rate_at, coef, qq, lam, has_fl ? fl : ce, has_fl || has_ce,
                         has_fl ? 1 : 2, ma);
      ra = rank_nonzero(zc, rz, ca);
    }
    if (need_b) {
      cb = nonzero_entry(cost, run, rate_at, coef, qq, lam, ce, has_fl && has_ce, 2, mb);
      rb = rank_nonzero(zc, rz, cb);
      const bool a_first = ca <= cb;
      rb += a_first;
      ra += !a_first;
    }
    if (need_c) {
      cc = nonzero_entry(cost, run, rate_at, coef, qq, lam, ext, afq > 1.5f, 3, mc);
      rc = rank_nonzero(zc, rz, cc);
      const bool a_first = ca <= cc, b_first = cb <= cc;
      rc += a_first;
      ra += !a_first;
      if (need_b) {
        rc += b_first;
        rb += !b_first;
      }
    }

    // the ranks of the entries present are a permutation: slots 0-7 are
    // each written once, the rest go to slot 8
    constexpr uint32_t kSlotBytes = 8 * kThreads;
#pragma unroll
    for (int p = 0; p < kStates; ++p) {
      sts_u2(slot + min(rz[p], kStates) * kSlotBytes, __float_as_uint(zc[p]), zrun[p] << 8 | p);
    }
    sts_u2(slot + min(ra, kStates) * kSlotBytes, __float_as_uint(ca), ma);
    sts_u2(slot + min(rb, kStates) * kSlotBytes, __float_as_uint(cb), mb);
    sts_u2(slot + min(rc, kStates) * kSlotBytes, __float_as_uint(cc), mc);
    uint32_t meta[kStates];
#pragma unroll
    for (int i = 0; i < kStates; ++i) {
      const uint2 e = lds_u2(slot + i * kSlotBytes);
      cost[i] = __uint_as_float(e.x);
      run[i] = e.y >> 8;
      meta[i] = e.y;
    }
    hist[zz - 1] = make_uint2(__byte_perm(__byte_perm(meta[0], meta[1], 0x0040),
                                          __byte_perm(meta[2], meta[3], 0x0040), 0x5410),
                              __byte_perm(__byte_perm(meta[4], meta[5], 0x0040),
                                          __byte_perm(meta[6], meta[7], 0x0040), 0x5410));
    fq = fq_next;
  }

  // the end-of-block rate where a run is open; ties to the lowest state
  int idx = 0;
  float best = __fadd_rn(cost[0], run[0] > 0 ? 4.0f : 0.0f);
#pragma unroll
  for (int p = 1; p < kStates; ++p) {
    const float f = __fadd_rn(cost[p], run[p] > 0 ? 4.0f : 0.0f);
    if (f < best) {
      best = f;
      idx = p;
    }
  }
  // the path, into the tail of the block's staged row: word 33 + k (bytes
  // 132-259) holds the ACs 2k and 2k + 1 (the DC and AC 1 in word 33). The
  // backtrack, going down from 63, has read the coefficients there already.
  uint32_t* words = reinterpret_cast<uint32_t*>(s_x + r * kPitch) + 33;
  uint32_t high = 0;  // an odd AC, until its even neighbour comes
#pragma unroll 1
  for (int top = 63; top >= 1; top -= 9) {  // 7 rounds of 9 steps, their history loaded at once
    uint2 h[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) h[k] = hist[top - 1 - k];
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      const int zz = top - k;
      const int code = ((idx < 4 ? h[k].x : h[k].y) >> (8 * (idx & 3))) & 0xFF;
      const uint32_t v = code >> 3 ? static_cast<uint16_t>(static_cast<int>(
                                         candidate(code >> 3, __fdiv_rn(x[zz], q[zz]))))
                                   : 0u;
      if (zz & 1) {
        high = v << 16;
      } else {
        words[zz >> 1] = high | v;
      }
      idx = code & 7;
    }
  }
  words[0] = high | static_cast<uint16_t>(dc);
  int4* dst = reinterpret_cast<int4*>(out + row * 64);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    dst[k] = make_int4(words[4 * k], words[4 * k + 1], words[4 * k + 2], words[4 * k + 3]);
  }
}

}  // namespace trellis
}  // namespace pixo

extern "C" {

// dct: [n, 64] f32 zigzag blocks on the device, 16-byte aligned; lum/chrom:
// the zigzag [64] f32 tables, rate: the [256] f32 rate LUT and pattern: the
// MCU's component ids ([bpm], 1 <= bpm <= 8), all in HOST memory (passed by
// value to the kernel); out: [n, 64] int16 on the device, 16-byte aligned.
// Block i takes the chroma table where pattern[i % bpm] != 0. Returns
// cudaGetLastError() after the launch.
int pixo_trellis_quantize(const float* dct, int64_t n, const float* lum, const float* chrom,
                          const uint8_t* pattern, int32_t bpm, float lam, const float* rate,
                          int16_t* out, void* stream) {
  using namespace pixo::trellis;
  if (n <= 0 || bpm < 1 || bpm > kMaxPattern) return static_cast<int>(cudaErrorInvalidValue);
  // as many CTAs as the card holds at once where the batch allows, each a
  // sample of the whole batch: every SM gets as many CTAs, and as much DP.
  // The card's CTA slots (SMs x CTAs an SM) are found once a device.
  static std::atomic<int> card_slots[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int slots = dev < 64 ? card_slots[dev].load() : 0;
  if (slots == 0) {
    int sms = 0, ctas = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, trellis_quantize_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    slots = sms * (ctas > 0 ? ctas : 1);
    if (dev < 64) card_slots[dev].store(slots);
  }
  const int per_cta = static_cast<int>((n + slots - 1) / slots < kThreads ? (n + slots - 1) / slots : kThreads);
  const int64_t grid = (n + per_cta - 1) / per_cta;
  if (grid > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  Params prm;
  std::memcpy(prm.rate, rate, sizeof(prm.rate));
  std::memcpy(prm.q[0], lum, sizeof(prm.q[0]));
  std::memcpy(prm.q[1], chrom, sizeof(prm.q[1]));
  std::memset(prm.pattern, 0, sizeof(prm.pattern));
  std::memcpy(prm.pattern, pattern, static_cast<size_t>(bpm));
  prm.bpm = bpm;
  prm.lam = lam;
  trellis_quantize_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dct, n, per_cta, prm, out);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the trellis kernel an SM holds at once (its occupancy), or -1.
int pixo_trellis_ctas_per_sm(void) {
  int ctas = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, pixo::trellis::trellis_quantize_kernel,
                                                    pixo::trellis::kThreads, 0) != cudaSuccess)
    return -1;
  return ctas;
}

}  // extern "C"
