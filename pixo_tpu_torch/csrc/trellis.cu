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
// - the at most 11 entries merge by (cost, order): a finite entry's rank
//   counts the entries before it, and the 8 first ranks are the next states;
// - a state's history is 6 bits a step (its parent, and which candidate it
//   took: 0 for zero, 1-3 for a nonzero slot), so a step of 8 states is one
//   64-bit word; the backtrack recomputes the candidate's value from the
//   coefficient;
// - the DC rounds as the host library does (floor(x + 0.5) or
//   ceil(x - 0.5) in f32); where every AC has 2|coef| < q the AC is all zero
//   (core.cpp's exact early exit: any nonzero costs more than it saves).
//
// What bounds it on the card: operations. A block moves 384 bytes (256 in,
// 128 out), and the DP does some hundreds of operations a step for 63 steps
// (the nonzero minima, the zero children, the 11-entry rank and the selection),
// in registers; the per-thread history (504 bytes) lives in local memory,
// which the L1 and L2 hold. The design is the simple one: a thread a block,
// the CTA's 128 blocks staged in shared memory with coalesced loads at a
// pitch of 65 floats (a thread's reads of its own row hit 32 banks across a
// warp), the rate LUT and the two tables in shared memory, a flat grid.x
// (N may exceed 65,535 CTAs' worth of blocks).

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace pixo {
namespace trellis {

constexpr int kStates = 8;
constexpr int kNz = 3;                 // nonzero candidate slots: floor, ceil, the extension
constexpr int kEntries = kStates + kNz;
constexpr int kThreads = 128;          // blocks a CTA: a thread a block
constexpr int kPitch = 65;             // floats a staged block takes: no bank conflicts
constexpr int kMaxPattern = 8;

struct Params {
  float rate[256];  // (run << 4) | category -> the rate estimate, as the plain version's LUT
  float q[2][64];   // lum, chrom tables in zigzag order
  uint8_t pattern[kMaxPattern];
  int bpm;
  float lam;
};

__device__ __forceinline__ bool finite(float x) { return x < __int_as_float(0x7f800000); }

// The nonzero candidates of fq (floor, ceil, the extension) and their validity.
__device__ __forceinline__ void candidates(float fq, float* v, bool* ok) {
  const float fl = floorf(fq), ce = ceilf(fq);
  v[0] = fl;
  v[1] = ce;
  v[2] = fq >= 0.0f ? __fadd_rn(ce, 1.0f) : __fsub_rn(fl, 1.0f);
  ok[0] = fl != 0.0f;
  ok[1] = ce != 0.0f && ce != fl;
  ok[2] = fabsf(fq) > 1.5f;
}

__device__ __forceinline__ int category(float v) {
  const unsigned a = static_cast<unsigned>(fabsf(v));
  return a == 0 ? 0 : 32 - __clz(a);
}

__global__ void __launch_bounds__(kThreads) trellis_quantize_kernel(const float* __restrict__ dct, int64_t n,
                                                           const Params prm, int16_t* __restrict__ out) {
  __shared__ float s_rate[256];
  __shared__ float s_q[2 * kPitch];  // chrom at kPitch: the two tables' entries in other banks
  __shared__ float s_x[kThreads * kPitch];
  const int tid = threadIdx.x;
  for (int k = tid; k < 256; k += kThreads) s_rate[k] = prm.rate[k];
  for (int k = tid; k < 128; k += kThreads) s_q[(k >> 6) * kPitch + (k & 63)] = prm.q[k >> 6][k & 63];
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads;
  const int rows = static_cast<int>(n - first < kThreads ? n - first : kThreads);
  const float4* src = reinterpret_cast<const float4*>(dct + first * 64);
  for (int k = tid; k < rows * 16; k += kThreads) {
    const float4 v = src[k];
    float* d = s_x + (k >> 4) * kPitch + 4 * (k & 15);
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();
  if (tid >= rows) return;

  const int64_t row = first + tid;
  const float* x = s_x + tid * kPitch;
  const float* q = s_q + (prm.pattern[row % prm.bpm] != 0 ? kPitch : 0);
  alignas(16) int16_t path[64];
  {
    const float x0 = __fdiv_rn(x[0], q[0]);
    const float r = x0 >= 0.0f ? floorf(__fadd_rn(x0, 0.5f)) : ceilf(__fsub_rn(x0, 0.5f));
    path[0] = static_cast<int16_t>(static_cast<int>(r));
  }
  bool big = false;
  for (int k = 1; k < 64; ++k) big |= __fmul_rn(2.0f, fabsf(x[k])) >= q[k];

  if (!big) {
    for (int k = 1; k < 64; ++k) path[k] = 0;
  } else {
    const float inf = __int_as_float(0x7f800000);
    const float lam = prm.lam;
    float cost[kStates];
    int run[kStates];
#pragma unroll
    for (int p = 0; p < kStates; ++p) {
      cost[p] = p == 0 ? 0.0f : inf;
      run[p] = 0;
    }
    uint64_t hist[63];  // step zz - 1: 6 bits a state, (candidate << 3) | parent

    for (int zz = 1; zz < 64; ++zz) {
      const float coef = x[zz], qq = q[zz];
      float v[kNz];
      bool ok[kNz];
      candidates(__fdiv_rn(coef, qq), v, ok);

      // the entries: 0-7 the zero children, 8-10 the nonzero candidates
      float ec[kEntries];
      int eo[kEntries], erun[kEntries], ecode[kEntries];
#pragma unroll
      for (int s = 0; s < kNz; ++s) {
        const float d = __fsub_rn(coef, __fmul_rn(v[s], qq));
        const float ld = __fmul_rn(lam, __fmul_rn(d, d));
        const int cat = category(v[s]);
        float best = inf;
        int bp = 0;
#pragma unroll
        for (int p = 0; p < kStates; ++p) {
          const float rate = cat < 16 ? s_rate[(run[p] << 4) | cat] : 0.0f;
          const float c = __fadd_rn(__fadd_rn(cost[p], rate), ld);
          if (c < best) {
            best = c;
            bp = p;
          }
        }
        ec[kStates + s] = ok[s] ? best : inf;
        eo[kStates + s] = 1 + s;
        erun[kStates + s] = 0;
        ecode[kStates + s] = ((1 + s) << 3) | bp;
      }
      const float ld0 = __fmul_rn(lam, __fmul_rn(coef, coef));
#pragma unroll
      for (int p = 0; p < kStates; ++p) {  // an invalid parent's child stays inf
        const int nr = run[p] + 1;
        ec[p] = __fadd_rn(__fadd_rn(cost[p], nr >= 16 ? 10.0f : 0.0f), ld0);
        eo[p] = 4 * p;  // after every nonzero order 1-3 of parent 0's turn
        erun[p] = nr >= 16 ? 0 : nr;
        ecode[p] = p;
      }

      // rank of each finite entry among all; the first 8 become the states
      int rank[kEntries];
#pragma unroll
      for (int e = 0; e < kEntries; ++e) {
        int r = 0;
#pragma unroll
        for (int f = 0; f < kEntries; ++f) {
          if (f != e) r += ec[f] < ec[e] || (ec[f] == ec[e] && eo[f] < eo[e]);
        }
        rank[e] = finite(ec[e]) ? r : kEntries;
      }
      uint64_t h = 0;
#pragma unroll
      for (int i = 0; i < kStates; ++i) {
        float c = inf;
        int r = 0, code = 0;
#pragma unroll
        for (int e = 0; e < kEntries; ++e) {
          if (rank[e] == i) {
            c = ec[e];
            r = erun[e];
            code = ecode[e];
          }
        }
        cost[i] = c;
        run[i] = r;
        h |= static_cast<uint64_t>(code) << (6 * i);
      }
      hist[zz - 1] = h;
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
    for (int zz = 63; zz >= 1; --zz) {
      const int code = static_cast<int>(hist[zz - 1] >> (6 * idx)) & 63;
      int16_t val = 0;
      if (code >> 3) {
        float v[kNz];
        bool ok[kNz];
        candidates(__fdiv_rn(x[zz], q[zz]), v, ok);
        val = static_cast<int16_t>(static_cast<int>(v[(code >> 3) - 1]));
      }
      path[zz] = val;
      idx = code & 7;
    }
  }
  int4* dst = reinterpret_cast<int4*>(out + row * 64);
  const int4* p4 = reinterpret_cast<const int4*>(path);
#pragma unroll
  for (int k = 0; k < 8; ++k) dst[k] = p4[k];
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
  const int64_t grid = (n + kThreads - 1) / kThreads;
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
      dct, n, prm, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
