// Adler-32 on the card, for Hopper (sm_90a).
//
// Replaces the JAX package's compress/checksums.py::adler32_jnp (:89), whose
// 2048-byte chunk sums and weighted sums are carried by a lax.scan. No path
// of either package calls it: it is the device counterpart of zlib's
// adler32 and equals it bit for bit.
//
// A run of m bytes d[0..m) acts on the state (a, b) as a <- a + s and
// b <- b + m * a + w, with s = sum d[i] and w = sum (m - i) * d[i], all mod
// 65521. Two runs in order combine as s = s1 + s2, w = w1 + w2 + m2 * s1,
// m = m1 + m2, an associative (not commutative) operation. Over runs r_1 ..
// r_N in order it unrolls to s = sum s_i, w = sum (w_i + s_i * after_i),
// after_i the bytes after run i: each run's term needs only its own end, so
// the terms add in any order, and the combine needs no tree.
//
// One launch (and a memset of its ticket), its grid sized to the card's CTA
// slots by the wrapper's plan (compress/checksums.py::adler32_plan): CTA c
// takes the contiguous share [c * share, (c + 1) * share) of the bytes, a
// multiple of 16 bytes (the last share ragged).
// - Its threads take the share's 16-byte chunks in turn (thread t chunks t,
//   t + 256, ...: a warp's load is 512 contiguous bytes), four loads in
//   flight a thread. A chunk's s and w come from byte dot products (__dp4a
//   with 1s and with the weights 0..15); its term w + s * after, after the
//   bytes of the share past it, is added in 64 bits. The share's last 0-15
//   bytes go a byte a thread.
// - Each thread's sums are reduced mod 65521 and summed over the CTA (warp
//   shuffles, then the eight warps in shared memory): the share's run.
// - Thread 0 writes the run to the call's scratch, fences, and takes a
//   ticket (an atomic add on a word of the same scratch, zeroed by the
//   memset on the call's stream). The CTA that takes the last ticket
//   combines the grid's runs (after_i: the bytes past share i) and applies
//   the result to the start value. No state outside the call's scratch.
//
// What bounds it: the bytes, read once (16 MiB in 5 us at 3.35 TB/s); the
// runs are 8 bytes a CTA.

#include <cstdint>

#include <cuda_runtime.h>

namespace pixo {

constexpr int kAdlerThreads = 256;
constexpr int kAdlerLoads = 4;  // 16-byte loads a thread keeps in flight
constexpr uint32_t kAdlerMod = 65521;

// The sum of v over the CTA, in thread 0 (the others get partial sums).
__device__ __forceinline__ uint64_t block_sum(uint64_t v, uint64_t* warp_sums) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < kAdlerThreads / 32; w++) v += warp_sums[w];
  __syncthreads();  // warp_sums may be written again
  return v;
}

// The 16 bytes of chunk v, followed by `after` bytes of the run: s += its
// sum, w += its weighted sum (weights 16..1) + its sum * after.
__device__ __forceinline__ void add_chunk(uint4 v, uint64_t after, uint32_t& s, uint64_t& w) {
  const uint32_t x[4] = {v.x, v.y, v.z, v.w};
  uint32_t cs = 0, cq = 0;  // the chunk's sum and its sum weighted by the byte's index 0..15
#pragma unroll
  for (int i = 0; i < 4; i++) {
    cs = __dp4a(x[i], 0x01010101u, cs);
    cq = __dp4a(x[i], 0x03020100u + 0x04040404u * i, cq);
  }
  s += cs;
  w += cs * (after + 16) - cq;
}

__global__ void __launch_bounds__(kAdlerThreads) adler32_kernel(const uint8_t* __restrict__ d, int64_t n,
                                                               int64_t share, uint32_t adler,
                                                               uint2* __restrict__ runs,
                                                               unsigned int* __restrict__ ticket,
                                                               uint32_t* __restrict__ out) {
  __shared__ uint64_t warp_sums[kAdlerThreads / 32];
  __shared__ bool last;
  const int64_t start = blockIdx.x * share;
  const int64_t len = n - start < share ? n - start : share;
  const int64_t chunks = len >> 4;
  const uint4* __restrict__ p = reinterpret_cast<const uint4*>(d + start);
  uint32_t s = 0;  // at most 4080 a chunk: share / 4096 chunks a thread keep it in 32 bits
  uint64_t w = 0;
  int64_t c = threadIdx.x;
  for (; c + (kAdlerLoads - 1) * kAdlerThreads < chunks; c += kAdlerLoads * kAdlerThreads) {
    uint4 v[kAdlerLoads];
#pragma unroll
    for (int u = 0; u < kAdlerLoads; u++) v[u] = __ldg(p + c + u * kAdlerThreads);
#pragma unroll
    for (int u = 0; u < kAdlerLoads; u++)
      add_chunk(v[u], static_cast<uint64_t>(len - 16 * (c + u * kAdlerThreads) - 16), s, w);
  }
  for (; c < chunks; c += kAdlerThreads) add_chunk(__ldg(p + c), static_cast<uint64_t>(len - 16 * c - 16), s, w);
  const int64_t tail = 16 * chunks + threadIdx.x;  // the share's ragged end, a byte a thread
  if (tail < len) {
    const uint32_t x = d[start + tail];
    s += x;
    w += static_cast<uint64_t>(x) * static_cast<uint64_t>(len - tail);
  }
  const uint64_t run_s = block_sum(s % kAdlerMod, warp_sums) % kAdlerMod;
  const uint64_t run_w = block_sum(w % kAdlerMod, warp_sums) % kAdlerMod;
  if (threadIdx.x == 0) {
    runs[blockIdx.x] = make_uint2(static_cast<uint32_t>(run_s), static_cast<uint32_t>(run_w));
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  uint64_t ts = 0, tw = 0;
  for (int64_t i = threadIdx.x; i < gridDim.x; i += kAdlerThreads) {
    const uint2 r = __ldcg(runs + i);
    const int64_t end = (i + 1) * share < n ? (i + 1) * share : n;
    ts += r.x;
    tw += r.y + static_cast<uint64_t>(r.x) * static_cast<uint64_t>((n - end) % kAdlerMod);
  }
  const uint64_t total_s = block_sum(ts, warp_sums) % kAdlerMod;
  const uint64_t total_w = block_sum(tw, warp_sums) % kAdlerMod;
  if (threadIdx.x == 0) {
    const uint64_t a0 = adler & 0xffffu, b0 = adler >> 16;
    const uint64_t a = (a0 + total_s) % kAdlerMod;
    const uint64_t b = (b0 + static_cast<uint64_t>(n % kAdlerMod) * a0 + total_w) % kAdlerMod;
    *out = static_cast<uint32_t>((b << 16) | a);
  }
}

}  // namespace pixo

extern "C" {

// CTAs of the kernel an SM holds at once (its occupancy), or 0 where the
// query fails.
int pixo_adler32_ctas_per_sm() {
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pixo::adler32_kernel, pixo::kAdlerThreads, 0) !=
      cudaSuccess)
    return 0;
  return per_sm;
}

// data: [n] uint8 on the device, n >= 1, 16-byte aligned; grid CTAs of
// share bytes each (a multiple of 16; grid * share >= n > (grid - 1) *
// share); scratch: 2 * grid + 2 uint32 words: the runs, the ticket, then
// the checksum of data continued from adler, in its last word.
int pixo_adler32(const uint8_t* data, int64_t n, uint32_t adler, int64_t grid, int64_t share,
                 uint32_t* scratch, void* stream) {
  using namespace pixo;
  if (n <= 0 || (reinterpret_cast<uintptr_t>(data) & 15) || grid < 1 || grid > 0x7fffffffll || share < 16 ||
      (share & 15) || grid * share < n || (grid - 1) * share >= n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + 2 * grid);
  cudaError_t rc = cudaMemsetAsync(ticket, 0, sizeof(unsigned int), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  adler32_kernel<<<static_cast<unsigned>(grid), kAdlerThreads, 0, s>>>(
      data, n, share, adler, reinterpret_cast<uint2*>(scratch), ticket, scratch + 2 * grid + 1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
