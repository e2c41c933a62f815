// Device PNG unfilter, for Hopper (sm_90a).
//
// Replaces the JAX package's ops/png_unfilter.py::unfilter_device_batch
// (:29), a jit lax.scan over the anti-diagonal wavefront; it has no Pallas
// kernel. No path of either package calls it: the PNG decode reconstructs
// its rows with the host library's png_unfilter, which it equals bit for
// bit.
//
// Pixel (y, x) needs a = out(y, x - 1), b = out(y - 1, x) and
// c = out(y - 1, x - 1), pixels of bpp bytes (0 outside the image), then
// out = raw + pred mod 256 byte by byte, pred by the row's filter: 0, a, b,
// (a + b) >> 1 on the unwrapped bytes, or Paeth (ties to a, then b, then c).
// Ids outside 0-4 take no predictor, as in the JAX function. The bpp bytes
// of a pixel are independent, so the function's critical path is
// ceil(RB / bpp) + H - 1 dependent pixel steps.
//
// Design: a lane a row, a pixel a step, warps of 32 rows with no CTA barrier
// in the step loop.
// - A warp takes a group of 32 consecutive rows; lane l runs one step behind
//   lane l - 1: at step s it reconstructs pixel x = s - l of its row, held in
//   one register (32 bits up to bpp 4, else 64). The pixel above is lane
//   l - 1's output of step s - 1, handed down by __shfl_up_sync; c is the
//   lane's b of the step before, a its own last output.
// - Lane 0 takes the row above from a ring that lane 31 of the warp of the
//   group above fills, a slot a pixel. Each slot holds the pixel beside a
//   32-bit tag, the pixel's running index through that ring, written as one
//   64-bit store (two for bpp 5-8, each with the tag), so data and flag are
//   one word and no fence orders them: the reader spins until the slot
//   holds its index. Lane 0 takes kTake pixels at once, every lane loading
//   the slots (one broadcast each), so the warp waits as one and kTake
//   steps run as straight-line code (a wait in every step fenced the
//   compiler's scheduling a step at a time); a group then starts up to
//   kTake steps later than the 32 the wavefront needs. The writer waits,
//   once a chunk of kChunk steps, until the reader's count (stored by the
//   reader's lane 0 once a chunk, after the slots' loads have been used)
//   leaves room for the chunk's pixels. A warp waits only for the warp
//   before it (its data) and the warp after it (room).
// - An image's warps cycle over its groups: warp q of the image takes
//   groups q, q + total, ... (total = ctas x warps), and the last warp's
//   ring feeds warp 0. Any height runs in one launch.
// - An image may take a cluster of up to 8 CTAs (ops/png_unfilter.py::
//   unfilter_plan picks the split from B, H, RB and the card's SMs): where
//   a ring's writer sits in another CTA it writes through distributed
//   shared memory (rings live with their readers, counts with their
//   writers). The cluster's barriers come once before the walk (the rings
//   set up) and once after it (no CTA leaves while another may write to
//   it). Where the rings the plan needs outgrow shared memory, they live in
//   a global scratch instead (kGlobal), with the same protocol.
// - Each lane streams its row through a ring of aligned 16-byte words in
//   shared memory, brought by cp.async kAhead chunks ahead of their use and
//   waited for once a chunk, when the chunk's pixels are loaded at once,
//   each as two (three for bpp 5-8) aligned 32-bit words and a funnel
//   shift. A row may start at any byte: an aligned word that holds a byte
//   of the tensor lies in the tensor's 16-byte aligned allocation (rows at
//   odd offsets take the same path; a warp-wide TMA tile of 32 rows would
//   stay live 31 steps past its first row's use, for the lanes' skew, and
//   needs aligned rows). A lane's words are 16 x odd bytes apart, so the
//   lanes' skewed reads spread over the banks. A step stores its pixel's bytes into the lane's staging
//   bytes; once a chunk the completed aligned 8-byte words go out whole,
//   byte by byte only at a row's two ends (where a word is shared with the
//   neighbouring row).
// - The predictor works on the pixel's bytes in one register at once and
//   without a branch (a warp's rows take any filters): byte-wise
//   VABSDIFF4 for Paeth's pa = |b - c| and pb = |a - c|, byte-wise borrow
//   tests for the rest. pc = |a + b - 2c| needs nine bits, but its tests
//   do not: pc = pa + pb unless c lies strictly between a and b, where
//   pc = |pa - pb|; so a (or b, the nearer of the two) loses to c exactly
//   where c lies strictly between them and 2 min(pa, pb) > max(pa, pb).
//
// What bounds it: the critical path, the function's ceil(RB / bpp) + H - 1
// steps and up to kTake more a group, each a shuffle, the predictor and an
// add in one dependent chain; the bytes take far less at the H100's
// 3.35 TB/s. At PNG (a)'s 8x512x1536, bpp 3, on an H100 80GB HBM3 at 700 W
// (chip_smoke.py --unfilter-parts): 0.16 ms on the plan's 8 CTAs of 2 warps
// an image, about 310 SM clocks a step of the function's path; a lone warp
// (32 rows) takes about 250 a step, and each group more adds about 6 us,
// some 44 steps of a warp that takes from a ring and fills one. The
// predictor is a third of the time. One SM an image (16 warps) took 0.30
// ms: its four warps a scheduler then contend for issue.

#include <cstdint>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace pixo {

constexpr int kChunk = 16;       // steps between a warp's chunk-level work: copies, room, its count
constexpr int kTake = 8;         // steps whose pixels above lane 0 takes at once (divides kChunk)
constexpr int kAhead = 2;        // chunks a lane's copies run ahead of its steps
constexpr int kMaxWarps = 16;    // warps a CTA at most
constexpr int kMaxCtas = 8;      // CTAs an image at most (a portable cluster)
constexpr int kMinRing = 64;     // ring slots at least

__host__ __device__ constexpr int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The 16-byte words of a lane's input ring: the words that the current
// chunk and the kAhead after it reach, and one more.
template <int BPP>
__host__ __device__ constexpr int in_words() {
  return pow2_at_least(((kAhead + 1) * kChunk * BPP + 15) / 16 + 1);
}

// A lane's input ring and 16 bytes of padding (16 x an odd number of bytes
// in all, so the lanes' skewed reads spread over the banks).
template <int BPP>
__host__ __device__ constexpr int lane_bytes() {
  return 16 * in_words<BPP>() + 16;
}

// A lane's output staging: the word carried over and a chunk's bytes, 8 x
// an odd number of bytes.
template <int BPP>
__host__ __device__ constexpr int stage_bytes() {
  return 8 * (((8 + kChunk * BPP + 7) / 8) | 1);
}

// Bytes of a ring slot: the pixel's 32-bit words, each beside the tag.
template <int BPP>
__host__ __device__ constexpr int slot_bytes() {
  return BPP <= 4 ? 8 : 16;
}

// ---- byte-wise arithmetic on 4 bytes in a word

// 0xff in each byte where x < y (unsigned), else 0: the borrow out of the
// byte's top bit, from a difference that borrows nothing across bytes,
// spread over the byte by PRMT's sign replication (a selector nibble of 8
// or more; __byte_perm keeps only a nibble's low 3 bits, so PTX).
__device__ __forceinline__ uint32_t lt4(uint32_t x, uint32_t y) {
  const uint32_t t = (x | 0x80808080u) - (y & 0x7f7f7f7fu);
  const uint32_t borrow = ((x ^ y) & y) | (~(x ^ y) & ~t);
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(borrow), "r"(0u), "r"(0xBA98u));
  return r;
}

__device__ __forceinline__ uint32_t add4(uint32_t x, uint32_t y) {
  return ((x & 0x7f7f7f7fu) + (y & 0x7f7f7f7fu)) ^ ((x ^ y) & 0x80808080u);
}

// m1..m4: all ones where the row's filter is 1..4, else 0.
struct Masks {
  uint32_t sub, up, avg, paeth;
};

__device__ __forceinline__ uint32_t predict4(const Masks& m, uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t avg = (a & b) + (((a ^ b) >> 1) & 0x7f7f7f7fu);
  const uint32_t pa = __vabsdiffu4(b, c), pb = __vabsdiffu4(a, c);
  const uint32_t a_wins = ~lt4(pb, pa);  // pa <= pb
  // 2 min(pa, pb) > max(pa, pb), both ways at once and then the one that
  // applies: a shorter chain from b than min, max, halve, compare
  const uint32_t far = (lt4((pb >> 1) & 0x7f7f7f7fu, pa) & a_wins) | (lt4((pa >> 1) & 0x7f7f7f7fu, pb) & ~a_wins);
  const uint32_t inside = lt4(a, c) ^ lt4(b, c);  // c between a and b (at a tie, min(pa, pb) is 0 and c loses)
  const uint32_t take_c = inside & far;
  const uint32_t paeth = (c & take_c) | (((a & a_wins) | (b & ~a_wins)) & ~take_c);
  return (a & m.sub) | (b & m.up) | (avg & m.avg) | (paeth & m.paeth);
}

__device__ __forceinline__ uint32_t step4(const Masks& m, uint32_t raw, uint32_t a, uint32_t b, uint32_t c) {
  return add4(raw, predict4(m, a, b, c));
}

__device__ __forceinline__ uint64_t step8(const Masks& m, uint64_t raw, uint64_t a, uint64_t b, uint64_t c) {
  const uint32_t lo = step4(m, static_cast<uint32_t>(raw), static_cast<uint32_t>(a), static_cast<uint32_t>(b),
                            static_cast<uint32_t>(c));
  const uint32_t hi = step4(m, static_cast<uint32_t>(raw >> 32), static_cast<uint32_t>(a >> 32),
                            static_cast<uint32_t>(b >> 32), static_cast<uint32_t>(c >> 32));
  return static_cast<uint64_t>(hi) << 32 | lo;
}

// ---- rings and counts. Their accesses are asm volatile, so they keep
// their program order among themselves and leave the other memory accesses
// free: a slot's data and tag are one 64-bit store, and a count is stored
// after the slots it counts were loaded and used.

template <int BPP>
using Pixel = typename std::conditional<(BPP <= 4), uint32_t, uint64_t>::type;

// A ring slot as loaded: the pixel's words, each beside its tag (y is x up
// to bpp 4).
struct Slot {
  uint64_t x, y;
};

__device__ __forceinline__ bool holds(const Slot& v, uint32_t i) {
  return static_cast<uint32_t>(v.x >> 32) == i && static_cast<uint32_t>(v.y >> 32) == i;
}

template <int BPP>
__device__ __forceinline__ Pixel<BPP> slot_pixel(const Slot& v) {
  if constexpr (BPP <= 4)
    return static_cast<uint32_t>(v.x);
  else
    return static_cast<uint64_t>(static_cast<uint32_t>(v.y)) << 32 | static_cast<uint32_t>(v.x);
}

// A warp's ends of the rings: its input ring and the count of what the next
// warp has read of its output ring (both its own to read), the next warp's
// ring and this warp's count of its input ring (both to write).
template <int BPP, bool kGlobal>
struct Rings;

// In shared memory: its own through 32-bit shared addresses, the others
// through the cluster's shared window (mapa; a CTA of its own cluster too).
template <int BPP>
struct Rings<BPP, false> {
  uint32_t in, room, out, count;

  __device__ __forceinline__ static uint32_t local(const uint8_t* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
  }
  __device__ __forceinline__ static uint32_t remote(const uint8_t* p, int rank) {
    uint32_t a;
    asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(a) : "r"(local(p)), "r"(rank));
    return a;
  }
  __device__ __forceinline__ uint64_t ld(uint32_t a) const {
    uint64_t v;
    asm volatile("ld.relaxed.cluster.shared::cta.u64 %0, [%1];" : "=l"(v) : "r"(a));
    return v;
  }
  __device__ __forceinline__ void st(uint32_t a, uint64_t v) const {
    asm volatile("st.relaxed.cluster.shared::cluster.u64 [%0], %1;" ::"r"(a), "l"(v));
  }
  __device__ __forceinline__ uint32_t read_room() const {
    uint32_t v;
    asm volatile("ld.relaxed.cluster.shared::cta.u32 %0, [%1];" : "=r"(v) : "r"(room));
    return v;
  }
  __device__ __forceinline__ void publish(uint32_t v) const {
    asm volatile("st.relaxed.cluster.shared::cluster.u32 [%0], %1;" ::"r"(count), "r"(v));
  }
  __device__ __forceinline__ Slot load(int slots, uint32_t i) const {
    const uint32_t a = in + (i & (slots - 1)) * slot_bytes<BPP>();
    Slot v;
    v.x = ld(a);
    v.y = BPP <= 4 ? v.x : ld(a + 8);
    return v;
  }
  __device__ __forceinline__ void put(int slots, uint32_t i, Pixel<BPP> v) const {
    const uint32_t a = out + (i & (slots - 1)) * slot_bytes<BPP>();
    const uint64_t tag = static_cast<uint64_t>(i) << 32;
    st(a, tag | static_cast<uint32_t>(v));
    if constexpr (BPP > 4) st(a + 8, tag | static_cast<uint32_t>(static_cast<uint64_t>(v) >> 32));
  }
};

// In global memory: generic addresses, volatile accesses.
template <int BPP>
struct Rings<BPP, true> {
  const uint8_t *in, *room;
  uint8_t *out, *count;

  __device__ __forceinline__ static uint64_t ld(const uint8_t* p) {
    uint64_t v;
    asm volatile("ld.volatile.u64 %0, [%1];" : "=l"(v) : "l"(p));
    return v;
  }
  __device__ __forceinline__ static void st(uint8_t* p, uint64_t v) {
    asm volatile("st.volatile.u64 [%0], %1;" ::"l"(p), "l"(v));
  }
  __device__ __forceinline__ uint32_t read_room() const {
    uint32_t v;
    asm volatile("ld.volatile.u32 %0, [%1];" : "=r"(v) : "l"(room));
    return v;
  }
  __device__ __forceinline__ void publish(uint32_t v) const {
    asm volatile("st.volatile.u32 [%0], %1;" ::"l"(count), "r"(v));
  }
  __device__ __forceinline__ Slot load(int slots, uint32_t i) const {
    const uint8_t* a = in + static_cast<int64_t>(i & (slots - 1)) * slot_bytes<BPP>();
    Slot v;
    v.x = ld(a);
    v.y = BPP <= 4 ? v.x : ld(a + 8);
    return v;
  }
  __device__ __forceinline__ void put(int slots, uint32_t i, Pixel<BPP> v) const {
    uint8_t* a = out + static_cast<int64_t>(i & (slots - 1)) * slot_bytes<BPP>();
    const uint64_t tag = static_cast<uint64_t>(i) << 32;
    st(a, tag | static_cast<uint32_t>(v));
    if constexpr (BPP > 4) st(a + 8, tag | static_cast<uint32_t>(static_cast<uint64_t>(v) >> 32));
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

// A lane's row read through aligned 16-byte words that cp.async brings into
// a ring of kWords slots of shared memory, word k into slot k % kWords.
template <int BPP>
struct RowIn {
  static constexpr int kWords = in_words<BPP>();
  const uint8_t* words;  // the aligned word that holds the row's first byte
  uint8_t* ring;         // the lane's kWords * 16 bytes
  int count;             // the aligned words that hold bytes of the row (0: no row)
  int sent;              // the words sent
  int lead;              // the row's first byte within its word

  // Sends every word that the steps before step ``end`` reach (the lane's
  // pixels below end - lane), as far as the row goes.
  __device__ __forceinline__ void send_through(int end, int lane) {
    const int last = (lead + (end - lane) * BPP - 1) >> 4;
    while (sent < count && sent <= last) {
      cp_async16(ring + 16 * (sent & (kWords - 1)), words + 16 * static_cast<int64_t>(sent));
      sent++;
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // The pixel whose first byte is byte q - lead of the row (bytes past the
  // row are whatever the ring holds: a pixel's bytes are independent).
  __device__ __forceinline__ Pixel<BPP> pixel(int q) const {
    const int w = q >> 2, sh = 8 * (q & 3);
    const auto word = [&](int k) {
      return *reinterpret_cast<const uint32_t*>(ring + ((4 * k) & (16 * kWords - 1)));
    };
    const uint32_t w0 = word(w), w1 = word(w + 1);
    if constexpr (BPP <= 4) {
      return __funnelshift_r(w0, w1, sh);
    } else {
      const uint32_t w2 = word(w + 2);
      return static_cast<uint64_t>(__funnelshift_r(w1, w2, sh)) << 32 | __funnelshift_r(w0, w1, sh);
    }
  }
};

// A lane's output row through its staging bytes: a step stores its pixel's
// bytes there; once a chunk the words it completed go out whole (byte by
// byte at the row's two ends, where a word is shared with the neighbouring
// row) and the word still being filled moves to the front. The stage is
// reached through its 32-bit shared address (a generic pointer would make
// every byte a generic store).
template <int BPP>
struct RowOut {
  uint8_t* words;  // the aligned 8-byte word that holds the row's first byte
  uint32_t stage;  // the lane's stage_bytes<BPP>(), a shared address
  int lead;        // the row's first byte within its word
  int end;         // lead + the row's bytes
  int base;        // the row position of the stage's first byte, a multiple of 8

  // Where the pixel x0 (the chunk's first step's) goes in the stage.
  __device__ __forceinline__ uint32_t at(int x0) const { return stage + lead + x0 * BPP - base; }

  __device__ __forceinline__ static void put(uint32_t a, Pixel<BPP> v) {
#pragma unroll
    for (int j = 0; j < BPP; j++)
      asm volatile("st.shared.u8 [%0], %1;" ::"r"(a + j), "r"(static_cast<uint32_t>(v >> (8 * j))));
  }

  __device__ __forceinline__ uint64_t word(int lo) const {
    uint64_t w;
    asm volatile("ld.shared.u64 %0, [%1];" : "=l"(w) : "r"(stage + lo - base));
    return w;
  }

  // The row's bytes of word w, which starts at lo, one by one: a row's
  // first and last words, out of the step loop's line.
  __device__ __noinline__ void store_part(uint64_t w, int lo) const {
    for (int j = lo > lead ? lo : lead; j < lo + 8 && j < end; j++)
      words[j] = static_cast<uint8_t>(w >> (8 * (j - lo)));
  }

  // After a chunk whose steps took the lane's pixels x0 .. x0 + kChunk - 1
  // (those of the row among them staged): the completed words, a fixed
  // count of predicated stores; the row's first and last words, which may
  // hold another row's bytes, out of line.
  __device__ __forceinline__ void flush(int x0, int pixels) {
    constexpr int kMost = (kChunk * BPP + 7) / 8 + 1;  // the most words a chunk completes
    const int x1 = x0 + kChunk < pixels ? x0 + kChunk : pixels;
    if (x1 <= 0 || x0 >= pixels) return;
    const int e = lead + x1 * BPP < end ? lead + x1 * BPP : end;  // staged bytes end here
#pragma unroll
    for (int k = 0; k < kMost; k++) {
      const int lo = base + 8 * k;
      const uint64_t w = word(lo);
      if (lo + 8 <= e && lo >= lead) *reinterpret_cast<uint64_t*>(words + lo) = w;
    }
    const int lo = base + ((e - base) & ~7);  // the word being filled
    if (base == 0 && lead > 0 && e >= 8) store_part(word(0), 0);
    if (x1 == pixels) {
      if (lo < e) store_part(word(lo), lo);
    } else {
      asm volatile("st.shared.u64 [%0], %1;" ::"r"(stage), "l"(word(lo)));
      base = lo;
    }
  }
};

// Lane 0's pixels above for kTake steps, the ring's pixels first + i for
// i < kTake: every lane loads the slots (one broadcast each) and the warp
// waits, as one, for those of the row (i < want) to hold their index.
template <int BPP, bool kGlobal>
__device__ __forceinline__ void take(const Rings<BPP, kGlobal>& ring, int slots, uint32_t first, int want,
                                     Pixel<BPP> (&above)[kTake]) {
  Slot v[kTake];
#pragma unroll
  for (int i = 0; i < kTake; i++) v[i] = ring.load(slots, first + i);
  for (;;) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < kTake; i++) ok &= i >= want || holds(v[i], first + i);
    if (ok) break;
#pragma unroll
    for (int i = 0; i < kTake; i++)
      if (i < want && !holds(v[i], first + i)) v[i] = ring.load(slots, first + i);
  }
#pragma unroll
  for (int i = 0; i < kTake; i++) above[i] = slot_pixel<BPP>(v[i]);
}

// rows, out: [B, H, RB]; filters: [B, H]. Grid: B x ctas CTAs, in clusters
// of ctas; warps of 32 lanes a CTA. ring_slots: a power of 2 (at least
// kMinRing). gring: with kGlobal, B x ctas x warps ring blocks of
// ring_slots x slot_bytes + 16 bytes; else null, the rings in shared memory
// after the lanes'. A ring block is a warp's input ring, then the count of
// what the next warp has read of the ring this warp fills.
template <int BPP, bool kGlobal>
__global__ void __launch_bounds__(kMaxWarps * 32)
    unfilter_kernel(const uint8_t* __restrict__ rows, const int32_t* __restrict__ filters, int64_t h, int rb,
                    int ctas, int ring_slots, uint8_t* gring, uint8_t* out) {
  using P = Pixel<BPP>;
  extern __shared__ __align__(16) uint8_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t image = blockIdx.x / ctas;
  const int rank = static_cast<int>(blockIdx.x % ctas);
  const int total = ctas * warps;       // the image's warps
  const int q = rank * warps + warp;    // this warp's place among them
  const int blk = ring_slots * slot_bytes<BPP>() + 16;
  uint8_t* mine = smem + threadIdx.x * lane_bytes<BPP>();
  uint8_t* staged = smem + blockDim.x * lane_bytes<BPP>();  // the lanes' output stages
  uint8_t* rings = kGlobal ? gring + image * total * static_cast<int64_t>(blk)
                           : staged + blockDim.x * stage_bytes<BPP>();

  // the CTA's own ring blocks: no slot holds a pixel, nothing read
  for (int w = 0; w < warps; w++) {
    uint8_t* b0 = rings + static_cast<int64_t>(kGlobal ? rank * warps + w : w) * blk;
    for (int i = threadIdx.x; i < ring_slots * slot_bytes<BPP>() / 8; i += blockDim.x)
      reinterpret_cast<uint64_t*>(b0)[i] = 0xFFFFFFFF00000000ull;
    if (threadIdx.x == 0) *reinterpret_cast<uint32_t*>(b0 + blk - 16) = 0;
  }
  if (ctas > 1)
    cluster.sync();
  else
    __syncthreads();

  // The ring block of the image's warp k, and the CTA that holds it.
  const auto block = [&](int k) -> uint8_t* {
    return rings + static_cast<int64_t>(kGlobal ? k : k % warps) * blk;
  };
  const int next = q + 1 == total ? 0 : q + 1, prev = q == 0 ? total - 1 : q - 1;
  Rings<BPP, kGlobal> ring;
  if constexpr (kGlobal) {
    ring.in = block(q);
    ring.room = block(q) + blk - 16;
    ring.out = block(next);
    ring.count = block(prev) + blk - 16;
  } else {
    ring.in = ring.local(block(q));
    ring.room = ring.local(block(q) + blk - 16);
    ring.out = ring.remote(block(next), next / warps);
    ring.count = ring.remote(block(prev) + blk - 16, prev / warps);
  }

  const int pixels = (rb + BPP - 1) / BPP;
  const int64_t groups = (h + 31) / 32;
  RowIn<BPP> in;
  in.ring = mine;
  RowOut<BPP> wr;
  wr.stage = static_cast<uint32_t>(__cvta_generic_to_shared(staged + threadIdx.x * stage_bytes<BPP>()));
  int k = 0;  // the groups this warp has taken
  for (int64_t g = q; g < groups; g += total, k++) {
    const int64_t y = 32 * g + lane;
    const bool row_ok = y < h;
    const int n = static_cast<int>(h - 32 * g < 32 ? h - 32 * g : 32);
    const bool reads = g > 0, writes = g + 1 < groups;
    const uint32_t in_base = static_cast<uint32_t>(q == 0 ? k - 1 : k) * static_cast<uint32_t>(pixels);
    const uint32_t out_base = static_cast<uint32_t>(k) * static_cast<uint32_t>(pixels);
    const int64_t row = (image * h + (row_ok ? y : 0)) * rb;
    const int f = row_ok ? filters[image * h + y] : 0;
    const Masks m = {f == 1 ? ~0u : 0u, f == 2 ? ~0u : 0u, f == 3 ? ~0u : 0u, f == 4 ? ~0u : 0u};
    asm volatile("cp.async.wait_all;\n" ::: "memory");  // the group before may still fill the ring
    const uintptr_t src = reinterpret_cast<uintptr_t>(rows + row);
    in.words = reinterpret_cast<const uint8_t*>(src & ~static_cast<uintptr_t>(15));
    in.lead = static_cast<int>(src & 15);
    in.count = row_ok ? (in.lead + rb + 15) >> 4 : 0;
    in.sent = 0;
    const uintptr_t dst = reinterpret_cast<uintptr_t>(out + row);
    wr.words = reinterpret_cast<uint8_t*>(dst & ~static_cast<uintptr_t>(7));
    wr.lead = static_cast<int>(dst & 7);
    wr.end = wr.lead + rb;
    wr.base = 0;
    for (int c = 0; c < kAhead; c++) in.send_through((c + 1) * kChunk, lane);
    P own = 0, up = 0, recv = 0;  // a, the last b (the next c), the lane above's last output
    int qin = in.lead - lane * BPP;  // step s's pixel's bytes: + s * BPP
    const int steps = pixels + n - 1;
    for (int s0 = 0; s0 < steps; s0 += kChunk) {
      in.send_through(s0 + (kAhead + 1) * kChunk, lane);
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead) : "memory");
      if (reads && lane == 0) ring.publish(in_base + static_cast<uint32_t>(s0 < pixels ? s0 : pixels));
      const int need = (s0 - 31 + kChunk < pixels ? s0 - 31 + kChunk : pixels) - ring_slots;
      if (writes && need > 0) {  // room for lane 31's pixels of this chunk: the reader is past need
        while (static_cast<int>(ring.read_room() - (out_base + static_cast<uint32_t>(need))) < 0) {
        }
      }
      P raws[kChunk];  // the chunk's pixels, loaded at once (past the row: garbage, unused)
#pragma unroll
      for (int i = 0; i < kChunk; i++) raws[i] = in.pixel(qin + i * BPP);
      const uint32_t stage = wr.at(s0 - lane);
#pragma unroll
      for (int t0 = 0; t0 < kChunk; t0 += kTake) {
        P above[kTake] = {};  // lane 0's pixels above (0 above the image)
        if (reads) take(ring, ring_slots, in_base + static_cast<uint32_t>(s0 + t0), pixels - s0 - t0, above);
#pragma unroll
        for (int j = 0; j < kTake; j++) {
          const int i = t0 + j;
          const int x = s0 + i - lane;
          const bool on = row_ok && static_cast<unsigned>(x) < static_cast<unsigned>(pixels);
          const P b = lane == 0 ? above[j] : recv;
          const P raw = raws[i];
          P w;  // past the row: garbage, which only lanes past their rows receive
          if constexpr (BPP <= 4)
            w = step4(m, raw, own, b, up);
          else
            w = step8(m, raw, own, b, up);
          if constexpr (BPP <= 4) {  // first: the next step waits on it, the rest does not
            recv = __shfl_up_sync(0xFFFFFFFFu, w, 1);
          } else {
            const uint32_t lo = __shfl_up_sync(0xFFFFFFFFu, static_cast<uint32_t>(w), 1);
            const uint32_t hi = __shfl_up_sync(0xFFFFFFFFu, static_cast<uint32_t>(w >> 32), 1);
            recv = static_cast<uint64_t>(hi) << 32 | lo;
          }
          const P v = on ? w : 0;
          if (on && lane == 31 && writes) ring.put(ring_slots, out_base + x, v);
          own = v;
          up = on ? b : 0;
          if (on) wr.put(stage + i * BPP, v);
        }
      }
      if (row_ok) wr.flush(s0 - lane, pixels);
      qin += kChunk * BPP;
    }
    if (reads && lane == 0) ring.publish(in_base + static_cast<uint32_t>(pixels));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  if (ctas > 1) cluster.sync();  // no CTA leaves while another may still write to its rings or counts
}

// The launch's dynamic shared memory.
template <int BPP>
int64_t unfilter_smem(int warps, int ring_slots, bool global) {
  return static_cast<int64_t>(warps) * 32 * (lane_bytes<BPP>() + stage_bytes<BPP>()) +
         (global ? 0 : static_cast<int64_t>(warps) * (static_cast<int64_t>(ring_slots) * slot_bytes<BPP>() + 16));
}

template <int BPP>
cudaError_t launch_unfilter(const uint8_t* rows, const int32_t* filters, int64_t b, int64_t h, int rb, int ctas,
                            int warps, int ring_slots, uint8_t* ring, uint8_t* out, cudaStream_t stream) {
  const int64_t smem = unfilter_smem<BPP>(warps, ring_slots, ring != nullptr);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto* kernel = ring ? &unfilter_kernel<BPP, true> : &unfilter_kernel<BPP, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(b * ctas));
  cfg.blockDim = dim3(static_cast<unsigned>(32 * warps));
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;  // a cluster launch also for one CTA: the rings' shared::cluster accesses
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, rows, filters, h, rb, ctas, ring_slots, ring, out);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace pixo

extern "C" {

// rows: [b, h, rb] uint8 on the device, contiguous, at any byte offset;
// filters: [b, h] int32; out: [b, h, rb] uint8, not overlapping rows. One
// launch of b clusters of ctas CTAs (1 to 8) of warps warps (1 to 16);
// ring_slots a power of 2 of at least 64; ring: null for the rings in
// shared memory, else [b, ctas x warps] ring blocks of ring_slots x (8 for
// bpp up to 4, else 16) + 16 bytes of scratch on the device. bpp 1 to 8;
// rb at most 2^31 - 2049 (a step's byte positions are int). Where an image's groups of 32 rows wrap round its
// warps, the rings must hold a row, ctas x warps x (ring_slots - 8) >=
// ceil(rb / bpp), or the warps could deadlock: refused
// (ops/png_unfilter.py::unfilter_plan).
int pixo_unfilter(const uint8_t* rows, const int32_t* filters, int64_t b, int64_t h, int64_t rb, int bpp,
                  int32_t ctas, int32_t warps, int32_t ring_slots, void* ring, uint8_t* out, void* stream) {
  using namespace pixo;
  if (b < 1 || h < 1 || rb < 1 || rb > 0x7fffffffll - 2048 || bpp < 1 || bpp > 8 || rows == nullptr ||
      filters == nullptr || out == nullptr || ctas < 1 || ctas > kMaxCtas || warps < 1 || warps > kMaxWarps ||
      b * ctas > 0x7fffffffll || ring_slots < kMinRing || (ring_slots & (ring_slots - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = (h + 31) / 32, total = static_cast<int64_t>(ctas) * warps;
  const int64_t pixels = (rb + bpp - 1) / bpp;
  if (groups > total && total * (ring_slots - kChunk) < pixels) return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>(rb);
  auto* g = static_cast<uint8_t*>(ring);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bpp) {
    case 1: return static_cast<int>(launch_unfilter<1>(rows, filters, b, h, w, ctas, warps, ring_slots, g, out, s));
    case 2: return static_cast<int>(launch_unfilter<2>(rows, filters, b, h, w, ctas, warps, ring_slots, g, out, s));
    case 3: return static_cast<int>(launch_unfilter<3>(rows, filters, b, h, w, ctas, warps, ring_slots, g, out, s));
    case 4: return static_cast<int>(launch_unfilter<4>(rows, filters, b, h, w, ctas, warps, ring_slots, g, out, s));
    case 5: return static_cast<int>(launch_unfilter<5>(rows, filters, b, h, w, ctas, warps, ring_slots, g, out, s));
    case 6: return static_cast<int>(launch_unfilter<6>(rows, filters, b, h, w, ctas, warps, ring_slots, g, out, s));
    case 7: return static_cast<int>(launch_unfilter<7>(rows, filters, b, h, w, ctas, warps, ring_slots, g, out, s));
    default: return static_cast<int>(launch_unfilter<8>(rows, filters, b, h, w, ctas, warps, ring_slots, g, out, s));
  }
}

}  // extern "C"
