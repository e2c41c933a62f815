// pixo_tpu native host stage: the sequential byte/bit-stream work that the
// TPU device pipeline cannot express efficiently.
//
// Components (architectural parity with the reference's host-side stack):
//   - JPEG entropy packing + symbol counting (consumes device-emitted
//     zigzag coefficient streams; mirrors pixo src/jpeg/huffman.rs:423-481
//     and the restart logic of src/jpeg/mod.rs:1408-1445).
//   - From-scratch DEFLATE: hash-chain LZ77 with lazy matching, dynamic /
//     fixed / stored block selection, code-length RLE, zlib wrapping
//     (capability parity with pixo src/compress/{lz77,deflate,huffman}.rs).
//   - From-scratch INFLATE (stored/fixed/dynamic; capability parity with
//     pixo src/decode/inflate.rs).
//   - CRC-32 (slicing-by-8) and Adler-32 (NMAX batching), parity with
//     pixo src/compress/{crc32,adler32}.rs.
//
// Exposed as a C ABI consumed through ctypes (pixo_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <memory>
#include <vector>
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <ctime>
#if defined(__AVX2__)
#include <immintrin.h>
#endif

#define EXPORT extern "C" __attribute__((visibility("default")))

// ============================== checksums ==================================

static uint32_t crc_table[8][256];
static bool crc_init_done = false;

static void crc_init() {
    if (crc_init_done) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++) c = (c >> 1) ^ (0xEDB88320u & (-(c & 1)));
        crc_table[0][i] = c;
    }
    for (int t = 1; t < 8; t++)
        for (uint32_t i = 0; i < 256; i++)
            crc_table[t][i] = crc_table[0][crc_table[t - 1][i] & 0xFF] ^ (crc_table[t - 1][i] >> 8);
    crc_init_done = true;
}

EXPORT uint32_t pixo_crc32(const uint8_t* data, int64_t len, uint32_t crc) {
    crc_init();
    uint32_t c = ~crc;
    int64_t i = 0;
    for (; i + 8 <= len; i += 8) {
        c ^= (uint32_t)data[i] | ((uint32_t)data[i + 1] << 8) |
             ((uint32_t)data[i + 2] << 16) | ((uint32_t)data[i + 3] << 24);
        c = crc_table[7][c & 0xFF] ^ crc_table[6][(c >> 8) & 0xFF] ^
            crc_table[5][(c >> 16) & 0xFF] ^ crc_table[4][c >> 24] ^
            crc_table[3][data[i + 4]] ^ crc_table[2][data[i + 5]] ^
            crc_table[1][data[i + 6]] ^ crc_table[0][data[i + 7]];
    }
    for (; i < len; i++) c = crc_table[0][(c ^ data[i]) & 0xFF] ^ (c >> 8);
    return ~c;
}

EXPORT uint32_t pixo_adler32(const uint8_t* data, int64_t len, uint32_t adler) {
    const uint32_t MOD = 65521, NMAX = 5552;
#if defined(__AVX2__)
    // 32 bytes/iteration: vs1 accumulates byte sums (SAD vs zero, u64
    // lanes), vs2a the 32*a carry (u64 lanes), vs2b the positional
    // weights (maddubs with [32..1], u32 lanes). Window of 128
    // iterations (4 KiB) keeps every lane far from overflow; scalars
    // fold and reduce mod 65521 once per window.
    uint64_t a = adler & 0xFFFF, b = (adler >> 16) & 0xFFFF;
    int64_t i = 0;
    const __m256i vzero = _mm256_setzero_si256();
    const __m256i vwts = _mm256_setr_epi8(
        32, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
        16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 3, 2, 1);
    const __m256i vones16 = _mm256_set1_epi16(1);
    while (i + 32 <= len) {
        int64_t T = std::min<int64_t>((len - i) / 32, 128);
        __m256i vs1 = vzero, vs2a = vzero, vs2b = vzero;
        for (int64_t t = 0; t < T; t++, i += 32) {
            __m256i d = _mm256_loadu_si256((const __m256i*)(data + i));
            vs2a = _mm256_add_epi64(vs2a, _mm256_slli_epi64(vs1, 5));
            vs1 = _mm256_add_epi64(vs1, _mm256_sad_epu8(d, vzero));
            vs2b = _mm256_add_epi32(
                vs2b, _mm256_madd_epi16(_mm256_maddubs_epi16(d, vwts),
                                        vones16));
        }
        uint64_t l1[4], l2a[4];
        uint32_t l2b[8];
        _mm256_storeu_si256((__m256i*)l1, vs1);
        _mm256_storeu_si256((__m256i*)l2a, vs2a);
        _mm256_storeu_si256((__m256i*)l2b, vs2b);
        uint64_t S = l1[0] + l1[1] + l1[2] + l1[3];
        uint64_t W = l2a[0] + l2a[1] + l2a[2] + l2a[3];
        for (int k = 0; k < 8; k++) W += l2b[k];
        b = (b + (uint64_t)(32 * T) * a + W) % MOD;
        a = (a + S) % MOD;
    }
    uint32_t a32 = (uint32_t)a, b32 = (uint32_t)b;
    for (; i < len; i++) { a32 += data[i]; b32 += a32; }
    a32 %= MOD; b32 %= MOD;
    return (b32 << 16) | a32;
#else
    uint32_t a = adler & 0xFFFF, b = (adler >> 16) & 0xFFFF;
    int64_t i = 0;
    while (i < len) {
        int64_t n = std::min<int64_t>(NMAX, len - i);
        for (int64_t j = 0; j < n; j++) { a += data[i + j]; b += a; }
        a %= MOD; b %= MOD;
        i += n;
    }
    return (b << 16) | a;
#endif
}

// ============================ JPEG packing ==================================

namespace jpeg {

struct MsbWriter {
    uint8_t* out;
    int64_t cap, pos;
    uint64_t acc;      // bits pending, left-aligned within the low `nbits`
    int nbits;
    bool overflow;

    MsbWriter(uint8_t* o, int64_t c) : out(o), cap(c), pos(0), acc(0), nbits(0), overflow(false) {}

    inline void put_byte(uint8_t b) {
        if (pos >= cap) { overflow = true; return; }
        out[pos++] = b;
        if (b == 0xFF) {
            if (pos >= cap) { overflow = true; return; }
            out[pos++] = 0x00;
        }
    }

    inline void write(uint32_t value, int bits) {
        // accumulate MSB-first; up to 31 bits stay buffered between calls
        // (bits above `nbits` in acc are stale garbage, never extracted),
        // so the flush below runs only once per ~3 symbols instead of on
        // every call, and always moves a whole 4-byte unit
        acc = (acc << bits) | (value & ((bits == 32) ? 0xFFFFFFFFu : ((1u << bits) - 1)));
        nbits += bits;
        if (nbits >= 32) {
            // flush 4 bytes at once; 0xFF detection via the classic
            // haszero((w ^ ~0xFF...) ...) bit trick
            uint32_t w = (uint32_t)(acc >> (nbits - 32));
            uint32_t t = w ^ 0xFFFFFFFFu;  // FF bytes become 00
            if (((t - 0x01010101u) & ~t & 0x80808080u) == 0) {
                if (pos + 4 > cap) { overflow = true; return; }
                out[pos] = (uint8_t)(w >> 24);
                out[pos + 1] = (uint8_t)(w >> 16);
                out[pos + 2] = (uint8_t)(w >> 8);
                out[pos + 3] = (uint8_t)w;
                pos += 4;
            } else {
                put_byte((uint8_t)(w >> 24));
                put_byte((uint8_t)(w >> 16));
                put_byte((uint8_t)(w >> 8));
                put_byte((uint8_t)w);
            }
            nbits -= 32;
        }
    }

    inline void flush_pad_ones() {
        while (nbits >= 8) {
            put_byte((uint8_t)(acc >> (nbits - 8)));
            nbits -= 8;
        }
        if (nbits > 0) {
            int pad = 8 - nbits;
            uint8_t b = (uint8_t)(((acc << pad) | ((1u << pad) - 1)) & 0xFF);
            if (pos >= cap) { overflow = true; return; }
            out[pos++] = b;
            if (b == 0xFF) {
                if (pos >= cap) { overflow = true; return; }
                out[pos++] = 0x00;
            }
        }
        acc = 0; nbits = 0;
    }

    inline void raw_bytes(const uint8_t* b, int n) {
        if (pos + n > cap) { overflow = true; return; }
        memcpy(out + pos, b, n);
        pos += n;
    }
};

static inline int category(int v) {
    unsigned a = (v < 0) ? (unsigned)(-v) : (unsigned)v;
    return a == 0 ? 0 : (32 - __builtin_clz(a));
}

}  // namespace jpeg

namespace jpeg {

// Build a 64-bit nonzero bitmap for positions 1..63 of a block.
static inline uint64_t nonzero_mask_ac(const int16_t* block) {
#if defined(__AVX2__)
    uint64_t mask = 0;
    const __m256i zero = _mm256_setzero_si256();
    for (int g = 0; g < 4; g++) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(block + g * 16));
        __m256i eq = _mm256_cmpeq_epi16(v, zero);
        // per-i16 nonzero -> 16-bit mask via movemask on packed bytes
        uint32_t bytes = (uint32_t)_mm256_movemask_epi8(eq);
        // every i16 lane contributes two byte-mask bits; both set iff zero
        uint32_t both = bytes & (bytes >> 1);  // pair-AND at even bit positions
#if defined(__BMI2__)
        uint32_t zero16 = _pext_u32(both, 0x55555555u);
#else
        uint32_t zero16 = 0;
        for (int b = 0; b < 16; b++) zero16 |= ((both >> (2 * b)) & 1u) << b;
#endif
        mask |= (uint64_t)(~zero16 & 0xFFFF) << (g * 16);
    }
    return mask & ~1ull;  // drop DC bit
#else
    uint64_t mask = 0;
    for (int i = 1; i < 64; i++)
        if (block[i]) mask |= 1ull << i;
    return mask;
#endif
}

}  // namespace jpeg

namespace jpeg {
// One baseline block: DC diff + AC run-length coding against the given
// component tables. Shared verbatim by jpeg_pack_scan and the fused
// coefficients+pack path (jpeg_encode_scan_fused) so both emit
// byte-identical streams.
static inline void pack_one_block(
    MsbWriter& w, const int16_t* block,
    const uint16_t* dcc, const uint8_t* dcl,
    const uint16_t* acc, const uint8_t* acl, int& prev) {
    int dc = block[0];
    int diff = dc - prev;
    prev = dc;
    int cat = category(diff);
    // fuse huffman code + value bits into a single accumulator push
    {
        int bits = (diff < 0) ? diff - 1 : diff;
        uint32_t val = (uint32_t)bits & ((cat == 0) ? 0 : ((1u << cat) - 1));
        w.write(((uint32_t)dcc[cat] << cat) | val, dcl[cat] + cat);
    }

    uint64_t mask = nonzero_mask_ac(block);
    int prev_pos = 0;
    while (mask) {
        int pos = __builtin_ctzll(mask);
        mask &= mask - 1;
        int zero_run = pos - prev_pos - 1;
        while (zero_run >= 16) {
            w.write(acc[0xF0], acl[0xF0]);
            zero_run -= 16;
        }
        int ac = block[pos];
        int ac_cat = category(ac);
        int rs = (zero_run << 4) | ac_cat;
        int bits = (ac < 0) ? ac - 1 : ac;
        uint32_t val = (uint32_t)bits & ((1u << ac_cat) - 1);
        w.write(((uint32_t)acc[rs] << ac_cat) | val, acl[rs] + ac_cat);
        prev_pos = pos;
    }
    if (prev_pos != 63) w.write(acc[0x00], acl[0x00]);
}
}  // namespace jpeg

EXPORT int64_t jpeg_pack_scan(
    const int16_t* zz, int64_t nblocks,
    const uint8_t* pattern, int32_t bpm,
    const uint16_t* dc_lum_c, const uint8_t* dc_lum_l,
    const uint16_t* dc_chrom_c, const uint8_t* dc_chrom_l,
    const uint16_t* ac_lum_c, const uint8_t* ac_lum_l,
    const uint16_t* ac_chrom_c, const uint8_t* ac_chrom_l,
    int32_t restart_interval,
    uint8_t* out, int64_t out_cap) {
    jpeg::MsbWriter w(out, out_cap);
    int prev_dc[3] = {0, 0, 0};
    int rst_idx = 0;
    int64_t total_mcus = nblocks / bpm;

    const uint16_t* dc_codes[3] = {dc_lum_c, dc_chrom_c, dc_chrom_c};
    const uint8_t* dc_lens[3] = {dc_lum_l, dc_chrom_l, dc_chrom_l};
    const uint16_t* ac_codes[3] = {ac_lum_c, ac_chrom_c, ac_chrom_c};
    const uint8_t* ac_lens[3] = {ac_lum_l, ac_chrom_l, ac_chrom_l};

    for (int64_t mcu = 0; mcu < total_mcus; mcu++) {
        const int16_t* base = zz + mcu * bpm * 64;
        for (int k = 0; k < bpm; k++) {
            int comp = pattern[k];
            jpeg::pack_one_block(w, base + (int64_t)k * 64,
                                 dc_codes[comp], dc_lens[comp],
                                 ac_codes[comp], ac_lens[comp],
                                 prev_dc[comp]);
        }
        if (restart_interval > 0) {
            int64_t mcu_count = mcu + 1;
            if (mcu_count % restart_interval == 0 && mcu_count < total_mcus) {
                w.flush_pad_ones();
                uint8_t rst[2] = {0xFF, (uint8_t)(0xD0 + (rst_idx & 7))};
                w.raw_bytes(rst, 2);
                rst_idx = (rst_idx + 1) & 7;
                prev_dc[0] = prev_dc[1] = prev_dc[2] = 0;
            }
        }
    }
    w.flush_pad_ones();
    return w.overflow ? -1 : w.pos;
}

// Sparse variant: consumes device-compacted streams (dc per block, nonzero
// count per block, concatenated (position, value) pairs) instead of dense
// [N,64] blocks. Byte-identical output to jpeg_pack_scan; the host touches
// ~3 bytes per nonzero coefficient instead of 128 bytes per block.
// Shared body for the two compacted-stream layouts: `cap == 0` walks
// poss/vals sequentially (flat globally-compacted stream); `cap > 0`
// reads block i's entries at row i*cap (padded per-block top-k layout
// from the device — no host-side flatten pass needed).
static int64_t jpeg_pack_scan_sparse_impl(
    const int16_t* dc_arr, const uint8_t* counts,
    const uint8_t* poss, const int16_t* vals,
    int64_t nblocks, int32_t cap,
    const uint8_t* pattern, int32_t bpm,
    const uint16_t* dc_lum_c, const uint8_t* dc_lum_l,
    const uint16_t* dc_chrom_c, const uint8_t* dc_chrom_l,
    const uint16_t* ac_lum_c, const uint8_t* ac_lum_l,
    const uint16_t* ac_chrom_c, const uint8_t* ac_chrom_l,
    int32_t restart_interval,
    uint8_t* out, int64_t out_cap) {
    jpeg::MsbWriter w(out, out_cap);
    int prev_dc[3] = {0, 0, 0};
    int rst_idx = 0;
    int64_t total_mcus = nblocks / bpm;

    const uint16_t* dc_codes[3] = {dc_lum_c, dc_chrom_c, dc_chrom_c};
    const uint8_t* dc_lens[3] = {dc_lum_l, dc_chrom_l, dc_chrom_l};
    const uint16_t* ac_codes[3] = {ac_lum_c, ac_chrom_c, ac_chrom_c};
    const uint8_t* ac_lens[3] = {ac_lum_l, ac_chrom_l, ac_chrom_l};

    int64_t cursor = 0;  // index into poss/vals
    for (int64_t mcu = 0; mcu < total_mcus; mcu++) {
        for (int k = 0; k < bpm; k++) {
            int64_t blk = mcu * bpm + k;
            int comp = pattern[k];
            const uint16_t* dcc = dc_codes[comp];
            const uint8_t* dcl = dc_lens[comp];
            const uint16_t* acc = ac_codes[comp];
            const uint8_t* acl = ac_lens[comp];

            int dc = dc_arr[blk];
            int diff = dc - prev_dc[comp];
            prev_dc[comp] = dc;
            int cat = jpeg::category(diff);
            {
                int bits = (diff < 0) ? diff - 1 : diff;
                uint32_t val = (uint32_t)bits & ((cat == 0) ? 0 : ((1u << cat) - 1));
                w.write(((uint32_t)dcc[cat] << cat) | val, dcl[cat] + cat);
            }

            int c = counts[blk];
            int prev_pos = 0;
            int64_t base = (cap > 0) ? blk * (int64_t)cap : cursor;
            if (cap <= 0) cursor += c;
            for (int j = 0; j < c; j++) {
                int pos = poss[base + j];
                int ac = vals[base + j];
                int zero_run = pos - prev_pos - 1;
                while (zero_run >= 16) {
                    w.write(acc[0xF0], acl[0xF0]);
                    zero_run -= 16;
                }
                int ac_cat = jpeg::category(ac);
                int rs = (zero_run << 4) | ac_cat;
                int bits = (ac < 0) ? ac - 1 : ac;
                uint32_t val = (uint32_t)bits & ((1u << ac_cat) - 1);
                w.write(((uint32_t)acc[rs] << ac_cat) | val, acl[rs] + ac_cat);
                prev_pos = pos;
            }
            if (prev_pos != 63) w.write(acc[0x00], acl[0x00]);
        }
        if (restart_interval > 0) {
            int64_t mcu_count = mcu + 1;
            if (mcu_count % restart_interval == 0 && mcu_count < total_mcus) {
                w.flush_pad_ones();
                uint8_t rst[2] = {0xFF, (uint8_t)(0xD0 + (rst_idx & 7))};
                w.raw_bytes(rst, 2);
                rst_idx = (rst_idx + 1) & 7;
                prev_dc[0] = prev_dc[1] = prev_dc[2] = 0;
            }
        }
    }
    w.flush_pad_ones();
    return w.overflow ? -1 : w.pos;
}

EXPORT int64_t jpeg_pack_scan_sparse(
    const int16_t* dc_arr, const uint8_t* counts,
    const uint8_t* poss, const int16_t* vals,
    int64_t nblocks,
    const uint8_t* pattern, int32_t bpm,
    const uint16_t* dc_lum_c, const uint8_t* dc_lum_l,
    const uint16_t* dc_chrom_c, const uint8_t* dc_chrom_l,
    const uint16_t* ac_lum_c, const uint8_t* ac_lum_l,
    const uint16_t* ac_chrom_c, const uint8_t* ac_chrom_l,
    int32_t restart_interval,
    uint8_t* out, int64_t out_cap) {
    return jpeg_pack_scan_sparse_impl(
        dc_arr, counts, poss, vals, nblocks, 0, pattern, bpm,
        dc_lum_c, dc_lum_l, dc_chrom_c, dc_chrom_l,
        ac_lum_c, ac_lum_l, ac_chrom_c, ac_chrom_l,
        restart_interval, out, out_cap);
}

// Padded per-block layout (ops/sparse_pack.py sparsify_blocks_padded):
// block i's nonzero (pos, val) pairs live at poss/vals[i*cap .. i*cap+counts[i]).
EXPORT int64_t jpeg_pack_scan_padded(
    const int16_t* dc_arr, const uint8_t* counts,
    const uint8_t* poss, const int16_t* vals,
    int64_t nblocks, int32_t cap,
    const uint8_t* pattern, int32_t bpm,
    const uint16_t* dc_lum_c, const uint8_t* dc_lum_l,
    const uint16_t* dc_chrom_c, const uint8_t* dc_chrom_l,
    const uint16_t* ac_lum_c, const uint8_t* ac_lum_l,
    const uint16_t* ac_chrom_c, const uint8_t* ac_chrom_l,
    int32_t restart_interval,
    uint8_t* out, int64_t out_cap) {
    return jpeg_pack_scan_sparse_impl(
        dc_arr, counts, poss, vals, nblocks, cap, pattern, bpm,
        dc_lum_c, dc_lum_l, dc_chrom_c, dc_chrom_l,
        ac_lum_c, ac_lum_l, ac_chrom_c, ac_chrom_l,
        restart_interval, out, out_cap);
}

// Threaded batch variant: packs B independent images concurrently (the
// native analog of the reference's rayon pool; each stream is written to
// its own slice of `out` and lengths are returned per image).
#include <thread>

EXPORT int32_t jpeg_pack_scan_batch(
    const int16_t* zz, int32_t batch, int64_t blocks_per_image,
    const uint8_t* pattern, int32_t bpm,
    const uint16_t* dc_lum_c, const uint8_t* dc_lum_l,
    const uint16_t* dc_chrom_c, const uint8_t* dc_chrom_l,
    const uint16_t* ac_lum_c, const uint8_t* ac_lum_l,
    const uint16_t* ac_chrom_c, const uint8_t* ac_chrom_l,
    int32_t restart_interval,
    uint8_t* out, int64_t per_image_cap,
    int64_t* out_lens,
    int32_t nthreads) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > batch) nthreads = batch;
    std::vector<std::thread> threads;
    auto work = [&](int t) {
        for (int i = t; i < batch; i += nthreads) {
            out_lens[i] = jpeg_pack_scan(
                zz + (int64_t)i * blocks_per_image * 64, blocks_per_image,
                pattern, bpm,
                dc_lum_c, dc_lum_l, dc_chrom_c, dc_chrom_l,
                ac_lum_c, ac_lum_l, ac_chrom_c, ac_chrom_l,
                restart_interval,
                out + (int64_t)i * per_image_cap, per_image_cap);
        }
    };
    if (nthreads == 1) {
        work(0);
    } else {
        for (int t = 0; t < nthreads; t++) threads.emplace_back(work, t);
        for (auto& th : threads) th.join();
    }
    for (int i = 0; i < batch; i++)
        if (out_lens[i] < 0) return -1;
    return 0;
}

EXPORT int32_t jpeg_count_symbols(
    const int16_t* zz, int64_t nblocks,
    const uint8_t* pattern, int32_t bpm,
    int32_t restart_interval,
    int64_t* dc_lum, int64_t* dc_chrom, int64_t* ac_lum, int64_t* ac_chrom) {
    int prev_dc[3] = {0, 0, 0};
    int64_t total_mcus = nblocks / bpm;
    int64_t* dc_counts[3] = {dc_lum, dc_chrom, dc_chrom};
    int64_t* ac_counts[3] = {ac_lum, ac_chrom, ac_chrom};

    for (int64_t mcu = 0; mcu < total_mcus; mcu++) {
        const int16_t* base = zz + mcu * bpm * 64;
        for (int k = 0; k < bpm; k++) {
            int comp = pattern[k];
            const int16_t* block = base + (int64_t)k * 64;
            int dc = block[0];
            int diff = dc - prev_dc[comp];
            prev_dc[comp] = dc;
            dc_counts[comp][jpeg::category(diff)]++;
            // same SIMD nonzero-bitmap walk as pack_one_block: the
            // per-coefficient branchy loop made counting cost MORE than
            // packing the same blocks (5 ns/coeff of zero-branch
            // mispredicts on sparse content)
            uint64_t mask = jpeg::nonzero_mask_ac(block);
            int prev_pos = 0;
            while (mask) {
                int pos = __builtin_ctzll(mask);
                mask &= mask - 1;
                int zero_run = pos - prev_pos - 1;
                ac_counts[comp][0xF0] += zero_run >> 4;
                ac_counts[comp][((zero_run & 15) << 4) |
                                jpeg::category(block[pos])]++;
                prev_pos = pos;
            }
            if (prev_pos != 63) ac_counts[comp][0x00]++;
        }
        if (restart_interval > 0) {
            int64_t mcu_count = mcu + 1;
            if (mcu_count % restart_interval == 0 && mcu_count < total_mcus)
                prev_dc[0] = prev_dc[1] = prev_dc[2] = 0;
        }
    }
    return 0;
}

// ==================== progressive scan entropy coding =======================
// One single-component scan per call (all scripts use single-component
// scans). Mirrors pixo_tpu/jpeg/progressive.py's sinks exactly (tests
// assert byte equality): DC first/refine, AC first with EOB runs, AC
// refine with correction bits; EOB runs fall back to repeated single
// EOBs when the table lacks EOBn codes.

namespace jprog {

// libjpeg's MAX_CORR_BITS: cap on buffered refinement correction bits
// before the EOB run is force-flushed.
constexpr int kMaxCorrBits = 1000 - 63;

struct Ctx {
    jpeg::MsbWriter* w;
    const uint16_t* codes;
    const uint8_t* lens;
    bool eobn_ok;

    inline void sym(int s) { w->write(codes[s], lens[s]); }
    inline void bits(uint32_t v, int n) { if (n) w->write(v, n); }
};

// EOB-run accumulator (T.81 G.1.2.3 / libjpeg jcphuff emit_eobrun): the
// EOBn symbol goes FIRST, then the run's buffered refinement correction
// bits in block order. In the no-EOBn std-table fallback, refinement
// blocks are flushed eagerly per block (see the call sites), so pending
// is empty here and first-scan runs become N single EOBs.
struct RunState {
    int eob_run = 0;
    uint8_t pending[kMaxCorrBits + 64];
    int npending = 0;

    inline void flush(Ctx& c) {
        if (!eob_run) return;
        if (!c.eobn_ok) {
            for (int i = 0; i < eob_run; i++) c.sym(0x00);
        } else {
            int nbits = 0, t = eob_run;
            while (t > 1) { t >>= 1; nbits++; }
            c.sym(nbits << 4);
            if (nbits > 0) c.bits((uint32_t)(eob_run - (1 << nbits)), nbits);
            for (int i = 0; i < npending; i++) c.bits(pending[i], 1);
        }
        eob_run = 0;
        npending = 0;
    }
};

static inline int cat16(int v) {
    unsigned a = v < 0 ? (unsigned)(-v) : (unsigned)v;
    return a == 0 ? 0 : 32 - __builtin_clz(a);
}

// AC point transform: magnitude shift with truncation toward zero
// (T.81 G.1.2.2); an arithmetic shift would round negatives away from
// zero and desync the later refinement scans.
static inline int pt_ac(int v, int al) {
    return v < 0 ? -((-v) >> al) : (v >> al);
}

}  // namespace jprog

EXPORT int64_t jpeg_encode_progressive_scan(
    const int16_t* blocks, int64_t nblocks,
    int32_t ss, int32_t se, int32_t ah, int32_t al,
    const uint16_t* dc_codes, const uint8_t* dc_lens,
    const uint16_t* ac_codes, const uint8_t* ac_lens,
    int32_t eobn_ok /* -1: sniff ac_lens[0x10]; 0/1: explicit */,
    uint8_t* out, int64_t cap) {
    using namespace jprog;
    jpeg::MsbWriter w(out, cap);

    if (ss == 0 && se == 0) {  // DC scan
        Ctx dc{&w, dc_codes, dc_lens, false};
        // T.81 G.1.2.1: the point transform (arithmetic >> al) applies
        // to the DC VALUE; the diff chain runs over shifted values.
        int prev = 0;
        for (int64_t b = 0; b < nblocks; b++) {
            int t = blocks[b * 64] >> al;
            if (ah > 0) {
                dc.bits((uint32_t)t & 1, 1);
            } else {
                int shifted = t - prev;
                int cat = cat16(shifted);
                int bitsv = shifted < 0 ? shifted - 1 : shifted;
                uint32_t val = (uint32_t)bitsv & ((cat == 0) ? 0 : ((1u << cat) - 1));
                w.write(((uint32_t)dc_codes[cat] << cat) | val, dc_lens[cat] + cat);
                prev = t;
            }
        }
    } else {
        Ctx ac{&w, ac_codes, ac_lens,
               eobn_ok < 0 ? ac_lens[0x10] != 0 : eobn_ok != 0};
        RunState run;
        if (ah == 0) {  // AC first scan
            for (int64_t b = 0; b < nblocks; b++) {
                const int16_t* zz = blocks + b * 64;
                int k = se;
                while (k >= ss && pt_ac(zz[k], al) == 0) {
                    if (k == ss) break;
                    k--;
                }
                int last_nonzero = k;
                if (last_nonzero == ss && pt_ac(zz[ss], al) == 0) {
                    run.eob_run++;
                    if (run.eob_run == 0x7FFF) run.flush(ac);
                    continue;
                }
                run.flush(ac);
                int zero_run = 0;
                for (int i = ss; i <= last_nonzero; i++) {
                    int coef = pt_ac(zz[i], al);
                    if (coef == 0) { zero_run++; continue; }
                    while (zero_run >= 16) { ac.sym(0xF0); zero_run -= 16; }
                    int cat = cat16(coef);
                    int bitsv = coef < 0 ? coef - 1 : coef;
                    uint32_t val = (uint32_t)bitsv & ((1u << cat) - 1);
                    int rs = (zero_run << 4) | cat;
                    w.write(((uint32_t)ac_codes[rs] << cat) | val, ac_lens[rs] + cat);
                    zero_run = 0;
                }
                if (last_nonzero < se) run.eob_run++;
            }
        } else {  // AC refinement scan (libjpeg jcphuff encode_mcu_AC_refine)
            for (int64_t b = 0; b < nblocks; b++) {
                const int16_t* zz = blocks + b * 64;
                int absv[64];
                int eob_idx = ss - 1;  // last newly-nonzero position
                for (int i = ss; i <= se; i++) {
                    int v = zz[i];
                    int t = (v < 0 ? -v : v) >> al;
                    absv[i] = t;
                    if (t == 1) eob_idx = i;
                }
                uint8_t br[64];  // correction bits since last symbol
                int nbr = 0;
                int zero_run = 0;
                for (int i = ss; i <= se; i++) {
                    int t = absv[i];
                    if (t == 0) { zero_run++; continue; }
                    while (zero_run > 15 && i <= eob_idx) {
                        run.flush(ac);
                        ac.sym(0xF0);
                        for (int c = 0; c < nbr; c++) ac.bits(br[c], 1);
                        nbr = 0;
                        zero_run -= 16;
                    }
                    if (t > 1) {  // already nonzero: buffer correction bit
                        br[nbr++] = (uint8_t)(t & 1);
                        continue;
                    }
                    // newly nonzero (scaled magnitude exactly 1)
                    run.flush(ac);
                    ac.sym((zero_run << 4) | 1);
                    ac.bits(zz[i] < 0 ? 0u : 1u, 1);
                    for (int c = 0; c < nbr; c++) ac.bits(br[c], 1);
                    nbr = 0;
                    zero_run = 0;
                }
                if (zero_run > 0 || nbr > 0) {
                    if (!ac.eobn_ok) {
                        // no EOBn codes: flush this block eagerly (byte-
                        // identical to the deferred per-block emission)
                        ac.sym(0x00);
                        for (int c = 0; c < nbr; c++) ac.bits(br[c], 1);
                    } else {
                        run.eob_run++;
                        for (int c = 0; c < nbr; c++)
                            run.pending[run.npending++] = br[c];
                        if (run.eob_run == 0x7FFF ||
                            run.npending > kMaxCorrBits)
                            run.flush(ac);
                    }
                }
            }
        }
        run.flush(ac);
    }
    w.flush_pad_ones();
    return w.overflow ? -1 : w.pos;
}

// Count-mode twin (for building the progressive-aware Huffman tables).
EXPORT int32_t jpeg_count_progressive_scan(
    const int16_t* blocks, int64_t nblocks,
    int32_t ss, int32_t se, int32_t ah, int32_t al,
    int64_t* dc_counts /*12*/, int64_t* ac_counts /*256*/) {
    using namespace jprog;
    if (ss == 0 && se == 0) {
        if (ah > 0) return 0;  // refine bits only
        int prev = 0;
        for (int64_t b = 0; b < nblocks; b++) {
            int t = blocks[b * 64] >> al;  // shift-then-diff (G.1.2.1)
            dc_counts[cat16(t - prev)]++;
            prev = t;
        }
        return 0;
    }
    // Counting assumes EOBn codes (they end up in the table precisely
    // because they are counted here); flush points mirror the writer.
    int eob_run = 0;
    int npending = 0;
    auto flush = [&]() {
        if (!eob_run) return;
        int nbits = 0, t = eob_run;
        while (t > 1) { t >>= 1; nbits++; }
        ac_counts[nbits << 4]++;
        eob_run = 0;
        npending = 0;
    };
    if (ah == 0) {
        for (int64_t b = 0; b < nblocks; b++) {
            const int16_t* zz = blocks + b * 64;
            int k = se;
            while (k >= ss && pt_ac(zz[k], al) == 0) {
                if (k == ss) break;
                k--;
            }
            int last_nonzero = k;
            if (last_nonzero == ss && pt_ac(zz[ss], al) == 0) {
                eob_run++;
                if (eob_run == 0x7FFF) flush();
                continue;
            }
            flush();
            int zero_run = 0;
            for (int i = ss; i <= last_nonzero; i++) {
                int coef = pt_ac(zz[i], al);
                if (coef == 0) { zero_run++; continue; }
                while (zero_run >= 16) { ac_counts[0xF0]++; zero_run -= 16; }
                ac_counts[(zero_run << 4) | cat16(coef)]++;
                zero_run = 0;
            }
            if (last_nonzero < se) eob_run++;
        }
    } else {
        for (int64_t b = 0; b < nblocks; b++) {
            const int16_t* zz = blocks + b * 64;
            int absv[64];
            int eob_idx = ss - 1;
            for (int i = ss; i <= se; i++) {
                int v = zz[i];
                int t = (v < 0 ? -v : v) >> al;
                absv[i] = t;
                if (t == 1) eob_idx = i;
            }
            int nbr = 0;
            int zero_run = 0;
            for (int i = ss; i <= se; i++) {
                int t = absv[i];
                if (t == 0) { zero_run++; continue; }
                while (zero_run > 15 && i <= eob_idx) {
                    flush();
                    ac_counts[0xF0]++;
                    nbr = 0;
                    zero_run -= 16;
                }
                if (t > 1) { nbr++; continue; }
                flush();
                ac_counts[(zero_run << 4) | 1]++;
                nbr = 0;
                zero_run = 0;
            }
            if (zero_run > 0 || nbr > 0) {
                eob_run++;
                npending += nbr;
                if (eob_run == 0x7FFF || npending > kMaxCorrBits) flush();
            }
        }
    }
    flush();
    return 0;
}

// ======================== trellis quantization ==============================
// Viterbi R-D optimization per block (behavioral parity with pixo
// src/jpeg/trellis.rs): <=5 candidates/coeff, <=8 states, zero-run
// tracking, ZRL/EOB rate estimates, lambda=1.0, full backtracking.
// Batched over the device-emitted DCT stream: blocks are independent.

namespace trellis {

struct State {
    float cost;
    uint8_t zero_run;
    uint16_t parent;
    int16_t value;
};

static inline int category16(int v) {
    unsigned a = (v < 0) ? (unsigned)(-v) : (unsigned)v;
    return a == 0 ? 0 : (32 - __builtin_clz(a));
}

static inline float est_ac_len_formula(int rs) {
    switch (rs) {
        case 0x00: return 4.0f;
        case 0x01: return 2.0f;
        case 0x02: return 2.5f;
        case 0x03: return 3.0f;
        case 0x04: return 4.0f;
        case 0x11: return 3.0f;
        case 0x12: return 4.0f;
        case 0x21: return 4.0f;
        case 0xF0: return 10.0f;
        default: {
            float run = (float)(rs >> 4);
            float size = (float)(rs & 0x0F);
            return 3.0f + run * 0.5f + size * 0.3f;
        }
    }
}

// rs -> estimated code length, tabulated once (values identical to the
// formula; the hot loop reads est_len_lut[rs] + cat instead of branching)
struct EstLenLut {
    float v[256];
    EstLenLut() {
        for (int rs = 0; rs < 256; rs++) v[rs] = est_ac_len_formula(rs);
    }
};
static const EstLenLut est_len_lut;

static inline float est_ac_huffman_length(int rs) { return est_len_lut.v[rs]; }

static inline float est_ac_rate(int16_t value, uint8_t zero_run) {
    int cat = category16(value);
    int rs = ((int)zero_run << 4) | cat;
    return est_ac_huffman_length(rs) + (float)cat;
}

static inline float round_half_away(float x) {
    return x >= 0 ? __builtin_floorf(x + 0.5f) : __builtin_ceilf(x - 0.5f);
}

#if defined(__AVX2__)
// est_len_lut transposed to [cat][run] rows so one candidate's 16
// possible parent-run rates sit in two 8-float vectors.
struct RateTabT {
    alignas(32) float v[16][16];
    RateTabT() {
        for (int cat = 0; cat < 16; cat++)
            for (int run = 0; run < 16; run++)
                v[cat][run] = est_len_lut.v[(run << 4) | cat];
    }
};
static const RateTabT rate_tab_t;
#endif

// Quantize one block of zigzag-ordered DCT coefficients.
static void trellis_block(const float* dct_zz, const float* q_zz, float lambda,
                          int16_t* out_zz) {
    out_zz[0] = (int16_t)round_half_away(dct_zz[0] / q_zz[0]);

    // Exact fast path: when every AC satisfies 2|dct| < q the DP provably
    // returns all-zero AC. A +-1 insertion always adds rate >= est(run,1)
    // = 4.3 + 0.5*run and distortion (q-|c|)^2 - c^2 > 0; under this cost
    // table, avoiding a 10-bit ZRL requires inserting at run 15 (cost
    // 11.8 > 10 -- splitting earlier never reduces floor(zeros/16)), so
    // zero dominates at every position. Dominant on smooth content.
    {
        // branch-free form so the compiler vectorizes the reduction
        int big = 0;
        for (int i = 1; i < 64; i++) {
            float a = dct_zz[i] < 0 ? -dct_zz[i] : dct_zz[i];
            big |= (2.0f * a >= q_zz[i]);
        }
        if (!big) {
            memset(out_zz + 1, 0, 63 * sizeof(int16_t));
            return;
        }
    }

    const int MAX_STATES = 8;
    State cur[64];
    int ncur = 1;
    cur[0] = {0.0f, 0, 0, 0};

    // hist[pos] holds the backtracking slice (value << 16 | parent) of the
    // pruned states after processing zigzag pos — cost/run are only needed
    // for the *current* frontier, so the per-position history is 4 bytes
    // per state, not the whole State.
    static thread_local uint32_t hist[64][8];
    static thread_local int all_counts[64];
    all_counts[0] = 1;
    hist[0][0] = 0;

#if defined(__AVX2__)
    // SoA mirror of cur for the vectorized transition evaluation; lanes
    // >= ncur hold +inf so vector min-reductions ignore them (scalar
    // consumers index only [0, ncur)).
    alignas(32) float cost_soa[8];
    alignas(32) int32_t run_soa[8] = {0};
    cost_soa[0] = 0.0f;
    for (int i = 1; i < 8; i++) cost_soa[i] = __builtin_inff();
#endif

    // Per-block candidate precompute: fq = dct/q plus its floor/ceil as
    // ints, 8 lanes per divide. vdivps/vroundps/cvttps match the scalar
    // divss/floorf/ceilf/(int) results bit-for-bit.
    alignas(32) float fqs[64];
    alignas(32) int32_t fls[64], ces[64];
#if defined(__AVX2__)
    for (int i = 0; i < 64; i += 8) {
        __m256 c = _mm256_loadu_ps(dct_zz + i);
        __m256 qv = _mm256_loadu_ps(q_zz + i);
        __m256 f = _mm256_div_ps(c, qv);
        _mm256_store_ps(fqs + i, f);
        __m256 flv =
            _mm256_round_ps(f, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
        __m256 cev =
            _mm256_round_ps(f, _MM_FROUND_TO_POS_INF | _MM_FROUND_NO_EXC);
        _mm256_store_si256((__m256i*)(fls + i), _mm256_cvttps_epi32(flv));
        _mm256_store_si256((__m256i*)(ces + i), _mm256_cvttps_epi32(cev));
    }
#else
    for (int i = 0; i < 64; i++) {
        float f = dct_zz[i] / q_zz[i];
        fqs[i] = f;
        fls[i] = (int32_t)__builtin_floorf(f);
        ces[i] = (int32_t)__builtin_ceilf(f);
    }
#endif

    for (int zz = 1; zz < 64; zz++) {
        float coef = dct_zz[zz];
        float q = q_zz[zz];
        float fq = fqs[zz];

        // candidates: 0, floor, round, ceil (+extended), deduped in order.
        // round_half_away(fq) always lands on floor or ceil (|fq| < 2^12,
        // so fq+-0.5 is exact in f32), and the extended candidate
        // (|fq| > 1.5) lies strictly outside [floor, ceil] — the dedup
        // therefore reduces to the two skip-zero checks below, preserving
        // the original first-occurrence order [0, fl?, ce?, ext?].
        int16_t cands[6];
        int ncands = 0;
        cands[ncands++] = 0;
        int16_t fl = (int16_t)fls[zz];
        int16_t ce = (int16_t)ces[zz];
        if (fl != 0) cands[ncands++] = fl;
        if (ce != fl && ce != 0) cands[ncands++] = ce;
        float afq = fq < 0 ? -fq : fq;
        if (afq > 1.5f)
            cands[ncands++] = fq >= 0.0f ? (int16_t)(ce + 1) : (int16_t)(fl - 1);

        // Transition merge, written directly instead of via a hash map.
        // The merged (value, zero_run) keys have a fixed structure: every
        // nonzero candidate resets zero_run to 0 (one shared key per value,
        // min-cost parent wins, earliest parent on ties), while each
        // parent's zero-child gets a distinct run (parent runs are unique,
        // and only a run-15 parent maps to run 0 -- value 0, so it can't
        // collide with the nonzero keys). First-touch list order under the
        // old parent-outer/candidate-inner loop is therefore exactly:
        //   [p0's zero-child, v1, ..., vk, p1's zero-child, ...].
        // Reproducing that order keeps the stable partial selection (and
        // hence equal-cost tie-breaking) bit-identical to the map version;
        // float evaluation order (pcost + rate + lambda*dist) is preserved.
        float dist_zero = coef * coef;
        int cats[6];
        float lam_dists[6];
        for (int ci = 1; ci < ncands; ci++) {
            float d = coef - (float)cands[ci] * q;
            lam_dists[ci] = lambda * (d * d);
            cats[ci] = category16(cands[ci]);
        }
        State next[16];
        int nnext = 0;
#if defined(__AVX2__)
        // Vector transition evaluation: each lane reproduces the scalar
        // float op order exactly — rate = lut + cat, cost = (p.cost +
        // rate) + ld — so results are bit-identical (-ffp-contract=off
        // keeps GCC from fusing the adds).
        __m256 vcost = _mm256_load_ps(cost_soa);
        __m256i vrun = _mm256_load_si256((const __m256i*)run_soa);
        // zero children for all parents at once
        __m256i nr = _mm256_add_epi32(vrun, _mm256_set1_epi32(1));
        __m256i zrl = _mm256_cmpgt_epi32(nr, _mm256_set1_epi32(15));
        __m256 zrate =
            _mm256_and_ps(_mm256_castsi256_ps(zrl), _mm256_set1_ps(10.0f));
        __m256i newrun = _mm256_andnot_si256(zrl, nr);
        float lam_dz = lambda * dist_zero;
        __m256 zc = _mm256_add_ps(_mm256_add_ps(vcost, zrate),
                                  _mm256_set1_ps(lam_dz));
        alignas(32) float zc_cost[8];
        alignas(32) int32_t zc_run[8];
        _mm256_store_ps(zc_cost, zc);
        _mm256_store_si256((__m256i*)zc_run, newrun);
        // lanes whose parent sits at run 15 (took the ZRL +10)
        int zrl_any = _mm256_movemask_ps(_mm256_castsi256_ps(zrl)) &
                      ((1 << ncur) - 1);
        if (ncands == 1 && !zrl_any) {
            // Zero is the only candidate and no ZRL fired: every state
            // gains the same (rate 0) + lam_dz, so the sorted order and
            // tie order are preserved verbatim — pass the states through
            // with no selection. Inactive lanes stay +inf through the adds.
            for (int i = 0; i < ncur; i++) hist[zz][i] = (uint32_t)i;
            all_counts[zz] = ncur;
            _mm256_store_ps(cost_soa, zc);
            _mm256_store_si256((__m256i*)run_soa, newrun);
            continue;
        }
        next[nnext++] = {zc_cost[0], (uint8_t)zc_run[0], 0, 0};
        uint64_t nzk[6];  // nonzero-candidate keys, insertion-sorted
        int nnz = 0;
#if !defined(__AVX512VL__)
        __m256 run_hi =
            _mm256_castsi256_ps(_mm256_cmpgt_epi32(vrun, _mm256_set1_epi32(7)));
#endif
        for (int ci = 1; ci < ncands; ci++) {
            int cat = cats[ci];
            __m256 lo = _mm256_load_ps(rate_tab_t.v[cat]);
            __m256 hi = _mm256_load_ps(rate_tab_t.v[cat] + 8);
#if defined(__AVX512VL__)
            // one cross-register permute covers the 16-entry rate row
            __m256 r = _mm256_permutex2var_ps(lo, vrun, hi);
#else
            // rate_tab_t[cat][run] via two in-lane permutes + blend
            __m256 rlo = _mm256_permutevar8x32_ps(lo, vrun);
            __m256 rhi = _mm256_permutevar8x32_ps(hi, vrun);  // idx mod 8
            __m256 r = _mm256_blendv_ps(rlo, rhi, run_hi);
#endif
            __m256 ratev = _mm256_add_ps(r, _mm256_set1_ps((float)cat));
            __m256 costv = _mm256_add_ps(_mm256_add_ps(vcost, ratev),
                                         _mm256_set1_ps(lam_dists[ci]));
            // branchless first-min: inactive lanes are +inf; on equal
            // costs the lowest lane index (earliest parent) wins, same
            // as the scalar strict-< scan
            __m128 m4 = _mm_min_ps(_mm256_castps256_ps128(costv),
                                   _mm256_extractf128_ps(costv, 1));
            __m128 m2 = _mm_min_ps(m4, _mm_movehl_ps(m4, m4));
            __m128 m1 = _mm_min_ss(m2, _mm_shuffle_ps(m2, m2, 1));
            float best_cost = _mm_cvtss_f32(m1);
            int best_pi = __builtin_ctz(_mm256_movemask_ps(_mm256_cmp_ps(
                costv, _mm256_set1_ps(best_cost), _CMP_EQ_OQ)));
            uint32_t cb;
            memcpy(&cb, &best_cost, 4);
            uint64_t k = ((uint64_t)cb << 4) | (uint64_t)nnext;
            int ins = nnz;
            while (ins > 0 && nzk[ins - 1] > k) ins--;
            for (int m = nnz; m > ins; m--) nzk[m] = nzk[m - 1];
            nzk[ins] = k;
            nnz++;
            next[nnext++] = {best_cost, 0, (uint16_t)best_pi, cands[ci]};
        }
        for (int pi = 1; pi < ncur; pi++)
            next[nnext++] = {zc_cost[pi], (uint8_t)zc_run[pi], (uint16_t)pi, 0};
        if (!zrl_any) {
            // No ZRL reorder: the zero children are already key-sorted
            // (parents sorted, same added constant, sequence numbers
            // ascending), so the stable selection is a 2-way merge of the
            // zero-child keys with the sorted nonzero keys — no insertion
            // pass. Keys are unique (distinct sequence bits), so strict <
            // reproduces the stable tie order exactly.
            uint64_t zck[9];
            {
                uint32_t cb;
                memcpy(&cb, &zc_cost[0], 4);
                zck[0] = ((uint64_t)cb << 4);
                int k0 = ncands - 1;
                for (int pi = 1; pi < ncur; pi++) {
                    memcpy(&cb, &zc_cost[pi], 4);
                    zck[pi] = ((uint64_t)cb << 4) | (uint64_t)(k0 + pi);
                }
            }
            // sentinel-bounded branchless merge: both lists end in
            // UINT64_MAX so the take-side decision is one compare + cmov
            zck[ncur] = UINT64_MAX;
            nzk[nnz] = UINT64_MAX;
            int kept = ncur + nnz;
            if (kept > MAX_STATES) kept = MAX_STATES;
            int a = 0, b = 0;
            for (int i = 0; i < kept; i++) {
                uint64_t ka = zck[a], kb = nzk[b];
                int ta = ka < kb;
                uint64_t k = ta ? ka : kb;
                a += ta;
                b += 1 - ta;
                const State& s = next[k & 15];
                hist[zz][i] = ((uint32_t)(uint16_t)s.value << 16) | s.parent;
                cost_soa[i] = s.cost;
                run_soa[i] = s.zero_run;
            }
            all_counts[zz] = kept;
            ncur = kept;
            for (int i = kept; i < 8; i++) {
                cost_soa[i] = __builtin_inff();
                run_soa[i] = 0;
            }
            continue;
        }
#else
        auto zero_child = [&](int pi) -> State {
            const State& p = cur[pi];
            float rate;
            uint8_t new_run;
            int nr = p.zero_run + 1;
            if (nr >= 16) { rate = 10.0f; new_run = 0; }  // ZRL estimate
            else { rate = 0.0f; new_run = (uint8_t)nr; }
            return {p.cost + rate + lambda * dist_zero, new_run,
                    (uint16_t)pi, 0};
        };
        next[nnext++] = zero_child(0);
        for (int ci = 1; ci < ncands; ci++) {
            int cat = cats[ci];
            float ld = lam_dists[ci];
            float best_cost = 0.0f;
            int best_pi = -1;
            for (int pi = 0; pi < ncur; pi++) {
                float rate =
                    est_ac_huffman_length(((int)cur[pi].zero_run << 4) | cat)
                    + (float)cat;
                float cost = cur[pi].cost + rate + ld;
                if (best_pi < 0 || cost < best_cost) {
                    best_cost = cost;
                    best_pi = pi;
                }
            }
            next[nnext++] = {best_cost, 0, (uint16_t)best_pi, cands[ci]};
        }
        for (int pi = 1; pi < ncur; pi++) next[nnext++] = zero_child(pi);
#endif
        // stable partial selection of the MAX_STATES cheapest states
        // (identical result to stable_sort + truncate). Costs are
        // non-negative f32, so their bit patterns order as uint32; packing
        // (cost_bits << 4) | seq makes one uint64 compare reproduce the
        // float compare with the original first-come tie-breaks.
        int kept = 0;
        uint64_t sel[MAX_STATES];
        for (int si = 0; si < nnext; si++) {
            uint32_t cb;
            memcpy(&cb, &next[si].cost, 4);
            uint64_t k = ((uint64_t)cb << 4) | (uint64_t)si;
            if (kept == MAX_STATES && k >= sel[kept - 1]) continue;
            int ins = kept;
            while (ins > 0 && sel[ins - 1] > k) ins--;
            int tail = (kept < MAX_STATES) ? kept : MAX_STATES - 1;
            for (int m = tail; m > ins; m--) sel[m] = sel[m - 1];
            sel[ins] = k;
            if (kept < MAX_STATES) kept++;
        }
        for (int i = 0; i < kept; i++) {
            const State& s = next[sel[i] & 15];
            hist[zz][i] = ((uint32_t)(uint16_t)s.value << 16) | s.parent;
            cur[i] = s;
        }
        all_counts[zz] = kept;
        ncur = kept;
#if defined(__AVX2__)
        for (int i = 0; i < 8; i++) {
            cost_soa[i] = i < kept ? cur[i].cost : __builtin_inff();
            run_soa[i] = i < kept ? cur[i].zero_run : 0;
        }
#endif
        if (ncur == 0) break;
    }

    // EOB cost on trailing-zero states, then pick first minimum. The
    // frontier cost/run live in the SoA mirror on the AVX2 path (cur is
    // not maintained there); values are identical either way.
    float final_costs[64];
    for (int i = 0; i < ncur; i++) {
#if defined(__AVX2__)
        final_costs[i] = cost_soa[i] + (run_soa[i] > 0 ? 4.0f : 0.0f);
#else
        final_costs[i] = cur[i].cost + (cur[i].zero_run > 0 ? 4.0f : 0.0f);
#endif
    }
    int16_t path[63] = {0};
    if (ncur > 0) {
        int best = 0;
        for (int i = 1; i < ncur; i++)
            if (final_costs[i] < final_costs[best]) best = i;
        int state_idx = best;
        for (int zz = 63; zz >= 1; zz--) {
            if (state_idx < all_counts[zz]) {
                uint32_t h = hist[zz][state_idx];
                path[zz - 1] = (int16_t)(uint16_t)(h >> 16);
                state_idx = (int)(h & 0xffff);
            }
        }
    }
    for (int zz = 1; zz < 64; zz++) out_zz[zz] = path[zz - 1];
}

}  // namespace trellis

EXPORT int32_t jpeg_trellis_quantize(
    const float* dct_zz, int64_t nblocks,
    const uint8_t* pattern, int32_t bpm,
    const float* lum_q_zz, const float* chrom_q_zz,
    float lambda,
    int16_t* out_zz,
    int32_t nthreads) {
    auto work = [&](int64_t lo, int64_t hi) {
        for (int64_t blk = lo; blk < hi; blk++) {
            int comp = pattern[blk % bpm];
            const float* q = (comp == 0) ? lum_q_zz : chrom_q_zz;
            trellis::trellis_block(dct_zz + blk * 64, q, lambda,
                                   out_zz + blk * 64);
        }
    };
    if (nthreads < 1) nthreads = 1;
    if ((int64_t)nthreads > nblocks) nthreads = (int32_t)(nblocks > 0 ? nblocks : 1);
    if (nthreads == 1) {
        work(0, nblocks);
        return 0;
    }
    // blocks are independent and each writes its own 64-coeff slice, so a
    // contiguous-chunk split is deterministic regardless of thread count
    std::vector<std::thread> threads;
    int64_t chunk = (nblocks + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
        int64_t lo = (int64_t)t * chunk;
        int64_t hi = lo + chunk < nblocks ? lo + chunk : nblocks;
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
    return 0;
}

// ================= redmean nearest-palette + 6-6-6 LUT =======================
// Exact redmean distance (pixo src/png/mod.rs:1405-1430):
//   rm = (r1+r2)>>1;  d = ((512+rm)dr^2 + 1024 dg^2 + (767-rm)db^2)>>8 + da^2
// All terms fit int32. Ties resolve to the LOWEST palette index (the
// reference's strict-less scan and np.argmin agree). AVX2 vectorizes over
// palette entries; the 64^3-cell LUT build (mod.rs:1448-1478) drops from
// minutes of NumPy broadcast temporaries to ~20 ms.

static inline int64_t nearest_one_scalar(
    int r, int g, int b, int a,
    const uint8_t* pal, int64_t k) {
    int64_t best = 0;
    int32_t best_d = INT32_MAX;
    for (int64_t i = 0; i < k; i++) {
        const uint8_t* p = pal + i * 4;
        int32_t dr = r - p[0], dg = g - p[1], db = b - p[2], da = a - p[3];
        int32_t rm = (r + p[0]) >> 1;
        int32_t d = (((512 + rm) * dr * dr + 1024 * dg * dg +
                      (767 - rm) * db * db) >> 8) + da * da;
        if (d < best_d) { best_d = d; best = i; }
    }
    return best;
}

EXPORT int32_t nearest_palette_batch(
    const uint8_t* colors, int64_t n,       // [n, 4] rgba
    const uint8_t* palette, int64_t k,      // [k, 4] rgba
    uint8_t* out) {
#ifdef __AVX2__
    if (k >= 8) {
        // palette SoA in int32 lanes
        std::vector<int32_t> pr(k), pg(k), pb(k), pa(k);
        for (int64_t i = 0; i < k; i++) {
            pr[i] = palette[i * 4];
            pg[i] = palette[i * 4 + 1];
            pb[i] = palette[i * 4 + 2];
            pa[i] = palette[i * 4 + 3];
        }
        const __m256i c512 = _mm256_set1_epi32(512);
        const __m256i c767 = _mm256_set1_epi32(767);
        const __m256i c1024 = _mm256_set1_epi32(1024);
        const __m256i idx_step = _mm256_set1_epi32(8);
        const __m256i idx0 = _mm256_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7);
        int64_t kv = k & ~7LL;
        for (int64_t i = 0; i < n; i++) {
            const int r = colors[i * 4], g = colors[i * 4 + 1];
            const int b = colors[i * 4 + 2], a = colors[i * 4 + 3];
            __m256i vr = _mm256_set1_epi32(r), vg = _mm256_set1_epi32(g);
            __m256i vb = _mm256_set1_epi32(b), va = _mm256_set1_epi32(a);
            __m256i best_d = _mm256_set1_epi32(INT32_MAX);
            __m256i best_i = _mm256_setzero_si256();
            __m256i idx = idx0;
            for (int64_t j = 0; j < kv; j += 8) {
                __m256i qr = _mm256_loadu_si256((const __m256i*)(pr.data() + j));
                __m256i qg = _mm256_loadu_si256((const __m256i*)(pg.data() + j));
                __m256i qb = _mm256_loadu_si256((const __m256i*)(pb.data() + j));
                __m256i qa = _mm256_loadu_si256((const __m256i*)(pa.data() + j));
                __m256i dr = _mm256_sub_epi32(vr, qr);
                __m256i dg = _mm256_sub_epi32(vg, qg);
                __m256i db = _mm256_sub_epi32(vb, qb);
                __m256i da = _mm256_sub_epi32(va, qa);
                __m256i rm = _mm256_srai_epi32(_mm256_add_epi32(vr, qr), 1);
                __m256i d = _mm256_add_epi32(
                    _mm256_mullo_epi32(_mm256_add_epi32(c512, rm),
                                       _mm256_mullo_epi32(dr, dr)),
                    _mm256_mullo_epi32(c1024, _mm256_mullo_epi32(dg, dg)));
                d = _mm256_add_epi32(
                    d, _mm256_mullo_epi32(_mm256_sub_epi32(c767, rm),
                                          _mm256_mullo_epi32(db, db)));
                d = _mm256_add_epi32(_mm256_srai_epi32(d, 8),
                                     _mm256_mullo_epi32(da, da));
                __m256i lt = _mm256_cmpgt_epi32(best_d, d);  // d < best
                best_d = _mm256_blendv_epi8(best_d, d, lt);
                best_i = _mm256_blendv_epi8(best_i, idx, lt);
                idx = _mm256_add_epi32(idx, idx_step);
            }
            alignas(32) int32_t ds[8], is[8];
            _mm256_store_si256((__m256i*)ds, best_d);
            _mm256_store_si256((__m256i*)is, best_i);
            int32_t bd = INT32_MAX;
            int64_t bi = 0;
            for (int lane = 0; lane < 8; lane++) {
                // lane k-indices are unique mod 8; ties across lanes pick
                // the smaller palette index (the host's strict-less scan)
                if (ds[lane] < bd || (ds[lane] == bd && is[lane] < bi)) {
                    bd = ds[lane];
                    bi = is[lane];
                }
            }
            for (int64_t j = kv; j < k; j++) {  // scalar tail
                const uint8_t* p = palette + j * 4;
                int32_t dr = r - p[0], dg = g - p[1], db = b - p[2], da = a - p[3];
                int32_t rm = (r + p[0]) >> 1;
                int32_t d = (((512 + rm) * dr * dr + 1024 * dg * dg +
                              (767 - rm) * db * db) >> 8) + da * da;
                if (d < bd) { bd = d; bi = j; }
            }
            out[i] = (uint8_t)bi;
        }
        return 0;
    }
#endif
    for (int64_t i = 0; i < n; i++) {
        out[i] = (uint8_t)nearest_one_scalar(
            colors[i * 4], colors[i * 4 + 1], colors[i * 4 + 2],
            colors[i * 4 + 3], palette, k);
    }
    return 0;
}

// 6-6-6 opaque LUT build (pixo PaletteLut::new, mod.rs:1455-1478).
//
// Exact candidate pruning per 4x4x4 subcube: after the >>8 the redmean
// channel weights all lie in [2, 4] ((512+rm)/256 and (767-rm)/256 with
// rm in [0,255], green fixed at 4), so with E = euclidean^2 over RGB and
// da2 = (255-pa)^2 the integer distance obeys
//     2*E(x,p) + da2(p) <= D(x,p) <= 4*E(x,p) + da2(p).
// Bounding E over a subcube by the center distance +- half-diagonal rho
// gives, for every grid point x in the subcube,
//     D(x,p)  >= 2*max(0, ec(p)-rho)^2 + da2(p)      (lower bound)
//     D(x,p*) <= min_q 4*(ec(q)+rho)^2 + da2(q)      (upper bound on best)
// so dropping entries whose lower bound exceeds the upper bound (plus a
// float-safety margin) can never drop a winner or a tie; the exact scan
// over the survivors in ascending palette order reproduces the brute
// scan's lowest-index tie-break bit-for-bit. 67M distance evals -> ~6M
// on 256-color photographic palettes.
EXPORT int32_t palette_lut_build(
    const uint8_t* palette, int64_t k, uint8_t* lut /* 64*64*64 */) {
    if (k <= 0) return -1;
    if (k <= 8) {  // pruning overhead not worth it; brute-force
        std::vector<uint8_t> grid(64 * 64 * 64 * 4);
        size_t w = 0;
        for (int r6 = 0; r6 < 64; r6++)
            for (int g6 = 0; g6 < 64; g6++)
                for (int b6 = 0; b6 < 64; b6++) {
                    grid[w++] = (uint8_t)((r6 << 2) | (r6 >> 4));
                    grid[w++] = (uint8_t)((g6 << 2) | (g6 >> 4));
                    grid[w++] = (uint8_t)((b6 << 2) | (b6 >> 4));
                    grid[w++] = 255;
                }
        return nearest_palette_batch(grid.data(), 64 * 64 * 64, palette, k, lut);
    }

    std::vector<int32_t> pr(k), pg(k), pb(k), da2(k);
    for (int64_t i = 0; i < k; i++) {
        pr[i] = palette[i * 4];
        pg[i] = palette[i * 4 + 1];
        pb[i] = palette[i * 4 + 2];
        int32_t da = 255 - palette[i * 4 + 3];
        da2[i] = da * da;
    }
    uint8_t m8[64];  // 6-bit cell -> replicated 8-bit value (monotonic)
    for (int c = 0; c < 64; c++) m8[c] = (uint8_t)((c << 2) | (c >> 4));

    std::vector<int32_t> cands, parent;
    cands.reserve(k);
    parent.reserve(k);
    // per-entry bounds, integer and per-axis (box, not sphere): with
    // rlo/rhi the box's 8-bit extent, rm = (r+pr)>>1 lies in
    // [(rlo+pr)>>1, (rhi+pr)>>1], so the red/blue weights are known to
    // within (rhi-rlo)/2/256 per entry; per-axis gaps lr = max(0,
    // dist(pr, [rlo,rhi])) etc. give S >= wr_lo*lr^2 + 1024*lg^2 +
    // wb_lo*lb^2, and D = (S>>8)+da2 in [S/256 - 1 + da2, S/256 + da2].
    // Applied twice: 16^3 parent cubes prune the full palette, 4^3
    // subcubes prune the parent's survivors.
    std::vector<int64_t> lb(k), ub(k);
    auto prune_box = [&](int rlo, int rhi, int glo, int ghi, int blo,
                         int bhi, const std::vector<int32_t>& in,
                         std::vector<int32_t>* out_list) {
        int64_t ubmin = INT64_MAX;
        size_t m = in.size();
        for (size_t j = 0; j < m; j++) {
            int32_t p = in[j];
            int64_t lr = pr[p] < rlo ? rlo - pr[p]
                       : pr[p] > rhi ? pr[p] - rhi : 0;
            int64_t ur = std::max(rhi - pr[p], pr[p] - rlo);
            int64_t lg = pg[p] < glo ? glo - pg[p]
                       : pg[p] > ghi ? pg[p] - ghi : 0;
            int64_t ug = std::max(ghi - pg[p], pg[p] - glo);
            int64_t lbb = pb[p] < blo ? blo - pb[p]
                        : pb[p] > bhi ? pb[p] - bhi : 0;
            int64_t ubb = std::max(bhi - pb[p], pb[p] - blo);
            int64_t rm_lo = (rlo + pr[p]) >> 1;
            int64_t rm_hi = (rhi + pr[p]) >> 1;
            int64_t s_lo = (512 + rm_lo) * lr * lr + 1024 * lg * lg +
                           (767 - rm_hi) * lbb * lbb;
            int64_t s_hi = (512 + rm_hi) * ur * ur + 1024 * ug * ug +
                           (767 - rm_lo) * ubb * ubb;
            lb[j] = s_lo / 256 - 1 + da2[p];
            ub[j] = s_hi / 256 + 1 + da2[p];
            if (ub[j] < ubmin) ubmin = ub[j];
        }
        out_list->clear();
        for (size_t j = 0; j < m; j++)
            if (lb[j] <= ubmin) out_list->push_back(in[j]);
    };
    std::vector<int32_t> all(k);
    for (int64_t p = 0; p < k; p++) all[p] = (int32_t)p;
    for (int rp = 0; rp < 64; rp += 16) {
    for (int gp = 0; gp < 64; gp += 16) {
    for (int bp = 0; bp < 64; bp += 16) {
        prune_box(m8[rp], m8[rp + 15], m8[gp], m8[gp + 15], m8[bp],
                  m8[bp + 15], all, &parent);
    for (int rb = rp; rb < rp + 16; rb += 4) {
        const int rlo = m8[rb], rhi = m8[rb + 3];
        for (int gb = gp; gb < gp + 16; gb += 4) {
            const int glo = m8[gb], ghi = m8[gb + 3];
            for (int bb = bp; bb < bp + 16; bb += 4) {
                const int blo = m8[bb], bhi = m8[bb + 3];
                prune_box(rlo, rhi, glo, ghi, blo, bhi, parent, &cands);

                for (int r6 = rb; r6 < rb + 4; r6++) {
                    const int r = m8[r6];
                    for (int g6 = gb; g6 < gb + 4; g6++) {
                        const int g = m8[g6];
                        uint8_t* row = lut + ((size_t)r6 << 12) +
                                       ((size_t)g6 << 6) + bb;
                        for (int b6 = bb; b6 < bb + 4; b6++) {
                            const int b = m8[b6];
                            int32_t best_d = INT32_MAX;
                            int32_t best_i = 0;
                            for (int32_t ci : cands) {
                                int32_t dr = r - pr[ci], dg = g - pg[ci],
                                        db = b - pb[ci];
                                int32_t rm = (r + pr[ci]) >> 1;
                                int32_t d =
                                    (((512 + rm) * dr * dr + 1024 * dg * dg +
                                      (767 - rm) * db * db) >> 8) + da2[ci];
                                if (d < best_d) { best_d = d; best_i = ci; }
                            }
                            row[b6 - bb] = (uint8_t)best_i;
                        }
                    }
                }
            }
        }
    }
    }}}
    return 0;
}

// ===================== Floyd-Steinberg dithering =============================
// Sequential 2D error diffusion (parity with pixo src/png/mod.rs:1634-1698):
// rows coupled through the error buffers, so this stays a host stage.

EXPORT int32_t dither_fs(
    const uint8_t* rgba, int32_t width, int32_t height,
    const uint8_t* palette, int32_t palette_len,
    const uint8_t* opaque_lut,  // 64*64*64 entries
    uint8_t* out_indices) {
    std::vector<float> err(3 * (width + 2), 0.0f);
    std::vector<float> nxt(3 * (width + 2), 0.0f);
    float* er_ = err.data();
    float* nx_ = nxt.data();

    auto nearest_alpha = [&](int r, int g, int b, int a) -> int {
        // redmean distance incl. alpha (parity with perceptual_distance_sq)
        long long best = -1;
        int best_idx = 0;
        for (int i = 0; i < palette_len; i++) {
            int pr = palette[i * 4], pg = palette[i * 4 + 1],
                pb = palette[i * 4 + 2], pa = palette[i * 4 + 3];
            long long dr = r - pr, dg = g - pg, db = b - pb, da = a - pa;
            long long rm = (r + pr) >> 1;
            long long dist = (((512 + rm) * dr * dr + 1024 * dg * dg +
                               (767 - rm) * db * db) >> 8) + da * da;
            if (best < 0 || dist < best) { best = dist; best_idx = i; }
        }
        return best_idx;
    };

    int64_t pos = 0;
    for (int y = 0; y < height; y++) {
        float* e0 = er_, *e1 = er_ + (width + 2), *e2 = er_ + 2 * (width + 2);
        float* n0 = nx_, *n1 = nx_ + (width + 2), *n2 = nx_ + 2 * (width + 2);
        for (int x = 0; x < width; x++) {
            int r = rgba[pos], g = rgba[pos + 1], b = rgba[pos + 2], a = rgba[pos + 3];
            pos += 4;
            float fr = (float)r + e0[x + 1];
            float fg = (float)g + e1[x + 1];
            float fb = (float)b + e2[x + 1];
            fr = fr < 0 ? 0 : (fr > 255 ? 255 : fr);
            fg = fg < 0 ? 0 : (fg > 255 ? 255 : fg);
            fb = fb < 0 ? 0 : (fb > 255 ? 255 : fb);
            int ar = (int)fr, ag = (int)fg, ab = (int)fb;
            int idx;
            if (a == 255)
                idx = opaque_lut[((ar >> 2) << 12) | ((ag >> 2) << 6) | (ab >> 2)];
            else
                idx = nearest_alpha(ar, ag, ab, a);
            out_indices[y * (int64_t)width + x] = (uint8_t)idx;
            float pr = palette[idx * 4], pg = palette[idx * 4 + 1], pb = palette[idx * 4 + 2];
            float errs[3] = {(float)ar - pr, (float)ag - pg, (float)ab - pb};
            float* e_rows[3] = {e0, e1, e2};
            float* n_rows[3] = {n0, n1, n2};
            for (int c = 0; c < 3; c++) {
                e_rows[c][x + 2] += errs[c] * (7.0f / 16.0f);
                n_rows[c][x] += errs[c] * (3.0f / 16.0f);
                n_rows[c][x + 1] += errs[c] * (5.0f / 16.0f);
                n_rows[c][x + 2] += errs[c] * (1.0f / 16.0f);
            }
        }
        std::fill(er_, er_ + 3 * (width + 2), 0.0f);
        std::swap(er_, nx_);
    }
    return 0;
}

// ======================= JPEG entropy decode ================================
// Baseline Huffman scan decode (parity with pixo src/decode/jpeg.rs): the
// per-symbol bit stream is inherently serial, so it lives here; the caller
// hands pre-split, unstuffed restart segments and per-table canonical
// specs, and receives the full per-component coefficient planes.

namespace jdec {

struct HuffDec {
    int32_t min_code[17];
    int32_t max_code[17];
    int32_t val_idx[17];
    const uint8_t* vals;
    // 9-bit fast lookahead
    int16_t lut_sym[512];
    int8_t lut_len[512];

    void build(const uint8_t* bits, const uint8_t* values) {
        vals = values;
        int code = 0, k = 0;
        for (int ln = 1; ln <= 16; ln++) {
            int count = bits[ln - 1];
            if (count) {
                val_idx[ln] = k;
                min_code[ln] = code;
                max_code[ln] = code + count - 1;
                k += count;
                code += count;
            } else {
                min_code[ln] = 0;
                max_code[ln] = -1;
            }
            code <<= 1;
        }
        for (int i = 0; i < 512; i++) { lut_sym[i] = -1; lut_len[i] = 0; }
        code = 0; k = 0;
        for (int ln = 1; ln <= 9; ln++) {
            for (int c = 0; c < bits[ln - 1]; c++) {
                int prefix = code << (9 - ln);
                for (int fill = 0; fill < (1 << (9 - ln)); fill++) {
                    lut_sym[prefix | fill] = values[k];
                    lut_len[prefix | fill] = (int8_t)ln;
                }
                code++; k++;
            }
            code <<= 1;
        }
    }
};

struct MsbReader {
    const uint8_t* data;
    int64_t len, pos;
    uint64_t acc;
    int nbits;
    bool error;

    MsbReader(const uint8_t* d, int64_t l)
        : data(d), len(l), pos(0), acc(0), nbits(0), error(false) {}

    inline void fill() {
        // fast path: one unaligned big-endian 64-bit load tops the
        // accumulator up instead of a per-byte loop
        if (pos + 8 <= len) {
            int add = (56 - nbits) >> 3;
            if (add <= 0) return;
            uint64_t chunk;
            memcpy(&chunk, data + pos, 8);
            chunk = __builtin_bswap64(chunk);
            acc = (acc << (add * 8)) | (chunk >> (64 - add * 8));
            pos += add;
            nbits += add * 8;
            return;
        }
        while (nbits <= 56 && pos < len) {
            acc = (acc << 8) | data[pos++];
            nbits += 8;
        }
    }

    inline int peek9() {
        if (nbits < 9) fill();
        if (nbits >= 9) return (int)((acc >> (nbits - 9)) & 0x1FF);
        return nbits ? (int)((acc << (9 - nbits)) & 0x1FF) : 0;
    }

    inline int read_bit() {
        if (nbits < 1) fill();
        if (nbits < 1) { error = true; return 0; }
        nbits--;
        int b = (int)((acc >> nbits) & 1);
        return b;
    }

    inline uint32_t read_bits(int n) {
        if (n == 0) return 0;
        if (nbits < n) fill();
        if (nbits < n) { error = true; return 0; }
        nbits -= n;
        return (uint32_t)((acc >> nbits) & ((1ull << n) - 1));
    }

    inline int decode(const HuffDec& t) {
        int p = peek9();
        if (t.lut_len[p] && nbits >= t.lut_len[p]) {
            nbits -= t.lut_len[p];
            return t.lut_sym[p];
        }
        int code = 0;
        for (int ln = 1; ln <= 16; ln++) {
            code = (code << 1) | read_bit();
            if (error) return -1;
            if (t.max_code[ln] >= 0 && code <= t.max_code[ln] && code >= t.min_code[ln])
                return t.vals[t.val_idx[ln] + code - t.min_code[ln]];
        }
        error = true;
        return -1;
    }
};

static inline int extend(uint32_t bits, int size) {
    if (size == 0) return 0;
    if ((int)bits < (1 << (size - 1))) return (int)bits - (2 << (size - 1)) + 1;
    return (int)bits;
}

// Combined AC lookahead: a 12-bit window resolves the Huffman code AND
// its appended value bits in one table hit for most symbols (libjpeg-
// turbo style).  run 0xFF = EOB, 0xFE = ZRL; len 0 = fall back to the
// canonical walk.
struct AcLut {
    // packed entry: len(8) | run(8) | val(16); len 0 = slow path,
    // run 0xFF = EOB, 0xFE = ZRL — one cache line stream per hit
    uint32_t e[4096];
    // content key: restart-interval streams call per segment with the
    // same tables; rebuild only when the spec actually changes
    uint8_t key_bits[16];
    uint8_t key_vals[256];
    int key_n = -1;

    static inline uint32_t pack(int len, int run, int16_t val) {
        return (uint32_t)(uint8_t)len | ((uint32_t)(uint8_t)run << 8) |
               ((uint32_t)(uint16_t)val << 16);
    }

    void build(const uint8_t* bits, const uint8_t* values, bool dc = false) {
        int n = 0;
        for (int i = 0; i < 16; i++) n += bits[i];
        // content cache only when the full value list fits the key
        // (an over-long-but-Kraft-valid table must never collide)
        bool cacheable = n <= (int)sizeof(key_vals);
        if (cacheable && key_n == (dc ? n | 0x10000 : n) &&
            memcmp(key_bits, bits, 16) == 0 &&
            memcmp(key_vals, values, (size_t)n) == 0)
            return;
        if (cacheable) {
            memcpy(key_bits, bits, 16);
            memcpy(key_vals, values, (size_t)n);
            key_n = dc ? n | 0x10000 : n;
        } else {
            key_n = -1;
        }
        memset(e, 0, sizeof(e));
        int code = 0, k = 0;
        for (int ln = 1; ln <= 12; ln++) {
            for (int c = 0; c < bits[ln - 1]; c++, code++, k++) {
                int rs = values[k];
                if (dc && rs > 15) continue;   // invalid DC symbol: slow path
                int rrun = rs >> 4, size = rs & 15;
                int prefix = code << (12 - ln);
                if (size == 0) {
                    // val carries the raw run nibble: baseline ignores it,
                    // the progressive first pass reads it as the EOBn order
                    uint32_t ent = pack(ln, rrun == 15 ? 0xFE : 0xFF,
                                        (int16_t)rrun);
                    for (int f = 0; f < (1 << (12 - ln)); f++)
                        e[prefix | f] = ent;
                } else if (ln + size <= 12) {
                    int rem = 12 - ln - size;
                    for (int v = 0; v < (1 << size); v++) {
                        uint32_t ent = pack(ln + size, rrun,
                                            (int16_t)extend((uint32_t)v, size));
                        int base = prefix | (v << rem);
                        for (int f = 0; f < (1 << rem); f++) e[base | f] = ent;
                    }
                }
            }
            code <<= 1;
        }
    }
};

}  // namespace jdec

// Decode one entropy segment covering MCUs [mcu_start, mcu_end).
// comp_* arrays are per scan-component.  The Sink supplies the per-block
// destination (`at`, 64 int16 zeroed here) and a completion hook (`done`) —
// the coefficient sink stores blocks in the component's MCU-padded grid,
// the fused baseline sink (jpeg_decode_baseline below) IDCTs each block
// straight into uint8 planes so coefficients never round-trip DRAM.
template <class Sink>
static int32_t jpeg_decode_segment_sink(
    const uint8_t* seg, int64_t seg_len,
    int64_t mcu_start, int64_t mcu_end, int32_t mcu_cols,
    int32_t ncomp,
    const int32_t* comp_h, const int32_t* comp_v,
    const jdec::HuffDec* dct, const jdec::HuffDec* act,
    const jdec::AcLut* aclut, const jdec::AcLut* dclut,
    Sink& sink,
    int32_t* prev_dc /* per component, in/out */) {
    using namespace jdec;
    MsbReader r(seg, seg_len);
    for (int64_t mcu = mcu_start; mcu < mcu_end; mcu++) {
        int64_t my = mcu / mcu_cols, mx = mcu % mcu_cols;
        for (int c = 0; c < ncomp; c++) {
            const AcLut& L = aclut[c];
            for (int by = 0; by < comp_v[c]; by++) {
                for (int bx = 0; bx < comp_h[c]; bx++) {
                    int64_t row = my * comp_v[c] + by;
                    int64_t col = mx * comp_h[c] + bx;
                    // at() returns 64 zeroed int16 (the coeff sink memsets;
                    // the fused sink keeps its scratch zero across blocks
                    // and re-zeroes only [0, k) in done())
                    int16_t* block =
                        sink.at(c, row, col, (int64_t)mcu_cols * comp_h[c]);
                    if (r.nbits < 27) r.fill();
                    int diff;
                    uint32_t dent = 0;
                    if (r.nbits >= 12)
                        dent = dclut[c].e[(r.acc >> (r.nbits - 12)) & 0xFFF];
                    int dtl = (int)(dent & 0xFF);
                    if (dtl && dtl <= r.nbits) {
                        r.nbits -= dtl;
                        diff = (((dent >> 8) & 0xFF) == 0xFF)
                                   ? 0
                                   : (int)(int16_t)(dent >> 16);
                    } else {
                        int s = r.decode(dct[c]);
                        if (s < 0 || s > 15) return -1;
                        diff = s ? extend(r.read_bits(s), s) : 0;
                    }
                    // wrap like the Python tier: 16-bit coefficient storage
                    // semantics, no int32 signed-overflow UB on corrupt data
                    prev_dc[c] = ((prev_dc[c] + diff + 0x8000) & 0xFFFF) - 0x8000;
                    block[0] = (int16_t)prev_dc[c];
                    int k = 1;
                    while (k < 64) {
                        if (r.nbits < 27) r.fill();
                        if (r.nbits >= 12) {
                            int p = (int)((r.acc >> (r.nbits - 12)) & 0xFFF);
                            uint32_t ent = L.e[p];
                            int tl = (int)(ent & 0xFF);
                            if (tl && tl <= r.nbits) {
                                r.nbits -= tl;
                                uint32_t run = (ent >> 8) & 0xFF;
                                if (run == 0xFF) break;      // EOB
                                if (run == 0xFE) { k += 16; continue; }  // ZRL
                                k += (int)run;
                                if (k > 63) return -1;
                                block[k] = (int16_t)(ent >> 16);
                                k++;
                                continue;
                            }
                        }
                        int rs = r.decode(act[c]);
                        if (rs < 0) return -1;
                        int run = rs >> 4, size = rs & 0x0F;
                        if (size == 0) {
                            if (run == 15) { k += 16; continue; }
                            break;
                        }
                        k += run;
                        if (k > 63) return -1;
                        block[k] = (int16_t)extend(r.read_bits(size), size);
                        k++;
                    }
                    if (r.error) return -1;
                    // k bounds the written coefficients: every nonzero
                    // zigzag index is < k (EOB leaves k just past the
                    // last written entry; values are nonzero by T.81
                    // construction).  Sinks use it for sparse shortcuts.
                    sink.done(c, row, col, k);
                }
            }
        }
    }
    return 0;
}

// Coefficient sink: the original behavior — store each block (zigzag
// order) in the component's MCU-padded block grid.
struct JpegCoeffSink {
    int16_t** coeff_planes;
    inline int16_t* at(int c, int64_t row, int64_t col, int64_t stride) {
        int16_t* block = coeff_planes[c] + (row * stride + col) * 64;
        memset(block, 0, 128);
        return block;
    }
    inline void done(int, int64_t, int64_t, int) {}
};

static int32_t jpeg_decode_segment_impl(
    const uint8_t* seg, int64_t seg_len,
    int64_t mcu_start, int64_t mcu_end, int32_t mcu_cols,
    int32_t ncomp,
    const int32_t* comp_h, const int32_t* comp_v,
    const jdec::HuffDec* dct, const jdec::HuffDec* act,
    const jdec::AcLut* aclut, const jdec::AcLut* dclut,
    int16_t** coeff_planes /* per component */,
    int32_t* prev_dc /* per component, in/out */) {
    JpegCoeffSink sink{coeff_planes};
    return jpeg_decode_segment_sink(
        seg, seg_len, mcu_start, mcu_end, mcu_cols, ncomp, comp_h, comp_v,
        dct, act, aclut, dclut, sink, prev_dc);
}

// Whole-scan driver: loops restart segments inside the library so a
// restart-heavy stream (DRI=1..4) costs one FFI crossing instead of one
// per segment (~35 us each through ctypes).  Segment si covers MCUs
// [si*ri, min((si+1)*ri, total)); DC predictors reset per segment.
EXPORT int32_t jpeg_decode_scan(
    const uint8_t* segs, const int64_t* seg_off, int32_t nseg,
    int64_t restart_interval, int64_t total_mcus, int32_t mcu_cols,
    int32_t ncomp, const int32_t* comp_h, const int32_t* comp_v,
    const uint8_t* dc_bits, const uint8_t* dc_vals_flat, const int32_t* dc_vals_off,
    const uint8_t* ac_bits, const uint8_t* ac_vals_flat, const int32_t* ac_vals_off,
    int16_t** coeff_planes, int32_t* prev_dc) {
    using namespace jdec;
    if (ncomp < 1 || ncomp > 4) return -1;
    // all tables (canonical + combined lookahead) build ONCE per scan;
    // the per-segment loop only resets the DC predictors
    HuffDec dct[4], act[4];
    static thread_local AcLut aclut[4], dclut[4];
    for (int c = 0; c < ncomp; c++) {
        dct[c].build(dc_bits + 16 * c, dc_vals_flat + dc_vals_off[c]);
        act[c].build(ac_bits + 16 * c, ac_vals_flat + ac_vals_off[c]);
        aclut[c].build(ac_bits + 16 * c, ac_vals_flat + ac_vals_off[c]);
        // dc=true rejects symbols > 15 from the fast table so the slow
        // path (which returns -1 on them) stays authoritative
        dclut[c].build(dc_bits + 16 * c, dc_vals_flat + dc_vals_off[c], true);
    }
    for (int32_t si = 0; si < nseg; si++) {
        int64_t m0 = restart_interval ? si * restart_interval : 0;
        int64_t m1 = restart_interval ? (si + 1) * restart_interval : total_mcus;
        if (m1 > total_mcus) m1 = total_mcus;
        if (m0 >= m1) break;
        for (int c = 0; c < ncomp; c++) prev_dc[c] = 0;
        int32_t rc = jpeg_decode_segment_impl(
            segs + seg_off[si], seg_off[si + 1] - seg_off[si], m0, m1,
            mcu_cols, ncomp, comp_h, comp_v, dct, act, aclut, dclut,
            coeff_planes, prev_dc);
        if (rc != 0) return rc;
        if (!restart_interval) break;
    }
    return 0;
}

// Progressive (SOF2) scan decoding, one entropy segment at a time (T.81
// G.1.2; mirrors the Python reference loops in decode/jpeg_decoder.py,
// which mirror the encoder in pixo_tpu/jpeg/progressive.py — the reference
// decoder rejects SOF2 entirely, src/decode/jpeg.rs).
//
// DC scans (interleaved or single-component): units [unit_start, unit_end)
// of this segment. `interleaved` selects MCU addressing vs the component's
// own ceil-block raster. All arrays are per *scan* component.
EXPORT int32_t jpeg_prog_dc_segment(
    const uint8_t* seg, int64_t seg_len,
    int64_t unit_start, int64_t unit_end,
    int32_t mcu_cols, int32_t interleaved, int32_t ns,
    const int32_t* comp_h, const int32_t* comp_v, const int32_t* blk_w,
    const uint8_t* dc_bits, const uint8_t* dc_vals_flat, const int32_t* dc_vals_off,
    int32_t ah, int32_t al,
    int16_t** coeff_planes,
    int32_t* prev_dc) {
    using namespace jdec;
    HuffDec dct[4];
    if (ah == 0)
        for (int c = 0; c < ns; c++)
            dct[c].build(dc_bits + 16 * c, dc_vals_flat + dc_vals_off[c]);
    MsbReader r(seg, seg_len);
    for (int64_t unit = unit_start; unit < unit_end; unit++) {
        for (int c = 0; c < ns; c++) {
            int64_t stride = (int64_t)mcu_cols * comp_h[c];
            if (interleaved) {
                int64_t my = unit / mcu_cols, mx = unit % mcu_cols;
                for (int by = 0; by < comp_v[c]; by++) {
                    for (int bx = 0; bx < comp_h[c]; bx++) {
                        int16_t* block = coeff_planes[c] +
                            ((my * comp_v[c] + by) * stride + mx * comp_h[c] + bx) * 64;
                        if (ah == 0) {
                            int s = r.decode(dct[c]);
                            if (s < 0 || s > 15) return -1;
                            int diff = s ? extend(r.read_bits(s), s) : 0;
                            prev_dc[c] = ((prev_dc[c] + diff + 0x8000) & 0xFFFF) - 0x8000;
                            block[0] = (int16_t)((((prev_dc[c] << al) + 0x8000) & 0xFFFF) - 0x8000);
                        } else if (r.read_bit()) {
                            block[0] = (int16_t)(block[0] | (1 << al));
                        }
                        if (r.error) return -1;
                    }
                }
            } else {
                int64_t by = unit / blk_w[c], bx = unit % blk_w[c];
                int16_t* block = coeff_planes[c] + (by * stride + bx) * 64;
                if (ah == 0) {
                    int s = r.decode(dct[c]);
                    if (s < 0 || s > 15) return -1;
                    int diff = s ? extend(r.read_bits(s), s) : 0;
                    prev_dc[c] = ((prev_dc[c] + diff + 0x8000) & 0xFFFF) - 0x8000;
                    block[0] = (int16_t)((((prev_dc[c] << al) + 0x8000) & 0xFFFF) - 0x8000);
                } else if (r.read_bit()) {
                    block[0] = (int16_t)(block[0] | (1 << al));
                }
                if (r.error) return -1;
            }
        }
    }
    return 0;
}

// AC scans (always single-component, raster over the component's ceil
// block grid). `eobrun` carries the end-of-band run across units in/out.
EXPORT int32_t jpeg_prog_ac_segment(
    const uint8_t* seg, int64_t seg_len,
    int64_t unit_start, int64_t unit_end,
    int32_t stride, int32_t blk_w,
    int32_t ss, int32_t se, int32_t ah, int32_t al,
    const uint8_t* ac_bits, const uint8_t* ac_vals,
    int16_t* plane,
    int64_t* eobrun_io) {
    using namespace jdec;
    HuffDec act;
    act.build(ac_bits, ac_vals);
    static thread_local AcLut aclut;
    if (ah == 0) aclut.build(ac_bits, ac_vals);
    MsbReader r(seg, seg_len);
    int64_t eobrun = *eobrun_io;
    const int p1 = 1 << al, m1 = -(1 << al);

    for (int64_t unit = unit_start; unit < unit_end; unit++) {
        int64_t by = unit / blk_w, bx = unit % blk_w;
        int16_t* block = plane + (by * (int64_t)stride + bx) * 64;
        if (ah == 0) {  // first pass (G.1.2.2)
            if (eobrun > 0) { eobrun--; continue; }
            int k = ss;
            while (k <= se) {
                if (r.nbits < 27) r.fill();
                if (r.nbits >= 12) {
                    uint32_t ent = aclut.e[(r.acc >> (r.nbits - 12)) & 0xFFF];
                    int tl = (int)(ent & 0xFF);
                    if (tl && tl <= r.nbits) {
                        r.nbits -= tl;
                        uint32_t run = (ent >> 8) & 0xFF;
                        if (run == 0xFE) { k += 16; continue; }   // ZRL
                        if (run == 0xFF) {                        // EOB/EOBn
                            int ebr = (int)(int16_t)(ent >> 16);
                            eobrun = ((int64_t)1 << ebr) - 1;
                            if (ebr) eobrun += r.read_bits(ebr);
                            break;
                        }
                        k += (int)run;
                        if (k > se) return -1;
                        block[k] = (int16_t)((int)(int16_t)(ent >> 16) << al);
                        k++;
                        continue;
                    }
                }
                int rs = r.decode(act);
                if (rs < 0) return -1;
                int run = rs >> 4, size = rs & 0x0F;
                if (size == 0) {
                    if (run == 15) { k += 16; continue; }
                    eobrun = ((int64_t)1 << run) - 1;
                    if (run) eobrun += r.read_bits(run);
                    break;
                }
                k += run;
                if (k > se) return -1;
                block[k] = (int16_t)(extend(r.read_bits(size), size) << al);
                k++;
            }
        } else {  // refinement pass (G.1.2.3)
            int k = ss;
            if (eobrun == 0) {
                while (k <= se) {
                    int rs = r.decode(act);
                    if (rs < 0) return -1;
                    int run = rs >> 4, size = rs & 0x0F;
                    int val = 0;
                    if (size == 0) {
                        if (run < 15) {
                            eobrun = (int64_t)1 << run;
                            if (run) eobrun += r.read_bits(run);
                            break;
                        }
                        // run == 15: ZRL — pass 16 zero-history coefficients
                    } else {
                        if (size != 1) return -1;
                        val = r.read_bit() ? p1 : m1;
                    }
                    while (k <= se) {
                        if (block[k] != 0) {
                            if (r.read_bit() && (block[k] & p1) == 0)
                                block[k] = (int16_t)(block[k] + (block[k] > 0 ? p1 : m1));
                        } else {
                            if (run == 0) break;
                            run--;
                        }
                        k++;
                    }
                    if (val) {
                        if (k > se) return -1;
                        block[k] = (int16_t)val;
                    }
                    k++;
                }
            }
            if (eobrun > 0) {
                while (k <= se) {
                    if (block[k] != 0) {
                        if (r.read_bit() && (block[k] & p1) == 0)
                            block[k] = (int16_t)(block[k] + (block[k] > 0 ? p1 : m1));
                    }
                    k++;
                }
                eobrun--;
            }
        }
        if (r.error) return -1;
    }
    *eobrun_io = eobrun;
    return 0;
}

// ============================ PNG unfilter ==================================
// Reverse per-row PNG filtering (parity with pixo src/decode/png.rs row
// reconstruction). Sub/Average/Paeth carry an intra-row recurrence, so the
// host handles them; rows arrive as [height, row_bytes+1] with the filter
// type byte leading each row.

#if defined(__AVX2__)
// Per-pixel SSE unfilter for the left-dependent filters at bpp 3/4: the
// o[i-bpp] dependence makes Sub/Average/Paeth serial per chain, so the
// scalar loops pay a store-to-load-forward latency per BYTE; widening
// the whole pixel into one 16-bit vector step pays it once per PIXEL
// (libpng's SSE2 unfilter uses the same shape). Stores write 4 bytes:
// for bpp=3 the 4th byte overlaps the next pixel and is recomputed by
// the following store (or the scalar tail), and the `i + 4 <= row_bytes`
// bound keeps every access inside the row.
namespace pngunf {

static inline __m128i load4w(const uint8_t* p) {
    int32_t v;
    memcpy(&v, p, 4);
    return _mm_unpacklo_epi8(_mm_cvtsi32_si128(v), _mm_setzero_si128());
}

static inline void store4(uint8_t* p, __m128i w16) {
    int32_t v = _mm_cvtsi128_si32(_mm_packus_epi16(w16, w16));
    memcpy(p, &v, 4);
}

// The left pixel rides in a register carry, never through memory: the
// result lanes (bytes i..i+3) ARE the next iteration's o[i'-bpp..] for
// both bpp 3 and 4 (i' = i + bpp). For bpp=3 lane 3 of each result is
// computed from a stale lane and is garbage — but it only ever feeds
// lane-3 outputs, every lane-3 store is overwritten by the next
// iteration's lane 0 (or the scalar tail), and the carry's lane 3
// likewise only feeds lane 3, so lanes 0..2 stay exact by induction.
// (A memory reload per pixel costs a partial-overlap store-forward
// stall; measured 1.5x SLOWER than scalar. The carry wins 2x.)
static inline __m128i carry_init(const uint8_t* o, int bpp) {
    int32_t v = 0;
    memcpy(&v, o, (size_t)(bpp < 4 ? bpp : 4));
    return _mm_unpacklo_epi8(_mm_cvtsi32_si128(v), _mm_setzero_si128());
}

static inline void sub_px(const uint8_t* f, uint8_t* o,
                          int64_t row_bytes, int bpp) {
    int64_t i = 0;
    for (; i < bpp; i++) o[i] = f[i];
    __m128i a = carry_init(o, bpp);
    const __m128i lo = _mm_set1_epi16(0xFF);
    for (; i + 4 <= row_bytes; i += bpp) {
        a = _mm_and_si128(_mm_add_epi16(a, load4w(f + i)), lo);
        store4(o + i, a);
    }
    for (; i < row_bytes; i++) o[i] = (uint8_t)(f[i] + o[i - bpp]);
}

static inline void avg_px(const uint8_t* f, const uint8_t* prev, uint8_t* o,
                          int64_t row_bytes, int bpp) {
    int64_t i = 0;
    for (; i < bpp; i++) o[i] = (uint8_t)(f[i] + (prev[i] >> 1));
    __m128i a = carry_init(o, bpp);
    const __m128i lo = _mm_set1_epi16(0xFF);
    for (; i + 4 <= row_bytes; i += bpp) {
        __m128i t = _mm_srli_epi16(_mm_add_epi16(a, load4w(prev + i)), 1);
        a = _mm_and_si128(_mm_add_epi16(load4w(f + i), t), lo);
        store4(o + i, a);
    }
    for (; i < row_bytes; i++)
        o[i] = (uint8_t)(f[i] + ((o[i - bpp] + prev[i]) >> 1));
}

static inline void paeth_px(const uint8_t* f, const uint8_t* prev, uint8_t* o,
                            int64_t row_bytes, int bpp) {
    int64_t i = 0;
    for (; i < bpp; i++) o[i] = (uint8_t)(f[i] + prev[i]);  // a=c=0 -> pred=b
    __m128i a = carry_init(o, bpp);
    const __m128i lo = _mm_set1_epi16(0xFF);
    for (; i + 4 <= row_bytes; i += bpp) {
        __m128i b = load4w(prev + i);
        __m128i c = load4w(prev + i - bpp);
        // p - a = b - c, p - b = a - c, p - c = (a - c) + (b - c)
        __m128i bc = _mm_sub_epi16(b, c);
        __m128i ac = _mm_sub_epi16(a, c);
        __m128i pa = _mm_abs_epi16(bc);
        __m128i pb = _mm_abs_epi16(ac);
        __m128i pc = _mm_abs_epi16(_mm_add_epi16(ac, bc));
        __m128i not_a = _mm_or_si128(_mm_cmpgt_epi16(pa, pb),
                                     _mm_cmpgt_epi16(pa, pc));
        __m128i b_over_c = _mm_cmpgt_epi16(pb, pc);  // pb > pc -> c
        __m128i pred = _mm_blendv_epi8(b, c, b_over_c);
        pred = _mm_blendv_epi8(a, pred, not_a);
        a = _mm_and_si128(_mm_add_epi16(load4w(f + i), pred), lo);
        store4(o + i, a);
    }
    for (; i < row_bytes; i++) {
        int a2 = o[i - bpp], b = prev[i], c = prev[i - bpp];
        int p = a2 + b - c;
        int pa = p > a2 ? p - a2 : a2 - p;
        int pb = p > b ? p - b : b - p;
        int pc = p > c ? p - c : c - p;
        o[i] = (uint8_t)(f[i] + ((pa <= pb && pa <= pc) ? a2 : (pb <= pc ? b : c)));
    }
}

}  // namespace pngunf
#endif  // __AVX2__

EXPORT int32_t png_unfilter(const uint8_t* rows, int64_t height,
                            int64_t row_bytes, int32_t bpp, uint8_t* out) {
    std::vector<uint8_t> zero(row_bytes, 0);
    const uint8_t* prev = zero.data();
#if defined(__AVX2__)
    const bool px_simd = (bpp == 3 || bpp == 4) && row_bytes >= 2 * bpp + 4;
#endif
    for (int64_t y = 0; y < height; y++) {
        const uint8_t* src = rows + y * (row_bytes + 1);
        uint8_t ftype = src[0];
        const uint8_t* f = src + 1;
        uint8_t* o = out + y * row_bytes;
        switch (ftype) {
            case 0:
                memcpy(o, f, row_bytes);
                break;
            case 1:  // Sub
#if defined(__AVX2__)
                if (px_simd) { pngunf::sub_px(f, o, row_bytes, bpp); break; }
#endif
                for (int64_t i = 0; i < row_bytes; i++) {
                    uint8_t left = (i >= bpp) ? o[i - bpp] : 0;
                    o[i] = (uint8_t)(f[i] + left);
                }
                break;
            case 2:  // Up
                for (int64_t i = 0; i < row_bytes; i++) o[i] = (uint8_t)(f[i] + prev[i]);
                break;
            case 3:  // Average
#if defined(__AVX2__)
                if (px_simd) { pngunf::avg_px(f, prev, o, row_bytes, bpp); break; }
#endif
                for (int64_t i = 0; i < row_bytes; i++) {
                    int left = (i >= bpp) ? o[i - bpp] : 0;
                    o[i] = (uint8_t)(f[i] + ((left + prev[i]) >> 1));
                }
                break;
            case 4:  // Paeth
#if defined(__AVX2__)
                if (px_simd) { pngunf::paeth_px(f, prev, o, row_bytes, bpp); break; }
#endif
                for (int64_t i = 0; i < row_bytes; i++) {
                    int a = (i >= bpp) ? o[i - bpp] : 0;
                    int b = prev[i];
                    int c = (i >= bpp) ? prev[i - bpp] : 0;
                    int p = a + b - c;
                    int pa = p > a ? p - a : a - p;
                    int pb = p > b ? p - b : b - p;
                    int pc = p > c ? p - c : c - p;
                    int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    o[i] = (uint8_t)(f[i] + pred);
                }
                break;
            default:
                return -1;
        }
        prev = o;
    }
    return 0;
}

// Indexed-PNG palette expansion (decode): gather a 256-entry LUT over the
// sample plane. The caller pre-pads the LUT to 256 rows (out-of-range
// indices land on the padding = opaque black, reference parity with
// src/decode/png.rs:492-530), so the loop is a pure gather — NumPy's
// 2D fancy-indexing equivalent ran ~30x slower. lut is [256, 4] RGBA
// (channels==3 reads only rgb from each row).
EXPORT void png_palette_expand(const uint8_t* idx, int64_t n,
                               const uint8_t* lut, int32_t channels,
                               uint8_t* out) {
    uint32_t lut32[256];
    memcpy(lut32, lut, sizeof(lut32));
    if (channels == 4) {
        uint32_t* o = (uint32_t*)out;
        for (int64_t i = 0; i < n; i++) o[i] = lut32[idx[i]];
        return;
    }
    // 3-channel: overlapping 4-byte stores (each write's 4th byte is
    // overwritten by the next pixel); the final pixel is written exactly.
    int64_t i = 0;
    for (; i + 1 < n; i++)
        memcpy(out + i * 3, &lut32[idx[i]], 4);
    if (n) memcpy(out + i * 3, &lut32[idx[i]], 3);
}

// ---------------------------------------------------------------------------
// Forward PNG filtering: the host tier of the filter bank. Bit-identical to
// the device kernels in pixo_tpu/ops/png_filters.py (same candidates, same
// signed-abs scores, same selection rules as the reference's
// adaptive_filter / adaptive_filter_fast / bigrams_filter,
// pixo src/png/filter.rs:302-527). Used for single-image encodes where a
// device round-trip costs more than the filtering itself; the fused device
// dispatch remains the batch path.
// ---------------------------------------------------------------------------

namespace pngfilter {

// AVX2 tier for the hot per-byte loops (the analog of the reference's
// hand-written SIMD filters, src/simd/x86_64.rs:601-1009). All-integer, so
// bit-identical to the scalar fallbacks below by construction.
#ifdef __AVX2__
static inline __m256i paeth_pred_epi16(__m256i a, __m256i b, __m256i c) {
    __m256i p = _mm256_sub_epi16(_mm256_add_epi16(a, b), c);
    __m256i pa = _mm256_abs_epi16(_mm256_sub_epi16(p, a));
    __m256i pb = _mm256_abs_epi16(_mm256_sub_epi16(p, b));
    __m256i pc = _mm256_abs_epi16(_mm256_sub_epi16(p, c));
    // pred = (pa<=pb && pa<=pc) ? a : (pb<=pc ? b : c)
    __m256i not_a = _mm256_or_si256(_mm256_cmpgt_epi16(pa, pb),
                                    _mm256_cmpgt_epi16(pa, pc));
    __m256i bc = _mm256_blendv_epi8(b, c, _mm256_cmpgt_epi16(pb, pc));
    return _mm256_blendv_epi8(a, bc, not_a);
}

static inline void paeth_avx2(const uint8_t* cur, const uint8_t* prev,
                              int64_t rb, int bpp, uint8_t* out) {
    int64_t i = bpp;
    const __m256i mask_ff = _mm256_set1_epi16(0xFF);
    for (; i + 32 <= rb; i += 32) {
        __m256i x = _mm256_loadu_si256((const __m256i*)(cur + i));
        __m256i A = _mm256_loadu_si256((const __m256i*)(cur + i - bpp));
        __m256i B = _mm256_loadu_si256((const __m256i*)(prev + i));
        __m256i C = _mm256_loadu_si256((const __m256i*)(prev + i - bpp));
        __m256i x0 = _mm256_cvtepu8_epi16(_mm256_castsi256_si128(x));
        __m256i x1 = _mm256_cvtepu8_epi16(_mm256_extracti128_si256(x, 1));
        __m256i p0 = paeth_pred_epi16(
            _mm256_cvtepu8_epi16(_mm256_castsi256_si128(A)),
            _mm256_cvtepu8_epi16(_mm256_castsi256_si128(B)),
            _mm256_cvtepu8_epi16(_mm256_castsi256_si128(C)));
        __m256i p1 = paeth_pred_epi16(
            _mm256_cvtepu8_epi16(_mm256_extracti128_si256(A, 1)),
            _mm256_cvtepu8_epi16(_mm256_extracti128_si256(B, 1)),
            _mm256_cvtepu8_epi16(_mm256_extracti128_si256(C, 1)));
        __m256i r0 = _mm256_and_si256(_mm256_sub_epi16(x0, p0), mask_ff);
        __m256i r1 = _mm256_and_si256(_mm256_sub_epi16(x1, p1), mask_ff);
        __m256i packed = _mm256_permute4x64_epi64(
            _mm256_packus_epi16(r0, r1), 0xD8);
        _mm256_storeu_si256((__m256i*)(out + i), packed);
    }
    for (; i < rb; i++) {
        int a = cur[i - bpp], b = prev[i], c = prev[i - bpp];
        int p = a + b - c;
        int pa = p > a ? p - a : a - p;
        int pb = p > b ? p - b : b - p;
        int pc = p > c ? p - c : c - p;
        int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
        out[i] = (uint8_t)(cur[i] - pred);
    }
}

static inline void average_avx2(const uint8_t* cur, const uint8_t* prev,
                                int64_t rb, int bpp, uint8_t* out) {
    int64_t i = bpp;
    const __m256i one = _mm256_set1_epi8(1);
    for (; i + 32 <= rb; i += 32) {
        __m256i x = _mm256_loadu_si256((const __m256i*)(cur + i));
        __m256i a = _mm256_loadu_si256((const __m256i*)(cur + i - bpp));
        __m256i b = _mm256_loadu_si256((const __m256i*)(prev + i));
        // floor avg: avg_epu8 rounds up, subtract the carry bit
        __m256i fl = _mm256_sub_epi8(
            _mm256_avg_epu8(a, b),
            _mm256_and_si256(_mm256_xor_si256(a, b), one));
        _mm256_storeu_si256((__m256i*)(out + i), _mm256_sub_epi8(x, fl));
    }
    for (; i < rb; i++)
        out[i] = (uint8_t)(cur[i] - ((cur[i - bpp] + prev[i]) >> 1));
}
#endif

static inline void filter_row(int f, const uint8_t* cur, const uint8_t* prev,
                              int64_t rb, int bpp, uint8_t* out) {
    switch (f) {
        case 0:
            memcpy(out, cur, (size_t)rb);
            break;
        case 1:  // Sub
            for (int64_t i = 0; i < bpp && i < rb; i++) out[i] = cur[i];
            for (int64_t i = bpp; i < rb; i++)
                out[i] = (uint8_t)(cur[i] - cur[i - bpp]);
            break;
        case 2:  // Up
            for (int64_t i = 0; i < rb; i++) out[i] = (uint8_t)(cur[i] - prev[i]);
            break;
        case 3:  // Average
            for (int64_t i = 0; i < bpp && i < rb; i++)
                out[i] = (uint8_t)(cur[i] - (prev[i] >> 1));
#ifdef __AVX2__
            average_avx2(cur, prev, rb, bpp, out);
#else
            for (int64_t i = bpp; i < rb; i++)
                out[i] = (uint8_t)(cur[i] - ((cur[i - bpp] + prev[i]) >> 1));
#endif
            break;
        default: {  // Paeth
            for (int64_t i = 0; i < bpp && i < rb; i++)
                out[i] = (uint8_t)(cur[i] - prev[i]);  // a=c=0 -> pred=b
#ifdef __AVX2__
            paeth_avx2(cur, prev, rb, bpp, out);
#else
            for (int64_t i = bpp; i < rb; i++) {
                int a = cur[i - bpp], b = prev[i], c = prev[i - bpp];
                int p = a + b - c;
                int pa = p > a ? p - a : a - p;
                int pb = p > b ? p - b : b - p;
                int pc = p > c ? p - c : c - p;
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                out[i] = (uint8_t)(cur[i] - pred);
            }
#endif
            break;
        }
    }
}

// sum of |byte as i8| (the reference's minimum-sum-of-absolute-differences
// heuristic, score_filter src/png/filter.rs:614-627). AVX2: |int8| via
// abs_epi8 (|-128| stays 0x80 = 128 unsigned, which IS min(b, 256-b) for
// b=128), summed with SAD against zero — the reference's exact trick
// (src/simd/x86_64.rs:569).
static inline int64_t signed_abs_score(const uint8_t* row, int64_t rb) {
    int64_t i = 0, s = 0;
#ifdef __AVX2__
    __m256i acc = _mm256_setzero_si256();
    const __m256i zero = _mm256_setzero_si256();
    for (; i + 32 <= rb; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(row + i));
        acc = _mm256_add_epi64(acc, _mm256_sad_epu8(_mm256_abs_epi8(v), zero));
    }
    alignas(32) int64_t lanes[4];
    _mm256_store_si256((__m256i*)lanes, acc);
    s = lanes[0] + lanes[1] + lanes[2] + lanes[3];
#endif
    for (; i < rb; i++) {
        int b = row[i];
        s += b < 128 ? b : 256 - b;
    }
    return s;
}

}  // namespace pngfilter

// mode: 0-4 fixed filter id; 5 adaptive/min-sum (early stop rb/4+1);
//       6 adaptive-fast (Sub/Up/Paeth, early stop rb/8+1, optional sticky);
//       7 bigrams (fewest distinct consecutive byte pairs).
// out: height x (row_bytes+1) rows, leading byte = chosen filter id.
EXPORT int32_t png_filter_apply(const uint8_t* data, int64_t height,
                                int64_t row_bytes, int32_t bpp, int32_t mode,
                                int32_t sticky, uint8_t* out) {
    using pngfilter::filter_row;
    using pngfilter::signed_abs_score;
    const int64_t rb = row_bytes;
    if (height <= 0 || rb <= 0 || bpp <= 0) return -1;
    std::vector<uint8_t> zero(rb, 0);
    std::vector<uint8_t> tmp((size_t)rb * 5);
    // bigram distinct-count scratch: stamp array over 2^16 pair keys
    std::vector<int32_t> marks;
    int32_t gen = 0;
    if (mode == 7) marks.assign(65536, -1);

    int sticky_id = -1;
    for (int64_t y = 0; y < height; y++) {
        const uint8_t* cur = data + y * rb;
        const uint8_t* prev = y == 0 ? zero.data() : data + (y - 1) * rb;
        uint8_t* orow = out + y * (rb + 1);
        int chosen;
        if (mode <= 4) {
            chosen = mode;
            filter_row(chosen, cur, prev, rb, bpp, orow + 1);
        } else if (mode == 6 && sticky_id >= 0) {
            chosen = sticky_id;
            filter_row(chosen, cur, prev, rb, bpp, orow + 1);
        } else if (mode == 5) {
            // reference adaptive_filter: try None,Sub,Up,Avg,Paeth in order,
            // keep strict improvements, stop early at <= rb/4+1
            const int64_t early = rb / 4 + 1;
            int64_t best = INT64_MAX;
            chosen = 0;
            for (int f = 0; f < 5; f++) {
                uint8_t* buf = tmp.data() + (size_t)f * rb;
                filter_row(f, cur, prev, rb, bpp, buf);
                int64_t s = signed_abs_score(buf, rb);
                if (s < best) { best = s; chosen = f; }
                if (best <= early) break;
            }
            memcpy(orow + 1, tmp.data() + (size_t)chosen * rb, (size_t)rb);
        } else if (mode == 6) {
            // reference adaptive_filter_fast: Sub, Up, Paeth; early rb/8+1
            const int64_t early = rb / 8 + 1;
            uint8_t* b1 = tmp.data() + (size_t)1 * rb;
            uint8_t* b2 = tmp.data() + (size_t)2 * rb;
            uint8_t* b4 = tmp.data() + (size_t)4 * rb;
            filter_row(1, cur, prev, rb, bpp, b1);
            int64_t s1 = signed_abs_score(b1, rb);
            if (s1 <= early) {
                chosen = 1;
            } else {
                filter_row(2, cur, prev, rb, bpp, b2);
                int64_t s2 = signed_abs_score(b2, rb);
                int best12 = s2 < s1 ? 2 : 1;
                int64_t sb12 = s2 < s1 ? s2 : s1;
                if (sb12 <= early) {
                    chosen = best12;
                } else {
                    filter_row(4, cur, prev, rb, bpp, b4);
                    int64_t s4 = signed_abs_score(b4, rb);
                    chosen = s4 < sb12 ? 4 : best12;
                }
            }
            memcpy(orow + 1, tmp.data() + (size_t)chosen * rb, (size_t)rb);
            if (sticky) sticky_id = chosen;
        } else if (mode == 7) {
            // reference bigrams_filter: fewest distinct consecutive pairs
            int64_t best = INT64_MAX;
            chosen = 0;
            for (int f = 0; f < 5; f++) {
                uint8_t* buf = tmp.data() + (size_t)f * rb;
                filter_row(f, cur, prev, rb, bpp, buf);
                int64_t distinct = 0;
                gen++;
                for (int64_t i = 0; i + 1 < rb; i++) {
                    uint32_t key = ((uint32_t)buf[i] << 8) | buf[i + 1];
                    if (marks[key] != gen) {
                        marks[key] = gen;
                        distinct++;
                    }
                }
                if (distinct < best) { best = distinct; chosen = f; }
            }
            filter_row(chosen, cur, prev, rb, bpp, orow + 1);
        } else {
            return -1;
        }
        orow[0] = (uint8_t)chosen;
    }
    return 0;
}

// =============================== DEFLATE ====================================

namespace deflate {

struct LsbWriter {
    uint8_t* out;
    int64_t cap, pos;
    uint64_t acc;
    int nbits;
    bool overflow;

    LsbWriter(uint8_t* o, int64_t c) : out(o), cap(c), pos(0), acc(0), nbits(0), overflow(false) {}

    inline void write(uint32_t value, int bits) {
        acc |= (uint64_t)(value & ((1u << bits) - 1)) << nbits;
        nbits += bits;
        if (nbits >= 32) {
            if (pos + 4 > cap) { overflow = true; nbits = 0; return; }
            uint32_t lo = (uint32_t)acc;
            memcpy(out + pos, &lo, 4);
            pos += 4;
            acc >>= 32;
            nbits -= 32;
        }
    }

    // byte-granular fast path: push() accumulates without checks (caller
    // guarantees nbits + bits <= 64), flush_bytes() retires whole bytes
    // with ONE 8-byte store and leaves nbits < 8. Mixes freely with
    // write(): both keep bit order LSB-first in acc.
    inline void push(uint64_t value, int bits) {
        acc |= value << nbits;
        nbits += bits;
    }
    inline void flush_bytes() {
        if (pos + 8 > cap) { overflow = true; nbits &= 7; return; }
        memcpy(out + pos, &acc, 8);
        int adv = nbits >> 3;
        pos += adv;
        acc >>= adv * 8;
        nbits &= 7;
    }

    inline void flush() {
        while (nbits > 0) {
            if (pos >= cap) { overflow = true; nbits = 0; return; }
            out[pos++] = (uint8_t)acc;
            acc >>= 8;
            nbits -= 8;
        }
        acc = 0;
        nbits = 0;
    }

    inline void raw_bytes(const uint8_t* b, int64_t n) {
        if (pos + n > cap) { overflow = true; return; }
        memcpy(out + pos, b, n);
        pos += n;
    }
};

// length code tables (RFC 1951 3.2.5)
static const int LEN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,35,43,51,59,
                                 67,83,99,115,131,163,195,227,258};
static const int LEN_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,4,4,5,5,5,5,0};
static const int DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,257,385,513,769,
                                  1025,1537,2049,3073,4097,6145,8193,12289,16385,24577};
static const int DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,9,10,10,11,11,12,12,13,13};

static uint8_t len_to_sym[259];   // length 3..258 -> symbol 257..285 (stored as sym-257)
static uint8_t len_extra_bits[259];
static uint16_t len_extra_val[259];
// zlib-style distance-symbol lookup: d in [1,256] indexes the low half
// directly, larger distances index the high half by (d-1)>>7 (every
// symbol >= 16 spans a multiple of 128). Replaces a 5-step binary
// search on the emit/histogram hot paths (~3 lookups per match token).
static uint8_t dist_sym_lut[512];
static bool tables_init_done = false;

static void tables_init() {
    if (tables_init_done) return;
    for (int s = 0; s < 29; s++) {
        int lo = LEN_BASE[s];
        int hi = (s == 28) ? 258 : LEN_BASE[s + 1] - 1;
        for (int l = lo; l <= hi && l <= 258; l++) {
            len_to_sym[l] = (uint8_t)s;
            len_extra_bits[l] = (uint8_t)LEN_EXTRA[s];
            len_extra_val[l] = (uint16_t)(l - lo);
        }
    }
    {
        auto sym_of = [](int d) {
            int lo = 0, hi = 29;
            while (lo < hi) {
                int mid = (lo + hi + 1) >> 1;
                if (DIST_BASE[mid] <= d) lo = mid; else hi = mid - 1;
            }
            return lo;
        };
        for (int d = 1; d <= 256; d++) dist_sym_lut[d - 1] = (uint8_t)sym_of(d);
        for (int k = 0; k < 256; k++)
            dist_sym_lut[256 + k] = (uint8_t)sym_of((k << 7) + 1);
    }
    tables_init_done = true;
}

static inline int dist_symbol(int d) {
    if (d < 1) return 0;  // defensive: matches the old search's d<=0 result
    return d <= 256 ? dist_sym_lut[d - 1] : dist_sym_lut[256 + ((d - 1) >> 7)];
}

// ---- canonical huffman with length limit ----

// Length-limited Huffman code lengths via package-merge: provably optimal
// under the limit and always *exactly complete* (Kraft sum == 1), which
// DEFLATE decoders require for the literal and code-length alphabets.
// Singleton alphabets get a dummy second 1-bit code.
//
// Counting formulation (no per-item symbol lists): each merge level is a
// flat (weight, is_package) array; packages are formed from consecutive
// pairs in order, so the 2m-2 items taken at the top expand level by
// level into a PREFIX of each lower level's merged list, and the taken
// singletons of a level are exactly its s smallest symbols. lengths of
// sorted symbol j = number of levels whose prefix covers > j singletons.
// Composition (singleton-preferred tie merge, (weight, sym) sort) is
// identical to the list-based construction, so outputs are bit-equal,
// without the O(n*L^2) symbol-list copies and per-package allocations.
static void build_lengths(const uint64_t* freq, int n, int max_len, uint8_t* lengths) {
    // Package-merge, output-identical to the previous vector-of-vectors
    // implementation (same sort order, same singleton-preferred tie break,
    // same top-down expansion) but on flat thread-local arrays: one
    // allocation lifetime, no per-level clear/reserve churn — this runs
    // ~600 times per 3 MiB deflate (once per split block per tree).
    memset(lengths, 0, n);
    static thread_local std::vector<std::pair<uint64_t, int>> items_tl;
    items_tl.clear();
    for (int i = 0; i < n; i++)
        if (freq[i]) items_tl.push_back({freq[i], i});
    auto& items = items_tl;
    if (items.empty()) return;
    if (items.size() == 1) {
        int sym = items[0].second;
        lengths[sym] = 1;
        lengths[sym == 0 ? 1 : 0] = 1;
        return;
    }
    std::sort(items.begin(), items.end());
    int m = (int)items.size();

    // per-level rows live in one flat arena: a row holds all m singletons
    // plus up to prev/2 packages, so row lengths approach 2m from below
    const int cap = 2 * m + 2;
    static thread_local std::vector<uint64_t> w_arena;
    static thread_local std::vector<uint8_t> pkg_arena;
    static thread_local std::vector<int> row_len;
    if ((int64_t)w_arena.size() < (int64_t)max_len * cap) {
        w_arena.resize((size_t)max_len * cap);
        pkg_arena.resize((size_t)max_len * cap);
    }
    if ((int)row_len.size() < max_len) row_len.resize(max_len);

    uint64_t* w0 = w_arena.data();
    for (int i = 0; i < m; i++) w0[i] = items[i].first;
    row_len[0] = m;
    const std::pair<uint64_t, int>* its = items.data();
    for (int level = 1; level < max_len; level++) {
        const uint64_t* prev = w_arena.data() + (size_t)(level - 1) * cap;
        int npk = row_len[level - 1] / 2;
        uint64_t* out = w_arena.data() + (size_t)level * cap;
        uint8_t* opk = pkg_arena.data() + (size_t)level * cap;
        int a = 0, b = 0, o = 0;
        while (a < m && b < npk) {
            uint64_t pw = prev[2 * b] + prev[2 * b + 1];
            if (its[a].first <= pw) {
                out[o] = its[a++].first;
                opk[o++] = 0;
            } else {
                out[o] = pw;
                opk[o++] = 1;
                b++;
            }
        }
        while (a < m) { out[o] = its[a++].first; opk[o++] = 0; }
        while (b < npk) {
            out[o] = prev[2 * b] + prev[2 * b + 1];
            opk[o++] = 1;
            b++;
        }
        row_len[level] = o;
    }
    // top-down prefix expansion: count taken singletons per level
    size_t take = (size_t)(2 * m - 2);
    for (int level = max_len - 1; level >= 1 && take > 0; level--) {
        const uint8_t* pk = pkg_arena.data() + (size_t)level * cap;
        size_t t = std::min(take, (size_t)row_len[level]);
        size_t packages = 0;
        for (size_t i = 0; i < t; i++) packages += pk[i];
        size_t singles = t - packages;
        for (size_t j = 0; j < singles; j++) lengths[items[j].second]++;
        take = 2 * packages;
    }
    if (take > 0) {  // level 0: all singletons
        size_t t = std::min(take, (size_t)m);
        for (size_t j = 0; j < t; j++) lengths[items[j].second]++;
    }
}

// ---- reference-parity Huffman build (heap + Kraft repair) ----
// Exact mirror of the reference's build_codes length derivation
// (pixo src/compress/huffman.rs:48-205): a
// BinaryHeap<Reverse<Node>> ordered by (frequency, symbol) where internal
// nodes (symbol=None) order before any leaf of equal frequency, including
// Rust std's heap mechanics — FromIterator heapify (sift_down per parent,
// right child preferred on ties), push via sift_up (strict-greater climbs),
// pop via sift_down_to_bottom (hole runs to a leaf, then sifts up) — so
// nodes that compare Equal (two internal nodes of the same frequency)
// merge in the reference's exact order.  Then the reference's
// limit_code_lengths: truncate to max_len, repair the Kraft sum by
// lengthening the first-shortest / shortening the first-longest code.
// Unlike package-merge this is NOT optimal under the limit — that is the
// point: bit-identical dynamic tables in parity mode.  Singletons get a
// single 1-bit code (no dummy), also per the reference.
static thread_local bool g_ref_huffman = false;

namespace refhuff {

struct HNode {
    uint64_t freq;
    int32_t sym;  // -1 = internal (None), orders before all leaves
    int32_t l, r;
};

struct RustHeap {
    std::vector<int32_t> data;
    const std::vector<HNode>* arena;

    // heap-order "a strictly greater than b" for Reverse(Node):
    // true iff node(a) < node(b) under (freq, sym) lexicographic order.
    inline bool gt(int32_t a, int32_t b) const {
        const HNode& x = (*arena)[a];
        const HNode& y = (*arena)[b];
        if (x.freq != y.freq) return x.freq < y.freq;
        return x.sym < y.sym;
    }

    void sift_up(size_t start, size_t pos) {
        int32_t elem = data[pos];
        while (pos > start) {
            size_t parent = (pos - 1) / 2;
            if (!gt(elem, data[parent])) break;
            data[pos] = data[parent];
            pos = parent;
        }
        data[pos] = elem;
    }

    void sift_down_range(size_t pos, size_t end) {
        int32_t elem = data[pos];
        size_t child = 2 * pos + 1;
        while (end >= 2 && child <= end - 2) {
            // pick the heap-greater child; the RIGHT one wins ties
            if (!gt(data[child], data[child + 1])) child += 1;
            if (!gt(data[child], elem)) { data[pos] = elem; return; }
            data[pos] = data[child];
            pos = child;
            child = 2 * pos + 1;
        }
        if (end >= 1 && child == end - 1 && gt(data[child], elem)) {
            data[pos] = data[child];
            pos = child;
        }
        data[pos] = elem;
    }

    void sift_down_to_bottom(size_t pos) {
        size_t end = data.size();
        size_t start = pos;
        int32_t elem = data[pos];
        size_t child = 2 * pos + 1;
        while (end >= 2 && child <= end - 2) {
            if (!gt(data[child], data[child + 1])) child += 1;
            data[pos] = data[child];
            pos = child;
            child = 2 * pos + 1;
        }
        if (end >= 1 && child == end - 1) {
            data[pos] = data[child];
            pos = child;
        }
        data[pos] = elem;
        sift_up(start, pos);
    }

    void heapify() {
        for (size_t n = data.size() / 2; n-- > 0;)
            sift_down_range(n, data.size());
    }

    void push(int32_t v) {
        data.push_back(v);
        sift_up(0, data.size() - 1);
    }

    int32_t pop() {  // caller guarantees non-empty
        int32_t last = data.back();
        data.pop_back();
        if (data.empty()) return last;
        int32_t top = data[0];
        data[0] = last;
        sift_down_to_bottom(0);
        return top;
    }
};

static void extract_depths(const std::vector<HNode>& arena, int32_t idx,
                           uint8_t depth, uint8_t* lengths) {
    const HNode& nd = arena[idx];
    if (nd.sym >= 0) {
        lengths[nd.sym] = depth > 1 ? depth : 1;
        return;
    }
    if (nd.l >= 0) extract_depths(arena, nd.l, depth + 1, lengths);
    if (nd.r >= 0) extract_depths(arena, nd.r, depth + 1, lengths);
}

// huffman.rs:127-205 verbatim
static void limit_lengths(uint8_t* lengths, int n, int max_len) {
    bool overflow = false;
    for (int i = 0; i < n; i++) overflow |= lengths[i] > max_len;
    if (!overflow) return;
    for (int i = 0; i < n; i++)
        if (lengths[i] > max_len) lengths[i] = (uint8_t)max_len;
    uint32_t kraft_limit = 1u << max_len;
    uint32_t kraft = 0;
    for (int i = 0; i < n; i++)
        if (lengths[i] > 0) kraft += 1u << (max_len - lengths[i]);
    while (kraft > kraft_limit) {
        int best_idx = -1;
        int best_len = max_len;
        for (int i = 0; i < n; i++) {
            if (lengths[i] > 0 && lengths[i] < max_len && lengths[i] < best_len) {
                best_len = lengths[i];
                best_idx = i;
            }
        }
        if (best_idx < 0) break;
        kraft -= 1u << (max_len - lengths[best_idx]);
        lengths[best_idx]++;
        kraft += 1u << (max_len - lengths[best_idx]);
    }
    while (kraft < kraft_limit) {
        int best_idx = -1;
        int best_len = 0;
        for (int i = 0; i < n; i++) {
            if (lengths[i] > 1 && lengths[i] > best_len) {
                best_len = lengths[i];
                best_idx = i;
            }
        }
        if (best_idx < 0) break;
        uint32_t oldc = 1u << (max_len - lengths[best_idx]);
        uint32_t newc = 1u << (max_len - (lengths[best_idx] - 1));
        if (kraft - oldc + newc <= kraft_limit) {
            kraft -= oldc;
            lengths[best_idx]--;
            kraft += newc;
        } else {
            break;
        }
    }
}

}  // namespace refhuff

static void ref_build_lengths(const uint64_t* freq, int n, int max_len,
                              uint8_t* lengths) {
    using namespace refhuff;
    memset(lengths, 0, n);
    std::vector<HNode> arena;
    RustHeap heap;
    heap.arena = &arena;
    for (int i = 0; i < n; i++)
        if (freq[i]) {
            heap.data.push_back((int32_t)arena.size());
            arena.push_back({freq[i], i, -1, -1});
        }
    if (arena.empty()) return;
    if (arena.size() == 1) {
        lengths[arena[0].sym] = 1;  // single symbol: no dummy (huffman.rs:66-71)
        return;
    }
    heap.heapify();
    while (heap.data.size() > 1) {
        int32_t left = heap.pop();
        int32_t right = heap.pop();
        int32_t parent = (int32_t)arena.size();
        arena.push_back({arena[left].freq + arena[right].freq, -1, left, right});
        heap.push(parent);
    }
    extract_depths(arena, heap.pop(), 0, lengths);
    limit_lengths(lengths, n, max_len);
}

static void lengths_to_codes(const uint8_t* lengths, int n, uint16_t* codes) {
    int bl_count[16] = {0};
    for (int i = 0; i < n; i++) bl_count[lengths[i]]++;
    bl_count[0] = 0;
    uint16_t next[16];
    uint16_t code = 0;
    for (int b = 1; b < 16; b++) { code = (uint16_t)((code + bl_count[b - 1]) << 1); next[b] = code; }
    for (int i = 0; i < n; i++) {
        if (!lengths[i]) { codes[i] = 0; continue; }
        uint16_t c = next[lengths[i]]++;
        // bit-reverse to LSB-first transmission order
        uint16_t r = 0;
        for (int b = 0; b < lengths[i]; b++) { r = (uint16_t)((r << 1) | (c & 1)); c >>= 1; }
        codes[i] = r;
    }
}

// fixed tables
static uint8_t fixed_lit_len[288];
static uint16_t fixed_lit_code[288];
static uint8_t fixed_dist_len[30];
static uint16_t fixed_dist_code[30];
static bool fixed_init_done = false;

static void fixed_init() {
    if (fixed_init_done) return;
    for (int i = 0; i < 288; i++)
        fixed_lit_len[i] = (i < 144) ? 8 : (i < 256) ? 9 : (i < 280) ? 7 : 8;
    lengths_to_codes(fixed_lit_len, 288, fixed_lit_code);
    for (int i = 0; i < 30; i++) fixed_dist_len[i] = 5;
    lengths_to_codes(fixed_dist_len, 30, fixed_dist_code);
    fixed_init_done = true;
}

// Eager init at library load: len_to_sym & co. are consumed by the
// split-search cost oracle (TokenRangeCost) *before* the first emit_block
// would lazily build them, so lazy-only init made the first deflate call
// of a process run its block-split search on an all-zero LUT (every match
// length -> symbol 257): valid output, but different split decisions than
// every subsequent call. Constructor-time init removes the ordering hazard
// for all entry points; the lazy calls stay as harmless no-ops.
__attribute__((constructor)) static void deflate_tables_eager_init() {
    fixed_init();
    tables_init();
}

// token: literal -> 0..255 in low bits with flag; match -> len(9b) dist(15b)
struct Token { uint32_t v; };  // bit31: is_match; match: len in 30..22? simpler below
static inline Token lit_token(uint8_t b) { return {b}; }
static inline Token match_token(int len, int dist) {
    return {0x80000000u | ((uint32_t)len << 16) | (uint32_t)dist};
}

struct Lz77Config { int chain, depth_cap, nice, lazy; };

static Lz77Config config_for_level(int level) {
    // pixo's level table (src/compress/lz77.rs:1415-1488):
    // {max_chain_length, max_search_depth, nice_length, lazy kind}; the
    // effective walk limit is min(chain, depth) like the reference's
    // chain_limit.min(max_search_depth). Levels 2 and 6 (the fast/balanced
    // preset workhorses) keep deeper search + higher nice cutoffs than the
    // reference: its {8,6,10}/{128,35,65} lose 18-32% to zlib on
    // interleaved mostly-zero residual rows (row-period matches sit deeper
    // than 35 in the zero-gram chain), which is exactly the content PNG
    // filtering emits — see test_ratio_competitive_on_filtered_rows.
    switch (level) {
        case 1: return {4, 4, 32, 0};
        case 2: return {8, 8, 48, 0};
        case 3: return {16, 12, 14, 0};
        case 4: return {32, 16, 30, 0};
        case 5: return {64, 16, 30, 1};
        case 6: return {128, 128, 128, 1};
        case 7: return {256, 100, 130, 1};
        case 8: return {1024, 300, 258, 2};
        default: return {4096, 600, 258, 2};
    }
}

static const int WINDOW = 32768;
static const int WMASK = WINDOW - 1;  // prev ring index mask
static const int MIN_MATCH = 3;
static const int MAX_MATCH = 258;
static const int HASH_BITS = 16;
static const int HASH_SIZE = 1 << HASH_BITS;
static const int HASH3_BITS = 15;  // secondary 3-byte table (parity with
static const int HASH3_SIZE = 1 << HASH3_BITS;  // pixo's 2^15 h3 table)

static inline uint32_t hash4(const uint8_t* p) {
    uint32_t v;
    memcpy(&v, p, 4);
    return (v * 2654435761u) >> (32 - HASH_BITS);
}

static inline uint32_t hash3(const uint8_t* p) {
    uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16);
    return (v * 2654435761u) >> (32 - HASH3_BITS);
}

__attribute__((always_inline))
static inline int match_length(const uint8_t* a, const uint8_t* b, int max) {
    int i = 0;
    while (i + 8 <= max) {
        uint64_t x, y;
        memcpy(&x, a + i, 8);
        memcpy(&y, b + i, 8);
        uint64_t diff = x ^ y;
        if (diff) return i + (__builtin_ctzll(diff) >> 3);
        i += 8;
    }
    while (i < max && a[i] == b[i]) i++;
    return i;
}

// Reusable per-thread matcher buffers (the pool analog of the reference's
// global Mutex<Deflater> pool, src/compress/deflate.rs:77-96). Hash heads
// are epoch-gated: a head entry is live only when its epoch stamp matches
// the current call's, so no per-call -1 fills of the 256 KiB head table or
// the O(len) prev array are needed (prev entries are only ever read for
// positions inserted this epoch, which wrote them first).
struct MatcherState {
    std::vector<int32_t> head, head3, prev;
};

// Length of the run of bytes equal to d[pos] starting at pos, capped at
// lim_abs (callers pass pos + min(cap, n - pos)). Word-at-a-time; replaces
// the precomputed zopfli-style same[] array: both consumers cap at
// MAX_MATCH anyway and runs are consumed wholesale by the RLE paths, so
// on-demand scans are amortized O(n) while the precompute wrote an O(n)
// u16 array per call (~0.8 ms per 512x512 image, pure memory traffic).
static inline int run_length_capped(const uint8_t* d, int64_t pos,
                                    int64_t lim_abs) {
    const uint8_t b = d[pos];
    int64_t e = pos + 1;
    while (e + 8 <= lim_abs) {
        uint64_t w;
        memcpy(&w, d + e, 8);
        uint64_t x = w ^ (0x0101010101010101ull * b);
        if (x) {
            e += (int64_t)(__builtin_ctzll(x) >> 3);
            return (int)(e - pos);
        }
        e += 8;
    }
    while (e < lim_abs && d[e] == b) e++;
    return (int)(e - pos);
}

static MatcherState& matcher_state() {
    static thread_local MatcherState st;
    return st;
}

struct Matcher {
    // head: 4-byte hash -> most recent pos (chained through prev);
    // head3: 3-byte hash -> most recent pos (no chain) for len-3 matches
    // whose 4th byte differs; same: run length of identical bytes starting
    // at pos, saturated at MAX_MATCH+1 (zopfli's `same` array, keeps the
    // dist-1 run seed O(1) over flat regions).
    std::unique_ptr<MatcherState> own;  // huge inputs skip the pool so the
                                        // thread-local footprint stays small
    MatcherState& st;
    const uint8_t* data;
    int64_t n;
    // head3 maintenance toggle: find() consults probe3 only when the
    // call's mml <= MIN_MATCH, so a greedy pass running at mml >= 4
    // (byte-diverse content) can skip the per-position head3 store
    // entirely — one random 128 KiB write per input byte of dead work.
    // Byte-neutral by construction: the table it stops refreshing is
    // never read at those mml values. The optimal parser always reads
    // probe3 and leaves this true.
    bool track3 = true;

    Matcher(const uint8_t* d, int64_t len)
        : own(len > (64 << 20) ? new MatcherState() : nullptr),
          st(own ? *own : matcher_state()), data(d), n(len) {
        if ((int64_t)st.prev.size() < WINDOW) {
            // prev is a WINDOW-sized ring (zlib-style): a chain walk only
            // ever reads prev[cand] for cand >= pos - WINDOW, and the one
            // position that could overwrite that slot (cand + WINDOW >=
            // pos) is never inserted before the read — find precedes
            // insert everywhere. The 128 KiB ring stays cache-resident
            // where the old O(len) absolute array (12.7 MB at 3 MiB
            // input) made every chain step a DRAM miss. Never cleared:
            // entries are only read for positions inserted this call,
            // which wrote them first.
            st.prev.resize(WINDOW);
        }
        if (st.head.empty()) {
            st.head.resize(HASH_SIZE);
            st.head3.resize(HASH3_SIZE);
        }
        memset(st.head.data(), 0xFF, HASH_SIZE * sizeof(int32_t));
        memset(st.head3.data(), 0xFF, HASH3_SIZE * sizeof(int32_t));
    }

    inline int32_t head4_at(uint32_t h) const { return st.head[h]; }
    inline int32_t head3_at(uint32_t h) const { return st.head3[h]; }

    inline void insert(int64_t pos) {
        if (track3 && pos + 3 <= n) st.head3[hash3(data + pos)] = (int32_t)pos;
        if (pos + 4 > n) return;
        uint32_t h = hash4(data + pos);
        st.prev[pos & WMASK] = st.head[h];
        st.head[h] = (int32_t)pos;
    }

    // Chain every position of a consumed match span [start, end): the
    // hot loop of match-heavy content (a 768 KiB filtered-gradient
    // stream is ~3k tokens but ~768k inserts). Bounds are hoisted and
    // the hash3 side table is refreshed only at the span's first and
    // final two positions: a mid-span probe3 hit needs a future len-3
    // match anchored strictly inside an already-matched span whose 4th
    // byte differs everywhere (else the hash4 chains cover it) — rare
    // enough that the bench battery (text/gradient-residual/
    // photo-residual/random + the PNG corpus rows) is byte-identical
    // with and without interior refreshes, while insert cost drops ~40%.
    inline void insert_span(int64_t start, int64_t end) {
        if (start >= end) return;
        int64_t e4 = std::min(end, n - 3);
        if (end - start <= 4) {
            // photo-class matches are 3-6 bytes: the span is 2-5 inserts
            // and the 5-per-8-bytes machinery below costs more than it
            // saves. Plain per-position inserts, same stores, same order.
            for (int64_t p = start; p < end && p < n; p++) insert(p);
            return;
        }
        int32_t* prev = st.prev.data();
        int32_t* head = st.head.data();
        int32_t* head3p = st.head3.data();
        if (end - start <= 128) {
            // short span: full refresh (photo-class residuals are mostly
            // short matches between literal runs; keeping head3 exact
            // there costs little and keeps their bytes unchanged).
            // One 8-byte load feeds 5 positions: hash4 reads the low 4
            // bytes of the shifting register, hash3 the low 3.
            int64_t p = start;
            for (; p + 5 <= e4; ) {
                uint64_t w8;
                memcpy(&w8, data + p, 8);
                for (int k = 0; k < 5; k++, p++, w8 >>= 8) {
                    if (track3)
                        head3p[(((uint32_t)w8 & 0xFFFFFFu) * 2654435761u) >>
                               (32 - HASH3_BITS)] = (int32_t)p;
                    uint32_t h = ((uint32_t)w8 * 2654435761u) >>
                                 (32 - HASH_BITS);
                    prev[p & WMASK] = head[h];
                    head[h] = (int32_t)p;
                }
            }
            for (; p < e4; p++) {
                if (track3) head3p[hash3(data + p)] = (int32_t)p;
                uint32_t h = hash4(data + p);
                prev[p & WMASK] = head[h];
                head[h] = (int32_t)p;
            }
        } else {
            // long span: hash4/prev everywhere, head3 only at the
            // endpoints — a mid-span probe3 hit needs a future len-3-only
            // match anchored strictly inside an already-consumed long
            // match (hash4 chains cover everything sharing 4 bytes);
            // find() consults probe3 only when the chains found nothing,
            // so interior staleness is byte-neutral on the bench battery
            // while insert cost drops ~40% on match-heavy content.
            if (track3) head3p[hash3(data + start)] = (int32_t)start;
            int64_t p = start;
            for (; p + 5 <= e4; ) {
                uint64_t w8;
                memcpy(&w8, data + p, 8);
                for (int k = 0; k < 5; k++, p++, w8 >>= 8) {
                    uint32_t h = ((uint32_t)w8 * 2654435761u) >>
                                 (32 - HASH_BITS);
                    prev[p & WMASK] = head[h];
                    head[h] = (int32_t)p;
                }
            }
            for (; p < e4; p++) {
                uint32_t h = hash4(data + p);
                prev[p & WMASK] = head[h];
                head[h] = (int32_t)p;
            }
            if (track3)
                for (int64_t q = std::max(start + 1, end - 2); q < end; q++)
                    if (q + 3 <= n) head3p[hash3(data + q)] = (int32_t)q;
        }
        for (int64_t p = e4; p < end; p++) insert(p);
    }

    inline void prefetch_head(int64_t pos) const {
        __builtin_prefetch(&st.head[hash4(data + pos)]);
    }

    // most recent position sharing 3 bytes with pos, or -1
    inline int32_t probe3(int64_t pos) const {
        if (pos + 3 > n) return -1;
        return head3_at(hash3(data + pos));
    }

    // find best match at pos; returns length (0 if none < mml), sets dist.
    // mml is the content-adaptive minimum match length (parity with pixo's
    // calculate_min_match_len, lz77.rs:329-360 / libdeflate): on
    // high-literal-diversity data, short matches cost more bits than the
    // entropy-coded literals they replace and grinding the chains for them
    // dominates runtime.
    inline int find(int64_t pos, int chain, int nice, int mml, int* dist_out) {
        if (pos + mml > n) return 0;
        int max_len = (int)std::min<int64_t>(MAX_MATCH, n - pos);
        int best_len = mml - 1, best_dist = 0;
        const uint8_t* cur = data + pos;
        // same-byte-run seed (parity with pixo detect_same_byte_run,
        // lz77.rs:617-637): dist-1 is optimal for runs, and seeding it here
        // is what makes the sparse RLE hash inserts safe — without it a
        // deep chain walks far-away run candidates instead of breaking
        if (pos >= 1 && cur[0] == data[pos - 1] && max_len >= 2 &&
            cur[1] == cur[0]) {
            // the cur[1] pre-check is byte-neutral: a run of 1 can never
            // reach mml (>= MIN_MATCH = 3), and it skips the word-at-a-
            // time scan on the isolated byte-pairs literal-heavy content
            // is full of
            int run = run_length_capped(data, pos, pos + max_len);
            if (run >= mml) {
                if (run >= nice || run == max_len) {
                    *dist_out = 1;
                    return run;
                }
                best_len = run;
                best_dist = 1;
            }
        }
        if (pos + 4 <= n) {  // 4-byte chain search (guard the 4-byte read)
            uint32_t cur32;
            memcpy(&cur32, cur, 4);
            uint32_t h = hash4(cur);
            int32_t cand = head4_at(h);
            // the probe3 fallback runs after the walk; issue its bucket
            // load now so the (random, 128 KiB-table) access overlaps the
            // chain walk instead of serializing behind it
            if (mml <= MIN_MATCH) __builtin_prefetch(&st.head3[hash3(cur)]);
            // zlib longest_match-style rejection order: once a best >= 4
            // exists, a candidate that cannot EXTEND it fails on one load
            // at the match tail — cheaper than verifying the prefix, and
            // it is the common case deep in a chain
            // tail-word filter (see search_ins): candidate bytes
            // [best_len-3, best_len] must all match to beat best_len; one
            // unaligned 32-bit compare rejects strictly more than the old
            // single cur[best_len] byte at the same one-load cost
            uint32_t scan_tail = 0;
            if (best_len >= 4) memcpy(&scan_tail, cur + best_len - 3, 4);
            // window floor: every in-window candidate satisfies
            // cand >= pos - WINDOW, chains are position-descending, and
            // with the matcher constructed after probe_min_match every
            // chain entry is < pos (find precedes insert), so the walk
            // stops at the first candidate below the floor. Replaces the
            // per-step dist compute + two branches of the old loop.
            const int32_t floor_ =
                (int32_t)(pos > WINDOW ? pos - WINDOW : 0);
            const int32_t* prevp = st.prev.data();
            while (cand >= floor_ && chain-- > 0) {
                const uint8_t* cp = data + cand;
                // hide the dependent-chain latency: the next candidate's
                // index is loaded now and its data line prefetched while
                // this candidate is verified (prefetch never faults, so a
                // stale/negative next is harmless)
                int32_t nxt = prevp[cand & WMASK];
                __builtin_prefetch(data + nxt);
                __builtin_prefetch(&prevp[nxt & WMASK]);
                if (best_len >= 4) {
                    uint32_t c_tail;
                    memcpy(&c_tail, cp + best_len - 3, 4);
                    if (c_tail != scan_tail) {
                        cand = nxt;
                        continue;
                    }
                    uint32_t c32;
                    memcpy(&c32, cp, 4);
                    if (c32 == cur32) {
                        // shared 4-byte prefix verified: extend from 4
                        int len =
                            4 + match_length(cur + 4, cp + 4, max_len - 4);
                        if (len > best_len) {
                            best_len = len;
                            best_dist = (int)(pos - cand);
                            if (len >= nice || len == max_len) break;
                            memcpy(&scan_tail, cur + best_len - 3, 4);
                        }
                    }
                } else {
                    uint32_t c32;
                    memcpy(&c32, cp, 4);
                    if (c32 == cur32) {
                        int len = match_length(cur, cp, max_len);
                        if (len > best_len) {
                            best_len = len;
                            best_dist = (int)(pos - cand);
                            if (len >= nice || len == max_len) break;
                            if (best_len >= 4)
                                memcpy(&scan_tail, cur + best_len - 3, 4);
                        }
                    }
                }
                cand = nxt;
            }
        }
        // hash3 fallback: len-3 coverage (a 4th byte that differs keeps
        // the match out of every hash4 chain). Consulted only when the
        // chain walk came up empty, which is exactly the literal-heavy
        // regime where the side table is fresh — insert_span refreshes
        // head3 only at consumed-match endpoints, and giving a possibly
        // interior-stale probe3 hit the pre-walk early-return (the old
        // order) returned needlessly FAR candidates once spans stopped
        // refreshing it (text 1 MiB: 3.2 -> 5.8 KB). The hash4 head is
        // always the nearest 4-byte candidate, so it probes first.
        if (mml <= MIN_MATCH && best_dist == 0) {
            int32_t c3 = probe3(pos);
            if (c3 >= 0) {
                int64_t dist = pos - c3;
                if (dist > 0 && dist <= WINDOW) {
                    int len = match_length(cur, data + c3, max_len);
                    if (len > best_len) {
                        best_len = len;
                        best_dist = (int)dist;
                    }
                }
            }
        }
        if (best_dist == 0) return 0;
        *dist_out = best_dist;
        return best_len;
    }

    // Fused insert+find (libdeflate hc_matchfinder-style): insert pos into
    // head/prev (and head3 when tracked) FIRST, capturing the pre-insert
    // entries, then walk the chains as they were before the insert.
    // Byte-identical to the old insert-after-find sequence by construction
    // (the walk starts from the captured old head, and probe3 uses the
    // captured old head3 entry), but each table is hashed and touched ONCE
    // per position instead of twice — the insert's random head/head3
    // accesses ride the find's.  min_len seeds the accept threshold (zlib
    // longest_match seeds best_len with prev_length): a lazy probe that
    // only defers on best+3 can start its walk at best+2 and single-byte-
    // reject nearly every candidate; results below min_len never change a
    // decision, so output is unchanged.
    inline int search_ins(int64_t pos, int chain, int nice, int mml,
                          int* dist_out, int min_len = 0,
                          int run_hint = -1) {
        // --- insert half (state mutation identical to insert(pos)) ---
        // one 4-byte load feeds both hashes (hash3 uses the low 3 bytes,
        // exactly the byte-order hash3() builds from single loads)
        int32_t c3 = -1;
        int32_t old4 = -1;
        if (pos + 4 <= n) {
            uint32_t w4;
            memcpy(&w4, data + pos, 4);
            if (track3) {
                uint32_t h3 = ((w4 & 0xFFFFFFu) * 2654435761u) >>
                              (32 - HASH3_BITS);
                c3 = st.head3[h3];
                st.head3[h3] = (int32_t)pos;
            }
            uint32_t h = (w4 * 2654435761u) >> (32 - HASH_BITS);
            old4 = st.head[h];
            st.prev[pos & WMASK] = old4;
            st.head[h] = (int32_t)pos;
        } else if (track3 && pos + 3 <= n) {
            uint32_t h3 = hash3(data + pos);
            c3 = st.head3[h3];
            st.head3[h3] = (int32_t)pos;
        }
        // --- find half (walks the pre-insert chain) ---
        if (min_len < mml) min_len = mml;
        if (pos + min_len > n) return 0;
        int max_len = (int)std::min<int64_t>(MAX_MATCH, n - pos);
        int best_len = min_len - 1, best_dist = 0;
        const uint8_t* cur = data + pos;
        // run-seed gate: data[pos-1] == data[pos] == data[pos+1] as one
        // 16-bit compare of overlapping halves (equivalent to the two
        // byte compares, one load). pos+1 < n holds: min_len >= 3 passed
        // the bound check above. A caller that already knows the run at
        // pos passes run_hint (0 = provably no seed, >0 = the exact value
        // run_length_capped would return) and skips both the gate and the
        // scan — the block loop's RLE gate computes the same run, and
        // rescanning every position of a zero stretch was O(run^2).
        if (run_hint != 0) {
            int run = run_hint;
            if (run < 0) {
                run = 0;
                if (pos >= 1) {
                    uint32_t g;
                    memcpy(&g, data + pos - 1, 2);
                    uint16_t lo = (uint16_t)g;
                    uint8_t b2 = data[pos + 1];
                    if ((uint8_t)lo == (uint8_t)(lo >> 8) && (uint8_t)lo == b2)
                        run = run_length_capped(data, pos, pos + max_len);
                }
            }
            if (run >= min_len) {
                if (run >= nice || run == max_len) {
                    *dist_out = 1;
                    return run;
                }
                best_len = run;
                best_dist = 1;
            }
        }
        if (old4 >= 0) {
            uint32_t cur32;
            memcpy(&cur32, cur, 4);
            int32_t cand = old4;
            // tail-word filter: a candidate can only beat best_len if its
            // bytes [best_len-3, best_len] all match (len > best_len needs
            // bytes 0..best_len equal) — one unaligned 32-bit compare
            // rejects strictly more candidates than the single
            // cur[best_len] byte for the same one-load cost. Valid while
            // best_len < max_len (guaranteed in-loop: len == max_len
            // breaks), so cp+best_len stays in bounds.
            uint32_t scan_tail = 0;
            if (best_len >= 4) memcpy(&scan_tail, cur + best_len - 3, 4);
            const int32_t floor_ =
                (int32_t)(pos > WINDOW ? pos - WINDOW : 0);
            const int32_t* prevp = st.prev.data();
            while (cand >= floor_ && chain-- > 0) {
                const uint8_t* cp = data + cand;
                int32_t nxt = prevp[cand & WMASK];
                __builtin_prefetch(data + nxt);
                __builtin_prefetch(&prevp[nxt & WMASK]);
                if (best_len >= 4) {
                    uint32_t c_tail;
                    memcpy(&c_tail, cp + best_len - 3, 4);
                    if (c_tail != scan_tail) {
                        cand = nxt;
                        continue;
                    }
                    uint32_t c32;
                    memcpy(&c32, cp, 4);
                    if (c32 == cur32) {
                        int len =
                            4 + match_length(cur + 4, cp + 4, max_len - 4);
                        if (len > best_len) {
                            best_len = len;
                            best_dist = (int)(pos - cand);
                            if (len >= nice || len == max_len) break;
                            memcpy(&scan_tail, cur + best_len - 3, 4);
                        }
                    }
                } else {
                    uint32_t c32;
                    memcpy(&c32, cp, 4);
                    if (c32 == cur32) {
                        int len = match_length(cur, cp, max_len);
                        if (len > best_len) {
                            best_len = len;
                            best_dist = (int)(pos - cand);
                            if (len >= nice || len == max_len) break;
                            if (best_len >= 4)
                                memcpy(&scan_tail, cur + best_len - 3, 4);
                        }
                    }
                }
                cand = nxt;
            }
        }
        if (mml <= MIN_MATCH && min_len <= MIN_MATCH && best_dist == 0 &&
            c3 >= 0) {
            int64_t dist = pos - c3;
            if (dist > 0 && dist <= WINDOW) {
                int len = match_length(cur, data + c3, max_len);
                if (len > best_len) {
                    best_len = len;
                    best_dist = (int)dist;
                }
            }
        }
        if (best_dist == 0) return 0;
        *dist_out = best_dist;
        return best_len;
    }
};

// content-adaptive minimum match length (parity with pixo
// choose_min_match_len, lz77.rs:343-360): count distinct byte values in the
// first 4 KiB; diverse literals + deep search => require longer matches.
static int calc_min_match(const uint8_t* data, int64_t len, int depth) {
    if (depth <= 4) return MIN_MATCH;
    bool used[256] = {false};
    int num_used = 0;
    int64_t scan = std::min<int64_t>(len, 4096);
    for (int64_t i = 0; i < scan; i++) {
        if (!used[data[i]]) { used[data[i]] = true; num_used++; }
    }
    int mml = MIN_MATCH;
    if (num_used > 32) mml = 4;
    if (num_used > 64 && depth >= 10) mml = 5;
    if (num_used > 96 && depth >= 20) mml = 6;
    return mml;
}

// The adaptive rule above (mirroring the reference's choose_min_match_len)
// can misfire badly: byte-diverse but short-period content (e.g.
// channel-interleaved gradient residuals, period-3 matches of length
// 3-6) loses 2.3x to zlib when mml lands at 5-6 and every period match
// is rejected.  The perf path therefore A/B-probes a 32 KiB prefix with
// the adaptive mml vs MIN_MATCH and keeps the smaller ACTUAL deflate
// output — an exact-cost decision, never worse than either rule.  The
// parity path bypasses this (g_force_mml) and keeps reference behavior.
static thread_local int g_force_mml = -1;  // -1 = adaptive + probe

EXPORT int64_t deflate_compress(const uint8_t* data, int64_t len,
                                int32_t level, int32_t zlib_wrap,
                                uint8_t* out, int64_t out_cap);

static int probe_min_match(const uint8_t* data, int64_t len, int level,
                           int adaptive_mml) {
    if (adaptive_mml <= MIN_MATCH || len < 8192) return adaptive_mml;
    // 16 KiB is enough prefix for the rule decision (verified: no flip on
    // the bench battery vs 32 KiB) and halves the probe's fixed cost —
    // the probe was ~20% of whole-call time on match-heavy content.
    int64_t plen = std::min<int64_t>(len, 16384);
    std::vector<uint8_t> buf((size_t)(plen + plen / 2 + 4096));
    int saved = g_force_mml;
    g_force_mml = adaptive_mml;
    int64_t a = deflate_compress(data, plen, level, 0, buf.data(),
                                 (int64_t)buf.size());
    g_force_mml = MIN_MATCH;
    int64_t b = deflate_compress(data, plen, level, 0, buf.data(),
                                 (int64_t)buf.size());
    g_force_mml = saved;
    if (b >= 0 && (a < 0 || b < a)) return MIN_MATCH;
    return adaptive_mml;
}

// emit a block of tokens with the best of (dynamic, fixed) huffman coding
// force: -1 = choose best of dynamic/fixed/stored (default path);
// 0 = fixed-only, 1 = dynamic-only (reference-parity block-type rules,
// deflate.rs:99-118 — no stored fallback at block level there).
static void emit_block(LsbWriter& w, const Token* tok, size_t ntok,
                       const uint8_t* raw, int64_t raw_start, int64_t raw_len,
                       bool last, int force = -1,
                       const uint64_t* pre_lit = nullptr,
                       const uint64_t* pre_dist = nullptr) {
    fixed_init();
    tables_init();

    // histogram — reused from the split search's chunk prefix sums when
    // the caller already paid for them (pre_* exclude the EOB, added here)
    uint64_t lit_freq[286];
    uint64_t dist_freq[30];
    if (pre_lit != nullptr) {
        memcpy(lit_freq, pre_lit, sizeof(lit_freq));
        memcpy(dist_freq, pre_dist, sizeof(dist_freq));
    } else {
        memset(lit_freq, 0, sizeof(lit_freq));
        memset(dist_freq, 0, sizeof(dist_freq));
        for (size_t i = 0; i < ntok; i++) {
            const Token& t = tok[i];
            if (t.v & 0x80000000u) {
                int len = (t.v >> 16) & 0x1FF;
                int dist = t.v & 0xFFFF;
                lit_freq[257 + len_to_sym[len]]++;
                dist_freq[dist_symbol(dist)]++;
            } else {
                lit_freq[t.v & 0xFF]++;
            }
        }
    }
    lit_freq[256]++;  // EOB

    uint8_t lit_len[286], dist_len[30];
    if (g_ref_huffman) {
        // reference order: seed dist_freqs[0]=1 when no matches exist
        // BEFORE building (deflate.rs:674-676), then heap-build
        bool any_df = false;
        for (int i = 0; i < 30; i++) any_df |= dist_freq[i] != 0;
        if (!any_df) dist_freq[0] = 1;
        ref_build_lengths(lit_freq, 286, 15, lit_len);
        ref_build_lengths(dist_freq, 30, 15, dist_len);
    } else {
        build_lengths(lit_freq, 286, 15, lit_len);
        build_lengths(dist_freq, 30, 15, dist_len);
    }
    // DEFLATE requires at least one distance code slot if HDIST>=1; ensure
    // at least one non-zero to keep decoders happy when no matches exist.
    bool any_dist = false;
    for (int i = 0; i < 30; i++) any_dist |= dist_len[i] != 0;
    if (!any_dist) dist_len[0] = 1;

    uint16_t lit_code[286], dist_code[30];
    lengths_to_codes(lit_len, 286, lit_code);
    lengths_to_codes(dist_len, 30, dist_code);

    // --- cost estimation: dynamic vs fixed vs stored ---
    auto token_cost = [&](const uint8_t* ll, const uint8_t* dl) -> uint64_t {
        uint64_t bits = 0;
        for (int i = 0; i < 286; i++) if (lit_freq[i]) bits += lit_freq[i] * ll[i];
        for (int s = 0; s < 30; s++) if (dist_freq[s]) bits += dist_freq[s] * (dl[s] + DIST_EXTRA[s]);
        for (int s = 257; s < 286; s++) if (lit_freq[s]) bits += lit_freq[s] * LEN_EXTRA[s - 257];
        return bits;
    };

    // code-length RLE for the dynamic header
    int hlit = 286; while (hlit > 257 && lit_len[hlit - 1] == 0) hlit--;
    int hdist = 30; while (hdist > 1 && dist_len[hdist - 1] == 0) hdist--;
    uint8_t all_lens[286 + 30];
    memcpy(all_lens, lit_len, hlit);
    memcpy(all_lens + hlit, dist_len, hdist);
    int total_lens = hlit + hdist;

    // RLE encode with symbols 16 (repeat prev 3-6), 17 (zeros 3-10), 18 (zeros 11-138)
    struct ClTok { uint8_t sym; uint8_t extra; };
    static thread_local std::vector<ClTok> cl_toks;
    cl_toks.clear();
    cl_toks.reserve(286 + 30);
    uint64_t cl_freq[19] = {0};
    {
        int i = 0;
        while (i < total_lens) {
            uint8_t v = all_lens[i];
            int run = 1;
            while (i + run < total_lens && all_lens[i + run] == v) run++;
            if (v == 0) {
                int r = run;
                while (r >= 11) { int take = std::min(r, 138); cl_toks.push_back({18, (uint8_t)(take - 11)}); cl_freq[18]++; r -= take; }
                while (r >= 3) { int take = std::min(r, 10); cl_toks.push_back({17, (uint8_t)(take - 3)}); cl_freq[17]++; r -= take; }
                while (r-- > 0) { cl_toks.push_back({0, 0}); cl_freq[0]++; }
            } else {
                cl_toks.push_back({v, 0}); cl_freq[v]++;
                int r = run - 1;
                while (r >= 3) { int take = std::min(r, 6); cl_toks.push_back({16, (uint8_t)(take - 3)}); cl_freq[16]++; r -= take; }
                while (r-- > 0) { cl_toks.push_back({v, 0}); cl_freq[v]++; }
            }
            i += run;
        }
    }
    uint8_t cl_len[19];
    if (g_ref_huffman) ref_build_lengths(cl_freq, 19, 7, cl_len);
    else build_lengths(cl_freq, 19, 7, cl_len);
    uint16_t cl_code[19];
    lengths_to_codes(cl_len, 19, cl_code);
    static const int CL_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};
    int hclen = 19;
    while (hclen > 4 && cl_len[CL_ORDER[hclen - 1]] == 0) hclen--;
    if (g_ref_huffman) {
        // reference HCLEN quirk (deflate.rs:698-708): the field is the
        // POSITION of the last nonzero CL code capped at 15 — not the
        // count minus 4 — so it always frames 3 extra trailing entries
        // (up to the 19 cap).  Both encodings are valid DEFLATE; mirror
        // the reference's bits.
        int lastpos = -1;
        for (int i = 18; i >= 0; i--)
            if (cl_len[CL_ORDER[i]]) { lastpos = i; break; }
        int hfield = lastpos < 0 ? 0 : std::min(lastpos, 15);
        hclen = hfield + 4;
    }

    uint64_t dyn_header_bits = 14 + hclen * 3;
    for (const ClTok& t : cl_toks) {
        dyn_header_bits += cl_len[t.sym];
        if (t.sym == 16) dyn_header_bits += 2;
        else if (t.sym == 17) dyn_header_bits += 3;
        else if (t.sym == 18) dyn_header_bits += 7;
    }
    uint64_t dyn_bits = dyn_header_bits + token_cost(lit_len, dist_len);
    uint64_t fixed_bits = token_cost(fixed_lit_len, fixed_dist_len);
    uint64_t stored_bits = 8ull * raw_len + 32 + (raw_len / 65535 + 1) * 40;

    if (force < 0 && raw_len > 0 && stored_bits < dyn_bits + 3 && stored_bits < fixed_bits + 3) {
        // stored blocks
        int64_t off = 0;
        while (off < raw_len || raw_len == 0) {
            int chunk = (int)std::min<int64_t>(65535, raw_len - off);
            bool final_chunk = (off + chunk == raw_len);
            w.write((last && final_chunk) ? 1 : 0, 1);
            w.write(0, 2);
            w.flush();
            uint8_t hdr[4] = {(uint8_t)chunk, (uint8_t)(chunk >> 8),
                              (uint8_t)~chunk, (uint8_t)~(chunk >> 8)};
            w.raw_bytes(hdr, 4);
            w.raw_bytes(raw + raw_start + off, chunk);
            off += chunk;
            if (raw_len == 0) break;
        }
        return;
    }

    const uint8_t *ll, *dl;
    const uint16_t *lc, *dc;
    bool use_fixed = force < 0 ? fixed_bits <= dyn_bits : force == 0;
    if (use_fixed) {
        w.write(last ? 1 : 0, 1);
        w.write(1, 2);  // fixed
        ll = fixed_lit_len; dl = fixed_dist_len; lc = fixed_lit_code; dc = fixed_dist_code;
    } else {
        w.write(last ? 1 : 0, 1);
        w.write(2, 2);  // dynamic
        w.write(hlit - 257, 5);
        w.write(hdist - 1, 5);
        w.write(hclen - 4, 4);
        for (int i = 0; i < hclen; i++) w.write(cl_len[CL_ORDER[i]], 3);
        for (const ClTok& t : cl_toks) {
            w.write(cl_code[t.sym], cl_len[t.sym]);
            if (t.sym == 16) w.write(t.extra, 2);
            else if (t.sym == 17) w.write(t.extra, 3);
            else if (t.sym == 18) w.write(t.extra, 7);
        }
        ll = lit_len; dl = dist_len; lc = lit_code; dc = dist_code;
    }

    // per-block combined LUTs: for each raw length 3..258 the final push
    // word (len code | extra value above it) and its total bit count; for
    // literals the (code, nbits) pair in one 32-bit entry. Built once per
    // block (256 + 256 entries), they collapse the 5 table loads per match
    // length and 2 per literal to 2 and 1.
    uint32_t lenlut_v[259];
    uint8_t lenlut_n[259];
    for (int len = 3; len <= 258; len++) {
        int ls = 257 + len_to_sym[len];
        lenlut_v[len] = (uint32_t)lc[ls] |
                        ((uint32_t)len_extra_val[len] << ll[ls]);
        lenlut_n[len] = (uint8_t)(ll[ls] + len_extra_bits[len]);
    }
    uint32_t litlut[256];
    for (int c = 0; c < 256; c++)
        litlut[c] = (uint32_t)lc[c] | ((uint32_t)ll[c] << 16);

    // token emission fast path: one 64-bit accumulate per code group and
    // one byte-granular flush per token (or per two literals). A match
    // pushes len-code+extra (<=20 bits) and dist-code+extra (<=28 bits)
    // on top of at most 7 residual bits — <=55 < 64, so a single
    // flush_bytes per match keeps the invariant. Literals (<=15 bits)
    // flush every other token. Bit order is identical to the write()
    // path; only the store granularity changes.
    w.flush_bytes();
    for (size_t ti = 0; ti < ntok; ti++) {
        const Token& t = tok[ti];
        if (t.v & 0x80000000u) {
            int len = (t.v >> 16) & 0x1FF;
            int dist = t.v & 0xFFFF;
            w.push(lenlut_v[len], lenlut_n[len]);
            int ds = dist_symbol(dist);
            w.push((uint32_t)dc[ds] |
                       ((uint32_t)(dist - DIST_BASE[ds]) << dl[ds]),
                   dl[ds] + DIST_EXTRA[ds]);
            w.flush_bytes();
        } else {
            uint32_t e = litlut[t.v & 0xFF];
            w.push(e & 0xFFFF, e >> 16);
            if (ti + 1 < ntok && !(tok[ti + 1].v & 0x80000000u)) {
                e = litlut[tok[++ti].v & 0xFF];
                w.push(e & 0xFFFF, e >> 16);
                if (ti + 1 < ntok && !(tok[ti + 1].v & 0x80000000u)) {
                    e = litlut[tok[++ti].v & 0xFF];
                    w.push(e & 0xFFFF, e >> 16);
                }
            }
            w.flush_bytes();
        }
    }
    w.write(lc[256], ll[256]);  // EOB
}

static inline void emit_block(LsbWriter& w, const std::vector<Token>& tokens,
                              const uint8_t* raw, int64_t raw_start,
                              int64_t raw_len, bool last, int force = -1,
                              const uint64_t* pre_lit = nullptr,
                              const uint64_t* pre_dist = nullptr) {
    emit_block(w, tokens.data(), tokens.size(), raw, raw_start, raw_len, last,
               force, pre_lit, pre_dist);
}

}  // namespace deflate

namespace deflate {

// High-entropy detector (exact parity with pixo deflate.rs:1108-1145):
// hash every 4-gram of the first 8 KiB into a 4096-slot table; flag
// stored only when the collision rate is < 5%. Note the parameters make
// this trigger essentially never (8K windows into 4K slots collide ~57%
// even on random data, by the birthday bound) — incompressible inputs
// are instead caught by the per-block stored-vs-dynamic size comparison
// in emit_block, matching the reference's observed behavior.
// Stored-block bail: fire only when the sample shows (a) essentially no
// repeated 4-grams (no LZ matches to find) AND (b) a near-flat byte
// histogram (no entropy-coding win either). Measured exact 4-gram duplicate
// rates: random 0.000, JPEG bytes 0.026, entropy-codable PNG residuals
// 0.0004 but ~6.5-bit literals (must NOT bail), text 0.99.
static bool is_high_entropy(const uint8_t* data, int64_t len) {
    if (len < 4096) return false;
    int64_t sample_len = std::min<int64_t>(len, 8192);
    // (b) literal entropy over the sample
    int64_t hist[256] = {0};
    for (int64_t i = 0; i < sample_len; i++) hist[data[i]]++;
    double entropy = 0.0;
    for (int v = 0; v < 256; v++) {
        if (!hist[v]) continue;
        double p = (double)hist[v] / (double)sample_len;
        entropy -= p * std::log2(p);
    }
    if (entropy <= 7.9) return false;
    // (a) exact distinct-4-gram count over the sample
    int64_t total = sample_len - 3;
    std::vector<uint32_t> grams((size_t)total);
    for (int64_t i = 0; i < total; i++) memcpy(&grams[i], data + i, 4);
    std::sort(grams.begin(), grams.end());
    int64_t dups = 0;
    for (int64_t i = 1; i < total; i++) dups += grams[i] == grams[i - 1];
    return (double)dups / (double)total < 0.01;
}

static void emit_stored_all(LsbWriter& w, const uint8_t* data, int64_t len) {
    int64_t off = 0;
    do {
        int chunk = (int)std::min<int64_t>(65535, len - off);
        bool last = (off + chunk == len);
        w.write(last ? 1 : 0, 1);
        w.write(0, 2);
        w.flush();
        uint8_t hdr[4] = {(uint8_t)chunk, (uint8_t)(chunk >> 8),
                          (uint8_t)~chunk, (uint8_t)~(chunk >> 8)};
        w.raw_bytes(hdr, 4);
        w.raw_bytes(data + off, chunk);
        off += chunk;
    } while (off < len);
}

// ---- adaptive block splitting ----
// Capability parity with pixo deflate.rs:439-653: entropy-cost estimate
// with a coarse split search; overhead 300 bits per extra block, minimum
// gain 10 bits, at most 15 blocks, skipped for very large inputs.


static double entropy_cost_bits(const uint64_t* lit_freq, const uint64_t* dist_freq) {
    uint64_t lt = 0, dt = 0;
    for (int i = 0; i < 286; i++) lt += lit_freq[i];
    for (int i = 0; i < 30; i++) dt += dist_freq[i];
    double bits = 0.0;
    for (int i = 0; i < 286; i++)
        if (lit_freq[i])
            bits += (double)lit_freq[i] *
                    (-__builtin_log2((double)lit_freq[i] / (double)lt));
    for (int i = 0; i < 30; i++)
        if (dist_freq[i])
            bits += (double)dist_freq[i] *
                    (-__builtin_log2((double)dist_freq[i] / (double)dt) + DIST_EXTRA[i]);
    for (int s = 257; s < 286; s++) bits += (double)lit_freq[s] * LEN_EXTRA[s - 257];
    return bits;
}

// Split-search cost oracle over chunked prefix-sum histograms: one O(T)
// pass builds per-chunk symbol histograms, after which any range cost is
// O(316) from prefix differences (the naive per-evaluation token scan made
// the split search the dominant fixed cost of whole-file DEFLATE: ~8 full
// passes per recursion level). Split points land on chunk boundaries; with
// a 300-bit block overhead the sub-chunk precision is irrelevant.
struct TokenRangeCost {
    static const size_t CHUNK = 1024;
    static const int NSYM = 286 + 30;
    size_t ntokens;
    size_t nchunks;
    std::vector<uint32_t> cum;  // (nchunks+1) x NSYM prefix histograms
    std::vector<int64_t> rawcum;  // (nchunks+1) raw-byte prefix lengths

    explicit TokenRangeCost(const std::vector<Token>& tokens)
        : ntokens(tokens.size()),
          nchunks((tokens.size() + CHUNK - 1) / CHUNK),
          cum((nchunks + 1) * NSYM, 0), rawcum(nchunks + 1, 0) {
        for (size_t k = 0; k < nchunks; k++) {
            uint32_t* h = cum.data() + (k + 1) * NSYM;
            const uint32_t* prev = cum.data() + k * NSYM;
            memcpy(h, prev, NSYM * sizeof(uint32_t));
            size_t end = std::min(ntokens, (k + 1) * CHUNK);
            int64_t raw = rawcum[k];
            for (size_t i = k * CHUNK; i < end; i++) {
                const Token& t = tokens[i];
                if (t.v & 0x80000000u) {
                    int len = (t.v >> 16) & 0x1FF;
                    h[257 + len_to_sym[len]]++;
                    h[286 + dist_symbol((int)(t.v & 0xFFFF))]++;
                    raw += len;
                } else {
                    h[t.v & 0xFF]++;
                    raw += 1;
                }
            }
            rawcum[k + 1] = raw;
        }
    }

    // cost of chunk range [ca, cb)
    double cost(size_t ca, size_t cb) const {
        uint64_t lit[286], dist[30];
        const uint32_t* a = cum.data() + ca * NSYM;
        const uint32_t* b = cum.data() + cb * NSYM;
        for (int s = 0; s < 286; s++) lit[s] = b[s] - a[s];
        for (int s = 0; s < 30; s++) dist[s] = b[286 + s] - a[286 + s];
        lit[256]++;
        return entropy_cost_bits(lit, dist);
    }

    // chunk boundary -> token index
    size_t token_index(size_t c) const {
        return std::min(ntokens, c * CHUNK);
    }
};

// Find split points in chunk range [a, b); appends chunk boundaries
// (exclusive) to `splits`.
static void find_splits(const TokenRangeCost& rc, size_t a, size_t b,
                        int* blocks_left, std::vector<size_t>* splits,
                        double whole = -1.0) {
    const double OVERHEAD = 300.0, MIN_GAIN = 10.0;
    if (*blocks_left <= 1 || b - a < 2) return;
    // `whole` is the caller's already-evaluated cost(a, b) when available
    // (the parent's search loop computed both halves of its chosen split);
    // recomputing it was ~2 of the ~16 entropy evaluations per node
    if (whole < 0.0) whole = rc.cost(a, b);
    // coarse 8-point search
    double best_gain = 0.0;
    size_t best_mid = 0;
    double best_ca = 0.0, best_cb = 0.0;
    for (int k = 1; k < 8; k++) {
        size_t mid = a + (b - a) * k / 8;
        if (mid <= a || mid >= b) continue;
        double ca = rc.cost(a, mid), cb = rc.cost(mid, b);
        double gain = whole - ca - cb - OVERHEAD;
        if (gain > best_gain) {
            best_gain = gain;
            best_mid = mid;
            best_ca = ca;
            best_cb = cb;
        }
    }
    if (best_gain < MIN_GAIN || best_mid == 0) return;
    (*blocks_left)--;
    find_splits(rc, a, best_mid, blocks_left, splits, best_ca);
    splits->push_back(best_mid);
    find_splits(rc, best_mid, b, blocks_left, splits, best_cb);
}

// token range -> raw byte length it covers
static int64_t tokens_raw_len(const std::vector<Token>& tokens, size_t a, size_t b) {
    int64_t n = 0;
    for (size_t i = a; i < b; i++) {
        const Token& t = tokens[i];
        n += (t.v & 0x80000000u) ? (int64_t)((t.v >> 16) & 0x1FF) : 1;
    }
    return n;
}

static void emit_block_split(LsbWriter& w, const std::vector<Token>& tokens,
                             const uint8_t* data, int64_t raw_start,
                             int64_t raw_len, bool last,
                             bool force_split_search = false) {
    // split search only for moderately sized blocks (parity: skip >512 KiB).
    // The optimal path forces the search regardless of raw size: its token
    // stream is one whole-payload emission (split cost is O(tokens), and
    // the parse already spent far more than that per token).
    if ((raw_len > 512 * 1024 && !force_split_search) || tokens.size() < 512) {
        emit_block(w, tokens, data, raw_start, raw_len, last);
        return;
    }
    bool dbg = getenv("PIXO_TPU_DEFLATE_DEBUG") != nullptr;
    auto tick = [] {
        struct timespec ts;
        clock_gettime(CLOCK_MONOTONIC, &ts);
        return ts.tv_sec + ts.tv_nsec * 1e-9;
    };
    double t0 = dbg ? tick() : 0.0;
    TokenRangeCost rc(tokens);
    if (dbg) { fprintf(stderr, "  emit: rc build %.2f ms\n", (tick() - t0) * 1e3); t0 = tick(); }
    int blocks_left = 15;
    std::vector<size_t> chunk_splits;
    find_splits(rc, 0, rc.nchunks, &blocks_left, &chunk_splits);
    if (dbg) { fprintf(stderr, "  emit: find_splits %.2f ms\n", (tick() - t0) * 1e3); t0 = tick(); }
    if (dbg) {
        uint64_t h = 1469598103934665603ull;
        for (const Token& t : tokens) { h ^= t.v; h *= 1099511628211ull; }
        fprintf(stderr, "emit_block_split: tokhash=%016llx splits=[",
                (unsigned long long)h);
        for (size_t c : chunk_splits) fprintf(stderr, "%zu,", c);
        fprintf(stderr, "]\n");
    }
    // split ranges land on chunk boundaries, so every emitted block's
    // histogram is an exact prefix-sum difference — emit_block need not
    // re-scan its tokens (that re-scan was a full extra pass per call)
    uint64_t lit[286], dist[30];
    auto range_hist = [&rc, &lit, &dist](size_t ca, size_t cb) {
        const uint32_t* pa = rc.cum.data() + ca * TokenRangeCost::NSYM;
        const uint32_t* pb = rc.cum.data() + cb * TokenRangeCost::NSYM;
        for (int s = 0; s < 286; s++) lit[s] = pb[s] - pa[s];
        for (int s = 0; s < 30; s++) dist[s] = pb[286 + s] - pa[286 + s];
    };
    if (chunk_splits.empty()) {
        range_hist(0, rc.nchunks);
        emit_block(w, tokens, data, raw_start, raw_len, last, -1, lit, dist);
        return;
    }
    std::vector<size_t> splits;
    for (size_t c : chunk_splits) splits.push_back(rc.token_index(c));
    splits.push_back(tokens.size());
    chunk_splits.push_back(rc.nchunks);
    size_t a = 0, ca = 0;
    int64_t roff = raw_start;
    for (size_t si = 0; si < splits.size(); si++) {
        size_t b = splits[si];
        size_t cb = chunk_splits[si];
        int64_t rlen = rc.rawcum[cb] - rc.rawcum[ca];
        bool is_last = last && (si + 1 == splits.size());
        range_hist(ca, cb);
        emit_block(w, tokens.data() + a, b - a, data, roff, rlen, is_last,
                   -1, lit, dist);
        roff += rlen;
        a = b;
        ca = cb;
    }
    if (dbg) fprintf(stderr, "  emit: blocks %.2f ms\n", (tick() - t0) * 1e3);
}

}  // namespace deflate

EXPORT int64_t deflate_compress(const uint8_t* data, int64_t len,
                                int32_t level, int32_t zlib_wrap,
                                uint8_t* out, int64_t out_cap) {
    using namespace deflate;
    if (level < 1) level = 1;
    if (level > 9) level = 9;
    LsbWriter w(out, out_cap);

    if (zlib_wrap) {
        // CMF/FLG: 32K window, level hint; FCHECK so that (CMF<<8|FLG) % 31 == 0
        uint8_t cmf = 0x78;
        // FLEVEL per the reference's zlib_header (deflate.rs:1642-1658):
        // 0-2 -> 1 (fast), 3-6 -> 2 (default), 7-9 -> 3 (maximum)
        int level_hint = (level <= 2) ? 1 : (level <= 6) ? 2 : 3;
        uint8_t flg = (uint8_t)(level_hint << 6);
        flg |= 31 - ((cmf << 8) | flg) % 31;
        uint8_t hdr[2] = {cmf, flg};
        w.raw_bytes(hdr, 2);
    }

    if (len == 0) {
        // empty: single fixed-huffman block with just EOB
        fixed_init();
        w.write(1, 1); w.write(1, 2);
        w.write(fixed_lit_code[256], fixed_lit_len[256]);
        w.flush();
    } else if (is_high_entropy(data, len)) {
        emit_stored_all(w, data, len);
        w.flush();
    } else {
        const bool dbg = getenv("PIXO_TPU_DEFLATE_DEBUG") != nullptr;
        auto tick = [] {
            struct timespec ts;
            clock_gettime(CLOCK_MONOTONIC, &ts);
            return ts.tv_sec + ts.tv_nsec * 1e-9;
        };
        double t0 = dbg ? tick() : 0.0;
        Lz77Config cfg = config_for_level(level);
        const int mml =
            g_force_mml > 0
                ? g_force_mml
                : probe_min_match(data, len, level,
                                  calc_min_match(data, len, cfg.depth_cap));
        // Construct AFTER probe_min_match: the probe's inner compress
        // calls share the pooled MatcherState, and constructing first
        // left their inserts (positions 0..16K of this very buffer) in
        // the outer matcher's chains — every find in the first 16 KiB
        // then walked future positions (dist <= 0), burning chain budget
        // on candidates it could never take. A clean matcher also makes
        // cand < pos an invariant the find loop can rely on.
        Matcher m(data, len);
        m.track3 = (mml <= MIN_MATCH);
        if (const char* ov = getenv("PIXO_TPU_CHAIN")) {
            int c = atoi(ov);
            if (c > 0) cfg.chain = c;
        }
        if (dbg) { fprintf(stderr, "deflate: setup %.2f ms (mml=%d chain=%d lazy=%d nice=%d)\n", (tick() - t0) * 1e3, mml, cfg.chain, cfg.lazy, cfg.nice); t0 = tick(); }
        // Block every ~256 KiB of input for histogram locality.
        const int64_t BLOCK_INPUT = 256 * 1024;
        int64_t pos = 0;
        std::vector<Token> tokens;
        while (pos < len) {
            int64_t block_end = std::min(len, pos + BLOCK_INPUT);
            tokens.clear();
            tokens.reserve((size_t)(block_end - pos) / 2);
            int64_t block_start = pos;

            // incompressible-mode heuristic state (parity concept with
            // pixo src/compress/lz77.rs: after a long literal run, throttle)
            int64_t literal_run = 0;
            // lazy-deferral carry: the match already found at this position
            // during the previous iteration's lookahead (parity with pixo's
            // pending_match, lz77.rs:419,484-489 — prevents both cascading
            // deferrals and a wasted duplicate chain walk)
            int pend_len = 0, pend_dist = 0;
            // equal-byte-run memo: [.., run_end_cache) holds run_byte_cache
            // with the TRUE run end (only sub-maximal scans are cached)
            int64_t run_end_cache = 0;
            uint8_t run_byte_cache = 0;

            while (pos < block_end) {
                // same-byte-run fast path (dist=1 RLE, parity concept with
                // pixo detect_same_byte_run, lz77.rs:272-316)
                bool rle_gate = false;
                int run_hint = 0;  // what search_ins's seed scan would see
                if (pend_len == 0 && pos > 0 && pos + MIN_MATCH <= len) {
                    // data[pos-1..pos+2] all equal as one rotate-compare
                    uint32_t g;
                    memcpy(&g, data + pos - 1, 4);
                    rle_gate = g == ((g << 8) | (g >> 24));
                    // rle_gate false means the run at pos is <= 2 (either
                    // the 3-byte seed gate fails outright, or it passes and
                    // the scan would stop at the differing 4th byte below
                    // MIN_MATCH) — the seed inside search_ins is provably
                    // a no-op either way, so run_hint stays 0
                } else if (pend_len == 0) {
                    run_hint = -1;  // bounds differ from the seed's; let
                                    // search_ins evaluate its own gate
                }
                if (rle_gate) {
                    int64_t limit = std::min<int64_t>(len - pos, MAX_MATCH);
                    int run;
                    if (pos < run_end_cache && data[pos] == run_byte_cache) {
                        // inside a previously scanned sub-maximal run: the
                        // remaining length is exact (same byte to the same
                        // true end), capped at this position's limit
                        run = (int)std::min<int64_t>(run_end_cache - pos,
                                                     limit);
                    } else {
                        run = run_length_capped(data, pos, pos + limit);
                        if (run < (int)limit) {
                            // true end found: cache it for the positions
                            // the parse will visit inside this run
                            run_end_cache = pos + run;
                            run_byte_cache = data[pos];
                        }
                    }
                    run_hint = run;
                    // Only shortcut when the run is maximal (hits MAX_MATCH
                    // or the end of input). A shorter run must compete with
                    // regular matching: on interleaved content (e.g. PNG
                    // residual rows of mostly-zeros with periodic nonzeros)
                    // a long row-period match spanning the nonzero bytes
                    // beats zero-run + literal parses by >20%. The hash
                    // chain finds the same dist-1 run anyway (nearest-first),
                    // so nothing is lost by falling through.
                    if (run == (int)limit && run >= mml) {
                        tokens.push_back(match_token(run, 1));
                        literal_run = 0;
                        int64_t end = pos + run;
                        // sparse insert to keep hash chains from degenerating
                        for (int64_t p = pos; p < end && p < len; p += 16) m.insert(p);
                        pos = end;
                        continue;
                    }
                }
                // incompressible mode (parity concept with pixo
                // src/compress/lz77.rs: after 512 straight literals, probe
                // sparsely and update the hash sparsely until data turns
                // compressible again)
                if (pend_len == 0 && literal_run > 512) {
                    if ((pos & 255) != 0) {
                        tokens.push_back(lit_token(data[pos]));
                        if ((pos & 63) == 0) m.insert(pos);
                        literal_run++;
                        pos += 1;
                        continue;
                    }
                    int dist_i = 0;
                    int best_i = m.search_ins(pos, 1, cfg.nice, mml, &dist_i);
                    if (best_i >= MIN_MATCH) {
                        tokens.push_back(match_token(best_i, dist_i));
                        literal_run = 0;
                        int64_t end = pos + best_i;
                        m.insert_span(pos + 1, std::min(end, len));
                        pos = end;
                    } else {
                        tokens.push_back(lit_token(data[pos]));
                        literal_run++;
                        pos += 1;
                    }
                    continue;
                }
                int dist = 0;
                int best;
                // with fused search+insert, pos is in the hash chains by the
                // time a token is emitted for it: a pend-carried match was
                // inserted by last iteration's lazy probe, and both branches
                // below insert via search_ins
                int64_t span_from = pos + 1;
                if (pend_len != 0) {
                    // use the lookahead match found last iteration directly
                    best = pend_len;
                    dist = pend_dist;
                    pend_len = 0;
                } else {
                    best = m.search_ins(pos, std::min(cfg.chain, cfg.depth_cap), cfg.nice, mml, &dist, 0, run_hint);
                    // len-3 matches at long range cost more bits than the
                    // literals they replace (zlib's TOO_FAR rule) and keep
                    // random data out of incompressible mode
                    if (best == MIN_MATCH && dist > 8192) best = 0;

                    // lazy evaluation (parity with lz77.rs:513-561): skip
                    // for "good enough" matches (GOOD_MATCH_LENGTH=16) and
                    // defer only when the next match is >= 3 bytes longer
                    // (a literal costs ~8-9 bits; +3 match bytes justify it)
                    // or reaches the nice cutoff. Lazy2 halves the chain.
                    const int GOOD_MATCH = 16;
                    if (best >= MIN_MATCH && cfg.lazy && best < cfg.nice &&
                        best < GOOD_MATCH && pos + 1 < block_end) {
                        int next_chain = cfg.lazy >= 2
                            ? (cfg.chain / 2 > 1 ? cfg.chain / 2 : 1)
                            : cfg.chain;
                        // zlib good_match analog: with a decent (>=8) match
                        // already in hand, the lazy probe only needs to beat
                        // it by 3 — quarter the walk (zlib deflate.c quarters
                        // chain_length when prev_length >= good_match)
                        if (best >= 8) next_chain = next_chain / 4 > 1
                            ? next_chain / 4 : 1;
                        next_chain = std::min(next_chain, cfg.depth_cap);
                        int dist2 = 0;
                        // threshold-seeded probe (see search_ins): only a
                        // match >= best+3 can defer, so the walk starts there.
                        // run at pos+1 derives from the known run at pos:
                        // >=3 -> run-1; 1..2 -> the probe's seed gate fails
                        int hint2 = run_hint < 0 ? -1
                                    : (run_hint >= 3 ? run_hint - 1 : 0);
                        int best2 = m.search_ins(pos + 1, next_chain, cfg.nice,
                                                 mml, &dist2, best + 3, hint2);
                        span_from = pos + 2;  // pos+1 now inserted too
                        if (best2 >= best + 3 || best2 >= cfg.nice) {
                            tokens.push_back(lit_token(data[pos]));
                            literal_run++;
                            pend_len = best2;
                            pend_dist = dist2;
                            pos += 1;
                            continue;
                        }
                    }
                }

                if (best >= MIN_MATCH) {
                    tokens.push_back(match_token(best, dist));
                    literal_run = 0;
                    int64_t end = pos + best;
                    bool run_span = dist == 1 ||
                        (best >= 32 && data[pos] == data[pos + 1] &&
                         run_length_capped(data, pos, end) == best);
                    if (run_span) {
                        // RLE match, or a match whose span is one equal-byte
                        // run: chain only first and last positions. Interior
                        // positions all hash into the same bucket and only
                        // degenerate the chain (parity with lz77.rs:565-575;
                        // the run seed re-finds them at dist 1 anyway).
                        // pos (and pos+1 when lazily probed) are already
                        // inserted by search_ins; the extra interior entries
                        // that policy would have skipped are the SAME ones
                        // the old code inserted before its find.
                        if (end - 1 >= span_from && end - 1 < len)
                            m.insert(end - 1);
                    } else {
                        m.insert_span(span_from,
                                      std::min(end, (int64_t)len));
                    }
                    pos = end;
                } else {
                    tokens.push_back(lit_token(data[pos]));
                    literal_run++;
                    pos += 1;
                    // software pipeline: the next find's first touch is a
                    // random load from the 256 KiB head table — issue it
                    // now so it overlaps this iteration's tail
                    if (pos + 4 <= len) m.prefetch_head(pos);
                }
            }
            // matches may run past block_end; the block's raw span is the
            // range the tokens actually cover
            if (dbg) { fprintf(stderr, "deflate: lz77 %.2f ms (%zu tokens)\n", (tick() - t0) * 1e3, tokens.size()); t0 = tick(); }
            emit_block_split(w, tokens, data, block_start, pos - block_start,
                             pos == len);
            if (dbg) { fprintf(stderr, "deflate: emit %.2f ms\n", (tick() - t0) * 1e3); t0 = tick(); }
        }
        w.flush();
    }

    if (zlib_wrap) {
        uint32_t a = pixo_adler32(data, len, 1);
        uint8_t tail[4] = {(uint8_t)(a >> 24), (uint8_t)(a >> 16), (uint8_t)(a >> 8), (uint8_t)a};
        w.raw_bytes(tail, 4);
    }
    return w.overflow ? -1 : w.pos;
}

// ========================= optimal DEFLATE ==================================
// Zopfli-style iterative optimal parse (capability parity with pixo
// src/compress/lz77.rs:996-1200 + deflate.rs:291-357): per block, build a
// per-position sublen table (min distance for every achievable length),
// then iterate { entropy cost model from last parse -> shortest-path DP
// over bit costs -> backtrace } and emit the best parse.

namespace deflate {

// Per-position match table stored as distance segments: lengths
// MIN_MATCH..maxlen are covered contiguously (nearest-first first-write-wins
// traversal), and the minimal distance changes only at a handful of length
// breakpoints. Segment k covers lengths (hi[k-1], hi[k]] at distance
// dist[k]. This replaces the dense 259-entry sublen row (68 MB per 128 KiB
// block) with ~8.4 MB and lets the DP hoist the distance cost per segment.
static const int MAX_SEGS = 15;

struct PosSegs {
    uint16_t hi[MAX_SEGS];
    uint16_t dist[MAX_SEGS];
    uint16_t count;
};

// Device-precomputed chain assist (SURVEY §7 step 4: hash/candidate
// passes on device, decisions on host). cand/clen are [N, K] row-major:
// cand[pos*K+k] = the (k+1)-th most recent position sharing pos's 4-byte
// hash (-1 past the chain end), clen the exact match length against pos.
// The arrays cover the first K chain steps; the host walks m.prev for
// deeper chains, so output is identical to the unassisted build.
struct AssistView {
    const int32_t* cand;
    const int32_t* clen;
    int k;
};

struct OptimalParser {
    const uint8_t* data;
    int64_t n;
    int64_t block_start, block_len;
    std::vector<PosSegs> segs;
    std::vector<uint16_t> maxlen;

    OptimalParser(const uint8_t* d, int64_t total, int64_t start, int64_t blen)
        : data(d), n(total), block_start(start), block_len(blen) {}

    // debug counters (PIXO_TPU_OPT_DEBUG): chain-walk visits / tail-word
    // rejects / full match_length evaluations in the last build_matches
    int64_t dbg_visits = 0, dbg_tail_rej = 0, dbg_evals = 0;

    void build_matches(Matcher& m, int chain_limit,
                       const AssistView* av = nullptr,
                       int nice_len = MAX_MATCH,
                       int stall_limit = 0) {
        if (stall_limit <= 0) stall_limit = chain_limit;
        segs.assign((size_t)block_len, PosSegs{{0}, {0}, 0});
        maxlen.assign(block_len, 0);
        // zopfli's long-match shortcut (GetBestLengths): once a position
        // has a maximal 258-byte match, taking it whole is (near-)always
        // optimal, so the 257 interior positions keep empty match tables
        // (literal-only in the DP) and skip the chain walk entirely. On
        // periodic/repetitive content this collapses both the table build
        // and the DP from O(len * 258) to O(len/258 * 258): measured
        // ~90x on 64 KiB of repeated text. Hash insertion still runs for
        // every position so later chains see full history.
        int64_t skip_until = -1;
        for (int64_t i = 0; i < block_len; i++) {
            int64_t pos = block_start + i;
            if (pos < skip_until) {
                m.insert(pos);
                continue;
            }
            if (pos + MIN_MATCH <= n) {
                int max_here = (int)std::min<int64_t>(MAX_MATCH, n - pos);
                PosSegs& sg = segs[i];
                int best = 0;
                const uint8_t* cur = data + pos;
                // 3-byte head first: it is the globally most recent matching
                // position (any 4-byte match also matches 3 bytes), so
                // nearest-first still records the minimum distance per length
                int32_t c3 = m.probe3(pos);
                if (c3 >= 0) {
                    int64_t dist = pos - c3;
                    if (dist > 0 && dist <= WINDOW) {
                        int len = match_length(cur, data + c3, max_here);
                        if (len >= MIN_MATCH) {
                            sg.hi[0] = (uint16_t)len;
                            sg.dist[0] = (uint16_t)dist;
                            sg.count = 1;
                            best = len;
                        }
                    }
                }
                if (pos + 4 <= n && best < max_here && best < nice_len) {
                    uint32_t cur32;
                    memcpy(&cur32, cur, 4);
                    uint32_t h = hash4(cur);
                    int32_t cand = m.head4_at(h);
                    int chain = chain_limit;
                    // productivity budget (see the host walk below); the
                    // assisted prefix must tick the same counter so the
                    // assisted and plain paths stay byte-identical
                    int stall = stall_limit;
                    bool done = false;
                    if (av && av->k > 0) {
                        // consume the device-scored prefix of the chain;
                        // the acceptance logic mirrors the walk below
                        // (candidates only contribute lengths > best, so
                        // the prefix/frontier pruning is subsumed by the
                        // exact device lengths)
                        const int32_t* ac = av->cand + (size_t)pos * av->k;
                        const int32_t* al = av->clen + (size_t)pos * av->k;
                        int kk = 0;
                        for (; kk < av->k; kk++) {
                            int32_t c = ac[kk];
                            if (c < 0 || chain-- <= 0 || stall-- <= 0) {
                                done = true;
                                break;
                            }
                            int64_t dist = pos - c;
                            if (dist > WINDOW) { done = true; break; }
                            if (dist > 0) {
                                int len = al[kk];
                                if (len > max_here) len = max_here;
                                if (len > best) {
                                    if (sg.count == MAX_SEGS) { done = true; break; }
                                    sg.hi[sg.count] = (uint16_t)len;
                                    sg.dist[sg.count] = (uint16_t)dist;
                                    sg.count++;
                                    best = len;
                                    if (best == max_here || best >= nice_len) {
                                        done = true;
                                        break;
                                    }
                                    stall = stall_limit;
                                }
                            }
                            cand = c;  // last consumed chain entry
                        }
                        if (done) cand = -1;
                        else cand = cand >= 0 && kk == av->k ? m.st.prev[cand & WMASK]
                                                             : m.head4_at(h);
                    }
                    // tail-word filter + prefetch pipeline (same idiom as
                    // the greedy search_ins walk): a candidate can only
                    // beat `best` if bytes [best-3, best] all match — a
                    // necessary condition for len > best, so rejecting on
                    // it never changes the recorded segments (bytes out
                    // are identical); it just rejects strictly more than
                    // the old single cur[best] byte for one unaligned
                    // load. In-loop best < max_here (best == max_here
                    // breaks), so cp+best stays in bounds.
                    uint32_t scan_tail = 0;
                    if (best >= 4) memcpy(&scan_tail, cur + best - 3, 4);
                    const int32_t floor_ =
                        (int32_t)(pos > WINDOW ? pos - WINDOW : 0);
                    const int32_t* prevp = m.st.prev.data();
                    // productivity cutoff: stop after stall_limit
                    // consecutive candidates that don't improve `best` —
                    // productive walks (repetitive content finding long
                    // matches early) are unaffected, pathologically deep
                    // unproductive chains (photo content) are cut. The
                    // budget continues across the assisted prefix above.
                    while (cand >= floor_ && cand < pos && chain-- > 0 &&
                           stall-- > 0) {
                        const uint8_t* cp = data + cand;
                        int32_t nxt = prevp[cand & WMASK];
                        __builtin_prefetch(data + nxt);
                        __builtin_prefetch(&prevp[nxt & WMASK]);
                        dbg_visits++;
                        if (best >= 4) {
                            uint32_t c_tail;
                            memcpy(&c_tail, cp + best - 3, 4);
                            if (c_tail != scan_tail) {
                                dbg_tail_rej++;
                                cand = nxt;
                                continue;
                            }
                        }
                        uint32_t c32;
                        memcpy(&c32, cp, 4);
                        if (c32 == cur32 && (best < 4 || cp[best] == cur[best])) {
                            dbg_evals++;
                            int len = 4 + match_length(cur + 4, cp + 4,
                                                       max_here - 4);
                            if (len > best) {
                                if (sg.count == MAX_SEGS) break;
                                // lengths best+1..len at this distance
                                sg.hi[sg.count] = (uint16_t)len;
                                sg.dist[sg.count] = (uint16_t)(pos - cand);
                                sg.count++;
                                best = len;
                                if (best == max_here || best >= nice_len)
                                    break;
                                if (best >= 4)
                                    memcpy(&scan_tail, cur + best - 3, 4);
                                stall = stall_limit;
                            }
                        }
                        cand = nxt;
                    }
                }
                maxlen[i] = (uint16_t)best;
                if (best == MAX_MATCH) {
                    // Prefill the skipped interiors with their one valid
                    // edge: position pos+k provably matches at the same
                    // distance for the remaining MAX_MATCH-k bytes (both
                    // spans lie inside the anchor's verified 258-byte
                    // window), so a DP path landing mid-region can jump
                    // to the region end in one match instead of being
                    // forced into literals (zopfli gives its skipped run
                    // interiors the same kind of edge). The dist==0 lead
                    // segment marks lengths 3..rem-1 as a gap so the DP
                    // does O(1) work per interior position.
                    skip_until = pos + MAX_MATCH;
                    uint16_t d258 = sg.dist[sg.count - 1];
                    for (int k = 1; k < MAX_MATCH && i + k < block_len; k++) {
                        int rem = MAX_MATCH - k;
                        if (rem < MIN_MATCH) break;
                        PosSegs& in = segs[i + k];
                        in.count = 0;
                        if (rem - 1 >= MIN_MATCH) {
                            in.hi[0] = (uint16_t)(rem - 1);
                            in.dist[0] = 0;  // gap: no lengths 3..rem-1
                            in.count = 1;
                        }
                        in.hi[in.count] = (uint16_t)rem;
                        in.dist[in.count] = d258;
                        in.count++;
                        maxlen[i + k] = (uint16_t)rem;
                    }
                }
            }
            m.insert(pos);
        }
    }
};

// entropy cost model (bits, float). Parity concept with pixo CostModel
// (src/compress/lz77.rs:1213-1329): -log2(count/total), unseen = 15 bits.
struct CostModel {
    float lit_cost[286];
    float dist_cost[30];

    void from_fixed() {
        fixed_init();
        for (int i = 0; i < 286; i++) lit_cost[i] = i < 288 ? fixed_lit_len[i] : 15.0f;
        for (int i = 0; i < 30; i++) dist_cost[i] = 5.0f;
    }

    void from_histogram(const uint64_t* lit_freq, const uint64_t* dist_freq) {
        uint64_t lt = 0, dt = 0;
        for (int i = 0; i < 286; i++) lt += lit_freq[i];
        for (int i = 0; i < 30; i++) dt += dist_freq[i];
        for (int i = 0; i < 286; i++)
            lit_cost[i] = lit_freq[i] ? -__builtin_log2f((float)lit_freq[i] / (float)lt) : 15.0f;
        for (int i = 0; i < 30; i++)
            dist_cost[i] = dist_freq[i] ? -__builtin_log2f((float)dist_freq[i] / (float)dt) : 15.0f;
    }
};

static void optimal_parse_block(
    const OptimalParser& p, const CostModel& cm, std::vector<Token>& tokens) {
    tables_init();
    int64_t blen = p.block_len;
    std::vector<float> cost(blen + 1, 1e30f);
    std::vector<int32_t> from_len(blen + 1, 0);
    std::vector<uint16_t> from_dist(blen + 1, 0);
    cost[0] = 0.0f;
    const uint8_t* base = p.data + p.block_start;
    // hoisted per-length cost LUT (length symbol + extra bits)
    float len_cost[MAX_MATCH + 1];
    for (int l = MIN_MATCH; l <= MAX_MATCH; l++) {
        int ls = 257 + len_to_sym[l];
        len_cost[l] = cm.lit_cost[ls] + LEN_EXTRA[ls - 257];
    }
    for (int64_t i = 0; i < blen; i++) {
        float c = cost[i];
        if (c >= 1e30f) continue;
        // literal edge
        float lc = c + cm.lit_cost[base[i]];
        if (lc < cost[i + 1]) { cost[i + 1] = lc; from_len[i + 1] = 1; from_dist[i + 1] = 0; }
        // match edges: distance segments, so the distance cost is computed
        // once per segment and the inner loop is one add + compare per length
        int ml = std::min<int>(p.maxlen[i], (int)(blen - i));
        if (ml >= MIN_MATCH) {
            const PosSegs& sg = p.segs[i];
            float* cost_i = cost.data() + i;
            int32_t* flen_i = from_len.data() + i;
            uint16_t* fdist_i = from_dist.data() + i;
            int l = MIN_MATCH;
            for (int k = 0; k < sg.count && l <= ml; k++) {
                uint16_t d = sg.dist[k];
                int seg_end = std::min<int>(sg.hi[k], ml);
                if (d == 0) {  // gap segment (long-match skip interior)
                    l = seg_end + 1;
                    continue;
                }
                int ds = dist_symbol(d);
                float dc = c + cm.dist_cost[ds] + DIST_EXTRA[ds];
                for (; l <= seg_end; l++) {
                    float mc = dc + len_cost[l];
                    if (mc < cost_i[l]) {
                        cost_i[l] = mc;
                        flen_i[l] = l;
                        fdist_i[l] = d;
                    }
                }
            }
        }
    }
    // backtrace
    std::vector<Token> rev;
    int64_t i = blen;
    while (i > 0) {
        int l = from_len[i];
        if (l <= 1) {
            rev.push_back(lit_token(base[i - 1]));
            i -= 1;
        } else {
            rev.push_back(match_token(l, from_dist[i]));
            i -= l;
        }
    }
    tokens.assign(rev.rbegin(), rev.rend());
}

}  // namespace deflate

static int64_t deflate_optimal_impl(const uint8_t* data, int64_t len,
                                    int32_t iterations, int32_t zlib_wrap,
                                    const deflate::AssistView* av,
                                    uint8_t* out, int64_t out_cap) {
    using namespace deflate;
    if (iterations < 1) iterations = 1;
    LsbWriter w(out, out_cap);
    if (zlib_wrap) {
        uint8_t hdr[2] = {0x78, 0xDA};
        w.raw_bytes(hdr, 2);
    }
    if (len == 0) {
        fixed_init();
        w.write(1, 1); w.write(1, 2);
        w.write(fixed_lit_code[256], fixed_lit_len[256]);
        w.flush();
    } else {
        const int64_t BLOCK = 128 * 1024;
        Matcher m(data, len);
        int64_t pos = 0;
        // Tokens accumulate across parse blocks and are emitted once at the
        // end: parse blocking exists only to bound the match-table memory,
        // and per-parse-block emission wasted a dynamic tree header (~
        // 50-100 B) per 128 KiB on highly compressible payloads. The
        // whole-stream emission lets the adaptive split search place block
        // boundaries by content instead of by parse granularity.
        std::vector<Token> all_tokens;
        while (pos < len) {
            int64_t blen = std::min(len - pos, BLOCK);
            OptimalParser p(data, len, pos, blen);
            const bool dbg = getenv("PIXO_TPU_OPT_DEBUG") != nullptr;
            auto tick = [] {
                struct timespec ts;
                clock_gettime(CLOCK_MONOTONIC, &ts);
                return ts.tv_sec + ts.tv_nsec * 1e-9;
            };
            double t0 = dbg ? tick() : 0.0;
            static const int opt_chain = [] {
                const char* e = getenv("PIXO_TPU_OPT_CHAIN");
                return e ? atoi(e) : 1024;
            }();
            static const int opt_nice = [] {
                const char* e = getenv("PIXO_TPU_OPT_NICE");
                return e ? atoi(e) : MAX_MATCH;
            }();
            static const int opt_stall = [] {
                const char* e = getenv("PIXO_TPU_OPT_STALL");
                return e ? atoi(e) : -1;  // -1 = adaptive
            }();
            int stall = opt_stall;
            if (stall < 0) {
                // Adaptive productivity cutoff: diverse content (photo
                // residuals) finds its productive matches shallow in the
                // chain — a stall cutoff there is ~2x build time for
                // ~+0.3% size. Periodic/smooth content (tiny distinct-
                // 4-gram counts) hides its long row-stride matches deep
                // behind thousands of hash twins: it needs the full
                // chain, and its blocks are cheap anyway (the 258-run
                // skip collapses them). Sampled distinct-4-gram count
                // separates the classes by 2-3 orders of magnitude
                // (measured: 25 vs 7.5k-22k per 128 KiB block).
                const int SAMPLE = 16384;
                int64_t avail = blen - 3;
                int take = (int)std::min<int64_t>(SAMPLE, avail);
                if (take > 256) {
                    std::vector<uint32_t> grams((size_t)take);
                    int64_t step = avail / take;
                    if (step < 1) step = 1;
                    const uint8_t* bp = data + pos;
                    for (int k = 0; k < take; k++)
                        memcpy(&grams[k], bp + (int64_t)k * step, 4);
                    std::sort(grams.begin(), grams.end());
                    int distinct = 1;
                    for (int k = 1; k < take; k++)
                        distinct += grams[k] != grams[k - 1];
                    stall = distinct >= 1024 ? 128 : 0;
                } else {
                    stall = 0;
                }
            }
            p.build_matches(m, opt_chain, av, opt_nice, stall);
            if (dbg)
                fprintf(stderr,
                        "opt: build_matches %.0f ms (block %lld, visits %lld, "
                        "tail_rej %lld, evals %lld)\n",
                        (tick() - t0) * 1e3, (long long)blen,
                        (long long)p.dbg_visits, (long long)p.dbg_tail_rej,
                        (long long)p.dbg_evals);

            CostModel cm;
            cm.from_fixed();
            std::vector<Token> tokens, prev_tokens, best_tokens;
            double prev_cost = 1e300, best_cost = 1e300;
            for (int it = 0; it < iterations; it++) {
                if (dbg) t0 = tick();
                optimal_parse_block(p, cm, tokens);
                // parse self-entropy (model-independent quality measure):
                // sum of -log2(p) over the parse's own symbol histogram
                // plus the extra bits — comparable across iterations.
                uint64_t lit_freq[286] = {0}, dist_freq[30] = {0};
                double extra_bits = 0.0;
                for (const Token& t : tokens) {
                    if (t.v & 0x80000000u) {
                        int l = (t.v >> 16) & 0x1FF;
                        int ls = 257 + len_to_sym[l];
                        int ds = dist_symbol((int)(t.v & 0xFFFF));
                        lit_freq[ls]++;
                        dist_freq[ds]++;
                        extra_bits += LEN_EXTRA[ls - 257] + DIST_EXTRA[ds];
                    } else {
                        lit_freq[t.v & 0xFF]++;
                    }
                }
                lit_freq[256]++;
                uint64_t lt = 0, dt = 0;
                for (int s = 0; s < 286; s++) lt += lit_freq[s];
                for (int s = 0; s < 30; s++) dt += dist_freq[s];
                double self_cost = extra_bits;
                for (int s = 0; s < 286; s++)
                    if (lit_freq[s])
                        self_cost -= (double)lit_freq[s] *
                            log2((double)lit_freq[s] / (double)lt);
                for (int s = 0; s < 30; s++)
                    if (dist_freq[s])
                        self_cost -= (double)dist_freq[s] *
                            log2((double)dist_freq[s] / (double)dt);
                if (dbg) fprintf(stderr,
                                 "opt: DP iter %d %.0f ms (%zu tokens, %.0f est bits)\n",
                                 it, (tick() - t0) * 1e3, tokens.size(),
                                 self_cost);
                if (self_cost < best_cost) {
                    best_cost = self_cost;
                    best_tokens = tokens;
                }
                // exact convergence: an unchanged parse yields the same
                // histogram, hence the same cost model, hence the same
                // parse forever
                if (it > 0 && tokens.size() == prev_tokens.size() &&
                    memcmp(tokens.data(), prev_tokens.data(),
                           tokens.size() * sizeof(Token)) == 0)
                    break;
                // near-convergence: <0.1% estimated improvement (the
                // reference's iteration threshold, deflate.rs:291-357);
                // the best parse seen so far is kept either way
                if (it > 0 && self_cost >= prev_cost * 0.999)
                    break;
                prev_cost = self_cost;
                if (it + 1 < iterations) {
                    prev_tokens = tokens;
                    cm.from_histogram(lit_freq, dist_freq);
                }
            }
            all_tokens.insert(all_tokens.end(), best_tokens.begin(),
                              best_tokens.end());
            pos += blen;
        }
        emit_block_split(w, all_tokens, data, 0, len, true,
                         /*force_split_search=*/true);
        w.flush();
    }
    if (zlib_wrap) {
        uint32_t a = pixo_adler32(data, len, 1);
        uint8_t tail[4] = {(uint8_t)(a >> 24), (uint8_t)(a >> 16), (uint8_t)(a >> 8), (uint8_t)a};
        w.raw_bytes(tail, 4);
    }
    return w.overflow ? -1 : w.pos;
}

EXPORT int64_t deflate_compress_optimal(const uint8_t* data, int64_t len,
                                        int32_t iterations, int32_t zlib_wrap,
                                        uint8_t* out, int64_t out_cap) {
    return deflate_optimal_impl(data, len, iterations, zlib_wrap, nullptr,
                                out, out_cap);
}

// Optimal parse with device-precomputed chain candidates (the [HK] split
// of SURVEY §2.2: hash bucketing + match-length scoring on device, the
// sequential DP and bit emission on host). cand/clen: [len, k] row-major
// int32 (see AssistView). Byte-identical to the unassisted entry.
EXPORT int64_t deflate_compress_optimal_assisted(
    const uint8_t* data, int64_t len, int32_t iterations, int32_t zlib_wrap,
    const int32_t* cand, const int32_t* clen, int32_t k,
    uint8_t* out, int64_t out_cap) {
    deflate::AssistView av{cand, clen, (int)k};
    return deflate_optimal_impl(data, len, iterations, zlib_wrap,
                                k > 0 ? &av : nullptr, out, out_cap);
}

// ====================== reference byte-parity DEFLATE =======================
// Exact mirror of the reference's DECISION layer (pixo src/compress/
// lz77.rs + deflate.rs): hash functions and table shapes, matcher
// traversal and tie-breaking, lazy/incompressible state machines, block
// segmentation (whole-stream tokens, <=128-token fixed/dynamic rule,
// coarse-to-fine split search with the reference's f64 accumulation
// order), the level ladder including the level-1 HT bucket matcher, the
// 4096-slot collision entropy gate, and the stream-level stored
// comparison. The one remaining layer that is NOT mirrored is Huffman
// table construction (we use package-merge; the reference uses a
// BinaryHeap + Kraft limiting whose tie-breaking is Rust-heap-specific)
// — see NOTES.md "DEFLATE divergence table".

namespace refparity {

using deflate::Token;
using deflate::lit_token;
using deflate::match_token;
using deflate::match_length;
using deflate::run_length_capped;
using deflate::calc_min_match;
using deflate::emit_block;
using deflate::emit_stored_all;
using deflate::len_to_sym;
using deflate::dist_symbol;
using deflate::LEN_EXTRA;
using deflate::DIST_EXTRA;
using deflate::tables_init;

static const int64_t RWINDOW = 32768;
static const int RMIN = 3;
static const int RMAX = 258;
static const int RHASH_SIZE = 1 << 16;
static const int RHASH3_SIZE = 1 << 15;
static const int RHT_BITS = 15;
static const int RHT_SIZE = 1 << RHT_BITS;

static inline uint32_t rhash4(const uint8_t* d, int64_t n, int64_t pos) {
    if (pos + 3 >= n) return 0;
    uint32_t v;
    memcpy(&v, d + pos, 4);
    return ((v * 0x1E35A7BDu) >> 16) & (RHASH_SIZE - 1);
}

static inline uint32_t rhash3(const uint8_t* d, int64_t n, int64_t pos) {
    if (pos + 2 >= n) return 0;
    uint32_t v = (uint32_t)d[pos] | ((uint32_t)d[pos + 1] << 8) |
                 ((uint32_t)d[pos + 2] << 16);
    return ((v * 0x1E35A7BDu) >> 17) & (RHASH3_SIZE - 1);
}

static inline uint32_t rhash4_ht(const uint8_t* d, int64_t n, int64_t pos) {
    if (pos + 3 >= n) return 0;
    uint32_t v;
    memcpy(&v, d + pos, 4);
    return ((v * 0x1E35A7BDu) >> (32 - RHT_BITS)) & (RHT_SIZE - 1);
}

// detect_same_byte_run (lz77.rs:272-316) == capped run length
static inline int64_t ref_run(const uint8_t* d, int64_t n, int64_t pos) {
    if (pos >= n) return 0;
    int64_t cap = std::min<int64_t>(n - pos, RMAX);
    return run_length_capped(d, pos, pos + cap);
}

static inline int64_t ref_match_length(const uint8_t* d, int64_t n,
                                       int64_t p1, int64_t p2) {
    int max_len = (int)std::min<int64_t>(n - p2, RMAX);
    return match_length(d + p2, d + p1, max_len);
}

struct RefConfig {
    int64_t chain, depth, nice;
    int lazy;  // 0=None, 1=Lazy, 2=Lazy2
    bool use_ht;
};

static RefConfig ref_config(int level) {
    switch (level) {  // lz77.rs:1415-1488
        case 1: return {4, 4, 32, 0, true};
        case 2: return {8, 6, 10, 0, false};
        case 3: return {16, 12, 14, 0, false};
        case 4: return {32, 16, 30, 0, false};
        case 5: return {64, 16, 30, 1, false};
        case 6: return {128, 35, 65, 1, false};
        case 7: return {256, 100, 130, 1, false};
        case 8: return {1024, 300, RMAX, 2, false};
        case 9: return {4096, 600, RMAX, 2, false};
        default: return {4096, 600, RMAX, 2, false};
    }
}

struct RefMatcher {
    std::vector<int32_t> head, head3, prev;
    std::vector<int32_t> ht;  // RHT_SIZE x 2 buckets
    const uint8_t* d;
    int64_t n;

    RefMatcher(const uint8_t* dd, int64_t nn)
        : head(RHASH_SIZE, -1), head3(RHASH3_SIZE, -1),
          prev(RWINDOW, -1), ht(RHT_SIZE * 2, -1), d(dd), n(nn) {}

    // update_hash (lz77.rs:864-876): both tables gated at pos+3 < n,
    // prev indexed mod the window
    inline void update_hash(int64_t pos) {
        if (pos + 3 >= n) return;
        head3[rhash3(d, n, pos)] = (int32_t)pos;
        uint32_t h = rhash4(d, n, pos);
        prev[pos % RWINDOW] = head[h];
        head[h] = (int32_t)pos;
    }

    // find_best_match (lz77.rs:605-751)
    bool find(int64_t pos, int64_t chain_limit, int64_t nice, int64_t mml,
              int* len_out, int* dist_out) {
        if (pos + RMIN > n) return false;
        int64_t run_len = ref_run(d, n, pos);
        bool run_ok = run_len >= mml && pos >= 1 && d[pos - 1] == d[pos];
        if (run_ok && (run_len >= nice || run_len >= RMAX)) {
            *len_out = (int)std::min<int64_t>(run_len, RMAX);
            *dist_out = 1;
            return true;
        }
        int64_t best_len = mml - 1, best_dist = 0;
        if (run_ok) { best_len = run_len; best_dist = 1; }

        int32_t cand3 = head3[rhash3(d, n, pos)];
        if (cand3 >= 0) {
            int64_t mp = cand3, dist = pos - mp;
            if (dist != 0 && dist <= RWINDOW && mp + 3 <= n &&
                memcmp(d + pos, d + mp, 3) == 0) {
                int64_t len = ref_match_length(d, n, mp, pos);
                if (len >= mml && !(len == 3 && dist > 8192) &&
                    (len > best_len || (len == best_len && dist < best_dist))) {
                    best_len = len;
                    best_dist = dist;
                    if (best_len >= nice) {
                        *len_out = (int)best_len;
                        *dist_out = (int)best_dist;
                        return true;
                    }
                }
            }
        }

        int32_t chain_pos = head[rhash4(d, n, pos)];
        int64_t max_distance = std::min<int64_t>(pos, RWINDOW);
        int64_t chain_remaining = chain_limit;
        bool have_prefix = pos + 4 <= n;
        uint32_t prefix = 0;
        if (have_prefix) memcpy(&prefix, d + pos, 4);
        while (chain_pos >= 0 && chain_remaining > 0) {
            int64_t mp = chain_pos, dist = pos - mp;
            if (dist == 0) {
                chain_pos = prev[mp % RWINDOW];
                chain_remaining--;
                continue;
            }
            if (dist > max_distance) break;
            if (have_prefix && mp + 4 <= n) {
                uint32_t c;
                memcpy(&c, d + mp, 4);
                if (c != prefix) {
                    chain_pos = prev[mp % RWINDOW];
                    chain_remaining--;
                    continue;
                }
            }
            int64_t len = ref_match_length(d, n, mp, pos);
            if (len >= mml && !(len == 3 && dist > 8192) &&
                (len > best_len || (len == best_len && dist < best_dist))) {
                best_len = len;
                best_dist = dist;
                if (len >= RMAX || best_len >= nice) break;
            }
            chain_pos = prev[mp % RWINDOW];
            chain_remaining--;
        }
        if (best_len >= mml) {
            *len_out = (int)best_len;
            *dist_out = (int)best_dist;
            return true;
        }
        return false;
    }

    // find_best_match_ht (lz77.rs:751-811): 2-entry buckets, inserts pos
    bool find_ht(int64_t pos, int64_t nice, int64_t mml,
                 int* len_out, int* dist_out) {
        if (pos + RMIN > n) return false;
        int32_t* bucket = &ht[(size_t)rhash4_ht(d, n, pos) * 2];
        int32_t cand0 = bucket[0], cand1 = bucket[1];
        bucket[1] = cand0;
        bucket[0] = (int32_t)pos;
        int64_t best_len = mml - 1, best_dist = 0;
        for (int32_t cand : {cand0, cand1}) {
            if (cand < 0) continue;
            int64_t mp = cand, dist = pos - mp;
            if (dist == 0 || dist > RWINDOW || mp + 3 > n) continue;
            if (memcmp(d + pos, d + mp, 3) != 0) continue;
            int64_t len = ref_match_length(d, n, mp, pos);
            if (len < mml || (len == 3 && dist > 8192)) continue;
            if (len > best_len) {
                best_len = len;
                best_dist = dist;
                if (best_len >= nice) break;
            }
        }
        if (best_len >= mml) {
            *len_out = (int)best_len;
            *dist_out = (int)best_dist;
            return true;
        }
        return false;
    }
};

// compress_into_sink (lz77.rs:403-591)
static void compress_tokens(const uint8_t* d, int64_t n, int level,
                            std::vector<Token>& out) {
    RefConfig cfg = ref_config(level);
    const int64_t mml = calc_min_match(d, n, (int)cfg.depth);
    RefMatcher m(d, n);
    out.clear();
    out.reserve((size_t)n);

    int64_t pos = 0, literal_streak = 0, probe_since_last = 0,
            incompressible_updates = 0;
    bool incompressible = false;
    bool have_pend = false;
    int pend_len = 0, pend_dist = 0;

    auto insert_match = [&](int64_t p, int L, int D) {
        if (D == 1 && L >= RMIN) {
            m.update_hash(p);
            if (L > 1) m.update_hash(p + L - 1);
        } else {
            for (int i = 0; i < L; i++) m.update_hash(p + i);
        }
    };

    while (pos < n) {
        if (incompressible) {
            if (probe_since_last >= 256) {
                probe_since_last = 0;
                int L, D;
                if (m.find(pos, std::min<int64_t>(1, cfg.depth), cfg.nice,
                           mml, &L, &D)) {
                    incompressible = false;
                    literal_streak = 0;
                    out.push_back(match_token(L, D));
                    insert_match(pos, L, D);
                    pos += L;
                    continue;
                }
            }
            out.push_back(lit_token(d[pos]));
            if (++incompressible_updates >= 64) {
                m.update_hash(pos);
                incompressible_updates = 0;
            }
            pos++;
            literal_streak++;
            probe_since_last++;
            continue;
        }

        int64_t chain_limit;
        if (literal_streak >= 512) {
            incompressible = true;
            probe_since_last = 0;
            chain_limit = 1;
        } else {
            chain_limit = cfg.chain;
        }

        int L = 0, D = 0;
        bool found;
        if (have_pend) {
            L = pend_len;
            D = pend_dist;
            found = true;
            have_pend = false;
        } else if (cfg.use_ht) {
            found = m.find_ht(pos, cfg.nice, mml, &L, &D);
        } else {
            found = m.find(pos, std::min(chain_limit, cfg.depth), cfg.nice,
                           mml, &L, &D);
        }

        if (found) {
            literal_streak = 0;
            incompressible = false;
            probe_since_last = 0;
            if (D == 0) {  // defensive, mirrors lz77.rs:505-511
                out.push_back(lit_token(d[pos]));
                m.update_hash(pos);
                pos++;
                continue;
            }
            if (cfg.lazy != 0 && L < cfg.nice && L < 16 && pos + 1 < n) {
                m.update_hash(pos);
                int64_t next_chain =
                    cfg.lazy == 2 ? std::max<int64_t>(chain_limit / 2, 1)
                                  : chain_limit;
                int L2, D2;
                bool f2;
                if (cfg.use_ht) {
                    f2 = m.find_ht(pos + 1, cfg.nice, mml, &L2, &D2);
                } else {
                    f2 = m.find(pos + 1, std::min(next_chain, cfg.depth),
                                cfg.nice, mml, &L2, &D2);
                }
                if (f2 && (L2 >= L + 3 || L2 >= cfg.nice)) {
                    out.push_back(lit_token(d[pos]));
                    pend_len = L2;
                    pend_dist = D2;
                    have_pend = true;
                    pos++;
                    continue;
                }
            }
            out.push_back(match_token(L, D));
            insert_match(pos, L, D);
            pos += L;
        } else {
            literal_streak++;
            if (literal_streak >= 512) {
                incompressible = true;
                probe_since_last = 0;
                incompressible_updates = 0;
            }
            out.push_back(lit_token(d[pos]));
            m.update_hash(pos);
            pos++;
        }
    }
}

// is_high_entropy_data (deflate.rs:1108-1145): 4096-slot collision table
static bool ref_high_entropy(const uint8_t* d, int64_t n) {
    if (n < 4096) return false;
    int64_t sample = std::min<int64_t>(n, 8192);
    bool seen[4096] = {false};
    int64_t collisions = 0;
    for (int64_t i = 0; i + 4 <= sample; i++) {
        uint32_t v;
        memcpy(&v, d + i, 4);
        uint32_t h = ((v * 0x1E35A7BDu) >> 20) & 4095;
        if (seen[h]) collisions++;
        else seen[h] = true;
    }
    int64_t total = sample >= 3 ? sample - 3 : 0;
    return (float)collisions / (float)total < 0.05f;
}

// estimate_block_cost (deflate.rs:484-535): exact f64 accumulation order
static double estimate_block_cost(const std::vector<Token>& tokens,
                                  size_t start, size_t end) {
    if (end <= start) return 0.0;
    tables_init();
    uint32_t lit[286] = {0}, dist[30] = {0};
    for (size_t i = start; i < end; i++) {
        const Token& t = tokens[i];
        if (t.v & 0x80000000u) {
            lit[257 + len_to_sym[(t.v >> 16) & 0x1FF]]++;
            dist[dist_symbol((int)(t.v & 0xFFFF))]++;
        } else {
            lit[t.v & 0xFF]++;
        }
    }
    lit[256]++;
    bool any = false;
    for (int i = 0; i < 30; i++) any |= dist[i] != 0;
    if (!any) dist[0] = 1;

    uint64_t lit_total = 0, dist_total = 0;
    for (int i = 0; i < 286; i++) lit_total += lit[i];
    for (int i = 0; i < 30; i++) dist_total += dist[i];
    if (lit_total == 0) return 300.0;
    double log_lit = std::log2((double)lit_total);
    double log_dist = dist_total > 0 ? std::log2((double)dist_total) : 0.0;
    double bits = 300.0;
    for (int i = 0; i < 286; i++)
        if (lit[i])
            bits += (double)lit[i] * (log_lit - std::log2((double)lit[i]));
    for (int i = 0; i < 30; i++)
        if (dist[i])
            bits += (double)dist[i] * (log_dist - std::log2((double)dist[i]));
    for (size_t i = start; i < end; i++) {
        const Token& t = tokens[i];
        if (t.v & 0x80000000u) {
            int ls = len_to_sym[(t.v >> 16) & 0x1FF];
            int ds = dist_symbol((int)(t.v & 0xFFFF));
            bits += (double)(LEN_EXTRA[ls] + DIST_EXTRA[ds]);
        }
    }
    return bits;
}

// find_best_split / find_block_splits (deflate.rs:538-653)
static const size_t RMIN_BLOCK = 10;

static bool find_best_split(const std::vector<Token>& tokens, size_t start,
                            size_t end, size_t* split_out) {
    if (end - start < RMIN_BLOCK * 2) return false;
    double orig = estimate_block_cost(tokens, start, end);
    bool have = false;
    size_t best_split = 0;
    double best_cost = orig;

    size_t step = std::max<size_t>((end - start) / 9, 1);
    bool have_cand = false;
    size_t cand_i = 0;
    double cand_cost = 0.0;
    for (size_t i = start + RMIN_BLOCK; i < end - RMIN_BLOCK; i += step) {
        double total = estimate_block_cost(tokens, start, i) +
                       estimate_block_cost(tokens, i, end);
        if (!have_cand || total < cand_cost) {
            have_cand = true;
            cand_i = i;
            cand_cost = total;
        }
    }
    if (have_cand && cand_cost < best_cost) {
        best_cost = cand_cost;
        best_split = cand_i;
        have = true;
    }
    if (have) {
        size_t fine_start = best_split > step ? best_split - step : 0;
        fine_start = std::max(fine_start, start + RMIN_BLOCK);
        size_t fine_end = std::min(best_split + step, end - RMIN_BLOCK);
        for (size_t i = fine_start; i <= fine_end; i++) {
            double total = estimate_block_cost(tokens, start, i) +
                           estimate_block_cost(tokens, i, end);
            if (total < best_cost) {
                best_cost = total;
                best_split = i;
            }
        }
    }
    if (have && best_cost < orig - 10.0) {
        *split_out = best_split;
        return true;
    }
    return false;
}

static std::vector<size_t> find_block_splits(const std::vector<Token>& tokens,
                                             size_t max_blocks) {
    std::vector<size_t> splits;
    if (tokens.size() < RMIN_BLOCK * 2 || max_blocks <= 1) return splits;
    std::vector<bool> done(tokens.size(), false);
    size_t num_blocks = 1;
    while (num_blocks < max_blocks) {
        std::vector<size_t> bounds;
        bounds.push_back(0);
        for (size_t s : splits) bounds.push_back(s);
        bounds.push_back(tokens.size());
        bool have_largest = false;
        size_t ls = 0, le = 0, lsz = 0;
        for (size_t i = 0; i + 1 < bounds.size(); i++) {
            size_t s = bounds[i], e = bounds[i + 1], sz = e - s;
            if (!done[s] && sz >= RMIN_BLOCK * 2 && (!have_largest || sz > lsz)) {
                have_largest = true;
                ls = s; le = e; lsz = sz;
            }
        }
        if (!have_largest) break;
        size_t split;
        if (find_best_split(tokens, ls, le, &split)) {
            auto it = splits.begin();
            while (it != splits.end() && *it <= split) ++it;
            splits.insert(it, split);
            num_blocks++;
        } else {
            done[ls] = true;
        }
    }
    return splits;
}

// should_use_stored (deflate.rs:1091-1097)
static bool should_use_stored(int64_t data_len, int64_t deflated_len) {
    int64_t stored_overhead = (data_len / 65535 + 1) * 5;
    int64_t stored_total = data_len + stored_overhead + 2 + 4;
    int64_t deflated_total = deflated_len + 2 + 4;
    return deflated_total >= stored_total;
}

// ============ optimal (Zopfli-style) mirror: deflate.rs:270-900 =============
// Exact mirror of the reference's iterative optimal path used by PNG max:
// deflate_optimal_zlib(filtered, 5) (png/mod.rs:571-573). Split path for
// inputs <= 512 KiB, plain path above; CostModel entropy costs in f32;
// find_match_with_sublen + compress_optimal_cached (lz77.rs:886-1210);
// statistics blending and f32 convergence (deflate.rs:762-860).

struct RefCostModel {  // lz77.rs:1213-1310
    float lit_len[286];
    float dist[30];
    void set_fixed() {
        for (int i = 0; i < 144; i++) lit_len[i] = 8.0f;
        for (int i = 144; i < 256; i++) lit_len[i] = 9.0f;
        for (int i = 256; i < 280; i++) lit_len[i] = 7.0f;
        for (int i = 280; i < 286; i++) lit_len[i] = 8.0f;
        for (int i = 0; i < 30; i++) dist[i] = 5.0f;
    }
    // NOTE on log2: the reference (wasm build) uses Rust's libm log2f
    // (musl-derived); host glibc log2f is a different implementation.
    // Byte-identity against the oracle is the executable check that the
    // two agree on the u32-count inputs this model ever sees.
    void from_statistics(const uint32_t* lc, const uint32_t* dc) {
        uint32_t lit_total = 0;
        for (int i = 0; i < 286; i++) lit_total += lc[i];
        if (lit_total == 0) { set_fixed(); return; }
        float log_total = log2f((float)lit_total);
        for (int i = 0; i < 286; i++)
            lit_len[i] = lc[i] > 0 ? log_total - log2f((float)lc[i]) : 15.0f;
        uint32_t dist_total = 0;
        for (int i = 0; i < 30; i++) dist_total += dc[i];
        if (dist_total > 0) {
            float dlt = log2f((float)dist_total);
            for (int i = 0; i < 30; i++)
                dist[i] = dc[i] > 0 ? dlt - log2f((float)dc[i]) : 15.0f;
        } else {
            for (int i = 0; i < 30; i++) dist[i] = 5.0f;
        }
    }
    float literal_cost(uint8_t b) const { return lit_len[b]; }
    float match_cost(int len, int dv) const {
        float lc = lit_len[257 + len_to_sym[len]] +
                   (float)deflate::len_extra_bits[len];
        int ds = dist_symbol(dv);
        float dcst = dist[ds] + (float)DIST_EXTRA[ds];
        return lc + dcst;
    }
};

static void ref_count_symbols(const std::vector<Token>& tokens,
                              uint32_t lit[286], uint32_t dist[30]) {
    memset(lit, 0, 286 * sizeof(uint32_t));
    memset(dist, 0, 30 * sizeof(uint32_t));
    for (const Token& t : tokens) {
        if (t.v & 0x80000000u) {
            int len = (int)((t.v >> 16) & 0x7FFF);
            int dv = (int)(t.v & 0xFFFF);
            lit[257 + len_to_sym[len]]++;
            dist[dist_symbol(dv)]++;
        } else {
            lit[t.v & 0xFF]++;
        }
    }
    lit[256]++;  // end of block
    bool any = false;
    for (int i = 0; i < 30; i++) any |= dist[i] != 0;
    if (!any) dist[0] = 1;
}

// Longest-match cache entry: sublen compressed as monotone steps.
// sublen[len] = min distance over candidates with length >= len, which is
// non-decreasing in len, so (up_to_len, dist) steps reproduce the full
// [259] array the reference caches per position (lz77.rs:85-146).
struct RefCacheEntry {
    std::vector<std::pair<uint16_t, uint16_t>> steps;  // (last len, dist)
    uint16_t max_len = 0;
};

struct RefOptimalParser {
    const uint8_t* d;
    int64_t n;
    int chain_limit;  // min(max_chain_length, max_search_depth), level 9
    std::vector<int32_t> head, head3, prev;
    std::vector<RefCacheEntry> cache;
    bool cache_ready = false;

    RefOptimalParser(const uint8_t* data, int64_t len)
        : d(data), n(len) {
        RefConfig cfg = ref_config(9);
        chain_limit = cfg.chain < cfg.depth ? cfg.chain : cfg.depth;
        head.assign(RHASH_SIZE, -1);
        head3.assign(RHASH3_SIZE, -1);
        prev.assign(RWINDOW, -1);
        cache.resize((size_t)len);
    }

    void update_hash(int64_t pos) {  // lz77.rs:864-876
        if (pos + 3 >= n) return;
        head3[rhash3(d, n, pos)] = (int32_t)pos;
        uint32_t h = rhash4(d, n, pos);
        prev[pos % RWINDOW] = head[h];
        head[h] = (int32_t)pos;
    }

    // lz77.rs:886-982 — fills sublen[3..=max] (0 = none), returns max_len
    int find_match_with_sublen(int64_t pos, uint16_t* sublen) {
        memset(sublen, 0, 259 * sizeof(uint16_t));
        int max_length = 0;
        if (pos + RMIN > n) return 0;

        int64_t run_len = ref_run(d, n, pos);
        if (run_len >= RMIN && pos >= 1 && d[pos - 1] == d[pos]) {
            for (int64_t l = RMIN; l <= run_len; l++) sublen[l] = 1;
            max_length = (int)run_len;
            if (run_len >= RMAX) return max_length;
        }

        int32_t c3 = head3[rhash3(d, n, pos)];
        if (c3 >= 0) {
            int64_t distv = pos - c3;
            if (distv != 0 && distv <= RWINDOW && c3 + 3 <= n &&
                d[pos] == d[c3] && d[pos + 1] == d[c3 + 1] &&
                d[pos + 2] == d[c3 + 2]) {
                if (sublen[3] == 0 || (uint16_t)distv < sublen[3])
                    sublen[3] = (uint16_t)distv;
                if (max_length < 3) max_length = 3;
            }
        }

        int32_t chain_pos = head[rhash4(d, n, pos)];
        int64_t max_distance = pos < RWINDOW ? pos : RWINDOW;
        int remaining = chain_limit;
        while (chain_pos >= 0 && remaining > 0) {
            int64_t mp = chain_pos;
            int64_t distv = pos - mp;
            if (distv == 0) {
                chain_pos = prev[mp % RWINDOW];
                remaining--;
                continue;
            }
            if (distv > max_distance) break;
            int length = (int)ref_match_length(d, n, mp, pos);
            if (length >= RMIN && !(length == 3 && distv > 8192)) {
                for (int l = RMIN; l <= length; l++) {
                    if (sublen[l] == 0 || (uint16_t)distv < sublen[l])
                        sublen[l] = (uint16_t)distv;
                }
                if (length > max_length) {
                    max_length = length;
                    if (max_length >= RMAX) break;
                }
            }
            chain_pos = prev[mp % RWINDOW];
            remaining--;
        }
        return max_length;
    }

    void cache_set(int64_t pos, const uint16_t* sublen, int max_len) {
        RefCacheEntry& e = cache[pos];
        e.max_len = (uint16_t)max_len;
        e.steps.clear();
        int l = RMIN;
        while (l <= max_len) {
            uint16_t dv = sublen[l];
            int hi = l;
            while (hi + 1 <= max_len && sublen[hi + 1] == dv) hi++;
            e.steps.push_back({(uint16_t)hi, dv});
            l = hi + 1;
        }
    }

    // compress_optimal_cached (lz77.rs:1066-1141): first call populates
    // the cache + hash tables; later calls replay cached sublen tables.
    void parse(const RefCostModel& model, std::vector<Token>& out) {
        out.clear();
        if (n == 0) return;
        const float FMAX = 3.4028234663852886e38f;  // f32::MAX
        std::vector<float> costs((size_t)n + 1, FMAX);
        std::vector<uint16_t> len_arr((size_t)n + 1, 0);
        std::vector<uint16_t> dist_arr((size_t)n + 1, 0);
        costs[0] = 0.0f;
        uint16_t sublen[259];

        for (int64_t i = 0; i < n; i++) {
            if (costs[i] >= FMAX) continue;
            float lit_cost = costs[i] + model.literal_cost(d[i]);
            if (lit_cost < costs[i + 1]) {
                costs[i + 1] = lit_cost;
                len_arr[i + 1] = 1;
                dist_arr[i + 1] = 0;
            }
            if (!cache_ready) {
                int ml = find_match_with_sublen(i, sublen);
                cache_set(i, sublen, ml);
                update_hash(i);
            }
            const RefCacheEntry& e = cache[i];
            // walk the step-compressed sublen per length (cost varies per
            // length even at equal distance)
            int l = RMIN;
            for (const auto& step : e.steps) {
                uint16_t dv = step.second;
                for (; l <= step.first; l++) {
                    if (dv == 0) continue;
                    float mc = costs[i] + model.match_cost(l, dv);
                    int64_t end_pos = i + l;
                    if (end_pos <= n && mc < costs[end_pos]) {
                        costs[end_pos] = mc;
                        len_arr[end_pos] = (uint16_t)l;
                        dist_arr[end_pos] = dv;
                    }
                }
            }
        }
        cache_ready = true;

        // trace_backwards (lz77.rs:1144-1210)
        std::vector<std::pair<int, uint16_t>> rev;
        int64_t p = n;
        while (p > 0) {
            int len = len_arr[p];
            if (len == 0) break;
            rev.push_back({len, dist_arr[p]});
            p -= len;
        }
        int64_t data_pos = 0;
        for (auto it = rev.rbegin(); it != rev.rend(); ++it) {
            int len = it->first;
            uint16_t dv = it->second;
            if (len == 1 && dv == 0) {
                out.push_back(lit_token(d[data_pos]));
            } else if (dv == 0) {
                out.push_back(lit_token(d[data_pos]));  // defensive mirror
            } else {
                out.push_back(match_token(len, dv));
            }
            data_pos += len;
        }
    }
};

// Shared zopfli iteration driver (deflate_optimal_split deflate.rs:762-854
// and deflate_optimal :291-360 differ ONLY in what they keep per
// iteration). `on_tokens` fires for the greedy baseline and after every
// parse — including the converging iteration, which both reference
// variants consume before breaking. The convergence arithmetic (f32 cost
// sum in token order, |prev-cost| < cost*0.001, the 0.5f stats blend)
// must stay bit-exact with the oracle and lives only here.
template <typename F>
static void ref_optimal_iterate(const uint8_t* data, int64_t len,
                                int iterations, F&& on_tokens) {
    std::vector<Token> initial;
    compress_tokens(data, len, 9, initial);
    uint32_t lit_counts[286], dist_counts[30];
    ref_count_symbols(initial, lit_counts, dist_counts);
    on_tokens(initial);
    float prev_cost = 3.4028234663852886e38f;  // f32::MAX
    RefOptimalParser parser(data, len);
    RefCostModel model;
    std::vector<Token> tokens;
    for (int iter = 0; iter < iterations; iter++) {
        model.from_statistics(lit_counts, dist_counts);
        parser.parse(model, tokens);
        on_tokens(tokens);
        uint32_t new_lit[286], new_dist[30];
        ref_count_symbols(tokens, new_lit, new_dist);
        float cost = 0.0f;
        for (const Token& t : tokens) {
            if (t.v & 0x80000000u)
                cost += model.match_cost((int)((t.v >> 16) & 0x7FFF),
                                         (int)(t.v & 0xFFFF));
            else
                cost += model.literal_cost((uint8_t)(t.v & 0xFF));
        }
        if (iter > 2 && fabsf(prev_cost - cost) < cost * 0.001f) break;
        prev_cost = cost;
        for (int i = 0; i < 286; i++)
            lit_counts[i] =
                (uint32_t)((float)lit_counts[i] * 0.5f + (float)new_lit[i]);
        for (int i = 0; i < 30; i++)
            dist_counts[i] =
                (uint32_t)((float)dist_counts[i] * 0.5f + (float)new_dist[i]);
    }
}

}  // namespace refparity

// deflate_zlib / deflate (reference parity): decision layer mirrored from
// pixo deflate.rs:245-269 (<=1 KiB raw fixed-only), :900-960 (whole-stream
// tokens, level>=5 1KiB..512KiB split, <=128-token fixed/dynamic rule),
// :1066-1097 (entropy gate + stream-level stored comparison, zlib only).
EXPORT int64_t deflate_compress_parity(const uint8_t* data, int64_t len,
                                       int32_t level, int32_t zlib_wrap,
                                       int32_t packed, uint8_t* out,
                                       int64_t out_cap) {
    using namespace deflate;
    using namespace refparity;
    if (level < 1) level = 1;
    if (level > 9) level = 9;
    struct HuffGuard {  // heap-based table build for the whole call
        HuffGuard() { deflate::g_ref_huffman = true; }
        ~HuffGuard() { deflate::g_ref_huffman = false; }
    } huff_guard;
    LsbWriter w(out, out_cap);
    if (zlib_wrap) {
        uint8_t cmf = 0x78;
        // reference zlib_header mapping (deflate.rs:1646-1651)
        int hint = (level <= 2) ? 1 : (level <= 6) ? 2 : 3;
        uint8_t flg = (uint8_t)(hint << 6);
        flg |= 31 - ((cmf << 8) | flg) % 31;
        uint8_t hdr[2] = {cmf, flg};
        w.raw_bytes(hdr, 2);
    }
    int64_t body_start = w.pos;

    if (len == 0) {
        fixed_init();
        w.write(1, 1); w.write(1, 2);
        w.write(fixed_lit_code[256], fixed_lit_len[256]);
        w.flush();
    } else if (zlib_wrap && len >= 4096 && ref_high_entropy(data, len)) {
        emit_stored_all(w, data, len);
        w.flush();
    } else {
        std::vector<Token> tokens;
        compress_tokens(data, len, level, tokens);

        if (packed) {
            // compress_packed_zlib / deflate_packed (deflate.rs:258-270,
            // 972-1062) — the path every reference PNG encode takes: NO
            // block splitting ever; literal-only streams >= 8 KiB go
            // stored; <= 128 tokens fixed, else one dynamic block.
            int64_t match_count = 0;
            for (const Token& t : tokens) match_count += (t.v >> 31) & 1;
            if (!zlib_wrap && len <= 1024) {
                emit_block(w, tokens, data, 0, len, true, /*force=*/0);
            } else if (zlib_wrap && match_count == 0 && len >= 8192) {
                emit_stored_all(w, data, len);
            } else if (tokens.size() <= 128) {
                emit_block(w, tokens, data, 0, len, true, /*force=*/0);
            } else {
                emit_block(w, tokens, data, 0, len, true, /*force=*/1);
            }
        } else if (!zlib_wrap && len <= 1024) {
            // deflate() small-input path: fixed-only
            emit_block(w, tokens, data, 0, len, true, /*force=*/0);
        } else if (level >= 5 && len > 1024 && len <= 512 * 1024) {
            // encode_with_block_splitting: every block dynamic
            std::vector<size_t> splits;
            if (tokens.size() >= RMIN_BLOCK * 2)
                splits = find_block_splits(tokens, 15);
            std::vector<size_t> bounds;
            bounds.push_back(0);
            for (size_t s : splits) bounds.push_back(s);
            bounds.push_back(tokens.size());
            for (size_t i = 0; i + 1 < bounds.size(); i++) {
                std::vector<Token> part(tokens.begin() + bounds[i],
                                        tokens.begin() + bounds[i + 1]);
                emit_block(w, part, data, 0, 0, i + 2 == bounds.size(),
                           /*force=*/1);
            }
        } else if (tokens.size() <= 128) {
            emit_block(w, tokens, data, 0, len, true, /*force=*/0);
        } else {
            emit_block(w, tokens, data, 0, len, true, /*force=*/1);
        }
        w.flush();

        if (zlib_wrap &&
            should_use_stored(len, w.pos - body_start)) {
            w.pos = body_start;  // byte-aligned: header was raw bytes
            emit_stored_all(w, data, len);
            w.flush();
        }
    }

    if (zlib_wrap) {
        uint32_t a = pixo_adler32(data, len, 1);
        uint8_t tail[4] = {(uint8_t)(a >> 24), (uint8_t)(a >> 16),
                           (uint8_t)(a >> 8), (uint8_t)a};
        w.raw_bytes(tail, 4);
    }
    return w.overflow ? -1 : w.pos;
}

// Mirror of the reference's deflate_optimal_zlib(data, iterations)
// (deflate.rs:371-397): the DEFLATE the reference PNG max preset uses
// (png/mod.rs:571-573 passes iterations=5). <= 512 KiB takes the
// block-splitting variant (last iteration's tokens, coarse-to-fine
// splits); larger inputs take the plain variant (smallest single
// dynamic block across iterations). Heap-Huffman + HCLEN quirks ride
// the same g_ref_huffman guard as deflate_compress_parity.
EXPORT int64_t deflate_optimal_parity(const uint8_t* data, int64_t len,
                                      int32_t iterations, uint8_t* out,
                                      int64_t out_cap) {
    using namespace deflate;
    using namespace refparity;
    if (iterations < 1) iterations = 1;
    struct HuffGuard {
        HuffGuard() { deflate::g_ref_huffman = true; }
        ~HuffGuard() { deflate::g_ref_huffman = false; }
    } huff_guard;
    tables_init();
    LsbWriter w(out, out_cap);
    uint8_t cmf = 0x78;
    uint8_t flg = (uint8_t)(3 << 6);  // zlib_header(9) -> FLEVEL 3
    flg |= 31 - ((cmf << 8) | flg) % 31;
    uint8_t hdr[2] = {cmf, flg};
    w.raw_bytes(hdr, 2);
    int64_t body_start = w.pos;

    if (len == 0) {
        fixed_init();
        w.write(1, 1);
        w.write(1, 2);
        w.write(fixed_lit_code[256], fixed_lit_len[256]);
        w.flush();
        uint32_t a = pixo_adler32(data, len, 1);
        uint8_t tail[4] = {(uint8_t)(a >> 24), (uint8_t)(a >> 16),
                           (uint8_t)(a >> 8), (uint8_t)a};
        w.raw_bytes(tail, 4);
        return w.overflow ? -1 : w.pos;
    }

    if (len > 512 * 1024) {
        // deflate_optimal (deflate.rs:291-360): smallest single dynamic
        // block across the greedy baseline + every iteration's parse.
        std::vector<uint8_t> scratch((size_t)(len + len / 2 + 4096));
        std::vector<uint8_t> best_bytes;
        int64_t best_size = -1;
        ref_optimal_iterate(
            data, len, iterations, [&](const std::vector<Token>& toks) {
                LsbWriter sw(scratch.data(), (int64_t)scratch.size());
                emit_block(sw, toks, data, 0, 0, true, /*force=*/1);
                sw.flush();
                if (sw.overflow) return;  // can't happen for dynamic blocks
                if (best_size < 0 || sw.pos < best_size) {
                    best_size = sw.pos;
                    best_bytes.assign(scratch.begin(),
                                      scratch.begin() + sw.pos);
                }
            });
        if (best_size < 0) return -1;
        w.raw_bytes(best_bytes.data(), (int64_t)best_bytes.size());
    } else {
        // deflate_optimal_split_zlib(data, iterations, 15): keep the LAST
        // iteration's tokens, then the coarse-to-fine split search
        std::vector<Token> best;
        ref_optimal_iterate(
            data, len, iterations,
            [&](const std::vector<Token>& toks) { best = toks; });
        std::vector<size_t> splits;
        if (best.size() >= RMIN_BLOCK * 2) splits = find_block_splits(best, 15);
        std::vector<size_t> bounds;
        bounds.push_back(0);
        for (size_t s : splits) bounds.push_back(s);
        bounds.push_back(best.size());
        for (size_t i = 0; i + 1 < bounds.size(); i++) {
            std::vector<Token> part(best.begin() + bounds[i],
                                    best.begin() + bounds[i + 1]);
            emit_block(w, part, data, 0, 0, i + 2 == bounds.size(),
                       /*force=*/1);
        }
        w.flush();
    }

    if (should_use_stored(len, w.pos - body_start)) {
        w.pos = body_start;
        emit_stored_all(w, data, len);
        w.flush();
    }
    uint32_t a = pixo_adler32(data, len, 1);
    uint8_t tail[4] = {(uint8_t)(a >> 24), (uint8_t)(a >> 16),
                       (uint8_t)(a >> 8), (uint8_t)a};
    w.raw_bytes(tail, 4);
    return w.overflow ? -1 : w.pos;
}

// =============================== INFLATE ====================================

namespace inflate {

struct BitReader {
    const uint8_t* data;
    int64_t len, pos;
    uint64_t acc;
    int nbits;
    bool error;

    BitReader(const uint8_t* d, int64_t l) : data(d), len(l), pos(0), acc(0), nbits(0), error(false) {}

    inline void fill() {
        // one unaligned 64-bit load instead of a per-byte loop; mask
        // keeps bits >= nbits zero so later ORs stay sound
        if (pos + 8 <= len) {
            uint64_t chunk;
            memcpy(&chunk, data + pos, 8);
            acc |= chunk << nbits;
            int add = (63 - nbits) >> 3;
            pos += add;
            nbits += add * 8;
            acc &= (1ull << nbits) - 1;
            return;
        }
        while (nbits <= 56 && pos < len) {
            acc |= (uint64_t)data[pos++] << nbits;
            nbits += 8;
        }
    }

    inline uint32_t read(int n) {
        if (nbits < n) fill();
        if (nbits < n) { error = true; return 0; }
        uint32_t v = (uint32_t)(acc & ((1ull << n) - 1));
        acc >>= n;
        nbits -= n;
        return v;
    }

    inline void align() {
        int drop = nbits & 7;
        acc >>= drop;
        nbits -= drop;
    }
};

// Canonical decode table, two-level (libdeflate/zlib style): a 10-bit
// root indexed by the low (LSB-first) bits of the code, plus linked
// subtables for 11-15-bit codes so every symbol decodes in at most two
// loads — no bit-by-bit fallback. Entries pack sym << 8 | code_len;
// a root entry with low byte 16+k points at a 2^k-entry subtable whose
// offset sits in the high bits; 0 = unassigned (invalid stream).
struct DecTable {
    static const int FAST_BITS = 10;
    // Subtable arena. For a valid (Kraft-satisfying) canonical code the
    // total subtable space is bounded well under 1024 (zlib's ENOUGH
    // analysis; long codes are consecutive in canonical order so they
    // share prefixes); 2048 leaves slack for over-subscribed garbage
    // headers, which instead mark the table invalid.
    static const int SUB_SIZE = 2048;
    uint32_t fast[1 << FAST_BITS];
    uint32_t sub[SUB_SIZE];
    bool valid;

    static inline uint32_t reverse_code(uint32_t x, int b) {
        uint32_t r = 0;
        for (int j = 0; j < b; j++) { r = (r << 1) | (x & 1); x >>= 1; }
        return r;
    }

    void build(const uint8_t* lengths, int n) {
        valid = true;
        int count[16];
        uint32_t first_code[16];
        int first_sym_idx[16], offs[16];
        uint16_t sorted_syms[288];
        memset(count, 0, sizeof(count));
        for (int i = 0; i < n; i++) count[lengths[i]]++;
        count[0] = 0;
        int total = 0;
        for (int b = 1; b < 16; b++) total += count[b];
        if (total == 0) { valid = false; return; }
        // canonical first codes
        uint32_t code = 0;
        int idx = 0;
        for (int b = 1; b < 16; b++) {
            code = (code + count[b - 1]) << 1;
            first_code[b] = code;
            first_sym_idx[b] = idx;
            offs[b] = idx;
            idx += count[b];
        }
        for (int i = 0; i < n; i++)
            if (lengths[i]) sorted_syms[offs[lengths[i]]++] = (uint16_t)i;
        // root entries for codes that fit FAST_BITS (LSB-first: reversed)
        memset(fast, 0, sizeof(fast));
        for (int b = 1; b <= FAST_BITS; b++) {
            uint32_t c = first_code[b];
            for (int k = 0; k < count[b]; k++, c++) {
                uint32_t r = reverse_code(c, b);
                uint32_t ent = ((uint32_t)sorted_syms[first_sym_idx[b] + k] << 8) |
                               (uint32_t)b;
                for (uint32_t hi = 0; hi < (1u << (FAST_BITS - b)); hi++)
                    fast[r | (hi << b)] = ent;
            }
        }
        // subtables for 11-15-bit codes: pass 1 sizes each root prefix by
        // the longest code under it, pass 2 assigns arena offsets, pass 3
        // fills (replicating within the subtable's unused high bits)
        uint8_t sub_bits[1 << FAST_BITS];
        int32_t sub_off[1 << FAST_BITS];
        bool any_long = false;
        for (int b = FAST_BITS + 1; b < 16; b++)
            if (count[b]) { any_long = true; break; }
        if (!any_long) return;
        memset(sub_bits, 0, sizeof(sub_bits));
        for (int b = FAST_BITS + 1; b < 16; b++) {
            uint32_t c = first_code[b];
            for (int k = 0; k < count[b]; k++, c++) {
                uint32_t prefix = reverse_code(c, b) & ((1 << FAST_BITS) - 1);
                uint8_t need = (uint8_t)(b - FAST_BITS);
                if (need > sub_bits[prefix]) sub_bits[prefix] = need;
            }
        }
        int arena = 0;
        for (int p = 0; p < (1 << FAST_BITS); p++) {
            if (!sub_bits[p]) continue;
            sub_off[p] = arena;
            arena += 1 << sub_bits[p];
            if (arena > SUB_SIZE) { valid = false; return; }
            fast[p] = ((uint32_t)sub_off[p] << 8) |
                      (uint32_t)(16 + sub_bits[p]);
        }
        memset(sub, 0, (size_t)arena * sizeof(uint32_t));
        for (int b = FAST_BITS + 1; b < 16; b++) {
            uint32_t c = first_code[b];
            for (int k = 0; k < count[b]; k++, c++) {
                uint32_t r = reverse_code(c, b);
                uint32_t prefix = r & ((1 << FAST_BITS) - 1);
                uint32_t lo = r >> FAST_BITS;  // (b - FAST_BITS) bits
                uint32_t ent = ((uint32_t)sorted_syms[first_sym_idx[b] + k] << 8) |
                               (uint32_t)b;
                int rep = sub_bits[prefix] - (b - FAST_BITS);
                for (uint32_t hi = 0; hi < (1u << rep); hi++)
                    sub[sub_off[prefix] + (lo | (hi << (b - FAST_BITS)))] = ent;
            }
        }
    }

    // Peek-decode from br.acc without consuming. Returns the packed entry
    // (sym << 8 | len), or 0 for an unassigned pattern. Safe whenever the
    // accumulator's bits above br.nbits are zero (BitReader maintains
    // this): a short-code entry reached through zero padding is the
    // correct decode by the prefix property, and a long entry fails the
    // caller's len <= nbits check.
    inline uint32_t peek(uint64_t acc) const {
        uint32_t e = fast[acc & ((1 << FAST_BITS) - 1)];
        uint32_t b = e & 0xFF;
        if (b > 16)
            e = sub[(e >> 8) +
                    ((acc >> FAST_BITS) & ((1u << (b - 16)) - 1))];
        return e;
    }

    // Careful decode: refills as needed, errors at true end-of-input.
    inline int decode(BitReader& br) {
        if (br.nbits < 16) br.fill();
        uint32_t e = peek(br.acc);
        int b = (int)(e & 0xFF);
        if (!b || b > br.nbits) { br.error = true; return -1; }
        br.acc >>= b;
        br.nbits -= b;
        return (int)(e >> 8);
    }
};

static const int LEN_BASE[29] = {3,4,5,6,7,8,9,10,11,13,15,17,19,23,27,31,35,43,51,59,
                                 67,83,99,115,131,163,195,227,258};
static const int LEN_EXTRA[29] = {0,0,0,0,0,0,0,0,1,1,1,1,2,2,2,2,3,3,3,3,4,4,4,4,5,5,5,5,0};
static const int DIST_BASE[30] = {1,2,3,4,5,7,9,13,17,25,33,49,65,97,129,193,257,385,513,769,
                                  1025,1537,2049,3073,4097,6145,8193,12289,16385,24577};
static const int DIST_EXTRA[30] = {0,0,0,0,1,1,2,2,3,3,4,4,5,5,6,6,7,7,8,8,9,9,10,10,11,11,12,12,13,13};

}  // namespace inflate

EXPORT int64_t inflate_decompress(const uint8_t* data, int64_t len,
                                  int32_t zlib_wrap,
                                  uint8_t* out, int64_t out_cap) {
    using namespace inflate;
    const uint8_t* p = data;
    int64_t n = len;
    if (zlib_wrap) {
        if (n < 6) return -1;
        if ((p[0] & 0x0F) != 8) return -1;       // deflate method
        if (((p[0] << 8) | p[1]) % 31 != 0) return -1;
        if (p[1] & 0x20) return -1;              // FDICT unsupported
        p += 2;
        n -= 6;  // leave adler tail out of the bit stream
    }

    BitReader br(p, n + (zlib_wrap ? 4 : 0));  // tail bytes may be consumed as padding
    int64_t opos = 0;
    static thread_local DecTable lit_table, dist_table;

    for (;;) {
        uint32_t bfinal = br.read(1);
        uint32_t btype = br.read(2);
        if (br.error) return -1;
        if (btype == 0) {
            br.align();
            uint32_t lenv = br.read(16);
            uint32_t nlen = br.read(16);
            if (br.error || (lenv ^ 0xFFFF) != nlen) return -1;
            // the reader is byte-aligned: rewind to the underlying byte
            // position and copy the payload in one memcpy instead of
            // 8-bit reads (stored blocks carry incompressible content —
            // this path was 2x slower than zlib per byte)
            int64_t src = br.pos - (br.nbits >> 3);
            if (src + (int64_t)lenv > br.len || opos + (int64_t)lenv > out_cap)
                return -1;
            memcpy(out + opos, br.data + src, (size_t)lenv);
            opos += lenv;
            br.pos = src + lenv;
            br.acc = 0;
            br.nbits = 0;
        } else if (btype == 1 || btype == 2) {
            if (btype == 1) {
                uint8_t ll[288];
                for (int i = 0; i < 288; i++)
                    ll[i] = (i < 144) ? 8 : (i < 256) ? 9 : (i < 280) ? 7 : 8;
                uint8_t dl[30];
                memset(dl, 5, 30);
                lit_table.build(ll, 288);
                dist_table.build(dl, 30);
            } else {
                uint32_t hlit = br.read(5) + 257;
                uint32_t hdist = br.read(5) + 1;
                uint32_t hclen = br.read(4) + 4;
                if (br.error || hlit > 286 || hdist > 30) return -1;
                static const int CL_ORDER[19] = {16,17,18,0,8,7,9,6,10,5,11,4,12,3,13,2,14,1,15};
                uint8_t cl_len[19] = {0};
                for (uint32_t i = 0; i < hclen; i++) cl_len[CL_ORDER[i]] = (uint8_t)br.read(3);
                DecTable cl_table;
                cl_table.build(cl_len, 19);
                if (!cl_table.valid) return -1;
                uint8_t lens[286 + 30] = {0};
                uint32_t got = 0;
                while (got < hlit + hdist) {
                    int sym = cl_table.decode(br);
                    if (sym < 0) return -1;
                    if (sym < 16) lens[got++] = (uint8_t)sym;
                    else if (sym == 16) {
                        if (got == 0) return -1;
                        uint32_t rep = 3 + br.read(2);
                        uint8_t v = lens[got - 1];
                        while (rep-- && got < hlit + hdist) lens[got++] = v;
                    } else if (sym == 17) {
                        uint32_t rep = 3 + br.read(3);
                        while (rep-- && got < hlit + hdist) lens[got++] = 0;
                    } else {
                        uint32_t rep = 11 + br.read(7);
                        while (rep-- && got < hlit + hdist) lens[got++] = 0;
                    }
                    if (br.error) return -1;
                }
                lit_table.build(lens, hlit);
                dist_table.build(lens + hlit, hdist);
                if (!lit_table.valid) return -1;
            }
            // Fast loop invariant: with >= 48 buffered bits, one whole
            // match decode needs no refill checks — litlen code (<=15) +
            // length extra (<=5) + distance code (<=15) + distance extra
            // (<=13) = 48 — and with opos <= out_fast_end the 258-byte
            // worst-case copy plus 8 bytes of chunk overshoot needs no
            // output bound checks. Outside either invariant (stream tail
            // or output tail) each symbol takes the careful path below.
            const int64_t out_fast_end = out_cap - (258 + 8);
            for (;;) {
                if (br.nbits < 48) br.fill();
                int sym;
                if (br.nbits >= 48 && opos <= out_fast_end) {
                    uint32_t e = lit_table.peek(br.acc);
                    int cl = (int)(e & 0xFF);
                    if (!cl) return -1;
                    br.acc >>= cl;
                    br.nbits -= cl;
                    sym = (int)(e >> 8);
                    if (sym < 256) {
                        out[opos++] = (uint8_t)sym;
                        // literal burst: >=15 buffered bits decode any
                        // one more code without a refill check
                        while (br.nbits >= 15 && opos <= out_fast_end) {
                            e = lit_table.peek(br.acc);
                            cl = (int)(e & 0xFF);
                            int s2 = (int)(e >> 8);
                            if (!cl || s2 >= 256) break;
                            br.acc >>= cl;
                            br.nbits -= cl;
                            out[opos++] = (uint8_t)s2;
                        }
                        continue;
                    }
                    if (sym == 256) break;
                    int ls = sym - 257;
                    if (ls >= 29) return -1;
                    uint32_t eb = (uint32_t)LEN_EXTRA[ls];
                    int mlen = LEN_BASE[ls] +
                               (int)(br.acc & ((1u << eb) - 1));
                    br.acc >>= eb;
                    br.nbits -= (int)eb;
                    e = dist_table.peek(br.acc);
                    cl = (int)(e & 0xFF);
                    if (!cl) return -1;
                    br.acc >>= cl;
                    br.nbits -= cl;
                    int ds = (int)(e >> 8);
                    if (ds >= 30) return -1;
                    uint32_t db = (uint32_t)DIST_EXTRA[ds];
                    int dist = DIST_BASE[ds] +
                               (int)(br.acc & ((1u << db) - 1));
                    br.acc >>= db;
                    br.nbits -= (int)db;
                    if (dist > opos) return -1;
                    uint8_t* dst = out + opos;
                    const uint8_t* src = dst - dist;
                    if (dist == 1) {
                        memset(dst, src[0], (size_t)mlen);   // RLE run
                    } else if (dist >= 8) {
                        // non-overlapping 8-byte chunks (may overshoot
                        // into the slack below out_fast_end)
                        int i = 0;
                        do {
                            memcpy(dst + i, src + i, 8);
                            i += 8;
                        } while (i < mlen);
                    } else {
                        for (int i = 0; i < mlen; i++) dst[i] = src[i];
                    }
                    opos += mlen;
                    continue;
                }
                // careful path: per-read refills, per-byte output bounds
                sym = lit_table.decode(br);
                if (sym < 0) return -1;
                if (sym < 256) {
                    if (opos >= out_cap) return -1;
                    out[opos++] = (uint8_t)sym;
                } else if (sym == 256) {
                    break;
                } else {
                    int ls = sym - 257;
                    if (ls >= 29) return -1;
                    int mlen = LEN_BASE[ls] + (int)br.read(LEN_EXTRA[ls]);
                    int ds = dist_table.decode(br);
                    if (ds < 0 || ds >= 30) return -1;
                    int dist = DIST_BASE[ds] + (int)br.read(DIST_EXTRA[ds]);
                    if (br.error || dist > opos || opos + mlen > out_cap) return -1;
                    for (int i = 0; i < mlen; i++, opos++)
                        out[opos] = out[opos - dist];
                }
            }
        } else {
            return -1;
        }
        if (bfinal) break;
    }
    return opos;
}

// ============================ JPEG pixel tail ===============================
// Host tier for the decode pixel stage: dezigzag + dequant + jidctint IDCT
// + plane assembly + nearest chroma upsample + fixed-point BT.601 inverse,
// in one pass per image.  Bit-exact with ops/jpeg_decode.py
// idct8x8_int / ycbcr_to_rgb_int (the jnp device tier) — the jidctint
// algebra below mirrors ops/jpeg_decode.py:44-99 line for line (NOT the
// reference's idct.rs, whose fix_mul placement bug we do not reproduce).

namespace jpegpix {

static const int ZZ[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

static const int64_t CB = 13;            // CONST_BITS
static const int64_t PB = 2;             // PASS1_BITS
static const int64_t R1 = 1LL << (CB - PB - 1);
static const int64_t R2 = 1LL << (CB + PB + 3 - 1);

static inline void idct_1d(const int64_t d[8], int64_t o[8]) {
    int64_t z1 = (d[2] + d[6]) * 4433;
    int64_t tmp2 = z1 - d[6] * 15137;
    int64_t tmp3 = z1 + d[2] * 6270;
    int64_t tmp0 = (d[0] + d[4]) << 13;
    int64_t tmp1 = (d[0] - d[4]) << 13;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    int64_t za = d[7] + d[1], zb = d[5] + d[3];
    int64_t zc = d[7] + d[3], zd = d[5] + d[1];
    int64_t z5 = (zc + zd) * 9633;
    int64_t t0 = d[7] * 2446, t1 = d[5] * 16819;
    int64_t t2 = d[3] * 25172, t3 = d[1] * 12299;
    za *= -7373; zb *= -20995;
    zc = zc * -16069 + z5;
    zd = zd * -3196 + z5;
    t0 += za + zc; t1 += zb + zd; t2 += zb + zc; t3 += za + zd;

    o[0] = tmp10 + t3; o[1] = tmp11 + t2; o[2] = tmp12 + t1;
    o[3] = tmp13 + t0; o[4] = tmp13 - t0; o[5] = tmp12 - t1;
    o[6] = tmp11 - t2; o[7] = tmp10 - t3;
}

static void idct_block_last(const int16_t* zzc, const uint16_t* qzz,
                            uint8_t out[64], int last) {
    int64_t natural[64];
    for (int i = 0; i < 64; i++) natural[i] = 0;
    for (int i = 0; i <= last; i++)
        natural[ZZ[i]] = (int64_t)zzc[i] * (int64_t)qzz[i];

    int64_t ws[64];
    // pass 1: columns.  DC-only column shortcut is bit-exact: with
    // d[1..7]=0 every o[r] is d[0]<<13, and (d0<<13 + R1) >> (CB-PB)
    // == d0<<2 because the rounding bit (1<<10) can never carry past
    // the shifted-away low 11 bits.
    for (int c = 0; c < 8; c++) {
        const int64_t* col = natural + c;
        if ((col[8] | col[16] | col[24] | col[32] | col[40] | col[48] |
             col[56]) == 0) {
            int64_t v = col[0] << PB;
            for (int r = 0; r < 8; r++) ws[r * 8 + c] = v;
            continue;
        }
        int64_t d[8], o[8];
        for (int r = 0; r < 8; r++) d[r] = natural[r * 8 + c];
        idct_1d(d, o);
        for (int r = 0; r < 8; r++)
            ws[r * 8 + c] = (o[r] + R1) >> (CB - PB);
    }
    // pass 2: rows.  DC-only row => every o[c] is d[0]<<13 exactly, so
    // the rounded/shifted/clamped sample is computed once and replicated.
    for (int r = 0; r < 8; r++) {
        const int64_t* row = ws + r * 8;
        if ((row[1] | row[2] | row[3] | row[4] | row[5] | row[6] |
             row[7]) == 0) {
            int64_t v = (((row[0] << CB) + R2) >> (CB + PB + 3)) + 128;
            uint8_t s = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
            memset(out + r * 8, s, 8);
            continue;
        }
        int64_t d[8], o[8];
        for (int c = 0; c < 8; c++) d[c] = ws[r * 8 + c];
        idct_1d(d, o);
        for (int c = 0; c < 8; c++) {
            int64_t v = ((o[c] + R2) >> (CB + PB + 3)) + 128;
            out[r * 8 + c] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
        }
    }
}

static void idct_block(const int16_t* zzc, const uint16_t* qzz,
                       uint8_t out[64]) {
    int last = 63;
    while (last > 0 && zzc[last] == 0) last--;
    idct_block_last(zzc, qzz, out, last);
}

#if defined(__AVX2__)
// AVX2 IDCT: the whole 8x8 jidctint in epi32 vectors, one vector per
// row (lanes = columns) for pass 1, transposed for pass 2.  int32 wrap
// semantics match the device tier (ops/jpeg_decode.py idct8x8_int runs
// in jnp.int32); conforming streams never overflow, so this is also
// bit-equal to the int64 scalar fallback on every tested input.

static inline void transpose8x8_epi32(__m256i r[8]) {
    __m256i t0 = _mm256_unpacklo_epi32(r[0], r[1]);
    __m256i t1 = _mm256_unpackhi_epi32(r[0], r[1]);
    __m256i t2 = _mm256_unpacklo_epi32(r[2], r[3]);
    __m256i t3 = _mm256_unpackhi_epi32(r[2], r[3]);
    __m256i t4 = _mm256_unpacklo_epi32(r[4], r[5]);
    __m256i t5 = _mm256_unpackhi_epi32(r[4], r[5]);
    __m256i t6 = _mm256_unpacklo_epi32(r[6], r[7]);
    __m256i t7 = _mm256_unpackhi_epi32(r[6], r[7]);
    __m256i u0 = _mm256_unpacklo_epi64(t0, t2);
    __m256i u1 = _mm256_unpackhi_epi64(t0, t2);
    __m256i u2 = _mm256_unpacklo_epi64(t1, t3);
    __m256i u3 = _mm256_unpackhi_epi64(t1, t3);
    __m256i u4 = _mm256_unpacklo_epi64(t4, t6);
    __m256i u5 = _mm256_unpackhi_epi64(t4, t6);
    __m256i u6 = _mm256_unpacklo_epi64(t5, t7);
    __m256i u7 = _mm256_unpackhi_epi64(t5, t7);
    r[0] = _mm256_permute2x128_si256(u0, u4, 0x20);
    r[1] = _mm256_permute2x128_si256(u1, u5, 0x20);
    r[2] = _mm256_permute2x128_si256(u2, u6, 0x20);
    r[3] = _mm256_permute2x128_si256(u3, u7, 0x20);
    r[4] = _mm256_permute2x128_si256(u0, u4, 0x31);
    r[5] = _mm256_permute2x128_si256(u1, u5, 0x31);
    r[6] = _mm256_permute2x128_si256(u2, u6, 0x31);
    r[7] = _mm256_permute2x128_si256(u3, u7, 0x31);
}

static inline void idct_pass_avx2(const __m256i d[8], __m256i o[8],
                                  int shift, __m256i rnd) {
    auto mulc = [](__m256i v, int32_t c) {
        return _mm256_mullo_epi32(v, _mm256_set1_epi32(c));
    };
    __m256i z1 = mulc(_mm256_add_epi32(d[2], d[6]), 4433);
    __m256i tmp2 = _mm256_sub_epi32(z1, mulc(d[6], 15137));
    __m256i tmp3 = _mm256_add_epi32(z1, mulc(d[2], 6270));
    __m256i tmp0 = _mm256_slli_epi32(_mm256_add_epi32(d[0], d[4]), 13);
    __m256i tmp1 = _mm256_slli_epi32(_mm256_sub_epi32(d[0], d[4]), 13);
    __m256i tmp10 = _mm256_add_epi32(tmp0, tmp3);
    __m256i tmp13 = _mm256_sub_epi32(tmp0, tmp3);
    __m256i tmp11 = _mm256_add_epi32(tmp1, tmp2);
    __m256i tmp12 = _mm256_sub_epi32(tmp1, tmp2);

    __m256i za = _mm256_add_epi32(d[7], d[1]);
    __m256i zb = _mm256_add_epi32(d[5], d[3]);
    __m256i zc = _mm256_add_epi32(d[7], d[3]);
    __m256i zd = _mm256_add_epi32(d[5], d[1]);
    __m256i z5 = mulc(_mm256_add_epi32(zc, zd), 9633);
    __m256i t0 = mulc(d[7], 2446);
    __m256i t1 = mulc(d[5], 16819);
    __m256i t2 = mulc(d[3], 25172);
    __m256i t3 = mulc(d[1], 12299);
    za = mulc(za, -7373);
    zb = mulc(zb, -20995);
    zc = _mm256_add_epi32(mulc(zc, -16069), z5);
    zd = _mm256_add_epi32(mulc(zd, -3196), z5);
    t0 = _mm256_add_epi32(t0, _mm256_add_epi32(za, zc));
    t1 = _mm256_add_epi32(t1, _mm256_add_epi32(zb, zd));
    t2 = _mm256_add_epi32(t2, _mm256_add_epi32(zb, zc));
    t3 = _mm256_add_epi32(t3, _mm256_add_epi32(za, zd));

    auto ds = [&](__m256i v) {
        return _mm256_srai_epi32(_mm256_add_epi32(v, rnd), shift);
    };
    o[0] = ds(_mm256_add_epi32(tmp10, t3));
    o[1] = ds(_mm256_add_epi32(tmp11, t2));
    o[2] = ds(_mm256_add_epi32(tmp12, t1));
    o[3] = ds(_mm256_add_epi32(tmp13, t0));
    o[4] = ds(_mm256_sub_epi32(tmp13, t0));
    o[5] = ds(_mm256_sub_epi32(tmp12, t1));
    o[6] = ds(_mm256_sub_epi32(tmp11, t2));
    o[7] = ds(_mm256_sub_epi32(tmp10, t3));
}

// `last` = a known bound on the highest possibly-nonzero zigzag index
// (callers that tracked the entropy decode pass it to skip the scan).
static void idct_block_avx2_last(const int16_t* zzc, const uint16_t* qzz,
                                 uint8_t out[64], int last) {
    if (last == 0) {
        // DC-only block: one sample replicated (both pass shortcuts)
        int32_t dq = (int32_t)zzc[0] * (int32_t)qzz[0];
        int32_t ws = dq << PB;
        int64_t v = ((((int64_t)ws << CB) + R2) >> (CB + PB + 3)) + 128;
        memset(out, (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v), 64);
        return;
    }
    alignas(32) int32_t natural[64];
    memset(natural, 0, sizeof(natural));
    for (int i = 0; i <= last; i++)
        natural[ZZ[i]] = (int32_t)zzc[i] * (int32_t)qzz[i];

    __m256i d[8], ws[8], o[8];
    for (int r = 0; r < 8; r++)
        d[r] = _mm256_load_si256((const __m256i*)(natural + r * 8));
    idct_pass_avx2(d, ws, (int)(CB - PB), _mm256_set1_epi32((int32_t)R1));
    transpose8x8_epi32(ws);  // lanes become rows
    idct_pass_avx2(ws, o, (int)(CB + PB + 3), _mm256_set1_epi32((int32_t)R2));
    // o[c] lanes = rows; transpose back so vectors are output rows
    transpose8x8_epi32(o);
    const __m256i c128 = _mm256_set1_epi32(128);
    for (int r = 0; r < 8; r += 2) {
        __m256i a = _mm256_add_epi32(o[r], c128);
        __m256i b = _mm256_add_epi32(o[r + 1], c128);
        __m256i p16 = _mm256_permute4x64_epi64(_mm256_packs_epi32(a, b), 0xD8);
        __m256i p8 = _mm256_permute4x64_epi64(_mm256_packus_epi16(p16, p16), 0xD8);
        _mm_storeu_si128((__m128i*)(out + r * 8), _mm256_castsi256_si128(p8));
    }
}

static void idct_block_avx2(const int16_t* zzc, const uint16_t* qzz,
                            uint8_t out[64]) {
    int last = 63;
    while (last > 0 && zzc[last] == 0) last--;
    idct_block_avx2_last(zzc, qzz, out, last);
}
#endif  // __AVX2__

}  // namespace jpegpix

// coeffs: concatenated [nblocks_total, 64] int16 zigzag streams, component
// blocks contiguous (offsets in comp_off[ncomp+1]); qtables [ncomp][64]
// zigzag; comp_h/comp_v sampling factors. out: [height, width, ncomp==1?1:3].
// Shared geometry precheck for the two pixel-tail entries below: the
// interleave loops index the first plane at full resolution, so
// spec-legal files with subsampled luma must take the generic Python
// upsampling tier; the scalar build has no fancy color tail.
static int64_t jpeg_pixels_geometry_check(
    const int32_t* comp_h, const int32_t* comp_v, int32_t ncomp,
    int32_t mcu_cols, int32_t mcu_rows, int32_t max_h, int32_t max_v,
    int32_t width, int32_t height, int32_t fancy) {
    if (ncomp != 1 && ncomp != 3) return -1;
    if (comp_h[0] != max_h || comp_v[0] != max_v) return -3;
    if ((int64_t)width > (int64_t)mcu_cols * max_h * 8 ||
        (int64_t)height > (int64_t)mcu_rows * max_v * 8)
        return -2;
#if !defined(__AVX2__)
    if (fancy) return -3;
#else
    (void)fancy;
#endif
    return 0;
}

// Plane -> pixel tail shared by jpeg_decode_pixels and the fused
// jpeg_decode_baseline: nearest/fancy chroma upsample + fixed-point
// BT.601 inverse (AVX2 16-px path with a scalar mirror).
static int64_t jpeg_assemble_pixels(
    std::vector<std::vector<uint8_t>>& planes, const int* pw, const int* ph,
    const int32_t* comp_h, const int32_t* comp_v, int32_t ncomp,
    int32_t max_h, int32_t max_v,
    int32_t width, int32_t height, int32_t fancy, uint8_t* out) {
    if (ncomp == 1) {
        for (int y = 0; y < height; y++)
            memcpy(out + (size_t)y * width,
                   planes[0].data() + (size_t)y * pw[0], width);
        return 0;
    }

    int hr1 = max_h / comp_h[1], vr1 = max_v / comp_v[1];
    int hr2 = max_h / comp_h[2], vr2 = max_v / comp_v[2];
    // sampling ratios are powers of two (1/2/4): shift, never divide —
    // ~12M integer divisions per 3 MP image cost more than the IDCT
    auto sh = [](int r) { return r == 1 ? 0 : r == 2 ? 1 : r == 4 ? 2 : -1; };
    int hs1 = sh(hr1), vs1 = sh(vr1), hs2 = sh(hr2), vs2 = sh(vr2);
    if (hs1 < 0 || vs1 < 0 || hs2 < 0 || vs2 < 0) return -3;
    // fancy (triangle) upsampling supports ratios 1/2 only — other
    // geometries fall back to the jnp tier, matching upsample_triangle
    if (fancy && (hr1 > 2 || vr1 > 2 || hr2 > 2 || vr2 > 2)) return -3;

    // libjpeg triangle upsample of one output row into dst[0..width):
    // bit-equal to ops/jpeg_decode.py upsample_triangle, which shifts
    // over the FULL padded plane (edge replicate only at plane edges).
    auto fancy_row = [&](const uint8_t* plane, int pwc, int phc, int hr,
                         int vr, int y, uint8_t* dst) {
        const uint8_t *mainr, *othr;
        int rnd_v = 0;
        if (vr == 2) {
            int k = y >> 1;
            if (k >= phc) k = phc - 1;
            int ok = (y & 1) ? (k + 1 < phc ? k + 1 : phc - 1)
                             : (k > 0 ? k - 1 : 0);
            mainr = plane + (size_t)k * pwc;
            othr = plane + (size_t)ok * pwc;
            rnd_v = (y & 1) ? 1 : 2;
        } else {
            mainr = plane + (size_t)y * pwc;
            othr = nullptr;
        }
        if (hr == 2 && vr == 2) {
            // r[c] = 3*main[c] + oth[c] (x4 scale), then 3:1 horizontally
            int cmax = (width + 1) / 2;
            int r_prev, r_cur, r_next;
            r_cur = 3 * (int)mainr[0] + (int)othr[0];
            r_prev = r_cur;  // left edge replicate
            for (int c = 0; c < cmax; c++) {
                int cn = c + 1 < pwc ? c + 1 : pwc - 1;
                r_next = 3 * (int)mainr[cn] + (int)othr[cn];
                int e = (3 * r_cur + r_prev + 8) >> 4;
                int o = (3 * r_cur + r_next + 7) >> 4;
                if (2 * c < width) dst[2 * c] = (uint8_t)e;
                if (2 * c + 1 < width) dst[2 * c + 1] = (uint8_t)o;
                r_prev = r_cur;
                r_cur = r_next;
            }
        } else if (hr == 2) {
            int cmax = (width + 1) / 2;
            for (int c = 0; c < cmax; c++) {
                int cp = c > 0 ? c - 1 : 0;
                int cn = c + 1 < pwc ? c + 1 : pwc - 1;
                int e = (3 * (int)mainr[c] + (int)mainr[cp] + 2) >> 2;
                int o = (3 * (int)mainr[c] + (int)mainr[cn] + 1) >> 2;
                if (2 * c < width) dst[2 * c] = (uint8_t)e;
                if (2 * c + 1 < width) dst[2 * c + 1] = (uint8_t)o;
            }
        } else if (vr == 2) {
            for (int x = 0; x < width; x++)
                dst[x] = (uint8_t)((3 * (int)mainr[x] + (int)othr[x] + rnd_v) >> 2);
        } else {
            memcpy(dst, mainr, width);
        }
    };

#if defined(__AVX2__)
    // AVX2 color tail: per-row nearest chroma upsample into padded stack
    // buffers, then 16-px fixed-point BT.601 inverse with the exact
    // arithmetic of the scalar loop below (mullo/srai epi32 + saturating
    // packs == compute-then-clamp, since all terms fit int16 range).
    {
        std::vector<uint8_t> cbbuf(width + 64), crbuf(width + 64);
        auto upsample_row = [&](const uint8_t* src, int hsx, uint8_t* dst) {
            if (hsx == 0) { memcpy(dst, src, width); return; }
            if (hsx == 1) {
                int half = (width + 1) >> 1;
                int x = 0;
                for (; x + 16 <= half; x += 16) {
                    __m128i v = _mm_loadu_si128((const __m128i*)(src + x));
                    _mm_storeu_si128((__m128i*)(dst + 2 * x),
                                     _mm_unpacklo_epi8(v, v));
                    _mm_storeu_si128((__m128i*)(dst + 2 * x + 16),
                                     _mm_unpackhi_epi8(v, v));
                }
                for (; x < half; x++) { dst[2 * x] = src[x]; dst[2 * x + 1] = src[x]; }
                return;
            }
            for (int x = 0; x < width; x++) dst[x] = src[x >> hsx];
        };
        // 16-px interleave masks: output chunk k byte i is channel (16k+i)%3
        // of pixel (16k+i)/3
        alignas(16) int8_t mr[3][16], mg[3][16], mb[3][16];
        for (int k = 0; k < 3; k++)
            for (int i = 0; i < 16; i++) {
                int j = 16 * k + i;
                mr[k][i] = (j % 3 == 0) ? (int8_t)(j / 3) : (int8_t)0x80;
                mg[k][i] = (j % 3 == 1) ? (int8_t)(j / 3) : (int8_t)0x80;
                mb[k][i] = (j % 3 == 2) ? (int8_t)(j / 3) : (int8_t)0x80;
            }
        const __m256i c128 = _mm256_set1_epi32(128);
        const __m256i c359 = _mm256_set1_epi32(359);
        const __m256i c88 = _mm256_set1_epi32(88);
        const __m256i c183 = _mm256_set1_epi32(183);
        const __m256i c454 = _mm256_set1_epi32(454);
        auto conv8 = [&](const uint8_t* yp, const uint8_t* cbp,
                         const uint8_t* crp, __m256i& r, __m256i& g,
                         __m256i& b) {
            __m256i Y = _mm256_cvtepu8_epi32(_mm_loadl_epi64((const __m128i*)yp));
            __m256i cb = _mm256_sub_epi32(
                _mm256_cvtepu8_epi32(_mm_loadl_epi64((const __m128i*)cbp)), c128);
            __m256i cr = _mm256_sub_epi32(
                _mm256_cvtepu8_epi32(_mm_loadl_epi64((const __m128i*)crp)), c128);
            r = _mm256_add_epi32(Y, _mm256_srai_epi32(_mm256_mullo_epi32(cr, c359), 8));
            g = _mm256_sub_epi32(Y, _mm256_srai_epi32(
                _mm256_add_epi32(_mm256_mullo_epi32(cb, c88),
                                 _mm256_mullo_epi32(cr, c183)), 8));
            b = _mm256_add_epi32(Y, _mm256_srai_epi32(_mm256_mullo_epi32(cb, c454), 8));
        };
        auto pack16 = [&](__m256i lo, __m256i hi) {
            __m256i p16 = _mm256_permute4x64_epi64(
                _mm256_packs_epi32(lo, hi), 0xD8);
            __m256i p8 = _mm256_permute4x64_epi64(
                _mm256_packus_epi16(p16, p16), 0xD8);
            return _mm256_castsi256_si128(p8);
        };
        for (int y = 0; y < height; y++) {
            const uint8_t* yrow = planes[0].data() + (size_t)y * pw[0];
            if (fancy) {
                fancy_row(planes[1].data(), pw[1], ph[1], hr1, vr1, y,
                          cbbuf.data());
                fancy_row(planes[2].data(), pw[2], ph[2], hr2, vr2, y,
                          crbuf.data());
            } else {
                upsample_row(planes[1].data() + (size_t)(y >> vs1) * pw[1],
                             hs1, cbbuf.data());
                upsample_row(planes[2].data() + (size_t)(y >> vs2) * pw[2],
                             hs2, crbuf.data());
            }
            uint8_t* orow = out + (size_t)y * width * 3;
            int x = 0;
            for (; x + 16 <= width; x += 16) {
                __m256i r0, g0, b0, r1, g1, b1;
                conv8(yrow + x, cbbuf.data() + x, crbuf.data() + x, r0, g0, b0);
                conv8(yrow + x + 8, cbbuf.data() + x + 8, crbuf.data() + x + 8,
                      r1, g1, b1);
                __m128i R = pack16(r0, r1), G = pack16(g0, g1), B = pack16(b0, b1);
                uint8_t* dst = orow + (size_t)x * 3;
                for (int k = 0; k < 3; k++) {
                    __m128i o = _mm_or_si128(
                        _mm_or_si128(
                            _mm_shuffle_epi8(R, _mm_load_si128((const __m128i*)mr[k])),
                            _mm_shuffle_epi8(G, _mm_load_si128((const __m128i*)mg[k]))),
                        _mm_shuffle_epi8(B, _mm_load_si128((const __m128i*)mb[k])));
                    _mm_storeu_si128((__m128i*)(dst + 16 * k), o);
                }
            }
            for (; x < width; x++) {
                int32_t Y = yrow[x];
                int32_t cb = (int32_t)cbbuf[x] - 128;
                int32_t cr = (int32_t)crbuf[x] - 128;
                int32_t r = Y + ((cr * 359) >> 8);
                int32_t g = Y - ((cb * 88 + cr * 183) >> 8);
                int32_t b = Y + ((cb * 454) >> 8);
                orow[x * 3 + 0] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
                orow[x * 3 + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
                orow[x * 3 + 2] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
            }
        }
        return 0;
    }
#endif

    if (fancy) return -3;  // scalar fallback build: jnp tier handles fancy
    for (int y = 0; y < height; y++) {
        const uint8_t* yrow = planes[0].data() + (size_t)y * pw[0];
        const uint8_t* cbrow = planes[1].data() + (size_t)(y >> vs1) * pw[1];
        const uint8_t* crrow = planes[2].data() + (size_t)(y >> vs2) * pw[2];
        uint8_t* orow = out + (size_t)y * width * 3;
        for (int x = 0; x < width; x++) {
            int32_t Y = yrow[x];
            int32_t cb = (int32_t)cbrow[x >> hs1] - 128;
            int32_t cr = (int32_t)crrow[x >> hs2] - 128;
            int32_t r = Y + ((cr * 359) >> 8);
            int32_t g = Y - ((cb * 88 + cr * 183) >> 8);
            int32_t b = Y + ((cb * 454) >> 8);
            orow[x * 3 + 0] = (uint8_t)(r < 0 ? 0 : r > 255 ? 255 : r);
            orow[x * 3 + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
            orow[x * 3 + 2] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
        }
    }
    return 0;
}

EXPORT int64_t jpeg_decode_pixels(
    const int16_t* coeffs, const int64_t* comp_off, const uint16_t* qtables,
    const int32_t* comp_h, const int32_t* comp_v, int32_t ncomp,
    int32_t mcu_cols, int32_t mcu_rows, int32_t max_h, int32_t max_v,
    int32_t width, int32_t height, int32_t fancy, uint8_t* out) {
    using namespace jpegpix;
    int64_t rc = jpeg_pixels_geometry_check(
        comp_h, comp_v, ncomp, mcu_cols, mcu_rows, max_h, max_v,
        width, height, fancy);
    if (rc != 0) return rc;

    std::vector<std::vector<uint8_t>> planes(ncomp);
    std::vector<int> pw(ncomp), ph(ncomp);
    for (int ci = 0; ci < ncomp; ci++) {
        int bw = mcu_cols * comp_h[ci];
        int bh = mcu_rows * comp_v[ci];
        pw[ci] = bw * 8; ph[ci] = bh * 8;
        planes[ci].resize((size_t)pw[ci] * ph[ci]);
        const int16_t* src = coeffs + comp_off[ci] * 64;
        int64_t nb = comp_off[ci + 1] - comp_off[ci];
        if (nb != (int64_t)bw * bh) return -2;
        const uint16_t* q = qtables + (size_t)ci * 64;
        uint8_t blk[64];
        for (int64_t b = 0; b < nb; b++) {
#if defined(__AVX2__)
            idct_block_avx2(src + b * 64, q, blk);
#else
            idct_block(src + b * 64, q, blk);
#endif
            int by = (int)(b / bw), bx = (int)(b % bw);
            uint8_t* dst = planes[ci].data() + (size_t)by * 8 * pw[ci] + bx * 8;
            for (int r = 0; r < 8; r++)
                memcpy(dst + (size_t)r * pw[ci], blk + r * 8, 8);
        }
    }
    return jpeg_assemble_pixels(planes, pw.data(), ph.data(), comp_h, comp_v,
                                ncomp, max_h, max_v, width, height, fancy, out);
}

// Fused baseline sink for jpeg_decode_segment_sink: each entropy-decoded
// block is IDCT'd straight into the component's uint8 plane while still
// hot in L1, so the [nblocks, 64] int16 coefficient store never exists
// (the analog of the encode-side jpeg_encode_scan_fused win: at 512x512
// 4:2:0 that store is ~1.5 MB written + reread through a 1 MB L2).
struct JpegFusedIdctSink {
    uint8_t* planes[4];
    const uint16_t* qzz[4];
    int pw[4];
    alignas(32) int16_t local[64];
    JpegFusedIdctSink() { memset(local, 0, sizeof(local)); }
    // The scratch block stays all-zero between blocks: done() re-zeroes
    // exactly the prefix the entropy decode may have written ([0, k)),
    // so the 128-byte per-block memset disappears.
    inline int16_t* at(int, int64_t, int64_t, int64_t) { return local; }
    inline void done(int c, int64_t row, int64_t col, int k) {
        uint8_t* dst = planes[c] + (size_t)row * 8 * pw[c] + col * 8;
        const uint16_t* q = qzz[c];
        if (k <= 1) {
            // DC-only block (the common case for photo chroma): both
            // IDCT passes collapse to one replicated sample.  Arithmetic
            // mirrors exactly what the two-stage path computes for these
            // blocks per build: idct_block_avx2's int32-wrap last==0
            // shortcut, or the scalar tier's int64 column/row shortcuts.
#if defined(__AVX2__)
            int32_t dq = (int32_t)local[0] * (int32_t)q[0];
            int32_t ws = (int32_t)(dq << jpegpix::PB);
            int64_t v = ((((int64_t)ws << jpegpix::CB) + jpegpix::R2) >>
                         (jpegpix::CB + jpegpix::PB + 3)) + 128;
#else
            int64_t dq = (int64_t)local[0] * (int64_t)q[0];
            int64_t ws = dq << jpegpix::PB;
            int64_t v = (((ws << jpegpix::CB) + jpegpix::R2) >>
                         (jpegpix::CB + jpegpix::PB + 3)) + 128;
#endif
            uint8_t s = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
            for (int r = 0; r < 8; r++)
                memset(dst + (size_t)r * pw[c], s, 8);
            local[0] = 0;
            return;
        }
        // ZRL runs can push k past 64 without writes; the IDCT bound is
        // a clamp (zeros above the true last coefficient are harmless)
        int last = k - 1 > 63 ? 63 : k - 1;
        uint8_t blk[64];
#if defined(__AVX2__)
        jpegpix::idct_block_avx2_last(local, q, blk, last);
#else
        jpegpix::idct_block_last(local, q, blk, last);
#endif
        for (int r = 0; r < 8; r++)
            memcpy(dst + (size_t)r * pw[c], blk + r * 8, 8);
        memset(local, 0, (size_t)(last + 1) * sizeof(int16_t));
    }
};

// Whole-image fused baseline decode: entropy decode + IDCT + upsample +
// color in ONE call (one ctypes crossing instead of two, no coefficient
// DRAM round-trip).  Restart-segment handling mirrors jpeg_decode_scan;
// the pixel tail is the same jpeg_assemble_pixels as the two-stage path,
// so outputs are byte-identical by construction (asserted over a config
// matrix in tests/test_torch_decode.py::test_native_fused_decode_equals_two_stage).  Returns 0 ok, -1 corrupt
// stream, -2 bad geometry args, -3 decline (caller falls back to the
// two-stage native path, then the Python tiers).
EXPORT int32_t jpeg_decode_baseline(
    const uint8_t* segs, const int64_t* seg_off, int32_t nseg,
    int64_t restart_interval, int64_t total_mcus,
    int32_t mcu_cols, int32_t mcu_rows,
    int32_t ncomp, const int32_t* comp_h, const int32_t* comp_v,
    int32_t max_h, int32_t max_v, int32_t width, int32_t height,
    const uint8_t* dc_bits, const uint8_t* dc_vals_flat, const int32_t* dc_vals_off,
    const uint8_t* ac_bits, const uint8_t* ac_vals_flat, const int32_t* ac_vals_off,
    const uint16_t* qtables_zz /* ncomp x 64, zigzag order */,
    int32_t fancy, uint8_t* out) {
    using namespace jdec;
    int64_t g = jpeg_pixels_geometry_check(
        comp_h, comp_v, ncomp, mcu_cols, mcu_rows, max_h, max_v,
        width, height, fancy);
    if (g != 0) return (int32_t)g;
    // power-of-two sampling-ratio check normally done by the assemble
    // tail — run it up front so exotic ratios decline before the decode
    if (ncomp == 3) {
        for (int ci = 1; ci < 3; ci++) {
            int hr = max_h / comp_h[ci], vr = max_v / comp_v[ci];
            if ((hr != 1 && hr != 2 && hr != 4) ||
                (vr != 1 && vr != 2 && vr != 4))
                return -3;
            if (fancy && (hr > 2 || vr > 2)) return -3;
        }
    }

    HuffDec dct[4], act[4];
    static thread_local AcLut aclut[4], dclut[4];
    for (int c = 0; c < ncomp; c++) {
        dct[c].build(dc_bits + 16 * c, dc_vals_flat + dc_vals_off[c]);
        act[c].build(ac_bits + 16 * c, ac_vals_flat + ac_vals_off[c]);
        aclut[c].build(ac_bits + 16 * c, ac_vals_flat + ac_vals_off[c]);
        dclut[c].build(dc_bits + 16 * c, dc_vals_flat + dc_vals_off[c], true);
    }

    std::vector<std::vector<uint8_t>> planes(ncomp);
    std::vector<int> pw(ncomp), ph(ncomp);
    JpegFusedIdctSink sink;
    for (int ci = 0; ci < ncomp; ci++) {
        pw[ci] = mcu_cols * comp_h[ci] * 8;
        ph[ci] = mcu_rows * comp_v[ci] * 8;
        planes[ci].resize((size_t)pw[ci] * ph[ci]);
        sink.planes[ci] = planes[ci].data();
        sink.qzz[ci] = qtables_zz + (size_t)ci * 64;
        sink.pw[ci] = pw[ci];
    }

    int32_t prev_dc[4];
    for (int32_t si = 0; si < nseg; si++) {
        int64_t m0 = restart_interval ? si * restart_interval : 0;
        int64_t m1 = restart_interval ? (si + 1) * restart_interval : total_mcus;
        if (m1 > total_mcus) m1 = total_mcus;
        if (m0 >= m1) break;
        for (int c = 0; c < ncomp; c++) prev_dc[c] = 0;
        int32_t rc = jpeg_decode_segment_sink(
            segs + seg_off[si], seg_off[si + 1] - seg_off[si], m0, m1,
            mcu_cols, ncomp, comp_h, comp_v, dct, act, aclut, dclut,
            sink, prev_dc);
        if (rc != 0) return rc;
        if (!restart_interval) break;
    }
    return (int32_t)jpeg_assemble_pixels(
        planes, pw.data(), ph.data(), comp_h, comp_v, ncomp,
        max_h, max_v, width, height, fancy, out);
}

// ===================== JPEG encode coefficient pipeline =====================
// Host tier of clamp-pad -> fixed-point YCbCr -> blockify (444/420/gray)
// -> float AAN DCT -> round-half-away quantize -> zigzag, bit-exact with
// the NumPy mirrors (ops/blockify.py, ops/dct.py, ops/quantize.py).
// All f32 arithmetic uses explicit AVX intrinsics in the mirrors'
// per-element operation order, and the build passes -ffp-contract=off
// (GCC otherwise fuses even intrinsic mul/add pairs into FMA at -O3),
// so outputs are byte-identical.  One call replaces the
// ~35 ms NumPy path for one-shot CLI encodes.

namespace jcoef {

#if defined(__AVX2__)

static const float AAN_A1 = 0.70710678118654752440f;
static const float AAN_A2 = 0.5411961f;
static const float AAN_A3 = 0.70710678118654752440f;
static const float AAN_A4 = 1.3065629f;
static const float AAN_A5 = 0.38268343f;
static const float AAN_S[8] = {0.3535534f, 0.2548978f, 0.2705981f, 0.3006724f,
                               0.3535534f, 0.4499881f, 0.6532815f, 1.2814578f};

static inline void transpose8x8_ps(__m256 r[8]) {
    __m256 t0 = _mm256_unpacklo_ps(r[0], r[1]);
    __m256 t1 = _mm256_unpackhi_ps(r[0], r[1]);
    __m256 t2 = _mm256_unpacklo_ps(r[2], r[3]);
    __m256 t3 = _mm256_unpackhi_ps(r[2], r[3]);
    __m256 t4 = _mm256_unpacklo_ps(r[4], r[5]);
    __m256 t5 = _mm256_unpackhi_ps(r[4], r[5]);
    __m256 t6 = _mm256_unpacklo_ps(r[6], r[7]);
    __m256 t7 = _mm256_unpackhi_ps(r[6], r[7]);
    __m256 u0 = _mm256_shuffle_ps(t0, t2, 0x44);
    __m256 u1 = _mm256_shuffle_ps(t0, t2, 0xEE);
    __m256 u2 = _mm256_shuffle_ps(t1, t3, 0x44);
    __m256 u3 = _mm256_shuffle_ps(t1, t3, 0xEE);
    __m256 u4 = _mm256_shuffle_ps(t4, t6, 0x44);
    __m256 u5 = _mm256_shuffle_ps(t4, t6, 0xEE);
    __m256 u6 = _mm256_shuffle_ps(t5, t7, 0x44);
    __m256 u7 = _mm256_shuffle_ps(t5, t7, 0xEE);
    r[0] = _mm256_permute2f128_ps(u0, u4, 0x20);
    r[1] = _mm256_permute2f128_ps(u1, u5, 0x20);
    r[2] = _mm256_permute2f128_ps(u2, u6, 0x20);
    r[3] = _mm256_permute2f128_ps(u3, u7, 0x20);
    r[4] = _mm256_permute2f128_ps(u0, u4, 0x31);
    r[5] = _mm256_permute2f128_ps(u1, u5, 0x31);
    r[6] = _mm256_permute2f128_ps(u2, u6, 0x31);
    r[7] = _mm256_permute2f128_ps(u3, u7, 0x31);
}

// one AAN 1D pass over eight lane-vectors (exact _aan_1d op order; every
// step an explicit mul/add intrinsic so nothing can contract to FMA)
static inline void aan_1d_avx(__m256 d[8]) {
    __m256 tmp0 = _mm256_add_ps(d[0], d[7]);
    __m256 tmp7 = _mm256_sub_ps(d[0], d[7]);
    __m256 tmp1 = _mm256_add_ps(d[1], d[6]);
    __m256 tmp6 = _mm256_sub_ps(d[1], d[6]);
    __m256 tmp2 = _mm256_add_ps(d[2], d[5]);
    __m256 tmp5 = _mm256_sub_ps(d[2], d[5]);
    __m256 tmp3 = _mm256_add_ps(d[3], d[4]);
    __m256 tmp4 = _mm256_sub_ps(d[3], d[4]);

    __m256 tmp10 = _mm256_add_ps(tmp0, tmp3);
    __m256 tmp13 = _mm256_sub_ps(tmp0, tmp3);
    __m256 tmp11 = _mm256_add_ps(tmp1, tmp2);
    __m256 tmp12 = _mm256_sub_ps(tmp1, tmp2);

    __m256 o0 = _mm256_add_ps(tmp10, tmp11);
    __m256 o4 = _mm256_sub_ps(tmp10, tmp11);

    __m256 z1 = _mm256_mul_ps(_mm256_add_ps(tmp12, tmp13), _mm256_set1_ps(AAN_A1));
    __m256 o2 = _mm256_add_ps(tmp13, z1);
    __m256 o6 = _mm256_sub_ps(tmp13, z1);

    __m256 t10 = _mm256_add_ps(tmp4, tmp5);
    __m256 t11 = _mm256_add_ps(tmp5, tmp6);
    __m256 t12 = _mm256_add_ps(tmp6, tmp7);

    __m256 z5 = _mm256_mul_ps(_mm256_sub_ps(t10, t12), _mm256_set1_ps(AAN_A5));
    __m256 z2 = _mm256_add_ps(_mm256_mul_ps(t10, _mm256_set1_ps(AAN_A2)), z5);
    __m256 z4 = _mm256_add_ps(_mm256_mul_ps(t12, _mm256_set1_ps(AAN_A4)), z5);
    __m256 z3 = _mm256_mul_ps(t11, _mm256_set1_ps(AAN_A3));

    __m256 z11 = _mm256_add_ps(tmp7, z3);
    __m256 z13 = _mm256_sub_ps(tmp7, z3);

    __m256 o5 = _mm256_add_ps(z13, z2);
    __m256 o3 = _mm256_sub_ps(z13, z2);
    __m256 o1 = _mm256_add_ps(z11, z4);
    __m256 o7 = _mm256_sub_ps(z11, z4);

    d[0] = _mm256_mul_ps(o0, _mm256_set1_ps(AAN_S[0]));
    d[1] = _mm256_mul_ps(o1, _mm256_set1_ps(AAN_S[1]));
    d[2] = _mm256_mul_ps(o2, _mm256_set1_ps(AAN_S[2]));
    d[3] = _mm256_mul_ps(o3, _mm256_set1_ps(AAN_S[3]));
    d[4] = _mm256_mul_ps(o4, _mm256_set1_ps(AAN_S[4]));
    d[5] = _mm256_mul_ps(o5, _mm256_set1_ps(AAN_S[5]));
    d[6] = _mm256_mul_ps(o6, _mm256_set1_ps(AAN_S[6]));
    d[7] = _mm256_mul_ps(o7, _mm256_set1_ps(AAN_S[7]));
}

static const int ZZN[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

#if defined(__AVX512BW__) && defined(__AVX512VL__)
// zigzag as four 16-lane i16 permutes: output vector k picks ZZN[16k+i]
// from the four natural-order row-pair vectors (vpermi2w indexes 32 lanes;
// the blend mask selects the v2:v3 pair for source indices >= 32)
struct ZZPerm {
    __m256i idx[4];
    __mmask16 hi[4];
    ZZPerm() {
        alignas(32) int16_t buf[16];
        for (int k = 0; k < 4; k++) {
            uint16_t m = 0;
            for (int i = 0; i < 16; i++) {
                int j = ZZN[16 * k + i];
                buf[i] = (int16_t)(j & 31);
                if (j >= 32) m |= (uint16_t)(1u << i);
            }
            idx[k] = _mm256_load_si256((const __m256i*)buf);
            hi[k] = m;
        }
    }
};
static const ZZPerm zzperm;
#endif

// dct block [8][8] f32 (8 rows at `src`, consecutive rows `stride` floats
// apart) -> quantized+zigzagged int16[64].
// Mirrors dct8x8_aan_np (pass along last axis, then along row axis) and
// round_half_away_np (nearest; exact .5 ties away from zero).
static inline void dct_quant_zz_block(const float* src, int64_t stride,
                                      const float* q, const int* zz_src,
                                      int16_t* out) {
    __m256 r[8];
    for (int i = 0; i < 8; i++) r[i] = _mm256_loadu_ps(src + i * stride);
    // rows pass: butterfly along the row elements -> transpose so lanes
    // index rows and vector index = element position
    transpose8x8_ps(r);
    aan_1d_avx(r);      // r[i] = transformed element i across all rows
    transpose8x8_ps(r); // back to row-major: r[i] = transformed row i
    // columns pass: butterfly along the row axis directly
    aan_1d_avx(r);      // r[i] = final coefficient row i? (see note)
    // NOTE: after the first transpose-pair, r is row-major [row][elem];
    // the second aan_1d_avx consumed the vectors as d0..d7 = rows, so
    // its outputs are coefficient ROWS-of-the-transform along the row
    // axis: r[k][c] = coefficient (k, c) — matching
    // np.stack(cols_done, axis=-2).
#if !(defined(__AVX512BW__) && defined(__AVX512VL__))
    alignas(32) float coef[64];
#endif
    const __m256 half = _mm256_set1_ps(0.5f);
    for (int i = 0; i < 8; i++) {
        __m256 d = _mm256_div_ps(r[i], _mm256_loadu_ps(q + i * 8));
        __m256 nearest = _mm256_round_ps(
            d, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
        __m256 t = _mm256_round_ps(d, _MM_FROUND_TO_ZERO | _MM_FROUND_NO_EXC);
        __m256 frac = _mm256_sub_ps(d, t);
        __m256 absfrac = _mm256_andnot_ps(_mm256_set1_ps(-0.0f), frac);
        __m256 tie = _mm256_cmp_ps(absfrac, half, _CMP_EQ_OQ);
        __m256 ge0 = _mm256_cmp_ps(d, _mm256_setzero_ps(), _CMP_GE_OQ);
        __m256 away = _mm256_add_ps(
            t, _mm256_blendv_ps(_mm256_set1_ps(-1.0f), _mm256_set1_ps(1.0f), ge0));
        __m256 res = _mm256_blendv_ps(nearest, away, tie);
#if defined(__AVX512BW__) && defined(__AVX512VL__)
        r[i] = res;  // kept in registers for the vector pack below
#else
        _mm256_store_ps(coef + i * 8, res);
#endif
    }
#if defined(__AVX512BW__) && defined(__AVX512VL__)
    // res values are exactly integral, so cvtps(nearest) == the scalar
    // (int16_t) truncation, and packs saturation never fires (|coef| <=
    // ~8160); zigzag runs as four 32-lane i16 permutes
    (void)zz_src;
    __m256i v[4];
    for (int i = 0; i < 4; i++) {
        __m256i a = _mm256_packs_epi32(_mm256_cvtps_epi32(r[2 * i]),
                                       _mm256_cvtps_epi32(r[2 * i + 1]));
        v[i] = _mm256_permute4x64_epi64(a, 0xD8);
    }
    for (int k = 0; k < 4; k++) {
        __m256i lo = _mm256_permutex2var_epi16(v[0], zzperm.idx[k], v[1]);
        __m256i hi = _mm256_permutex2var_epi16(v[2], zzperm.idx[k], v[3]);
        _mm256_storeu_si256((__m256i*)(out + 16 * k),
                            _mm256_mask_blend_epi16(zzperm.hi[k], lo, hi));
    }
#else
    for (int i = 0; i < 64; i++) out[i] = (int16_t)coef[zz_src[i]];
#endif
}

// Raw zigzagged f32 DCT (pre-quantization): the trellis front-end. Same
// AAN op order as dct_quant_zz_block (bit-equal to the NumPy mirror and
// the TPU device tier; built with -ffp-contract=off).
static inline void dct_zz_block_f32(const float* src, int64_t stride,
                                    const int* zz_src, float* out) {
    __m256 r[8];
    for (int i = 0; i < 8; i++) r[i] = _mm256_loadu_ps(src + i * stride);
    transpose8x8_ps(r);
    aan_1d_avx(r);
    transpose8x8_ps(r);
    aan_1d_avx(r);
    alignas(32) float coef[64];
    for (int i = 0; i < 8; i++) _mm256_store_ps(coef + i * 8, r[i]);
    for (int i = 0; i < 64; i++) out[i] = coef[zz_src[i]];
}

// fixed-point BT.601 forward (color.py rgb_to_ycbcr_np semantics) for one
// clamped row; emits f32 y-128 plus raw cb/cr (also f32) for 420, or
// y/cb/cr-128 directly for 444.  SIMD: one 32-bit gather per 8 pixels
// pulls r|g|b|(junk) packed words; the last pixel stays scalar so the
// gather never reads past the image buffer.
static inline void ycc_row(const uint8_t* rgb, int n, int c_in,
                           float* y, float* cb, float* cr, int minus128_chroma) {
    int x = 0;
#if defined(__AVX512F__)
    // 512-bit variant: same integer ops, 16 pixels per gather
    if (c_in >= 3) {
        const __m512i step16 = _mm512_setr_epi32(
            0, c_in, 2 * c_in, 3 * c_in, 4 * c_in, 5 * c_in, 6 * c_in,
            7 * c_in, 8 * c_in, 9 * c_in, 10 * c_in, 11 * c_in, 12 * c_in,
            13 * c_in, 14 * c_in, 15 * c_in);
        const __m512i m255w = _mm512_set1_epi32(255);
        const __m512i c128w = _mm512_set1_epi32(128);
        const __m512 f128w = _mm512_set1_ps(128.0f);
        int limit = n - 1;  // last pixel scalar (gather would overread)
        for (; x + 16 <= limit; x += 16) {
            __m512i idx = _mm512_add_epi32(step16, _mm512_set1_epi32(x * c_in));
            __m512i v = _mm512_i32gather_epi32(idx, (const int*)rgb, 1);
            __m512i r = _mm512_and_si512(v, m255w);
            __m512i g = _mm512_and_si512(_mm512_srli_epi32(v, 8), m255w);
            __m512i b = _mm512_and_si512(_mm512_srli_epi32(v, 16), m255w);
            __m512i yv = _mm512_srai_epi32(
                _mm512_add_epi32(
                    _mm512_add_epi32(
                        _mm512_mullo_epi32(r, _mm512_set1_epi32(77)),
                        _mm512_mullo_epi32(g, _mm512_set1_epi32(150))),
                    _mm512_add_epi32(
                        _mm512_mullo_epi32(b, _mm512_set1_epi32(29)), c128w)),
                8);
            __m512i cbv = _mm512_add_epi32(
                _mm512_srai_epi32(
                    _mm512_add_epi32(
                        _mm512_add_epi32(
                            _mm512_mullo_epi32(r, _mm512_set1_epi32(-43)),
                            _mm512_mullo_epi32(g, _mm512_set1_epi32(-85))),
                        _mm512_add_epi32(
                            _mm512_mullo_epi32(b, _mm512_set1_epi32(128)),
                            c128w)),
                    8),
                c128w);
            __m512i crv = _mm512_add_epi32(
                _mm512_srai_epi32(
                    _mm512_add_epi32(
                        _mm512_add_epi32(
                            _mm512_mullo_epi32(r, _mm512_set1_epi32(128)),
                            _mm512_mullo_epi32(g, _mm512_set1_epi32(-107))),
                        _mm512_add_epi32(
                            _mm512_mullo_epi32(b, _mm512_set1_epi32(-21)),
                            c128w)),
                    8),
                c128w);
            yv = _mm512_min_epi32(_mm512_max_epi32(yv, _mm512_setzero_si512()),
                                  m255w);
            cbv = _mm512_min_epi32(
                _mm512_max_epi32(cbv, _mm512_setzero_si512()), m255w);
            crv = _mm512_min_epi32(
                _mm512_max_epi32(crv, _mm512_setzero_si512()), m255w);
            _mm512_storeu_ps(y + x,
                             _mm512_sub_ps(_mm512_cvtepi32_ps(yv), f128w));
            __m512 cbf = _mm512_cvtepi32_ps(cbv);
            __m512 crf = _mm512_cvtepi32_ps(crv);
            if (minus128_chroma) {
                cbf = _mm512_sub_ps(cbf, f128w);
                crf = _mm512_sub_ps(crf, f128w);
            }
            _mm512_storeu_ps(cb + x, cbf);
            _mm512_storeu_ps(cr + x, crf);
        }
    }
#endif
#if defined(__AVX2__)
    if (c_in >= 3) {
        const __m256i step = _mm256_setr_epi32(0, c_in, 2 * c_in, 3 * c_in,
                                               4 * c_in, 5 * c_in, 6 * c_in,
                                               7 * c_in);
        const __m256i m255 = _mm256_set1_epi32(255);
        const __m256i c128i = _mm256_set1_epi32(128);
        const __m256 f128 = _mm256_set1_ps(128.0f);
        int limit = n - 1;  // last pixel scalar (gather would overread 1-2 B)
        for (; x + 8 <= limit; x += 8) {
            __m256i idx = _mm256_add_epi32(step, _mm256_set1_epi32(x * c_in));
            __m256i v = _mm256_i32gather_epi32(
                (const int*)rgb, idx, 1);
            __m256i r = _mm256_and_si256(v, m255);
            __m256i g = _mm256_and_si256(_mm256_srli_epi32(v, 8), m255);
            __m256i b = _mm256_and_si256(_mm256_srli_epi32(v, 16), m255);
            __m256i yv = _mm256_srai_epi32(
                _mm256_add_epi32(
                    _mm256_add_epi32(
                        _mm256_mullo_epi32(r, _mm256_set1_epi32(77)),
                        _mm256_mullo_epi32(g, _mm256_set1_epi32(150))),
                    _mm256_add_epi32(
                        _mm256_mullo_epi32(b, _mm256_set1_epi32(29)), c128i)),
                8);
            __m256i cbv = _mm256_add_epi32(
                _mm256_srai_epi32(
                    _mm256_add_epi32(
                        _mm256_add_epi32(
                            _mm256_mullo_epi32(r, _mm256_set1_epi32(-43)),
                            _mm256_mullo_epi32(g, _mm256_set1_epi32(-85))),
                        _mm256_add_epi32(
                            _mm256_mullo_epi32(b, _mm256_set1_epi32(128)),
                            c128i)),
                    8),
                c128i);
            __m256i crv = _mm256_add_epi32(
                _mm256_srai_epi32(
                    _mm256_add_epi32(
                        _mm256_add_epi32(
                            _mm256_mullo_epi32(r, _mm256_set1_epi32(128)),
                            _mm256_mullo_epi32(g, _mm256_set1_epi32(-107))),
                        _mm256_add_epi32(
                            _mm256_mullo_epi32(b, _mm256_set1_epi32(-21)),
                            c128i)),
                    8),
                c128i);
            yv = _mm256_min_epi32(_mm256_max_epi32(yv, _mm256_setzero_si256()), m255);
            cbv = _mm256_min_epi32(_mm256_max_epi32(cbv, _mm256_setzero_si256()), m255);
            crv = _mm256_min_epi32(_mm256_max_epi32(crv, _mm256_setzero_si256()), m255);
            _mm256_storeu_ps(y + x, _mm256_sub_ps(_mm256_cvtepi32_ps(yv), f128));
            __m256 cbf = _mm256_cvtepi32_ps(cbv);
            __m256 crf = _mm256_cvtepi32_ps(crv);
            if (minus128_chroma) {
                cbf = _mm256_sub_ps(cbf, f128);
                crf = _mm256_sub_ps(crf, f128);
            }
            _mm256_storeu_ps(cb + x, cbf);
            _mm256_storeu_ps(cr + x, crf);
        }
    }
#endif
    for (; x < n; x++) {
        int r = rgb[x * c_in + 0];
        int g = rgb[x * c_in + (c_in > 1 ? 1 : 0)];
        int b = rgb[x * c_in + (c_in > 1 ? 2 : 0)];
        int yv = (77 * r + 150 * g + 29 * b + 128) >> 8;
        int cbv = ((-43 * r - 85 * g + 128 * b + 128) >> 8) + 128;
        int crv = ((128 * r - 107 * g - 21 * b + 128) >> 8) + 128;
        yv = yv < 0 ? 0 : yv > 255 ? 255 : yv;
        cbv = cbv < 0 ? 0 : cbv > 255 ? 255 : cbv;
        crv = crv < 0 ? 0 : crv > 255 ? 255 : crv;
        y[x] = (float)yv - 128.0f;
        cb[x] = minus128_chroma ? (float)cbv - 128.0f : (float)cbv;
        cr[x] = minus128_chroma ? (float)crv - 128.0f : (float)crv;
    }
}


#endif  // __AVX2__

}  // namespace jcoef

// img: [h, w, c_in] uint8 (c_in 1/3/4; alpha ignored), qlum/qchrom:
// natural-order [64] f32.  mode: 0=gray, 1=444, 2=420, 3=422.  out: int16
// [nblocks, 64] zigzag, block order identical to the NumPy mirrors.
// Returns nblocks or -1 (no AVX2 build / bad args).
#if defined(__AVX2__)
namespace jcoef {
struct QuantZZSink {  // fused quantize+zigzag int16 stream (encode path)
    const float *qlum, *qchrom;
    int16_t* o;
    inline void block(const float* src, int64_t stride, bool chroma) {
        dct_quant_zz_block(src, stride, chroma ? qchrom : qlum, ZZN, o);
        o += 64;
    }
};
struct RawZZSink {  // raw zigzagged f32 DCT (trellis front-end)
    float* o;
    inline void block(const float* src, int64_t stride, bool) {
        dct_zz_block_f32(src, stride, ZZN, o);
        o += 64;
    }
};
}  // namespace jcoef

template <class Sink>
static int64_t jpeg_coefficients_impl(
    const uint8_t* img, int64_t h, int64_t w, int32_t c_in, int32_t mode,
    Sink& sink) {
    using namespace jcoef;
    if (h <= 0 || w <= 0) return -1;
    if (mode == 0) {
        if (c_in != 1) return -1;
        int64_t ph = (h + 7) & ~7LL, pw = (w + 7) & ~7LL;
        int64_t bw = pw / 8, bh = ph / 8;
        std::vector<float> rows((size_t)8 * pw);
        for (int64_t by = 0; by < bh; by++) {
            for (int rr = 0; rr < 8; rr++) {
                int64_t sy = by * 8 + rr;
                if (sy >= h) sy = h - 1;
                const uint8_t* src = img + sy * w;
                float* dst = rows.data() + (size_t)rr * pw;
                for (int64_t x = 0; x < w; x++) dst[x] = (float)src[x] - 128.0f;
                for (int64_t x = w; x < pw; x++) dst[x] = dst[w - 1];
            }
            for (int64_t bx = 0; bx < bw; bx++) {
                sink.block(rows.data() + bx * 8, pw, false);
            }
        }
        return bh * bw;
    }
    if (c_in != 3 && c_in != 4) return -1;
    if (mode == 1) {  // 444
        int64_t ph = (h + 7) & ~7LL, pw = (w + 7) & ~7LL;
        int64_t bw = pw / 8, bh = ph / 8;
        std::vector<float> yb((size_t)8 * pw), cbb((size_t)8 * pw),
            crb((size_t)8 * pw);
        for (int64_t by = 0; by < bh; by++) {
            for (int rr = 0; rr < 8; rr++) {
                int64_t sy = by * 8 + rr;
                if (sy >= h) sy = h - 1;
                float* yd = yb.data() + (size_t)rr * pw;
                float* cbd = cbb.data() + (size_t)rr * pw;
                float* crd = crb.data() + (size_t)rr * pw;
                ycc_row(img + sy * w * c_in, (int)w, c_in, yd, cbd, crd, 1);
                for (int64_t x = w; x < pw; x++) {
                    yd[x] = yd[w - 1]; cbd[x] = cbd[w - 1]; crd[x] = crd[w - 1];
                }
            }
            for (int64_t bx = 0; bx < bw; bx++) {
                const float* planes[3] = {yb.data(), cbb.data(), crb.data()};
                for (int comp = 0; comp < 3; comp++)
                    sink.block(planes[comp] + bx * 8, pw, comp != 0);
            }
        }
        return bh * bw * 3;
    }
    if (mode == 3) {
        // 422: pad h to 8 / w to 16, MCU = Y(left), Y(right) + horizontal
        // pair-averaged Cb/Cr ((a + b) * 0.5 - 128, matching the
        // blocks_422_np mirror's float op order exactly). Beyond parity:
        // the reference has no 4:2:2 encode path (src/jpeg/mod.rs:96-300).
        int64_t ph = (h + 7) & ~7LL, pw = (w + 15) & ~15LL;
        int64_t nmx = pw / 16, nmy = ph / 8;
        std::vector<float> yb((size_t)8 * pw), cbr((size_t)8 * pw),
            crr((size_t)8 * pw), cbs((size_t)8 * (pw / 2)),
            crs((size_t)8 * (pw / 2));
        for (int64_t my = 0; my < nmy; my++) {
            for (int rr = 0; rr < 8; rr++) {
                int64_t sy = my * 8 + rr;
                if (sy >= h) sy = h - 1;
                float* yd = yb.data() + (size_t)rr * pw;
                float* cbd = cbr.data() + (size_t)rr * pw;
                float* crd = crr.data() + (size_t)rr * pw;
                ycc_row(img + sy * w * c_in, (int)w, c_in, yd, cbd, crd, 0);
                for (int64_t x = w; x < pw; x++) {
                    yd[x] = yd[w - 1]; cbd[x] = cbd[w - 1]; crd[x] = crd[w - 1];
                }
                // horizontal pair average (same row), mirror float order
                float* cbo = cbs.data() + (size_t)rr * (pw / 2);
                float* cro = crs.data() + (size_t)rr * (pw / 2);
                const __m256i fix = _mm256_setr_epi32(0, 1, 4, 5, 2, 3, 6, 7);
                const __m256 half = _mm256_set1_ps(0.5f);
                const __m256 c128f = _mm256_set1_ps(128.0f);
                int64_t x = 0;
                for (; x + 8 <= pw / 2; x += 8) {
                    const float* srcs[2] = {cbd, crd};
                    float* dsts[2] = {cbo, cro};
                    for (int ch = 0; ch < 2; ch++) {
                        __m256 a = _mm256_loadu_ps(srcs[ch] + 2 * x);
                        __m256 b = _mm256_loadu_ps(srcs[ch] + 2 * x + 8);
                        __m256 ev = _mm256_shuffle_ps(a, b, 0x88);
                        __m256 od = _mm256_shuffle_ps(a, b, 0xDD);
                        __m256 s = _mm256_add_ps(ev, od);
                        __m256 r =
                            _mm256_sub_ps(_mm256_mul_ps(s, half), c128f);
                        _mm256_storeu_ps(dsts[ch] + x,
                                         _mm256_permutevar8x32_ps(r, fix));
                    }
                }
                for (; x < pw / 2; x++) {
                    cbo[x] = (cbd[2 * x] + cbd[2 * x + 1]) * 0.5f - 128.0f;
                    cro[x] = (crd[2 * x] + crd[2 * x + 1]) * 0.5f - 128.0f;
                }
            }
            for (int64_t mx = 0; mx < nmx; mx++) {
                sink.block(yb.data() + mx * 16, pw, false);
                sink.block(yb.data() + mx * 16 + 8, pw, false);
                sink.block(cbs.data() + mx * 8, pw / 2, true);
                sink.block(crs.data() + mx * 8, pw / 2, true);
            }
        }
        return nmy * nmx * 4;
    }
    if (mode != 2) return -1;
    // 420: pad to 16, MCU = 4 Y (by,bx) + avg-cb + avg-cr
    int64_t ph = (h + 15) & ~15LL, pw = (w + 15) & ~15LL;
    int64_t nmx = pw / 16, nmy = ph / 16;
    std::vector<float> yb((size_t)16 * pw), cbr((size_t)16 * pw),
        crr((size_t)16 * pw), cbs((size_t)8 * (pw / 2)),
        crs((size_t)8 * (pw / 2));
    for (int64_t my = 0; my < nmy; my++) {
        for (int rr = 0; rr < 16; rr++) {
            int64_t sy = my * 16 + rr;
            if (sy >= h) sy = h - 1;
            float* yd = yb.data() + (size_t)rr * pw;
            float* cbd = cbr.data() + (size_t)rr * pw;
            float* crd = crr.data() + (size_t)rr * pw;
            ycc_row(img + sy * w * c_in, (int)w, c_in, yd, cbd, crd, 0);
            for (int64_t x = w; x < pw; x++) {
                yd[x] = yd[w - 1]; cbd[x] = cbd[w - 1]; crd[x] = crd[w - 1];
            }
        }
        // chroma 2x2 average: ((a + b) + c) + d) order must match the
        // mirror: (q00 + q01 + q10 + q11) * 0.25 - 128
        for (int rr = 0; rr < 8; rr++) {
            const float* cb0 = cbr.data() + (size_t)(2 * rr) * pw;
            const float* cb1 = cbr.data() + (size_t)(2 * rr + 1) * pw;
            const float* cr0 = crr.data() + (size_t)(2 * rr) * pw;
            const float* cr1 = crr.data() + (size_t)(2 * rr + 1) * pw;
            float* cbd = cbs.data() + (size_t)rr * (pw / 2);
            float* crd = crs.data() + (size_t)rr * (pw / 2);
            // mirror order per element: ((q00 + q01) + q10) + q11, then
            // * 0.25 - 128. Vector form deinterleaves even/odd columns
            // with in-lane shuffles (a consistent scrambled lane order)
            // and applies one order-fixing permute to the finished sum —
            // the adds are elementwise, so the permute commutes and each
            // lane's float op order matches the scalar exactly.
            const __m256i fix = _mm256_setr_epi32(0, 1, 4, 5, 2, 3, 6, 7);
            const __m256 quarter = _mm256_set1_ps(0.25f);
            const __m256 c128f = _mm256_set1_ps(128.0f);
            int64_t x = 0;
            for (; x + 8 <= pw / 2; x += 8) {
                const float* srcs[2][2] = {{cb0, cb1}, {cr0, cr1}};
                float* dsts[2] = {cbd, crd};
                for (int ch = 0; ch < 2; ch++) {
                    __m256 a = _mm256_loadu_ps(srcs[ch][0] + 2 * x);
                    __m256 b = _mm256_loadu_ps(srcs[ch][0] + 2 * x + 8);
                    __m256 ev0 = _mm256_shuffle_ps(a, b, 0x88);
                    __m256 od0 = _mm256_shuffle_ps(a, b, 0xDD);
                    __m256 c = _mm256_loadu_ps(srcs[ch][1] + 2 * x);
                    __m256 d = _mm256_loadu_ps(srcs[ch][1] + 2 * x + 8);
                    __m256 ev1 = _mm256_shuffle_ps(c, d, 0x88);
                    __m256 od1 = _mm256_shuffle_ps(c, d, 0xDD);
                    __m256 s = _mm256_add_ps(
                        _mm256_add_ps(_mm256_add_ps(ev0, od0), ev1), od1);
                    __m256 r = _mm256_sub_ps(_mm256_mul_ps(s, quarter), c128f);
                    _mm256_storeu_ps(dsts[ch] + x,
                                     _mm256_permutevar8x32_ps(r, fix));
                }
            }
            for (; x < pw / 2; x++) {
                float sb = ((cb0[2 * x] + cb0[2 * x + 1]) + cb1[2 * x]) +
                           cb1[2 * x + 1];
                float sr = ((cr0[2 * x] + cr0[2 * x + 1]) + cr1[2 * x]) +
                           cr1[2 * x + 1];
                cbd[x] = sb * 0.25f - 128.0f;
                crd[x] = sr * 0.25f - 128.0f;
            }
        }
        for (int64_t mx = 0; mx < nmx; mx++) {
            for (int sub = 0; sub < 4; sub++) {
                int64_t y0 = (sub / 2) * 8, x0 = mx * 16 + (sub % 2) * 8;
                sink.block(yb.data() + y0 * pw + x0, pw, false);
            }
            sink.block(cbs.data() + mx * 8, pw / 2, true);
            sink.block(crs.data() + mx * 8, pw / 2, true);
        }
    }
    return nmy * nmx * 6;
}
#endif  // __AVX2__

EXPORT int64_t jpeg_coefficients(
    const uint8_t* img, int64_t h, int64_t w, int32_t c_in, int32_t mode,
    const float* qlum, const float* qchrom, int16_t* out) {
#if !defined(__AVX2__)
    (void)img; (void)h; (void)w; (void)c_in; (void)mode; (void)qlum;
    (void)qchrom; (void)out;
    return -1;
#else
    jcoef::QuantZZSink sink{qlum, qchrom, out};
    return jpeg_coefficients_impl(img, h, w, c_in, mode, sink);
#endif
}

// Raw zigzagged f32 DCT for the host trellis path: same blockify /
// YCbCr / padding / MCU order as jpeg_coefficients, no quantization.
EXPORT int64_t jpeg_dct_zz(
    const uint8_t* img, int64_t h, int64_t w, int32_t c_in, int32_t mode,
    float* out) {
#if !defined(__AVX2__)
    (void)img; (void)h; (void)w; (void)c_in; (void)mode; (void)out;
    return -1;
#else
    jcoef::RawZZSink sink{out};
    return jpeg_coefficients_impl(img, h, w, c_in, mode, sink);
#endif
}

// Fused single-pass encode scan: coefficients (clamp-pad -> YCbCr ->
// AAN DCT -> quantize -> zigzag) packed into entropy-coded bytes block
// by block, without materializing the [nblocks, 64] int16 array (~2
// bytes/coefficient of DRAM write+reread saved) or a second ctypes
// crossing. Byte-identical to jpeg_coefficients + jpeg_pack_scan: the
// quantizer is the same dct_quant_zz_block and the packer the same
// pack_one_block, and block emission order from jpeg_coefficients_impl
// IS the interleaved scan order. The latency tier for the baseline
// single-image path (reference: one-shot CLI encodes,
// src/jpeg/mod.rs:1137-1230 does the analogous fused row walk).
#if defined(__AVX2__)
namespace jcoef {
struct FusedPackSink {
    const float *qlum, *qchrom;
    jpeg::MsbWriter w;
    const uint16_t* dc_codes[3];
    const uint8_t* dc_lens[3];
    const uint16_t* ac_codes[3];
    const uint8_t* ac_lens[3];
    const uint8_t* pattern;
    int bpm, k;
    int prev_dc[3];
    int32_t restart;
    int64_t mcu, total_mcus;
    int rst_idx;

    inline void block(const float* src, int64_t stride, bool chroma) {
        alignas(32) int16_t blk[64];
        dct_quant_zz_block(src, stride, chroma ? qchrom : qlum, ZZN, blk);
        int comp = pattern[k];
        jpeg::pack_one_block(w, blk, dc_codes[comp], dc_lens[comp],
                             ac_codes[comp], ac_lens[comp], prev_dc[comp]);
        if (++k == bpm) {
            k = 0;
            mcu++;
            if (restart > 0 && mcu % restart == 0 && mcu < total_mcus) {
                w.flush_pad_ones();
                uint8_t rst[2] = {0xFF, (uint8_t)(0xD0 + (rst_idx & 7))};
                w.raw_bytes(rst, 2);
                rst_idx = (rst_idx + 1) & 7;
                prev_dc[0] = prev_dc[1] = prev_dc[2] = 0;
            }
        }
    }
};
}  // namespace jcoef
#endif

EXPORT int64_t jpeg_encode_scan_fused(
    const uint8_t* img, int64_t h, int64_t w, int32_t c_in, int32_t mode,
    const float* qlum, const float* qchrom,
    const uint8_t* pattern, int32_t bpm,
    const uint16_t* dc_lum_c, const uint8_t* dc_lum_l,
    const uint16_t* dc_chrom_c, const uint8_t* dc_chrom_l,
    const uint16_t* ac_lum_c, const uint8_t* ac_lum_l,
    const uint16_t* ac_chrom_c, const uint8_t* ac_chrom_l,
    int32_t restart_interval,
    uint8_t* out, int64_t out_cap) {
#if !defined(__AVX2__)
    (void)img; (void)h; (void)w; (void)c_in; (void)mode; (void)qlum;
    (void)qchrom; (void)pattern; (void)bpm; (void)dc_lum_c; (void)dc_lum_l;
    (void)dc_chrom_c; (void)dc_chrom_l; (void)ac_lum_c; (void)ac_lum_l;
    (void)ac_chrom_c; (void)ac_chrom_l; (void)restart_interval; (void)out;
    (void)out_cap;
    return -1;
#else
    int64_t nblocks;
    if (mode == 0) {
        nblocks = ((h + 7) / 8) * ((w + 7) / 8);
    } else if (mode == 1) {
        nblocks = ((h + 7) / 8) * ((w + 7) / 8) * 3;
    } else {
        nblocks = ((h + 15) / 16) * ((w + 15) / 16) * 6;
    }
    jcoef::FusedPackSink sink{
        qlum, qchrom, jpeg::MsbWriter(out, out_cap),
        {dc_lum_c, dc_chrom_c, dc_chrom_c},
        {dc_lum_l, dc_chrom_l, dc_chrom_l},
        {ac_lum_c, ac_chrom_c, ac_chrom_c},
        {ac_lum_l, ac_chrom_l, ac_chrom_l},
        pattern, bpm, 0,
        {0, 0, 0},
        restart_interval, 0, nblocks / bpm, 0};
    int64_t rc = jpeg_coefficients_impl(img, h, w, c_in, mode, sink);
    if (rc != nblocks) return -1;
    sink.w.flush_pad_ones();
    return sink.w.overflow ? -1 : sink.w.pos;
#endif
}

// =========================== Lanczos3 resize ================================
// Host tier of the separable Lanczos pass pair.  Tap starts/weights are
// computed by ops/resize_kernels.lanczos_taps (Python/NumPy — the f32
// sinf semantics stay in one place); this runs the accumulation with
// the exact serial order of the lax.scan tier: lanes are independent
// output elements, each accumulating acc = acc + px*w per tap in f32
// (-ffp-contract=off build), with the reference's intermediate u8
// round/clamp between passes.  Bit-identical to resize_lanczos3.

namespace jresize {
#if defined(__AVX2__)
// round-half-away == roundf: nearest for non-ties, away at exact .5
static inline __m256 round_half_away_ps(__m256 d) {
    __m256 nearest = _mm256_round_ps(
        d, _MM_FROUND_TO_NEAREST_INT | _MM_FROUND_NO_EXC);
    __m256 t = _mm256_round_ps(d, _MM_FROUND_TO_ZERO | _MM_FROUND_NO_EXC);
    __m256 frac = _mm256_sub_ps(d, t);
    __m256 absfrac = _mm256_andnot_ps(_mm256_set1_ps(-0.0f), frac);
    __m256 tie = _mm256_cmp_ps(absfrac, _mm256_set1_ps(0.5f), _CMP_EQ_OQ);
    __m256 ge0 = _mm256_cmp_ps(d, _mm256_setzero_ps(), _CMP_GE_OQ);
    __m256 away = _mm256_add_ps(
        t, _mm256_blendv_ps(_mm256_set1_ps(-1.0f), _mm256_set1_ps(1.0f), ge0));
    return _mm256_blendv_ps(nearest, away, tie);
}
#endif
static inline uint8_t round_clamp_scalar(float v) {
    float t = truncf(v);
    float frac = v - t;
    float r;
    if (frac == 0.5f || frac == -0.5f) r = v >= 0.0f ? t + 1.0f : t - 1.0f;
    else r = nearbyintf(v);  // ties impossible here; nearest mode
    if (r < 0.0f) r = 0.0f;
    if (r > 255.0f) r = 255.0f;
    return (uint8_t)r;
}
}  // namespace jresize

EXPORT int32_t resize_lanczos3_host(
    const uint8_t* img, int64_t h, int64_t w, int32_t c,
    const int32_t* sx, const float* wx, int32_t kx, int32_t dst_w,
    const int32_t* sy, const float* wy, int32_t ky, int32_t dst_h,
    uint8_t* out) {
#if !defined(__AVX2__)
    (void)img; (void)h; (void)w; (void)c; (void)sx; (void)wx; (void)kx;
    (void)dst_w; (void)sy; (void)wy; (void)ky; (void)dst_h; (void)out;
    return -1;
#else
    using namespace jresize;
    if (h <= 0 || w <= 0 || c <= 0 || c > 4) return -1;

    // one vertical-style pass: src [S, N] u8 -> dst [dstn, N] u8, taps
    // along axis 0, lanes = 8 contiguous elements of the N axis (weights
    // shared across lanes, loads contiguous -> no gathers)
    auto vpass = [](const uint8_t* sp, int64_t S, int64_t N,
                    const int32_t* st, const float* wt, int kk,
                    int64_t dstn, uint8_t* dp) {
        for (int64_t d = 0; d < dstn; d++) {
            const float* wrow = wt + (size_t)d * kk;
            uint8_t* orow = dp + (size_t)d * N;
            int64_t x0 = 0;
            for (; x0 + 8 <= N; x0 += 8) {
                __m256 acc = _mm256_setzero_ps();
                for (int i = 0; i < kk; i++) {
                    int64_t idx = (int64_t)st[d] + i;
                    if (idx < 0) idx = 0;
                    if (idx >= S) idx = S - 1;
                    __m256i raw = _mm256_cvtepu8_epi32(_mm_loadl_epi64(
                        (const __m128i*)(sp + (size_t)idx * N + x0)));
                    acc = _mm256_add_ps(
                        acc, _mm256_mul_ps(_mm256_cvtepi32_ps(raw),
                                           _mm256_set1_ps(wrow[i])));
                }
                __m256 r = round_half_away_ps(acc);
                r = _mm256_min_ps(_mm256_max_ps(r, _mm256_setzero_ps()),
                                  _mm256_set1_ps(255.0f));
                alignas(32) float rv[8];
                _mm256_store_ps(rv, r);
                for (int l = 0; l < 8; l++) orow[x0 + l] = (uint8_t)rv[l];
            }
            for (; x0 < N; x0++) {
                float acc = 0.0f;
                for (int i = 0; i < kk; i++) {
                    int64_t idx = (int64_t)st[d] + i;
                    if (idx < 0) idx = 0;
                    if (idx >= S) idx = S - 1;
                    acc = acc + (float)sp[(size_t)idx * N + x0] * wrow[i];
                }
                orow[x0] = round_clamp_scalar(acc);
            }
        }
    };
    // blocked u8 transpose [a, b, c] -> [b, a, c]
    auto transpose_hw = [](const uint8_t* sp, int64_t a, int64_t b, int cc,
                           uint8_t* dp) {
        const int64_t T = 32;
        for (int64_t y0 = 0; y0 < a; y0 += T)
            for (int64_t x0 = 0; x0 < b; x0 += T) {
                int64_t y1 = y0 + T < a ? y0 + T : a;
                int64_t x1 = x0 + T < b ? x0 + T : b;
                for (int64_t y = y0; y < y1; y++)
                    for (int64_t x = x0; x < x1; x++)
                        memcpy(dp + ((size_t)x * a + y) * cc,
                               sp + ((size_t)y * b + x) * cc, cc);
            }
    };

    // horizontal pass as a vertical pass over the transposed image
    std::vector<uint8_t> tr((size_t)w * h * c);        // [w, h, c]
    transpose_hw(img, h, w, c, tr.data());
    std::vector<uint8_t> t1((size_t)dst_w * h * c);    // [dst_w, h, c]
    vpass(tr.data(), w, (int64_t)h * c, sx, wx, kx, dst_w, t1.data());
    std::vector<uint8_t> t2((size_t)h * dst_w * c);    // [h, dst_w, c]
    transpose_hw(t1.data(), dst_w, h, c, t2.data());
    // vertical pass
    vpass(t2.data(), h, (int64_t)dst_w * c, sy, wy, ky, dst_h, out);
    return 0;
#endif
}

// Generic length-limited Huffman build (counting-form package-merge) for
// the Python compress.huffman front-end: same single-symbol dummy rule
// as the Python implementation (deflate::build_lengths handles it).
EXPORT int32_t huffman_build_lengths(const uint64_t* freqs, int32_t n,
                                     int32_t max_len, uint8_t* out) {
    if (n <= 0 || max_len <= 0) return -1;
    deflate::build_lengths(freqs, n, max_len, out);
    return 0;
}
