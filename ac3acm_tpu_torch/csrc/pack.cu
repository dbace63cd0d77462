// P1: the encoder's frame packer for Hopper (sm_90a): a batch of frame
// fields -> finished AC-3 frames, one launch a call.
//
// Replaces what the JAX package leaves to XLA: ac3acm_tpu/ops/pack_device.py
// :361 pack_frames_device (no pallas_call), its token stream (:406 tokens,
// :269 _mant_tokens, :325 _exp_group_tokens) and :548 finish.  In the port
// it ran as an eager chain over an int64 token stream [N, T] in device
// memory (ops/pack_device.py:pack_frames_ref, the plain version: tokens,
// cumsum offsets, two scatter-add deposits, the CRCs as a position-table
// gather and XOR fold).  The serial definition is host/pack.py:pack_frame;
// native/ac3host.cpp:pack_one writes the same bytes in the same order.
//
// Per frame.  The token schedule is static per config (the wrapper's
// table, ops/pack_device.py:kernel_table): the header, then per audio
// block its side-info slots (constants, strategies, chbwcod, the first
// exponent, the exponent groups, gainrng, the snr offsets, ...) and its
// live mantissa bins in channel order.  Only the lengths and values are
// data: a slot of a reused block's channel is 0 bits long; a grouped
// class's member (bap 1, 2, 4) is 0 bits unless it heads its group
// (ordinal % 3, 3, 2 == 0, the ordinal counted over the block's live bins
// of every channel), when it carries 5, 7, 7 bits, the value 9 a + 3 b +
// c, 25 a + 5 b + c, 11 a + b of its own and the next members' codes (& 15,
// 0 where the block has no next member); other classes: 3 -> 3 bits,
// 5..13 -> class - 1, 14 -> 14, 15 -> 16, the rest 0.  Each value is
// masked to its length.  The bits are laid MSB first from bit 0; payload
// bits at or past byte total - 2 are dropped (the reference's overshoot:
// a frame whose tokens overrun its size is that prefix of its stream, and
// nothing is written outside its own bytes); CRC1 (bytes 2-3) is the
// CRC16 of bytes [4, 2 fs58) times crc_inv (the reference's back-patch),
// CRC2 (the last two bytes) that of [2 fs58, total - 2).  Integer-exact.
//
// Bound on the card: bytes.  The function reads a live bin's class (a
// byte), its code where the class is not 0 (16 bits, its narrowest), the
// exponents a coded (block, channel) sends (1 + 3 groups, a byte each;
// none where it reuses), the strategies and the two offsets, and writes
// the frame: on the encoder's content about 0.02 ms for 16,384 frames of
// 2.0 at 192 kbit/s and 0.05 ms for 5.1 at 640 kbit/s at 3.35 TB/s
// (chip_smoke.py:pack_least_bytes counts them from a call's fields).  Its
// integer work, a few operations a live bin and a CRC step a byte, is
// about 40% of that.
//
// What the design does about it.  One CTA a frame, 128 threads up to two
// channels, 256 above; the frame's words (at most 3,840 bytes) live in
// shared memory from first bit to CRC, so the token stream never exists
// in device memory.  Per block: the live bins of bap (16-byte loads),
// qmant (int32, as the core leaves it) and the exponents a group reads
// (non-reused channels only) are staged in shared memory; the block's
// elements (its slots, then its live bins) are cut into one run of
// consecutive elements a thread; one CTA-wide exclusive scan (warp
// shuffles and a shared carry) of a packed 64-bit count per thread gives
// every element's bit offset: 16-bit fields of the ungrouped bits and of
// the class 1, 2 and 4 members (a block holds at most 1,536 live bins and
// under 30,000 ungrouped bits, so no field carries), with a grouped
// class's bits 5 ceil(n1 / 3) + 7 ceil(n2 / 3) + 7 ceil(n4 / 2) over its
// members before.  A second walk deposits the ungrouped tokens with
// atomicOr into the shared words (the bits of a frame are disjoint, so OR
// is the plain version's add; a token of at most 16 bits straddles at
// most two words), stores each member's code by ordinal and each head's
// offset; after a barrier the heads and the exponent groups (7 bits each,
// at their channel's offset + 7 g) are deposited in parallel.  The CRCs:
// each thread runs the byte-wise CRC16 (a 256-entry shared table) over a
// contiguous chunk of each region, multiplies it by x^(8 x the bytes after
// the chunk) mod the polynomial (a per-config constant a thread, with
// crc_inv folded into CRC1's), and the CTA XOR-reduces them.  The frame
// leaves byte-swapped (__byte_perm), in 32-bit stores, or 16-bit ones
// where the frame size is not a multiple of 4 (44.1 kHz).
//
// Measured on an H100 at configs 3 and 4's calls (tools/
// torch_pack_variants.py, PERF.md): the CRCs take 4-6% of the kernel, so
// the plain version's position tables (a 32-byte L2 sector read for each
// frame byte) have little to win; sizing the CTAs for 1,536 threads an SM
// (P1_SM_THREADS) took 18-20% off ptxas's free choice; sized for 2,048 it
// spills.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCKS = 6;          // audio blocks a frame
constexpr int BINS = 256;
constexpr int MAX_BYTES = 3840;    // the largest frame: 640 kbit/s at 32 kHz
constexpr int MAX_WORDS = MAX_BYTES / 4 + 2;
constexpr int MAX_SLOTS = 96;      // side-info slots a block, header included
constexpr uint32_t POLY = 0x18005; // x^16 + x^15 + x^2 + 1

// the wrapper's table (ops/pack_device.py:kernel_table), int32:
// [8, 14) the live bins of each channel, [16, 22) the slots of each block,
// [24, 48) the exponent groups of each (channel, strategy 0..3), [48, 72)
// the exponent bytes a group walk reads (from byte 0), [72, 328) the CRC16
// byte table, [328, 584) and [584, 840) each thread's CRC1 and CRC2
// multipliers, [840, 840 + 6 * MAX_SLOTS) the slots
constexpr int TAB_GMAX = 4, TAB_NB = 8, TAB_NSLOTS = 16, TAB_NG = 24,
              TAB_SPAN = 48, TAB_CRC = 72, TAB_MULT1 = 328, TAB_MULT2 = 584,
              TAB_SLOTS = 840, TAB_SIZE = TAB_SLOTS + BLOCKS * MAX_SLOTS;

// a slot: value (bits 0-15), length (16-20), channel (21-23), kind (24-27)
enum Kind { K_CONST = 0, K_COND = 1, K_STRAT = 2, K_EXP0 = 3, K_GROUPS = 4,
            K_CSNR = 5, K_FSNR = 6 };

__host__ __device__ constexpr int threads_for(int nch)
{
    return nch <= 2 ? 128 : 256;
}

// the threads an SM is sized for: 1,536, so at most 40 registers a thread
// (left free, ptxas takes 64; at 2,048, 32 registers, it spills).  A build
// may set it (-DP1_SM_THREADS=n; 0 leaves the registers to ptxas), and
// -DP1_NO_CRC leaves both CRCs 0 (not a packer: it shows what they cost);
// tools/torch_pack_variants.py times such builds
#ifndef P1_SM_THREADS
#define P1_SM_THREADS 1536
#endif
#if P1_SM_THREADS > 0
#define P1_BOUNDS(NCH) \
    __launch_bounds__(threads_for(NCH), P1_SM_THREADS / threads_for(NCH))
#else
#define P1_BOUNDS(NCH)
#endif

// the ungrouped bits of class cls (ops/pack_device.py:_mant_tokens)
__device__ __forceinline__ int mant_len(int cls)
{
    if (cls == 3) return 3;
    if (cls == 14) return 14;
    if (cls == 15) return 16;
    return cls >= 5 ? cls - 1 : 0;
}

__device__ __forceinline__ uint32_t masked(uint32_t v, int len)
{
    return len >= 32 ? v : v & ((1u << len) - 1u);
}

// the bit offset of an element from the packed counts before it
__device__ __forceinline__ int offset_of(unsigned long long p)
{
    const int u = (int)(p & 0xFFFF), n1 = (int)((p >> 16) & 0xFFFF);
    const int n2 = (int)((p >> 32) & 0xFFFF), n4 = (int)(p >> 48);
    return u + 5 * ((n1 + 2) / 3) + 7 * ((n2 + 2) / 3) + 7 * ((n4 + 1) / 2);
}

// OR a token (v already masked to len <= 16 bits) into the frame's words,
// MSB first; bits from byte total - 2 on are the overshoot and dropped
__device__ __forceinline__ void deposit(uint32_t* words, int off, int len,
                                        uint32_t v, int limit)
{
    if (len <= 0 || off >= limit || v == 0)
        return;
    const int w = off >> 5, sh = 32 - (off & 31) - len;
    if (sh >= 0) {
        atomicOr(words + w, v << sh);
    } else {
        atomicOr(words + w, v >> -sh);
        atomicOr(words + w + 1, v << (32 + sh));
    }
}

// a(x) b(x) mod POLY (host/pack.py:mul_poly)
__device__ __forceinline__ uint32_t mul_poly(uint32_t a, uint32_t b)
{
    uint32_t c = 0;
#pragma unroll
    for (int k = 0; k < 16; k++) {
        if (a & 1u) c ^= b;
        a >>= 1;
        b <<= 1;
        if (b & 0x10000u) b ^= POLY;
    }
    return c;
}

__device__ __forceinline__ uint32_t byte_at(const uint32_t* words, int i)
{
    return (words[i >> 2] >> (24 - 8 * (i & 3))) & 0xFFu;
}

// this thread's chunk of bytes [a, e) through the CRC16, times its
// multiplier (x^(8 x the bytes after the chunk), per config and thread)
__device__ __forceinline__ uint32_t crc_part(const uint32_t* words,
                                             const uint16_t* tab, int a,
                                             int e, int tid, int nthreads,
                                             uint32_t mult)
{
    const int chunk = (e - a + nthreads - 1) / nthreads;
    const int s = a + tid * chunk;
    const int end = min(s + chunk, e);
    uint32_t crc = 0;
    for (int i = s; i < end; i++)
        crc = tab[(byte_at(words, i) ^ (crc >> 8)) & 0xFFu]
              ^ ((crc << 8) & 0xFFFFu);
    return mul_poly(crc, mult);
}

// the length of a slot in block b (0 for a reused channel's)
__device__ __forceinline__ int slot_len(int slot, const int* strat,
                                        const int* ng)
{
    const int kind = (slot >> 24) & 15, ch = (slot >> 21) & 7;
    const int len = (slot >> 16) & 31;
    const int s = strat[ch];
    switch (kind) {
    case K_COND:
    case K_EXP0:
        return s == 0 ? 0 : len;
    case K_GROUPS:
        return s == 0 ? 0 : 7 * ng[ch * 4 + (s == 1 ? 1 : s == 2 ? 2 : 3)];
    default:
        return len;
    }
}

template <int NCH>
__global__ void P1_BOUNDS(NCH)
pack_frames_kernel(const int8_t* __restrict__ bap,
                   const int32_t* __restrict__ qmant,
                   const uint8_t* __restrict__ exps,
                   const int32_t* __restrict__ strat,
                   const int32_t* __restrict__ csnr,
                   const int32_t* __restrict__ fsnr,
                   const int32_t* __restrict__ tab, int total, int fs58,
                   uint8_t* __restrict__ out)
{
    constexpr int T = threads_for(NCH);
    constexpr int NWARP = T / 32;
    constexpr int LMAX = NCH * BINS;
    __shared__ uint32_t words[MAX_WORDS];
    __shared__ __align__(16) int32_t s_q[NCH * BINS];
    __shared__ __align__(16) int8_t s_bap[NCH * BINS];
    __shared__ __align__(16) uint8_t s_exp[NCH * BINS];
    __shared__ uint8_t s_memb[3][LMAX];
    __shared__ int32_t s_head1[(LMAX + 2) / 3], s_head2[(LMAX + 2) / 3];
    __shared__ int32_t s_head4[(LMAX + 1) / 2];
    __shared__ uint16_t s_crc[256];
    __shared__ int32_t s_strat[BLOCKS * NCH];
    __shared__ int32_t s_nb[NCH], s_ng[NCH * 4], s_span[NCH * 4];
    __shared__ int32_t s_grpoff[NCH];
    __shared__ unsigned long long s_scan[NWARP];
    __shared__ uint32_t s_red[NWARP];
    __shared__ int s_pos;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long f = blockIdx.x;
    const int nwords = total / 4 + 2;
    const int limit = 8 * (total - 2);
    const int gmax = __ldg(tab + TAB_GMAX);
    for (int i = tid; i < nwords; i += T)
        words[i] = 0;
    for (int i = tid; i < 256; i += T)
        s_crc[i] = (uint16_t)__ldg(tab + TAB_CRC + i);
    for (int i = tid; i < BLOCKS * NCH; i += T)
        s_strat[i] = __ldg(strat + f * BLOCKS * NCH + i);
    for (int i = tid; i < NCH * 4; i += T) {
        s_ng[i] = __ldg(tab + TAB_NG + i);
        s_span[i] = __ldg(tab + TAB_SPAN + i);
    }
    if (tid < NCH)
        s_nb[tid] = __ldg(tab + TAB_NB + tid);
    if (tid == 0)
        s_pos = 0;
    const uint32_t cs = (uint32_t)__ldg(csnr + f) & 63u;
    const uint32_t fs = (uint32_t)__ldg(fsnr + f) & 15u;
    int L = 0;
#pragma unroll
    for (int c = 0; c < NCH; c++)
        L += __ldg(tab + TAB_NB + c);

    for (int b = 0; b < BLOCKS; b++) {
        // the last block's heads and groups have read the stage
        __syncthreads();
        const long long row = (f * BLOCKS + b) * NCH;
        const int* strat_b = s_strat + b * NCH;
        {
            const int4* gq = reinterpret_cast<const int4*>(qmant + row * BINS);
            int4* sq = reinterpret_cast<int4*>(s_q);
            for (int i = tid; i < NCH * (BINS / 4); i += T)
                if ((i & (BINS / 4 - 1)) * 4 < s_nb[i / (BINS / 4)])
                    sq[i] = __ldg(gq + i);
            const int4* gb = reinterpret_cast<const int4*>(bap + row * BINS);
            const int4* ge = reinterpret_cast<const int4*>(exps + row * BINS);
            int4* sb = reinterpret_cast<int4*>(s_bap);
            int4* se = reinterpret_cast<int4*>(s_exp);
            for (int i = tid; i < NCH * (BINS / 16); i += T) {
                const int c = i / (BINS / 16), k = i & (BINS / 16 - 1);
                if (k * 16 < s_nb[c])
                    sb[i] = __ldg(gb + i);
                const int s = strat_b[c];
                if (s != 0 && k * 16 < s_span[c * 4 + (s == 1 ? 1
                                                       : s == 2 ? 2 : 3)])
                    se[i] = __ldg(ge + i);
            }
        }
        __syncthreads();

        // this thread's run of the block's elements: slots, then live bins
        const int ns = __ldg(tab + TAB_NSLOTS + b);
        const int* slots = tab + TAB_SLOTS + b * MAX_SLOTS;
        const int nel = ns + L;
        const int per = (nel + T - 1) / T;
        const int j0 = min(tid * per, nel), j1 = min(j0 + per, nel);
        int c0 = 0, bin0 = j0 > ns ? j0 - ns : 0;
        while (c0 < NCH && bin0 >= s_nb[c0]) {
            bin0 -= s_nb[c0];
            c0++;
        }
        unsigned long long mine = 0;
        {
            int c = c0, bin = bin0;
            for (int j = j0; j < j1; j++) {
                if (j < ns) {
                    mine += (unsigned)slot_len(__ldg(slots + j), strat_b,
                                               s_ng);
                    continue;
                }
                const int cls = s_bap[c * BINS + bin];
                if (cls == 1)
                    mine += 1ull << 16;
                else if (cls == 2)
                    mine += 1ull << 32;
                else if (cls == 4)
                    mine += 1ull << 48;
                else
                    mine += (unsigned)mant_len(cls);
                bin++;
                while (c < NCH && bin >= s_nb[c]) {
                    bin -= s_nb[c];
                    c++;
                }
            }
        }

        // CTA-wide exclusive scan of the packed counts
        unsigned long long x = mine;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const unsigned long long y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
        }
        if (lane == 31)
            s_scan[warp] = x;
        __syncthreads();
        if (warp == 0) {
            unsigned long long w = lane < NWARP ? s_scan[lane] : 0ull;
#pragma unroll
            for (int d = 1; d < NWARP; d <<= 1) {
                const unsigned long long y = __shfl_up_sync(0xffffffffu, w,
                                                            d);
                if (lane >= d) w += y;
            }
            if (lane < NWARP)
                s_scan[lane] = w;
        }
        __syncthreads();
        unsigned long long p = (warp ? s_scan[warp - 1] : 0ull) + x - mine;
        const unsigned long long tot = s_scan[NWARP - 1];
        const int pos = s_pos;

        // deposit the ungrouped tokens; members by ordinal, heads' offsets
        {
            int c = c0, bin = bin0;
            for (int j = j0; j < j1; j++) {
                const int off = pos + offset_of(p);
                if (j < ns) {
                    const int slot = __ldg(slots + j);
                    const int kind = (slot >> 24) & 15, ch = (slot >> 21) & 7;
                    const int len = slot_len(slot, strat_b, s_ng);
                    uint32_t v = (uint32_t)slot & 0xFFFFu;
                    if (kind == K_STRAT)
                        v = (uint32_t)strat_b[ch];
                    else if (kind == K_EXP0)
                        v = s_exp[ch * BINS];
                    else if (kind == K_CSNR)
                        v = cs;
                    else if (kind == K_FSNR)
                        v = fs;
                    if (kind == K_GROUPS) {
                        if (len)
                            s_grpoff[ch] = off;
                    } else {
                        deposit(words, off, len, masked(v, len), limit);
                    }
                    p += (unsigned)len;
                    continue;
                }
                const int cls = s_bap[c * BINS + bin];
                const uint32_t q = (uint32_t)s_q[c * BINS + bin];
                if (cls == 1) {
                    const int o = (int)((p >> 16) & 0xFFFF);
                    s_memb[0][o] = (uint8_t)(q & 15u);
                    if (o % 3 == 0) s_head1[o / 3] = off;
                    p += 1ull << 16;
                } else if (cls == 2) {
                    const int o = (int)((p >> 32) & 0xFFFF);
                    s_memb[1][o] = (uint8_t)(q & 15u);
                    if (o % 3 == 0) s_head2[o / 3] = off;
                    p += 1ull << 32;
                } else if (cls == 4) {
                    const int o = (int)(p >> 48);
                    s_memb[2][o] = (uint8_t)(q & 15u);
                    if ((o & 1) == 0) s_head4[o >> 1] = off;
                    p += 1ull << 48;
                } else {
                    const int len = mant_len(cls);
                    deposit(words, off, len, masked(q, len), limit);
                    p += (unsigned)len;
                }
                bin++;
                while (c < NCH && bin >= s_nb[c]) {
                    bin -= s_nb[c];
                    c++;
                }
            }
        }
        __syncthreads();

        // the grouped heads and the exponent groups
        const int n1 = (int)((tot >> 16) & 0xFFFF);
        const int n2 = (int)((tot >> 32) & 0xFFFF), n4 = (int)(tot >> 48);
        for (int h = tid; h < (n1 + 2) / 3; h += T) {
            const int o = 3 * h;
            const uint32_t v = 9u * s_memb[0][o]
                + 3u * (o + 1 < n1 ? s_memb[0][o + 1] : 0u)
                + (o + 2 < n1 ? s_memb[0][o + 2] : 0u);
            deposit(words, s_head1[h], 5, v & 31u, limit);
        }
        for (int h = tid; h < (n2 + 2) / 3; h += T) {
            const int o = 3 * h;
            const uint32_t v = 25u * s_memb[1][o]
                + 5u * (o + 1 < n2 ? s_memb[1][o + 1] : 0u)
                + (o + 2 < n2 ? s_memb[1][o + 2] : 0u);
            deposit(words, s_head2[h], 7, v & 127u, limit);
        }
        for (int h = tid; h < (n4 + 1) / 2; h += T) {
            const int o = 2 * h;
            const uint32_t v = 11u * s_memb[2][o]
                + (o + 1 < n4 ? s_memb[2][o + 1] : 0u);
            deposit(words, s_head4[h], 7, v & 127u, limit);
        }
        for (int i = tid; i < NCH * gmax; i += T) {
            const int ch = i / gmax, g = i - ch * gmax;
            const int s = strat_b[ch];
            if (s == 0)
                continue;
            const int sel = s == 1 ? 1 : s == 2 ? 2 : 3;
            if (g >= s_ng[ch * 4 + sel])
                continue;
            const int gs = sel == 3 ? 4 : sel;
            const uint8_t* e = s_exp + ch * BINS;
            const int p0 = 1 + 3 * gs * g;
            // bytes past 255 read as 0 (the plain version's padding)
            const int prev = g ? (p0 - gs < BINS ? e[p0 - gs] : 0) : e[0];
            const int e0 = p0 < BINS ? e[p0] : 0;
            const int e1 = p0 + gs < BINS ? e[p0 + gs] : 0;
            const int e2 = p0 + 2 * gs < BINS ? e[p0 + 2 * gs] : 0;
            const int v = ((e0 - prev + 2) * 5 + (e1 - e0 + 2)) * 5
                          + (e2 - e1 + 2);
            deposit(words, s_grpoff[ch] + 7 * g, 7, (uint32_t)v & 127u,
                    limit);
        }
        if (tid == 0)
            s_pos = pos + offset_of(tot);
    }
    __syncthreads();

    // CRC1 over [4, 2 fs58) (crc_inv in its multipliers), CRC2 over
    // [2 fs58, total - 2)
#ifndef P1_NO_CRC
    const uint32_t c1 = crc_part(words, s_crc, 4, 2 * fs58, tid, T,
                                 (uint32_t)__ldg(tab + TAB_MULT1 + tid));
    const uint32_t c2 = crc_part(words, s_crc, 2 * fs58, total - 2, tid, T,
                                 (uint32_t)__ldg(tab + TAB_MULT2 + tid));
#else
    const uint32_t c1 = 0, c2 = 0;
#endif
    uint32_t r = c1 | (c2 << 16);
#pragma unroll
    for (int d = 16; d; d >>= 1)
        r ^= __shfl_xor_sync(0xffffffffu, r, d);
    if (lane == 0)
        s_red[warp] = r;
    __syncthreads();
    if (tid == 0) {
        uint32_t a = 0;
#pragma unroll
        for (int w = 0; w < NWARP; w++)
            a ^= s_red[w];
        words[0] = (words[0] & 0xFFFF0000u) | (a & 0xFFFFu);
        const int i = total - 2, sh = 16 - 8 * (i & 3);
        words[i >> 2] = (words[i >> 2] & ~(0xFFFFu << sh)) | ((a >> 16) << sh);
    }
    __syncthreads();

    uint8_t* dst = out + f * total;
    if ((total & 3) == 0) {
        uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
        for (int i = tid; i < total / 4; i += T)
            d32[i] = __byte_perm(words[i], 0, 0x0123);
    } else {
        uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
        for (int i = tid; i < total / 2; i += T) {
            const uint32_t w = __byte_perm(words[i >> 1], 0, 0x0123);
            d16[i] = (uint16_t)((i & 1) ? w >> 16 : w & 0xFFFFu);
        }
    }
}

template <int NCH>
cudaError_t launch(const void* bap, const void* qmant, const void* exps,
                   const void* strat, const void* csnr, const void* fsnr,
                   const void* tab, int total, int fs58, void* out,
                   long long N, cudaStream_t s)
{
    pack_frames_kernel<NCH><<<(unsigned)N, threads_for(NCH), 0, s>>>(
        (const int8_t*)bap, (const int32_t*)qmant, (const uint8_t*)exps,
        (const int32_t*)strat, (const int32_t*)csnr, (const int32_t*)fsnr,
        (const int32_t*)tab, total, fs58, (uint8_t*)out);
    return cudaGetLastError();
}

}  // namespace

extern "C" int pack_frames_launch(const void* bap, const void* qmant,
                                  const void* exps, const void* strat,
                                  const void* csnr, const void* fsnr,
                                  const void* tab, int total, int fs58,
                                  void* out, long long N, int nch,
                                  void* stream)
{
    if (N == 0)
        return 0;
    if (N < 0 || N > 0x7fffffffLL || total < 8 || total > MAX_BYTES
        || (total & 1) || fs58 < 2 || 2 * fs58 > total - 2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (nch) {
    case 1: return (int)launch<1>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, s);
    case 2: return (int)launch<2>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, s);
    case 3: return (int)launch<3>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, s);
    case 4: return (int)launch<4>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, s);
    case 5: return (int)launch<5>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, s);
    case 6: return (int)launch<6>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int pack_frames_threads(int nch)
{
    return threads_for(nch);
}

// the table's layout as the kernel reads it: the first index of each
// section (TAB_GMAX .. TAB_SLOTS), TAB_SIZE and MAX_SLOTS -> their count
extern "C" int pack_frames_layout(int* out)
{
    const int v[] = {TAB_GMAX, TAB_NB, TAB_NSLOTS, TAB_NG, TAB_SPAN, TAB_CRC,
                     TAB_MULT1, TAB_MULT2, TAB_SLOTS, TAB_SIZE, MAX_SLOTS};
    const int n = (int)(sizeof v / sizeof v[0]);
    for (int i = 0; i < n; i++)
        out[i] = v[i];
    return n;
}

extern "C" const char* pack_frames_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
