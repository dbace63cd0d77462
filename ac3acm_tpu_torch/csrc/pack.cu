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
// The codes come as int32 (JAX's dtype: pack_frames_device(cfg)'s calling
// form) or as int16, their low 16 bits (Q1's 16-bit form, which the
// device-pack path hands over): a template parameter.  A token is at most
// 16 bits, so both give the same bytes; an int16 code is widened as
// unsigned (class-15 codes from 32,768 up are negative as int16).
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
// What the design does about it.  A frame is a chain of short dependent
// steps (a block's offsets wait for the block before), so the card is
// kept busy by many frames at once, each on one warp, with nothing but
// __syncwarp on a frame's path: 8 warps a CTA up to two channels, 16
// above, the CTAs resident on every SM walking the frames (frame warp,
// warp + all warps, ...).  A warp's slice of shared memory holds the
// frame's words (at most 3,848 bytes, from first bit to CRC), two stages
// of a block's classes and exponents, each chunk step's counts, the
// block's grouped members compact by ordinal (a byte each) and its heads'
// offsets compact by head ordinal (16 bits each): 13,128 B at 5.1 and
// 2,560 bytes, 4,312 B at 2.0 and 768.  The launch bounds ask three CTAs
// an SM of 8 warps and one of 16 (min_ctas_for): ptxas takes 80 registers
// up to two channels and 91-96 above, no spill, in both code widths, so an
// SM holds 24 frames at 2.0 (three CTAs, by registers) and 16 at 5.1 (one
// CTA, by shared memory); the first design, a CTA a frame, held 12 and 6
// (pack_frames_resident reports it).  The CTA's slot
// schedule and CRC tables are read once, into shared memory, before the
// frames.  Per block:
//  * the next block's classes and its coded channels' exponents (16
//    bytes a lane a chunk, cp.async into the other stage) are issued
//    first and land while this block packs; the next frame's strategies
//    and offsets are loaded at the frame's start; the codes of this
//    block's coded bins are prefetched into L1;
//  * slots: lane l takes slot j0 + l of the CTA's table, 32 at a time (at
//    most MAX_SLOTS = 96), its length from the block's strategies, its
//    offset from a warp scan; a slot is at most 16 bits: its token is
//    or-ed in;
//  * bins: lane l takes the chunk of 16 bins 16 (l % 16) of channel
//    2 t + l / 16 in step t (NCH / 2 steps, rounded up): its classes are
//    4 words, dead bins (>= nb) masked off, and byte-SIMD compares
//    (__vcmpeq4, __vcmpges4, __vsadu4, __popc) give its ungrouped bits and
//    its members of classes 1, 2 and 4 without a branch, so a chunk of
//    class 0 costs a dozen instructions; the packed counts (16-bit fields:
//    ungrouped bits, n1, n2, n4) go through one warp scan a step;
//  * deposit: each lane owns the contiguous bits of its chunk; it loads
//    the codes of its coded bins (int32: one 16-byte load a word of
//    classes that has one; int16: one a pair of such words),
//    keeps the offset as a running sum (a grouped member adds its head's
//    5 or 7 bits when its ordinal starts a group), assembles its ungrouped
//    tokens in a register word and stores every word that lies inside its
//    bits whole; only the words it shares with a neighbour's bits take an
//    atomicOr.  Where a lane codes more than 4 of its 16 bins the warp
//    takes bin r of every chunk at once (16 rounds, a round no lane codes
//    skipped by a vote); else each lane walks its coded bins (__ffs).
//    Members land by ordinal, heads' offsets by head ordinal; after a
//    __syncwarp the heads and the exponent groups (7 bits each, at their
//    channel's offset + 7 g, read from the stage, a lane a group) are
//    or-ed in.
// The CRCs: each lane runs the CRC16 over its 32nd of each region, a whole
// word a step where it can (four 256-entry tables in shared memory: a
// byte followed by 0 to 3 zero bytes), multiplies it by x^(8 x the bytes
// after its chunk) mod the polynomial (kernel_table's TAB_MULT1 and
// TAB_MULT2, a constant a lane, crc_inv folded into CRC1's; the product
// a nibble at a time from a CTA table of its 16 multiples, reduced
// through the byte tables), and the warp XOR-reduces them with
// __shfl_xor_sync.  The frame leaves byte-swapped (__byte_perm), in
// 32-bit stores, or 16-bit ones where the frame size is not a multiple of
// 4 (44.1 kHz).
//
// Measured on an H100 (PERF.md; tools/torch_pack_variants.py times the
// P1_WARPS and P1_NO_CRC builds and the first design beside the committed
// build).  The first design, one CTA of 128 / 256 threads a
// frame with five CTA barriers a block and an atomicOr a token, ran at
// 3.6% / 3.9% of the byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int BLOCKS = 6;          // audio blocks a frame
constexpr int BINS = 256;
constexpr int MAX_BYTES = 3840;    // the largest frame: 640 kbit/s at 32 kHz
constexpr int MAX_SLOTS = 96;      // side-info slots a block, header included
constexpr int LANES = 32;          // a frame's threads: one warp
constexpr int CHUNK = 16;          // bins a lane takes at once (one int4)

// the wrapper's table (ops/pack_device.py:kernel_table), int32:
// [8, 14) the live bins of each channel, [16, 22) the slots of each block,
// [24, 48) the exponent groups of each (channel, strategy 0..3), [48, 72)
// the exponent bytes a group walk reads (from byte 0), [72, 328) the CRC16
// byte table, [328, 360) and [360, 392) each lane's CRC1 and CRC2
// multipliers, [392, 392 + 6 * MAX_SLOTS) the slots
constexpr int TAB_GMAX = 4, TAB_NB = 8, TAB_NSLOTS = 16, TAB_NG = 24,
              TAB_SPAN = 48, TAB_CRC = 72, TAB_MULT1 = 328, TAB_MULT2 = 360,
              TAB_SLOTS = 392, TAB_SIZE = TAB_SLOTS + BLOCKS * MAX_SLOTS;

// the CTA's shared tables (bytes): the slots, the CRC16 tables (a byte,
// and a byte followed by 1, 2 and 3 zero bytes: four bytes a step), the group
// counts and spans, the live bins, the slot counts, and each lane's CRC
// multipliers times each nibble (carry-less, a row of 17 a lane); the warps'
// slices follow
constexpr int SH_SLOTS = 0, SH_CRC = SH_SLOTS + 4 * BLOCKS * MAX_SLOTS,
              SH_NG = SH_CRC + 2 * 4 * 256, SH_SPAN = SH_NG + 4 * 24,
              SH_NB = SH_SPAN + 4 * 24, SH_NSLOTS = SH_NB + 4 * 8,
              SH_MULN = SH_NSLOTS + 4 * 8,
              CTA_BYTES = SH_MULN + 4 * 2 * LANES * 17;

// a slot: value (bits 0-15), length (16-20), channel (21-23), kind (24-27)
enum Kind { K_CONST = 0, K_COND = 1, K_STRAT = 2, K_EXP0 = 3, K_GROUPS = 4,
            K_CSNR = 5, K_FSNR = 6 };

// the warps a CTA (one frame each at a time): 8 up to two channels, 16
// above (a 5.1 frame's slice is 13 KB: 16 warps in one CTA of 219 KB ran
// faster than two CTAs of 8), fewer where the frames' slices would pass
// the 227 KB a CTA may hold (cta_warps); ptxas picks the registers.
// -DP1_WARPS=n sets the warps for every channel count, -DP1_NO_CRC leaves
// both CRCs 0 (not a packer: it shows what they cost);
// tools/torch_pack_variants.py times such builds
#ifndef P1_WARPS
#define P1_WARPS 0
#endif
constexpr int MAX_WARPS = 16;
constexpr int MAX_SMEM = 232448;   // a CTA's shared memory on sm_90

__host__ __device__ constexpr int warps_for(int nch)
{
    return P1_WARPS > 0 ? P1_WARPS : nch <= 2 ? 8 : MAX_WARPS;
}

__host__ __device__ constexpr int threads_for(int nch)
{
    return nch > 0 ? warps_for(nch) * LANES : 0;
}


// a warp's slice of shared memory for NCH channels and frames of `total`
// bytes: the frame's words; two stages of a block's classes and exponents;
// each chunk step's packed counts before each lane's chunk (8 bytes) and
// the end of its bits (4 bytes); the members; the heads; the frame's
// strategies and the group offsets
__host__ __device__ constexpr int words_padded(int total)
{
    return (total / 4 + 2 + 3) & ~3;
}

__host__ __device__ constexpr int steps_for(int nch)
{
    return (nch + 1) / 2;
}

__host__ __device__ constexpr int warp_bytes(int nch, int total)
{
    return (4 * words_padded(total) + 4 * nch * BINS
            + 12 * LANES * steps_for(nch) + nch * BINS
            + 2 * (nch * BINS / 2 + 8) + 4 * 7 * nch + 15) & ~15;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src)
{
    const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev()
{
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a line of device memory on its way into L1 (a code the block reads later)
__device__ __forceinline__ void prefetch_l1(const void* p)
{
    asm volatile("prefetch.global.L1 [%0];\n" :: "l"(p));
}

__device__ __forceinline__ void cp_async_wait_all()
{
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

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

// a lane's own bits [S, E) of the frame, assembled a word at a time: a
// word inside them is stored whole, one shared with a neighbour's bits
// (the run's first or last) is or-ed in
struct Run {
    int S, E, wi;
    uint32_t acc;

    __device__ __forceinline__ Run(int s, int e) : S(s), E(e), wi(-1), acc(0u)
    {
    }

    __device__ __forceinline__ void flush(uint32_t* words)
    {
        if (acc) {
            if (wi * 32 >= S && wi * 32 + 32 <= E)
                words[wi] = acc;
            else
                atomicOr(words + wi, acc);
        }
        acc = 0u;
    }

    // a token of len (1..16) bits, v masked, at off < the limit
    __device__ __forceinline__ void put(uint32_t* words, int off, int len,
                                        uint32_t v)
    {
        if (v == 0u)
            return;
        const int w = off >> 5, sh = 32 - (off & 31) - len;
        if (w != wi) {
            flush(words);
            wi = w;
        }
        if (sh >= 0) {
            acc |= v << sh;
        } else {
            acc |= v >> -sh;
            flush(words);
            wi = w + 1;
            acc = v << (32 + sh);
        }
    }
};

// crc(x) m(x) mod x^16 + x^15 + x^2 + 1 (host/pack.py:mul_poly) from nib,
// the products of m with the 16 nibbles: the 31-bit product a nibble of crc
// at a time, then its top 15 bits through the byte tables (v x^16 and
// v x^24 mod the polynomial)
__device__ __forceinline__ uint32_t mul_poly(uint32_t crc, const uint32_t* nib,
                                             const uint16_t* tab)
{
    const uint32_t p = nib[crc & 15u] ^ (nib[(crc >> 4) & 15u] << 4)
                       ^ (nib[(crc >> 8) & 15u] << 8)
                       ^ (nib[(crc >> 12) & 15u] << 12);
    return (p & 0xFFFFu) ^ tab[(p >> 16) & 0xFFu] ^ tab[256 + (p >> 24)];
}

__device__ __forceinline__ uint32_t crc_byte(const uint16_t* tab,
                                             const uint32_t* words,
                                             uint32_t crc, int i)
{
    const uint32_t byte = (words[i >> 2] >> (24 - 8 * (i & 3))) & 0xFFu;
    return tab[(byte ^ (crc >> 8)) & 0xFFu] ^ ((crc << 8) & 0xFFFFu);
}

// this lane's 32nd of bytes [a, e) through the CRC16, times its
// multiplier (x^(8 x the bytes after the chunk), per config and lane); the
// whole words a step: (crc << 16) ^ word times x^16 is the xor of the
// four tables' entries of its bytes
__device__ __forceinline__ uint32_t crc_part(const uint32_t* words,
                                             const uint16_t* tab, int a,
                                             int e, int lane,
                                             const uint32_t* nib)
{
    const int chunk = (e - a + LANES - 1) / LANES;
    const int s = a + lane * chunk;
    const int end = min(s + chunk, e);
    uint32_t crc = 0;
    int i = s;
    for (; i < end && (i & 3); i++)
        crc = crc_byte(tab, words, crc, i);
    for (; i + 4 <= end; i += 4) {
        const uint32_t d = (crc << 16) ^ words[i >> 2];
        crc = tab[768 + (d >> 24)] ^ tab[512 + ((d >> 16) & 0xFFu)]
              ^ tab[256 + ((d >> 8) & 0xFFu)] ^ tab[d & 0xFFu];
    }
    for (; i < end; i++)
        crc = crc_byte(tab, words, crc, i);
    return mul_poly(crc, nib, tab);
}

// a 4-bit mask of the bytes of x above 0 (bit i: byte i)
__device__ __forceinline__ uint32_t positive_bytes(uint32_t x)
{
    const uint32_t t = (__vcmpgts4(x, 0u) >> 7) & 0x01010101u;
    return (t * 0x01020408u) >> 24;
}

// a chunk's classes (4 words, dead bins 0) -> its packed counts: the
// ungrouped bits (bits 0-15) and the members of classes 1, 2 and 4
__device__ __forceinline__ unsigned long long chunk_counts(const uint32_t* w)
{
    uint32_t u = 0, n1 = 0, n2 = 0, n4 = 0;
#pragma unroll
    for (int k = 0; k < 4; k++) {
        const uint32_t x = w[k];
        // class - 1 from 5 up (signed: a negative byte has no bits), 3 -> 3,
        // 14 -> 14, 15 -> 16
        uint32_t l = __vsub4(x, 0x01010101u) & __vcmpges4(x, 0x05050505u);
        l |= __vcmpeq4(x, 0x03030303u) & 0x03030303u;
        l += __vcmpeq4(x, 0x0E0E0E0Eu) & 0x01010101u;
        l += __vcmpeq4(x, 0x0F0F0F0Fu) & 0x02020202u;
        u += __vsadu4(l, 0u);
        n1 += __popc(__vcmpeq4(x, 0x01010101u) & 0x01010101u);
        n2 += __popc(__vcmpeq4(x, 0x02020202u) & 0x01010101u);
        n4 += __popc(__vcmpeq4(x, 0x04040404u) & 0x01010101u);
    }
    return (unsigned long long)u | ((unsigned long long)n1 << 16)
           | ((unsigned long long)n2 << 32) | ((unsigned long long)n4 << 48);
}

template <int I>
struct Int {
    static constexpr int value = I;
};

// f(Int<0>()) ... f(Int<N - 1>()): a loop whose index is a constant in
// each body, so the arrays it indexes stay in registers
template <int N, int I = 0, typename F>
__device__ __forceinline__ void unrolled(F&& f)
{
    if constexpr (I < N) {
        f(Int<I>());
        unrolled<N, I + 1>(f);
    }
}

template <typename T>
__device__ __forceinline__ T warp_scan(T x, int lane)
{
#pragma unroll
    for (int d = 1; d < LANES; d <<= 1) {
        const T y = __shfl_up_sync(0xffffffffu, x, d);
        if (lane >= d) x += y;
    }
    return x;
}

__device__ __forceinline__ int sel_of(int s)
{
    return s == 1 ? 1 : s == 2 ? 2 : 3;
}

// the dead bins of a lane's chunk masked off: word k keeps live - 4 k bytes
__device__ __forceinline__ uint32_t live_mask(int live, int k)
{
    const int n = live - 4 * k;
    return n >= 4 ? 0xFFFFFFFFu : n <= 0 ? 0u : (1u << (8 * n)) - 1u;
}

// a lane's 16 codes of a chunk in registers: four int4s of int32 codes,
// or two of int16 codes; an int4 that holds no coded bin is not loaded
template <typename Code>
struct ChunkCodes {
    static constexpr int N = CHUNK * (int)sizeof(Code) / 16;
    int4 q[N];

    // the chunk's codes at row (its first bin), w its 4 words of classes
    __device__ __forceinline__ void load(const Code* row, const uint32_t* w)
    {
        const int4* p = reinterpret_cast<const int4*>(row);
        unrolled<N>([&](auto jj) {
            constexpr int j = decltype(jj)::value;
            uint32_t coded;
            if constexpr (N == 4)
                coded = positive_bytes(w[j]);
            else
                coded = positive_bytes(w[2 * j]) | positive_bytes(w[2 * j + 1]);
            q[j] = coded ? __ldg(p + j) : make_int4(0, 0, 0, 0);
        });
    }

    // the code of bin 4 K + i (K a constant, i in 0..3), as unsigned
    template <int K>
    __device__ __forceinline__ uint32_t at(int i) const
    {
        if constexpr (N == 4) {
            const int4& v = q[K];
            return (uint32_t)((i & 2) ? ((i & 1) ? v.w : v.z)
                                      : ((i & 1) ? v.y : v.x));
        } else {
            const int4& v = q[K >> 1];
            const uint32_t word = (uint32_t)((i & 2) ? ((K & 1) ? v.w : v.y)
                                                     : ((K & 1) ? v.z : v.x));
            return (i & 1) ? word >> 16 : word & 0xFFFFu;
        }
    }
};

// the CTAs an SM the launch bounds ask of ptxas: three of 8 warps (24
// frames, the int32-code instances' residency by their own choice of 80
// registers), one of 16.  Without a minimum ptxas spilled 28-112 bytes in
// five int16-code instances to reach 64 registers
__host__ __device__ constexpr int min_ctas_for(int nch)
{
    return warps_for(nch) <= 8 ? 3 : 1;
}

template <int NCH, typename Code>
__global__ void __launch_bounds__(threads_for(NCH), min_ctas_for(NCH))
pack_frames_kernel(const int8_t* __restrict__ bap,
                   const Code* __restrict__ qmant,
                   const uint8_t* __restrict__ exps,
                   const int32_t* __restrict__ strat,
                   const int32_t* __restrict__ csnr,
                   const int32_t* __restrict__ fsnr,
                   const int32_t* __restrict__ tab, int total, int fs58,
                   long long N, uint8_t* __restrict__ out)
{
    constexpr int NIT = steps_for(NCH);   // chunk steps a block
    constexpr int ROW = NCH * BINS;       // a block's classes or exponents
    constexpr int NST = BLOCKS * NCH;     // a frame's strategies
    extern __shared__ __align__(16) unsigned char smem[];
    int* s_slots = reinterpret_cast<int*>(smem + SH_SLOTS);
    uint16_t* s_crc = reinterpret_cast<uint16_t*>(smem + SH_CRC);
    int* s_ng = reinterpret_cast<int*>(smem + SH_NG);
    int* s_span = reinterpret_cast<int*>(smem + SH_SPAN);
    int* s_nb = reinterpret_cast<int*>(smem + SH_NB);
    int* s_nslots = reinterpret_cast<int*>(smem + SH_NSLOTS);
    uint32_t* s_muln = reinterpret_cast<uint32_t*>(smem + SH_MULN);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nthreads = blockDim.x, warps = nthreads >> 5;
    for (int i = tid; i < BLOCKS * MAX_SLOTS; i += nthreads)
        s_slots[i] = __ldg(tab + TAB_SLOTS + i);
    for (int i = tid; i < 256; i += nthreads) {
        uint32_t c = (uint32_t)__ldg(tab + TAB_CRC + i);
        s_crc[i] = (uint16_t)c;
        for (int k = 1; k < 4; k++) {
            // c x^8: the byte followed by one more zero byte
            c = (uint32_t)__ldg(tab + TAB_CRC + (c >> 8)) ^ ((c << 8) & 0xFFFFu);
            s_crc[256 * k + i] = (uint16_t)c;
        }
    }
    if (tid < 24) {
        s_ng[tid] = __ldg(tab + TAB_NG + tid);
        s_span[tid] = __ldg(tab + TAB_SPAN + tid);
    }
    if (tid < 8) {
        s_nb[tid] = tid < NCH ? __ldg(tab + TAB_NB + tid) : 0;
        s_nslots[tid] = tid < BLOCKS ? __ldg(tab + TAB_NSLOTS + tid) : 0;
    }
    for (int i = tid; i < 2 * LANES * 16; i += nthreads) {
        const int l = (i >> 4) & (LANES - 1), n = i & 15;
        const uint32_t m = (uint32_t)__ldg(
            tab + (i < LANES * 16 ? TAB_MULT1 : TAB_MULT2) + l);
        uint32_t v = 0;
        for (int k = 0; k < 4; k++)
            v ^= ((n >> k) & 1) ? m << k : 0u;
        s_muln[(i >> 4) * 17 + n] = v;
    }
    // the CTA's one barrier, before any frame
    __syncthreads();

    unsigned char* base = smem + CTA_BYTES + warp * warp_bytes(NCH, total);
    uint32_t* words = reinterpret_cast<uint32_t*>(base);
    // stage buf: the block's classes [ROW], then its exponents [ROW]
    uint8_t* stage = base + 4 * words_padded(total);           // [2][2][ROW]
    unsigned long long* s_pex = reinterpret_cast<unsigned long long*>(
        stage + 4 * ROW);                                      // [NIT][32]
    uint8_t* memb = reinterpret_cast<uint8_t*>(s_pex + NIT * LANES);
    uint16_t* head = reinterpret_cast<uint16_t*>(memb + ROW);  // [ROW/2+8]
    int* s_pend = reinterpret_cast<int*>(head + ROW / 2 + 8);  // [NIT][32]
    int* s_st = s_pend + NIT * LANES;                          // [NST]
    int* s_goff = s_st + NST;                                  // [NCH]

    const int nwords = total / 4 + 2;
    const int limit = 8 * (total - 2);
    // this lane's chunk in step t: channel 2 t + lane / 16, bins
    // 16 (lane % 16) + [0, 16)
    const int k16 = (lane & 15) * CHUNK;
    auto chunk_channel = [&](int t) { return 2 * t + (lane >> 4); };
    auto live_bins = [&](int c) {
        return c < NCH ? max(0, min(CHUNK, s_nb[c] - k16)) : 0;
    };

    const long long wstride = (long long)gridDim.x * warps;
    long long f = (long long)blockIdx.x * warps + warp;
    // lane l holds strategies l and l + 32 of its frame (then the next)
    int st0 = 0, st1 = 0, cs = 0, fs = 0;
    if (f < N) {
        if (lane < NST) st0 = __ldg(strat + f * NST + lane);
        if (lane + LANES < NST) st1 = __ldg(strat + f * NST + lane + LANES);
        cs = __ldg(csnr + f);
        fs = __ldg(fsnr + f);
    }

    // block b of frame g on its way into stage b & 1 (cp.async): its
    // classes, and its coded channels' exponents; s_of(c) gives its
    // strategies
    auto issue = [&](long long g, int b, auto s_of) {
        uint8_t* st_g = stage + (b & 1) * 2 * ROW;
#pragma unroll
        for (int t = 0; t < NIT; t++) {
            const int c = chunk_channel(t);
            const int s = s_of(c < NCH ? c : 0);
            if (g < N && c < NCH) {
                const long long row = (g * BLOCKS + b) * NCH + c;
                if (live_bins(c) > 0)
                    cp_async16(st_g + c * BINS + k16, bap + row * BINS + k16);
                // a D45 walk reads past the live bins (its span)
                if (s != 0 && k16 < s_span[c * 4 + sel_of(s)])
                    cp_async16(st_g + ROW + c * BINS + k16,
                               exps + row * BINS + k16);
            }
        }
        cp_async_commit();
    };
    issue(f, 0, [&](int c) { return __shfl_sync(0xffffffffu, st0, c); });

    for (; f < N; f += wstride) {
        const long long g = f + wstride;     // this warp's next frame
        // the last frame's bytes have left the words
        __syncwarp();
        if (lane < NST) s_st[lane] = st0;
        if (lane + LANES < NST) s_st[lane + LANES] = st1;
        const uint32_t fcs = (uint32_t)cs & 63u, ffs = (uint32_t)fs & 15u;
        if (g < N) {
            if (lane < NST) st0 = __ldg(strat + g * NST + lane);
            if (lane + LANES < NST)
                st1 = __ldg(strat + g * NST + lane + LANES);
            cs = __ldg(csnr + g);
            fs = __ldg(fsnr + g);
        }
        for (int i = lane; i < nwords; i += LANES)
            words[i] = 0u;
        int pos = 0;

        for (int b = 0; b < BLOCKS; b++) {
            // the last block's heads and groups have read its stage and
            // the members; s_st and the zeroed words are seen
            __syncwarp();
            if (b + 1 < BLOCKS)
                issue(f, b + 1, [&](int c) { return s_st[(b + 1) * NCH + c]; });
            else
                issue(g, 0, [&](int c) {
                    return __shfl_sync(0xffffffffu, st0, c);
                });
            cp_async_wait_prev();
            __syncwarp();
            const uint8_t* cl = stage + (b & 1) * 2 * ROW;   // classes
            const uint8_t* ex = cl + ROW;                    // exponents
            const int* st_b = s_st + b * NCH;
            const long long row0 = (f * BLOCKS + b) * NCH;

            // the codes of the block's coded bins, on their way into L1
            // while the slots and counts run
#pragma unroll
            for (int t = 0; t < NIT; t++) {
                const int c = chunk_channel(t);
                const int4 c4 = reinterpret_cast<const int4*>(cl)[
                    t * LANES + lane];
                const int live = live_bins(c);
                const int4* qrow = reinterpret_cast<const int4*>(
                    qmant + (row0 + (c < NCH ? c : 0)) * BINS + k16);
                const uint32_t p0 = positive_bytes((uint32_t)c4.x
                                                   & live_mask(live, 0));
                const uint32_t p1 = positive_bytes((uint32_t)c4.y
                                                   & live_mask(live, 1));
                const uint32_t p2 = positive_bytes((uint32_t)c4.z
                                                   & live_mask(live, 2));
                const uint32_t p3 = positive_bytes((uint32_t)c4.w
                                                   & live_mask(live, 3));
                if constexpr (sizeof(Code) == 4) {
                    if (p0) prefetch_l1(qrow);
                    if (p1) prefetch_l1(qrow + 1);
                    if (p2) prefetch_l1(qrow + 2);
                    if (p3) prefetch_l1(qrow + 3);
                } else if (p0 | p1 | p2 | p3) {
                    prefetch_l1(qrow);      // 32 bytes: one line
                }
            }

            // slots: a lane one, 32 at a time; lengths from the block's
            // strategies
            const int ns = s_nslots[b];
            const int* slots = s_slots + b * MAX_SLOTS;
            int su = 0;
            for (int j0 = 0; j0 < ns; j0 += LANES) {
                const int j = j0 + lane;
                const int slot = j < ns ? slots[j] : 0;
                const int kind = (slot >> 24) & 15, ch = (slot >> 21) & 7;
                const int s = st_b[ch < NCH ? ch : 0];
                int len = (slot >> 16) & 31;
                uint32_t v = (uint32_t)slot & 0xFFFFu;
                if (kind == K_COND || kind == K_EXP0)
                    len = s == 0 ? 0 : len;
                else if (kind == K_GROUPS)
                    len = s == 0 ? 0 : 7 * s_ng[ch * 4 + sel_of(s)];
                if (kind == K_STRAT)
                    v = (uint32_t)s;
                else if (kind == K_EXP0)
                    v = ex[ch * BINS];
                else if (kind == K_CSNR)
                    v = fcs;
                else if (kind == K_FSNR)
                    v = ffs;
                const int x = warp_scan(len, lane);
                const int off = pos + su + x - len;
                if (kind == K_GROUPS && len)
                    s_goff[ch] = off;
                else
                    deposit(words, off, len, masked(v, len), limit);
                su += __shfl_sync(0xffffffffu, x, LANES - 1);
            }

            // bins: each step's counts, one warp scan a step
            unsigned long long carry = (unsigned long long)su;
#pragma unroll 1
            for (int t = 0; t < NIT; t++) {
                const int live = live_bins(chunk_channel(t));
                const int4 c4 = reinterpret_cast<const int4*>(cl)[
                    t * LANES + lane];
                const uint32_t w[4] = {
                    (uint32_t)c4.x & live_mask(live, 0),
                    (uint32_t)c4.y & live_mask(live, 1),
                    (uint32_t)c4.z & live_mask(live, 2),
                    (uint32_t)c4.w & live_mask(live, 3)};
                const unsigned long long mine = chunk_counts(w);
                const unsigned long long x = warp_scan(mine, lane);
                s_pex[t * LANES + lane] = carry + x - mine;
                s_pend[t * LANES + lane] = pos + offset_of(carry + x);
                carry += __shfl_sync(0xffffffffu, x, LANES - 1);
            }
            const int n1 = (int)((carry >> 16) & 0xFFFF);
            const int n2 = (int)((carry >> 32) & 0xFFFF);
            const int n4 = (int)(carry >> 48);
            const int h1 = (n1 + 2) / 3, h2 = (n2 + 2) / 3;
            const int h4 = (n4 + 1) / 2;

            // deposit: bin r of every lane's chunk at once (a bin that no
            // lane codes costs a vote); each lane's own bits as whole words
#pragma unroll 1
            for (int t = 0; t < NIT; t++) {
                const int c = chunk_channel(t);
                const int live = live_bins(c);
                const int4 c4 = reinterpret_cast<const int4*>(cl)[
                    t * LANES + lane];
                const uint32_t w[4] = {
                    (uint32_t)c4.x & live_mask(live, 0),
                    (uint32_t)c4.y & live_mask(live, 1),
                    (uint32_t)c4.z & live_mask(live, 2),
                    (uint32_t)c4.w & live_mask(live, 3)};
                if (!__any_sync(0xffffffffu, w[0] | w[1] | w[2] | w[3]))
                    continue;
                const unsigned long long p = s_pex[t * LANES + lane];
                int off = pos + offset_of(p);
                Run run(off, s_pend[t * LANES + lane]);
                int o1 = (int)((p >> 16) & 0xFFFF);
                int o2 = (int)((p >> 32) & 0xFFFF), o4 = (int)(p >> 48);
                ChunkCodes<Code> q;
                q.load(qmant + (row0 + (c < NCH ? c : 0)) * BINS + k16, w);
                // one coded bin: a member by its ordinal (a head takes its
                // group's bits), or an ungrouped token into the lane's run
                auto bin = [&](int cls, uint32_t qv) {
                    const bool g1 = cls == 1, g2 = cls == 2, g4 = cls == 4;
                    if (g1 || g2 || g4) {
                        const int o = g1 ? o1 : g2 ? o2 : o4;
                        memb[(g1 ? 0 : g2 ? n1 : n1 + n2) + o] =
                            (uint8_t)(qv & 15u);
                        const int hq = g4 ? o >> 1 : o / 3;
                        if (o == (g4 ? 2 : 3) * hq) {
                            head[(g1 ? 0 : g2 ? h1 : h1 + h2) + hq] =
                                off < limit ? (uint16_t)off : (uint16_t)0xFFFF;
                            off += g1 ? 5 : 7;
                        }
                        o1 += g1;
                        o2 += g2;
                        o4 += g4;
                    } else {
                        const int len = mant_len(cls);
                        if (off < limit)
                            run.put(words, off, len, masked(qv, len));
                        off += len;
                    }
                };
                const int most = __reduce_max_sync(
                    0xffffffffu, (unsigned)(__popc(positive_bytes(w[0]))
                                            + __popc(positive_bytes(w[1]))
                                            + __popc(positive_bytes(w[2]))
                                            + __popc(positive_bytes(w[3]))));
                if (most > 4) {
                    // dense: bin r of every lane's chunk at once, a bin
                    // that no lane codes skipped by a vote
                    unrolled<CHUNK>([&](auto rr) {
                        constexpr int r = decltype(rr)::value;
                        constexpr int k = r >> 2, i = r & 3;
                        const int cls = (int)(int8_t)((w[k] >> (8 * i)) & 0xFFu);
                        if (!__any_sync(0xffffffffu, cls > 0))
                            return;
                        if (cls > 0)
                            bin(cls, q.template at<k>(i));
                    });
                } else {
                    // sparse: each lane only its coded bins (__ffs)
                    unrolled<4>([&](auto kk) {
                        constexpr int k = decltype(kk)::value;
                        uint32_t pm = positive_bytes(w[k]);
                        while (pm) {
                            const int i = __ffs(pm) - 1;
                            pm &= pm - 1u;
                            bin((int)((w[k] >> (8 * i)) & 0xFFu),
                                q.template at<k>(i));
                        }
                    });
                }
                run.flush(words);
            }
            __syncwarp();

            // the grouped heads and the exponent groups
            for (int h = lane; h < h1 + h2 + h4; h += LANES) {
                uint32_t v;
                int bits;
                if (h < h1) {
                    const int o = 3 * h;
                    v = 9u * memb[o] + 3u * (o + 1 < n1 ? memb[o + 1] : 0u)
                        + (o + 2 < n1 ? memb[o + 2] : 0u);
                    bits = 5;
                } else if (h < h1 + h2) {
                    const int o = 3 * (h - h1);
                    const uint8_t* m = memb + n1;
                    v = 25u * m[o] + 5u * (o + 1 < n2 ? m[o + 1] : 0u)
                        + (o + 2 < n2 ? m[o + 2] : 0u);
                    bits = 7;
                } else {
                    const int o = 2 * (h - h1 - h2);
                    const uint8_t* m = memb + n1 + n2;
                    v = 11u * m[o] + (o + 1 < n4 ? m[o + 1] : 0u);
                    bits = 7;
                }
                const int at = head[h];
                if (at != 0xFFFF)
                    deposit(words, at, bits, masked(v, bits), limit);
            }
            // a coded channel's groups, a lane each (the table keeps their
            // count within gmax)
            for (int ch = 0; ch < NCH; ch++) {
                const int s = st_b[ch];
                if (s == 0)
                    continue;
                const int sel = sel_of(s);
                const int gs = sel == 3 ? 4 : sel;
                const int ng = s_ng[ch * 4 + sel];
                const uint8_t* e = ex + ch * BINS;
                const int goff = s_goff[ch];
                for (int g7 = lane; g7 < ng; g7 += LANES) {
                    const int p0 = 1 + 3 * gs * g7;
                    // bytes past 255 read as 0 (the plain version's padding)
                    const int prev = g7 ? (p0 - gs < BINS ? e[p0 - gs] : 0)
                                        : e[0];
                    const int e0 = p0 < BINS ? e[p0] : 0;
                    const int e1 = p0 + gs < BINS ? e[p0 + gs] : 0;
                    const int e2 = p0 + 2 * gs < BINS ? e[p0 + 2 * gs] : 0;
                    const int v = ((e0 - prev + 2) * 5 + (e1 - e0 + 2)) * 5
                                  + (e2 - e1 + 2);
                    deposit(words, goff + 7 * g7, 7, (uint32_t)v & 127u,
                            limit);
                }
            }
            pos += offset_of(carry);
        }
        __syncwarp();

        // CRC1 over [4, 2 fs58) (crc_inv in its multipliers), CRC2 over
        // [2 fs58, total - 2)
#ifndef P1_NO_CRC
        const uint32_t c1 = crc_part(words, s_crc, 4, 2 * fs58, lane,
                                     s_muln + lane * 17);
        const uint32_t c2 = crc_part(words, s_crc, 2 * fs58, total - 2, lane,
                                     s_muln + (LANES + lane) * 17);
#else
        const uint32_t c1 = 0, c2 = 0;
#endif
        uint32_t r = c1 | (c2 << 16);
#pragma unroll
        for (int d = 16; d; d >>= 1)
            r ^= __shfl_xor_sync(0xffffffffu, r, d);
        __syncwarp();
        if (lane == 0) {
            words[0] = (words[0] & 0xFFFF0000u) | (r & 0xFFFFu);
            const int i = total - 2, sh = 16 - 8 * (i & 3);
            words[i >> 2] = (words[i >> 2] & ~(0xFFFFu << sh))
                            | ((r >> 16) << sh);
        }
        __syncwarp();

        uint8_t* dst = out + f * total;
        if ((total & 3) == 0) {
            uint32_t* d32 = reinterpret_cast<uint32_t*>(dst);
            for (int i = lane; i < total / 4; i += LANES)
                d32[i] = __byte_perm(words[i], 0, 0x0123);
        } else {
            uint16_t* d16 = reinterpret_cast<uint16_t*>(dst);
            for (int i = lane; i < total / 2; i += LANES) {
                const uint32_t w = __byte_perm(words[i >> 1], 0, 0x0123);
                d16[i] = (uint16_t)((i & 1) ? w >> 16 : w & 0xFFFFu);
            }
        }
    }
    cp_async_wait_all();
}

// a CTA's warps for frames of `total` bytes and its shared memory
template <int NCH>
int cta_warps(int total)
{
    int w = warps_for(NCH);
    while (w > 1 && CTA_BYTES + w * warp_bytes(NCH, total) > MAX_SMEM)
        w--;
    return w;
}

template <int NCH>
int smem_bytes(int total)
{
    return CTA_BYTES + cta_warps<NCH>(total) * warp_bytes(NCH, total);
}

// the CTAs an SM holds of the (NCH, Code) instance for frames of `total`
// bytes; the instance may take any CTA's shared memory (the attribute is
// the function's, whatever the frame size of the next launch)
template <int NCH, typename Code>
cudaError_t resident(int total, int* per_sm)
{
    cudaError_t e = cudaFuncSetAttribute(
        pack_frames_kernel<NCH, Code>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess)
        return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, pack_frames_kernel<NCH, Code>, cta_warps<NCH>(total) * LANES,
        smem_bytes<NCH>(total));
}

// the CTAs the card holds at once (its SMs times the CTAs an SM) of the
// (NCH, Code) instance at frames of `total` bytes, asked of the runtime
// (and the shared-memory attribute set) once a (device, total), then
// remembered
template <int NCH, typename Code>
cudaError_t card_ctas(int total, long long* ctas)
{
    static std::mutex mu;
    static std::map<std::pair<int, int>, long long> seen;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess)
        return e;
    std::lock_guard<std::mutex> hold(mu);
    const auto it = seen.find({dev, total});
    if (it != seen.end()) {
        *ctas = it->second;
        return cudaSuccess;
    }
    int per_sm = 0, sms = 0;
    e = resident<NCH, Code>(total, &per_sm);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess)
        return e;
    if (per_sm < 1)
        return cudaErrorInvalidConfiguration;
    *ctas = seen[{dev, total}] = (long long)sms * per_sm;
    return cudaSuccess;
}

template <int NCH, typename Code>
cudaError_t launch(const void* bap, const void* qmant, const void* exps,
                   const void* strat, const void* csnr, const void* fsnr,
                   const void* tab, int total, int fs58, void* out,
                   long long N, cudaStream_t s)
{
    long long card = 0;
    const cudaError_t e = card_ctas<NCH, Code>(total, &card);
    if (e != cudaSuccess)
        return e;
    const int warps = cta_warps<NCH>(total);
    const long long need = (N + warps - 1) / warps;
    const long long ctas = need < card ? need : card;
    pack_frames_kernel<NCH, Code><<<(unsigned)ctas, warps * LANES,
                                    smem_bytes<NCH>(total), s>>>(
        (const int8_t*)bap, (const Code*)qmant, (const uint8_t*)exps,
        (const int32_t*)strat, (const int32_t*)csnr, (const int32_t*)fsnr,
        (const int32_t*)tab, total, fs58, N, (uint8_t*)out);
    return cudaGetLastError();
}

// the NCH instance for codes of code_bytes (2: int16, 4: int32)
template <int NCH>
cudaError_t launch_nch(const void* bap, const void* qmant, const void* exps,
                       const void* strat, const void* csnr, const void* fsnr,
                       const void* tab, int total, int fs58, void* out,
                       long long N, int code_bytes, cudaStream_t s)
{
    return code_bytes == 2
        ? launch<NCH, int16_t>(bap, qmant, exps, strat, csnr, fsnr, tab,
                               total, fs58, out, N, s)
        : launch<NCH, int32_t>(bap, qmant, exps, strat, csnr, fsnr, tab,
                               total, fs58, out, N, s);
}

}  // namespace

// codes of code_bytes: 4 (int32) or 2 (int16, read as unsigned)
extern "C" int pack_frames_launch(const void* bap, const void* qmant,
                                  const void* exps, const void* strat,
                                  const void* csnr, const void* fsnr,
                                  const void* tab, int total, int fs58,
                                  void* out, long long N, int nch,
                                  int code_bytes, void* stream)
{
    if (N == 0)
        return 0;
    if (N < 0 || N > 0x7fffffffLL || total < 8 || total > MAX_BYTES
        || (total & 1) || fs58 < 2 || 2 * fs58 > total - 2
        || (code_bytes != 2 && code_bytes != 4))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int cb = code_bytes;
    switch (nch) {
    case 1: return (int)launch_nch<1>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, cb, s);
    case 2: return (int)launch_nch<2>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, cb, s);
    case 3: return (int)launch_nch<3>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, cb, s);
    case 4: return (int)launch_nch<4>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, cb, s);
    case 5: return (int)launch_nch<5>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, cb, s);
    case 6: return (int)launch_nch<6>(bap, qmant, exps, strat, csnr, fsnr, tab, total, fs58, out, N, cb, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// the warps of a CTA (a frame each at a time) for nch channels and frames
// of `total` bytes; 0 for a channel count the kernel does not take
extern "C" int pack_frames_warps(int nch, int total)
{
    switch (nch) {
    case 1: return cta_warps<1>(total);
    case 2: return cta_warps<2>(total);
    case 3: return cta_warps<3>(total);
    case 4: return cta_warps<4>(total);
    case 5: return cta_warps<5>(total);
    case 6: return cta_warps<6>(total);
    default: return 0;
    }
}

// frames resident on an SM for nch channels, frames of `total` bytes and
// int16 codes, the main path's (the CTAs the registers and shared memory
// allow, times their warps); a negative CUDA error code on failure
extern "C" int pack_frames_resident(int nch, int total)
{
    int per_sm = 0, warps = 0;
    cudaError_t e = cudaErrorInvalidValue;
    switch (nch) {
    case 1: e = resident<1, int16_t>(total, &per_sm); warps = cta_warps<1>(total); break;
    case 2: e = resident<2, int16_t>(total, &per_sm); warps = cta_warps<2>(total); break;
    case 3: e = resident<3, int16_t>(total, &per_sm); warps = cta_warps<3>(total); break;
    case 4: e = resident<4, int16_t>(total, &per_sm); warps = cta_warps<4>(total); break;
    case 5: e = resident<5, int16_t>(total, &per_sm); warps = cta_warps<5>(total); break;
    case 6: e = resident<6, int16_t>(total, &per_sm); warps = cta_warps<6>(total); break;
    default: break;
    }
    return e == cudaSuccess ? per_sm * warps : -(int)e;
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
