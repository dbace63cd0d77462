// E1: the encoder's SNR-offset search and its bap for Hopper (sm_90a).
//
// Replaces what the JAX package leaves to XLA inside the encoder's frame
// core (no pallas_call): ac3acm_tpu/models/encoder.py:398-451, the binary
// search over ops/alloc.py:285 bits_for_snro and the final
// ops/alloc.py:213 bap_from_mask.  In the port the same function ran as
// 12 eager passes, each building a [rows, 6, ch, 256, 15] compare tensor
// in device memory (ops/snr_search.py:snr_search_ref, the plain version).
//
// Per lane-frame row, with snro(c, f) = ((c - 15) * 16 + f) * 4:
//
//   v[blk, ch, band] = (max(mask - snro - floor, 0) & 0x1FE0) + floor
//   vbin[bin]        = v[MASKTAB[bin]] (bins < 253), 0 (bins 253..255)
//   address          = clamp((psd - vbin) >> 5, 0, 63), class BAPTAB[address]
//   bits(snro)       = sum over blocks of  lin + 5 ceil(n1 / 3)
//                      + 7 ceil(n2 / 3) + 7 ceil(n4 / 2)
//
// where lin sums BAP_BITS over the block's live bins (bins < nb[ch]) of
// every channel, and n1, n2, n4 count its bins of classes 1, 2 and 4 over
// every channel (the grouped ceilings are taken per block, after the
// channel sum: ac3enc.cpp:764-810).  fits(c, f) <=> avail - bits >= 0 in
// int32.  M is the result of 7 steps of lo = -1, hi = 63, mid = (lo + hi +
// 1) >> 1 on fits(mid, 0); fstar = max(flo, 0) after 5 steps of flo = -1,
// fhi = 15 on fits(M, fmid) (M = -1 included); bap is the class of every
// live bin at snro(M, fstar), 0 elsewhere.  Every int32 add and subtract
// wraps as PyTorch's does.
//
// Bound on the card.  At the narrowest type that holds each, the function
// reads a row's live bins (bins < nb[ch]) as an exponent a byte and the
// masking curve over the bands they reach as int16, and writes a class a
// byte a live bin and two int32: bytes bound it, about 0.032 ms for 16,384
// rows of 2.0 and 0.081 ms for 5.1 at 3.35 TB/s (chip_smoke.py:e1_bound;
// E1 itself reads psd and the curve as int32, the types its caller holds).
// The search itself is 12 candidates of about ten integer instructions a
// live bin, data-dependent: each candidate needs the whole row's bit
// count before the next is chosen.
//
// What the design does about it.  One CTA a row, one warp an audio block
// (6 warps).  A lane holds its psd bins (lane + 32 j of every channel:
// each warp load is one 128-byte line) in registers for the whole search,
// and the row's masking curve sits in shared memory; nothing but the bap,
// M and fstar is written, no compare, base or vbin tensor.  A candidate
// is: the CTA turns the 6 * ch * 50 curve into thresholds in shared
// memory; a barrier; each lane, for each of its live bins, reads its
// band's threshold, subtracts, shifts, clamps and adds one 64-bit word of
// a 64-entry shared table (lin in 16 bits, n1, n2, n4 in 16 bits each);
// two warp reductions (__reduce_add_sync) give the block's counts, lane 0
// its bits; a barrier; every thread sums the 6 blocks and takes the same
// step of the search.  A group of 32 bins that lies wholly past nb[ch]
// (bins 224..255 of a full-band channel, all but the first 32 of the
// LFE's) is skipped by a uniform branch.  The last pass writes the bap to
// shared memory and then to the output with 16-byte stores.  Bins past
// nb[ch] are never loaded: their psd is held at -2^30, whose address is 0
// and class 0, so they cost nothing (|floor| < 2^29 keeps psd - vbin from
// wrapping).  Tensor cores, TMA and clusters have nothing to offer a
// data-dependent integer compare-and-count of a few KB a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCKS = 6;          // audio blocks a frame: one warp each
constexpr int BINS = 256;
constexpr int BANDS = 50;
constexpr int MASKBINS = 253;      // bins with a band (MASKTAB's length)
constexpr int GROUPS = BINS / 32;  // bins a lane holds per channel
constexpr int THREADS = 32 * BLOCKS;
constexpr int DEAD_PSD = -(1 << 30);

// the tables the wrapper passes (ops/snr_search.py:_kernel_tables), int32:
// [0, 256) the band of each bin (bins >= 253: 0, unused), [256, 320) the
// class of each address, [320, 384) and [384, 448) the cost words of each
// address: lin | n1 << 16 and n2 | n4 << 16
constexpr int TAB_BAND = 0, TAB_CLASS = 256, TAB_COST_LO = 320,
              TAB_COST_HI = 384, TAB_SIZE = 448;

__device__ __forceinline__ int wrap_sub(int a, int b)
{
    return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int snro_of(int c, int f)
{
    return ((c - 15) * 16 + f) * 4;
}

// the thresholds of every (block, channel, band) of the row for one snro
__device__ __forceinline__ void thresholds(const int* s_mask, int* s_v,
                                           int n, int snro, int floor)
{
    for (int i = threadIdx.x; i < n; i += THREADS) {
        int v = wrap_sub(wrap_sub(s_mask[i], snro), floor);
        v = v < 0 ? 0 : v;
        s_v[i] = (int)((unsigned)(v & 0x1FE0) + (unsigned)floor);
    }
}

// no __launch_bounds__: given 192 threads, ptxas held the 4-channel
// instance to 56 registers and spilled; left free it takes 40 (1 channel)
// to 80 (6) with no spill
template <int NCH>
__global__ void
snr_search_kernel(const int32_t* __restrict__ psd,
                  const int32_t* __restrict__ mask,
                  const int32_t* __restrict__ avail,
                  const int32_t* __restrict__ nb,
                  const int32_t* __restrict__ tabs, int floor,
                  int32_t* __restrict__ M_out, int32_t* __restrict__ f_out,
                  int8_t* __restrict__ bap)
{
    constexpr int NV = BLOCKS * NCH * BANDS;       // a multiple of 4
    constexpr int NBAP = BLOCKS * NCH * BINS;      // bytes, a multiple of 16
    __shared__ int4 s_mask4[NV / 4];
    __shared__ int s_v[NV];
    __shared__ uint2 s_cost[64];
    __shared__ int s_class[64];
    __shared__ int s_bits[BLOCKS];
    __shared__ int4 s_bap4[NBAP / 16];
    const int* s_mask = (const int*)s_mask4;
    int8_t* s_bap = (int8_t*)s_bap4;

    const long long row = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;

    const int4* m4 = (const int4*)(mask + row * NV);
    for (int i = tid; i < NV / 4; i += THREADS)
        s_mask4[i] = m4[i];
    if (tid < 64) {
        s_cost[tid] = make_uint2((unsigned)tabs[TAB_COST_LO + tid],
                                 (unsigned)tabs[TAB_COST_HI + tid]);
        s_class[tid] = tabs[TAB_CLASS + tid];
    }
    __syncthreads();

    int nbc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
        nbc[c] = nb[c];
    // the offset in s_v of each of the lane's bins in channel 0
    int vofs[GROUPS];
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
        vofs[j] = w * NCH * BANDS + tabs[TAB_BAND + lane + 32 * j];
    int p[NCH][GROUPS];
    const int32_t* prow = psd + (row * BLOCKS + w) * NCH * BINS;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < GROUPS; ++j) {
            const int bin = lane + 32 * j;
            p[c][j] = bin < nbc[c] ? prow[c * BINS + bin] : DEAD_PSD;
        }
    const int av = avail[row];

    // vbin of the lane's bin j in channel c (0 past bin 252)
    auto vbin = [&](int c, int j) {
        const int v = s_v[vofs[j] + c * BANDS];
        return (j == GROUPS - 1 && lane + 32 * j >= MASKBINS) ? 0 : v;
    };
    auto address = [&](int c, int j) {
        const int a = wrap_sub(p[c][j], vbin(c, j)) >> 5;
        return a < 0 ? 0 : (a > 63 ? 63 : a);
    };
    auto fits = [&](int snro) {
        thresholds(s_mask, s_v, NV, snro, floor);
        __syncthreads();
        unsigned lo = 0, hi = 0;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int j = 0; j < GROUPS; ++j)
                if (32 * j < nbc[c]) {
                    const uint2 t = s_cost[address(c, j)];
                    lo += t.x;
                    hi += t.y;
                }
        lo = __reduce_add_sync(0xffffffffu, lo);
        hi = __reduce_add_sync(0xffffffffu, hi);
        if (lane == 0) {
            const int lin = lo & 0xFFFF, n1 = lo >> 16;
            const int n2 = hi & 0xFFFF, n4 = hi >> 16;
            s_bits[w] = lin + 5 * ((n1 + 2) / 3) + 7 * ((n2 + 2) / 3)
                + 7 * ((n4 + 1) / 2);
        }
        __syncthreads();
        int bits = 0;
#pragma unroll
        for (int b = 0; b < BLOCKS; ++b)
            bits += s_bits[b];
        return wrap_sub(av, bits) >= 0;
    };

    int lo = -1, hi = 63;
#pragma unroll 1
    for (int it = 0; it < 7; ++it) {               // ceil(log2(65))
        const int mid = (lo + hi + 1) >> 1;
        const bool ok = fits(snro_of(mid, 0));
        lo = ok ? mid : lo;
        hi = ok ? hi : mid - 1;
    }
    int flo = -1, fhi = 15;
#pragma unroll 1
    for (int it = 0; it < 5; ++it) {               // ceil(log2(17))
        const int fmid = (flo + fhi + 1) >> 1;
        const bool ok = fits(snro_of(lo, fmid));
        flo = ok ? fmid : flo;
        fhi = ok ? fhi : fmid - 1;
    }
    const int fstar = flo < 0 ? 0 : flo;

    // the bap at the chosen offset (the last barrier of fits() ordered
    // every read of s_v before these writes)
    thresholds(s_mask, s_v, NV, snro_of(lo, fstar), floor);
    __syncthreads();
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < GROUPS; ++j)
            s_bap[(w * NCH + c) * BINS + lane + 32 * j] =
                (int8_t)(32 * j < nbc[c] ? s_class[address(c, j)] : 0);
    __syncthreads();
    int4* out4 = (int4*)(bap + row * NBAP);
    for (int i = tid; i < NBAP / 16; i += THREADS)
        out4[i] = s_bap4[i];
    if (tid == 0) {
        M_out[row] = lo;
        f_out[row] = fstar;
    }
}

template <int NCH>
cudaError_t launch(const void* psd, const void* mask, const void* avail,
                   const void* nb, const void* tabs, int floor, void* M,
                   void* fstar, void* bap, long long N, cudaStream_t stream)
{
    snr_search_kernel<NCH><<<(unsigned)N, THREADS, 0, stream>>>(
        (const int32_t*)psd, (const int32_t*)mask, (const int32_t*)avail,
        (const int32_t*)nb, (const int32_t*)tabs, floor, (int32_t*)M,
        (int32_t*)fstar, (int8_t*)bap);
    return cudaGetLastError();
}

}  // namespace

// psd [N, 6, nch, 256] int32, mask [N, 6, nch, 50] int32 (16-byte aligned),
// avail [N] int32, nb [nch] int32, tabs [448] int32 -> M [N], fstar [N]
// int32, bap [N, 6, nch, 256] int8 (16-byte aligned); on `stream`
extern "C" int snr_search_launch(const void* psd, const void* mask,
                                 const void* avail, const void* nb,
                                 const void* tabs, int floor, void* M,
                                 void* fstar, void* bap, long long N, int nch,
                                 void* stream)
{
    if (N == 0)
        return 0;
    if (N < 0 || N > 0x7fffffffLL || floor <= -(1 << 29) ||
        floor >= (1 << 29))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (nch) {
    case 1: return (int)launch<1>(psd, mask, avail, nb, tabs, floor, M, fstar, bap, N, s);
    case 2: return (int)launch<2>(psd, mask, avail, nb, tabs, floor, M, fstar, bap, N, s);
    case 3: return (int)launch<3>(psd, mask, avail, nb, tabs, floor, M, fstar, bap, N, s);
    case 4: return (int)launch<4>(psd, mask, avail, nb, tabs, floor, M, fstar, bap, N, s);
    case 5: return (int)launch<5>(psd, mask, avail, nb, tabs, floor, M, fstar, bap, N, s);
    case 6: return (int)launch<6>(psd, mask, avail, nb, tabs, floor, M, fstar, bap, N, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" int snr_search_table_size()
{
    return TAB_SIZE;
}

extern "C" const char* snr_search_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
