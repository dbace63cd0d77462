// E1: the encoder's masking curve, SNR-offset search and bap for Hopper
// (sm_90a), from the coded exponents.
//
// Replaces what the JAX package leaves to XLA inside the encoder's frame
// core (no pallas_call): ac3acm_tpu/models/encoder.py:386-451, the
// masking curve (ops/alloc.py:81 band_psd, :120 excitation, :202
// masking_curve), the binary search over ops/alloc.py:285 bits_for_snro
// and the final ops/alloc.py:213 bap_from_mask.  In the port the curve ran
// as a 50-band loop of small eager ops and the search as 12 eager passes
// (ops/snr_search.py:mask_search_ref, the plain version).
//
// Per lane-frame row, with e the exponent of a bin (a byte), live the bins
// below nb[ch], and the encoder's curve constants (fgain, sgain, fdecay,
// sdecay, dbknee, floor):
//
//   psd[bin]         = 3072 - 128 e on live bins, 0 elsewhere
//   bndpsd[band]     = the log-add fold of the band's live bins in order:
//                      v = psd[first]; v = max(v, p) + LATAB[min(|v - p|
//                      >> 1, 255)] for each later live bin p
//   excite[band]     = the leak recurrence over the 50 bands (fast and slow
//                      leaks, lowcomp for bands < 22 but not the LFE's band
//                      6, startup bands up to 6): ops/alloc.py:excitation
//   mask[band]       = max(excite + (dbknee - bndpsd > 0 ?
//                          (dbknee - bndpsd) >> 2 : 0), hth[band])
//
// then, with snro(c, f) = ((c - 15) * 16 + f) * 4:
//
//   v[blk, ch, band] = (max(mask - snro - floor, 0) & 0x1FE0) + floor
//   vbin[bin]        = v[MASKTAB[bin]] (bins < 253), 0 (bins 253..255)
//   address          = clamp((psd - vbin) >> 5, 0, 63), class BAPTAB[address]
//   bits(snro)       = sum over blocks of  lin + 5 ceil(n1 / 3)
//                      + 7 ceil(n2 / 3) + 7 ceil(n4 / 2)
//
// where lin sums BAP_BITS over the block's live bins of every channel, and
// n1, n2, n4 count its bins of classes 1, 2 and 4 over every channel (the
// grouped ceilings are taken per block, after the channel sum:
// ac3enc.cpp:764-810).  fits(c, f) <=> avail - bits >= 0 in int32.  M is
// the result of 7 steps of lo = -1, hi = 63, mid = (lo + hi + 1) >> 1 on
// fits(mid, 0); fstar = max(flo, 0) after 5 steps of flo = -1, fhi = 15 on
// fits(M, fmid) (M = -1 included); bap is the class of every live bin at
// snro(M, fstar), 0 elsewhere.  Every add and subtract wraps as int32 does
// in PyTorch; shifts of negative values are arithmetic; no float anywhere.
//
// Since psd - vbin = (3072 - floor) - 128 e - X with X = max(...) & 0x1FE0
// a multiple of 32, the address of a bin below 253 is ((3072 - floor) >>
// 5) - X / 32 - 4 e, and of a bin past 252 it is 96 - 4 e: a candidate
// needs one entry t = 4 ((3072 - floor) >> 5) - X / 8 a band, and t - 16 e,
// clamped below at 0, is the byte offset of the bin's word in a table of
// addresses (address 63's word repeated past 63).  A dead bin's exponent
// is staged as 255, whose offset is below 0 at every offset: class 0, no
// cost.
//
// Bound on the card.  The function reads a live bin's exponent a byte and
// writes its class a byte, plus avail, M and fstar (int32) a row: about
// 0.026 ms for 16,384 rows of 2.0 and 0.066 ms for 5.1 at 3.35 TB/s
// (chip_smoke.py:e1_bound).  No curve is read: it is made on chip.  The
// search is 12 candidates of a few integer instructions a live bin,
// data-dependent: each candidate needs the whole row's bit count before
// the next is chosen.
//
// What the design does about it.  One CTA a row, one warp an audio block
// (6 warps).  The prologue, in shared memory: the row's exponents (16-byte
// loads, stored at a row stride of 65 words so that the bins of one band
// in different channels and blocks fall in different banks); the band
// folds, one thread a (block, channel, band), the widest bands first so
// that a warp's lanes share a trip count; the excitation and curve, one
// thread a (block, channel) chain of 50 dependent steps, written over the
// band psd as mask - floor, while the other threads mark the dead bins.
// Then a lane's bins are lane + 32 j of every channel of its block, read
// as bytes from shared memory each pass (in registers they held the
// 5.1 instance to 3 CTAs an SM), and the curve entries it refreshes sit in
// registers.  A candidate: each warp writes its own block's entries t to
// shared memory (no CTA barrier: a warp reads only its block's),
// __syncwarp, each lane sums one packed cost word a live bin, lin | n1 <<
// 10 | n2 << 16 | n4 << 22 (at most 48 bins a lane keep the fields apart;
// six instructions a bin: two shared loads, a multiply-add, a max, the
// word's load, an add), two warp reductions (__reduce_add_sync) give the
// block's counts, lane 0 its bits into a double-buffered slot, one
// __syncthreads, and every thread sums the 6 blocks and takes the same
// step of the search.  A group of 32 bins that lies wholly past nb[ch] is
// skipped by a uniform branch.  The last pass writes the bap over the
// staged exponents and then to the output with 16-byte stores.  Tensor
// cores, TMA and clusters have nothing to offer a data-dependent integer
// compare-and-count of a few KB a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCKS = 6;          // audio blocks a frame: one warp each
constexpr int BINS = 256;
constexpr int BANDS = 50;
constexpr int TBANDS = BANDS + 1;  // threshold entries a chain: entry 50
                                   // is bins 253..255's (X = 0)
constexpr int MASKBINS = 253;      // bins with a band (MASKTAB's length)
constexpr int GROUPS = BINS / 32;  // bins a lane holds per channel
constexpr int THREADS = 32 * BLOCKS;
constexpr int ROW_WORDS = BINS / 4 + 1;  // a chain's staged bytes, padded
constexpr int NO_BAND = -(1 << 30);      // curve entry of band 50: X = 0
// the floors the kernel takes (FLOORTAB's range and up to 3072): 4 x a
// bin's address then lies in [4 * (96 - 4 e), 4 * ((3072 - floor) >> 5)],
// so tables of NADDR addresses (the last ones repeating address 63's
// entry) need no upper clamp
constexpr int FLOOR_MIN = -2048, FLOOR_MAX = 3072;
constexpr int NADDR = ((3072 - FLOOR_MIN) >> 5) + 1;

// the tables the wrapper passes (ops/snr_search.py:_kernel_tables), int32:
// [0, 256) the threshold entry of each bin (MASKTAB; 50 past bin 252),
// [256, 320) the class of each address (BAPTAB), [320, 384) the cost word
// of each address, [384, 640) LATAB[0..255], [640, 690) each band's first
// bin | size << 16
constexpr int TAB_BAND = 0, TAB_CLASS = 256, TAB_COST = 320, TAB_LATAB = 384,
              TAB_BANDS = 640, TAB_SIZE = 690;

struct Curve {
    int fgain, sgain, fdecay, sdecay, dbknee, floor;
};

__device__ __forceinline__ int wadd(int a, int b)
{
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int wsub(int a, int b)
{
    return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int snro_of(int c, int f)
{
    return ((c - 15) * 16 + f) * 4;
}

// liba52's calc_lowcomp for band b (ops/alloc.py:_calc_lowcomp)
__device__ __forceinline__ int lowcomp_of(int a, int b0, int b1, int b)
{
    if (b >= 20) {
        const int d = wsub(a, 128);
        return d > 0 ? d : 0;
    }
    if (wadd(b0, 256) == b1)
        return b < 7 ? 384 : 320;
    if (b0 > b1) {
        const int d = wsub(a, 64);
        return d > 0 ? d : 0;
    }
    return a;
}

// no __launch_bounds__: left free, ptxas sizes each channel count's
// registers with no spill
template <int NCH>
__global__ void
snr_search_kernel(const uint8_t* __restrict__ exps,
                  const int32_t* __restrict__ avail,
                  const int32_t* __restrict__ nb,
                  const uint8_t* __restrict__ is_lfe,
                  const int32_t* __restrict__ hth,
                  const int32_t* __restrict__ tabs, Curve cv,
                  int32_t* __restrict__ M_out, int32_t* __restrict__ f_out,
                  int8_t* __restrict__ bap)
{
    constexpr int CH = BLOCKS * NCH;           // (block, channel) chains
    constexpr int NEXP = CH * BINS;            // bytes a row, a multiple of 16
    constexpr int NT = NCH * TBANDS;           // threshold entries a warp
    constexpr int OWN = (NT + 31) / 32;        // ... a lane refreshes
    __shared__ unsigned s_row[CH * ROW_WORDS]; // exponents, later the bap
    __shared__ int s_bnd[CH * BANDS];          // band psd, then mask - floor
    __shared__ int s_t[BLOCKS * NT];           // a candidate's entries t
    __shared__ unsigned s_cost[NADDR];
    __shared__ int s_class[NADDR];
    __shared__ int s_latab[256];
    __shared__ int s_band[BANDS];
    __shared__ int s_hth[BANDS];
    __shared__ int s_nb[NCH];
    __shared__ int s_lfe[NCH];
    __shared__ int s_bits[2][BLOCKS];
    const uint8_t* s_byte = (const uint8_t*)s_row;

    const long long row = blockIdx.x;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;

    // stage the row's exponents (16 bytes of one chain a thread a step)
    const int4* e4 = (const int4*)(exps + row * NEXP);
    for (int i = tid; i < NEXP / 16; i += THREADS) {
        const int4 v = e4[i];
        unsigned* d = s_row + (i >> 4) * ROW_WORDS + (i & 15) * 4;
        d[0] = (unsigned)v.x;
        d[1] = (unsigned)v.y;
        d[2] = (unsigned)v.z;
        d[3] = (unsigned)v.w;
    }
    for (int i = tid; i < 256; i += THREADS)
        s_latab[i] = tabs[TAB_LATAB + i];
    for (int i = tid; i < NADDR; i += THREADS) {
        const int a = i < 63 ? i : 63;
        s_cost[i] = (unsigned)tabs[TAB_COST + a];
        s_class[i] = tabs[TAB_CLASS + a];
    }
    if (tid < BANDS) {
        s_band[tid] = tabs[TAB_BANDS + tid];
        s_hth[tid] = hth[tid];
    }
    if (tid < NCH) {
        s_nb[tid] = nb[tid];
        s_lfe[tid] = is_lfe[tid] != 0;
    }
    __syncthreads();

    // band psd: one thread a (block, channel, band), widest bands first
    for (int t = tid; t < CH * BANDS; t += THREADS) {
        const int band = BANDS - 1 - t / CH;
        const int k = t % CH;                      // block k / NCH
        const int end = s_nb[k % NCH];
        const int fs = s_band[band];
        const int first = fs & 0xFFFF;
        const int last = first + (fs >> 16) < end ? first + (fs >> 16) : end;
        const uint8_t* e = s_byte + k * ROW_WORDS * 4;
        int v = first < end ? 3072 - (e[first] << 7) : 0;
        for (int bin = first + 1; bin < last; ++bin) {
            const int p = 3072 - (e[bin] << 7);
            int a = wsub(v, p);
            a = (a < 0 ? -a : a) >> 1;
            v = wadd(v > p ? v : p, s_latab[a < 255 ? a : 255]);
        }
        s_bnd[k * BANDS + band] = v;
    }
    __syncthreads();

    // excitation and masking curve: one thread a chain, in place
    if (tid < CH) {
        int* bnd = s_bnd + tid * BANDS;
        const bool lfe = s_lfe[tid % NCH];
        int fast = 0, slow = 0, lowcomp = 0;
        bool startup = true;
        int bn = bnd[0];
#pragma unroll
        for (int b = 0; b < BANDS; ++b) {
            const int bp = bn;
            bn = bnd[b + 1 < BANDS ? b + 1 : b];
            if (b < 22 && !(b == 6 && lfe))
                lowcomp = lowcomp_of(lowcomp, bp, bn, b);
            const int ff = wsub(bp, cv.fgain), fsl = wsub(bp, cv.sgain);
            int exc;
            if (b < 2) {
                exc = wsub(ff, lowcomp);
            } else {
                const int df0 = wsub(fast, cv.fdecay);
                const int ds0 = wsub(slow, cv.sdecay);
                const int df = df0 > ff ? df0 : ff;
                const int ds = ds0 > fsl ? ds0 : fsl;
                const int dfl = b < 22 ? wsub(df, lowcomp) : df;
                const int leak = dfl > ds ? dfl : ds;
                if (b < 7) {
                    const bool leave = (b != 6 || !lfe) && bp <= bn;
                    exc = startup ? wsub(ff, lowcomp) : leak;
                    fast = startup ? ff : df;
                    slow = startup ? fsl : ds;
                    startup = startup && !leave && b < 6;
                } else {
                    exc = leak;
                    fast = df;
                    slow = ds;
                }
            }
            const int tmp = wsub(cv.dbknee, bp);
            const int v1 = wadd(exc, tmp > 0 ? tmp >> 2 : 0);
            const int m = v1 > s_hth[b] ? v1 : s_hth[b];
            bnd[b] = wsub(m, cv.floor);
        }
    } else {
        // the other threads mark the dead bins' exponents (their address
        // is then below 0 at every offset: class 0, no cost, as a live bin
        // of exponent 255 is); the band psd above read only live ones
        for (int i = tid - CH; i < CH * (BINS / 4); i += THREADS - CH) {
            const int k = i / (BINS / 4), wd = i % (BINS / 4);
            const int live = s_nb[k % NCH] - 4 * wd;
            if (live < 4)
                s_row[k * ROW_WORDS + wd] |=
                    live <= 0 ? 0xFFFFFFFFu : 0xFFFFFFFFu << (8 * live);
        }
    }
    __syncthreads();

    // the search: this lane's bins are lane + 32 j of each channel of
    // block w; their exponents stay in shared memory (dead bins read 255)
    int nbc[NCH];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
        nbc[c] = s_nb[c];
    const int k4 = 4 * ((3072 - cv.floor) >> 5);
    // bins past 252 (lanes 29..31 of group 7) take 96 - 4 e, not k4 / 4
    const int fix7 = lane + 32 * (GROUPS - 1) >= MASKBINS ? 384 - k4 : 0;
    const uint8_t* const s_e = s_byte + w * NCH * ROW_WORDS * 4 + lane;
    // s_tw's entry of each of the lane's bins (channel 0)
    int* const s_tw = s_t + w * NT;
    int tofs[GROUPS];
#pragma unroll
    for (int j = 0; j < GROUPS; ++j)
        tofs[j] = tabs[TAB_BAND + lane + 32 * j];
    // the curve entries (mask - floor) this lane turns into thresholds
    int mf[OWN];
#pragma unroll
    for (int u = 0; u < OWN; ++u) {
        const int i = lane + 32 * u, c = i / TBANDS, band = i % TBANDS;
        mf[u] = (i < NT && band < BANDS)
            ? s_bnd[(w * NCH + c) * BANDS + band] : NO_BAND;
    }
    const int av = avail[row];

    // 4 x the address of the lane's bin j in channel c, clamped below (the
    // tables run to NADDR - 1, past every address a bin can reach)
    auto offset = [&](int c, int j) {
        int a = s_tw[c * TBANDS + tofs[j]] - 16 * (int)s_e[c * ROW_WORDS * 4
                                                            + 32 * j];
        if (j == GROUPS - 1)
            a += fix7;
        return a < 0 ? 0 : a;
    };
    // each entry: k4 - X / 8, X = max(mask - floor - snro, 0) & 0x1FE0
    auto thresholds = [&](int snro) {
#pragma unroll
        for (int u = 0; u < OWN; ++u) {
            const int v = wsub(mf[u], snro);
            if (u < OWN - 1 || lane + 32 * u < NT)
                s_tw[lane + 32 * u] = k4 - (((v > 0 ? v : 0) & 0x1FE0) >> 3);
        }
        __syncwarp();
    };
    int par = 0;
    auto fits = [&](int snro) {
        thresholds(snro);
        unsigned acc = 0;
#pragma unroll
        for (int c = 0; c < NCH; ++c)
#pragma unroll
            for (int j = 0; j < GROUPS; ++j)
                if (32 * j < nbc[c])
                    acc += *(const unsigned*)((const char*)s_cost
                                              + offset(c, j));
        unsigned lo = (acc & 0x3FFu) | ((acc << 6) & 0x3F0000u);
        unsigned hi = ((acc >> 16) & 0x3Fu) | ((acc >> 6) & 0x3F0000u);
        lo = __reduce_add_sync(0xffffffffu, lo);
        hi = __reduce_add_sync(0xffffffffu, hi);
        if (lane == 0) {
            const int lin = lo & 0xFFFF, n1 = lo >> 16;
            const int n2 = hi & 0xFFFF, n4 = hi >> 16;
            s_bits[par][w] = lin + 5 * ((n1 + 2) / 3) + 7 * ((n2 + 2) / 3)
                + 7 * ((n4 + 1) / 2);
        }
        __syncthreads();
        int bits = 0;
#pragma unroll
        for (int b = 0; b < BLOCKS; ++b)
            bits = wadd(bits, s_bits[par][b]);
        par ^= 1;
        return wsub(av, bits) >= 0;
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

    // the bap at the chosen offset, each bin's class over its own
    // exponent (the last barrier of fits() ordered every read of s_t
    // before this pass's thresholds)
    thresholds(snro_of(lo, fstar));
    uint8_t* const s_bap = (uint8_t*)s_e;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int j = 0; j < GROUPS; ++j)
            s_bap[c * ROW_WORDS * 4 + 32 * j] = (uint8_t)(32 * j < nbc[c]
                ? *(const int*)((const char*)s_class + offset(c, j)) : 0);
    __syncthreads();
    int4* out4 = (int4*)(bap + row * NEXP);
    for (int i = tid; i < NEXP / 16; i += THREADS) {
        const unsigned* s = s_row + (i >> 4) * ROW_WORDS + (i & 15) * 4;
        out4[i] = make_int4((int)s[0], (int)s[1], (int)s[2], (int)s[3]);
    }
    if (tid == 0) {
        M_out[row] = lo;
        f_out[row] = fstar;
    }
}

template <int NCH>
cudaError_t launch(const void* exps, const void* avail, const void* nb,
                   const void* is_lfe, const void* hth, const void* tabs,
                   Curve cv, void* M, void* fstar, void* bap, long long N,
                   cudaStream_t stream)
{
    snr_search_kernel<NCH><<<(unsigned)N, THREADS, 0, stream>>>(
        (const uint8_t*)exps, (const int32_t*)avail, (const int32_t*)nb,
        (const uint8_t*)is_lfe, (const int32_t*)hth, (const int32_t*)tabs,
        cv, (int32_t*)M, (int32_t*)fstar, (int8_t*)bap);
    return cudaGetLastError();
}

}  // namespace

// exps [N, 6, nch, 256] uint8 (16-byte aligned), avail [N] int32, nb [nch]
// int32, is_lfe [nch] bool, hth [50] int32, tabs [TAB_SIZE] int32, the
// curve's constants -> M [N], fstar [N] int32, bap [N, 6, nch, 256] int8
// (16-byte aligned); on `stream`
extern "C" int snr_search_launch(const void* exps, const void* avail,
                                 const void* nb, const void* is_lfe,
                                 const void* hth, const void* tabs,
                                 int fgain, int sgain, int fdecay, int sdecay,
                                 int dbknee, int floor, void* M, void* fstar,
                                 void* bap, long long N, int nch,
                                 void* stream)
{
    if (N == 0)
        return 0;
    if (N < 0 || N > 0x7fffffffLL || floor < FLOOR_MIN || floor > FLOOR_MAX)
        return (int)cudaErrorInvalidValue;
    const Curve cv{fgain, sgain, fdecay, sdecay, dbknee, floor};
    cudaStream_t s = (cudaStream_t)stream;
    switch (nch) {
    case 1: return (int)launch<1>(exps, avail, nb, is_lfe, hth, tabs, cv, M, fstar, bap, N, s);
    case 2: return (int)launch<2>(exps, avail, nb, is_lfe, hth, tabs, cv, M, fstar, bap, N, s);
    case 3: return (int)launch<3>(exps, avail, nb, is_lfe, hth, tabs, cv, M, fstar, bap, N, s);
    case 4: return (int)launch<4>(exps, avail, nb, is_lfe, hth, tabs, cv, M, fstar, bap, N, s);
    case 5: return (int)launch<5>(exps, avail, nb, is_lfe, hth, tabs, cv, M, fstar, bap, N, s);
    case 6: return (int)launch<6>(exps, avail, nb, is_lfe, hth, tabs, cv, M, fstar, bap, N, s);
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
