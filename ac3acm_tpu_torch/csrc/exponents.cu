// X1: the encoder's exponent stage for Hopper (sm_90a): raw exponents,
// exponent strategy, the run fold, the delta-constraint coding and the
// reuse copy, in one launch.
//
// Replaces what the JAX package leaves to XLA inside the encoder's frame
// core (no pallas_call): ac3acm_tpu/ops/mdct.py:181 extract_exponents and
// ac3acm_tpu/models/encoder.py:316-384 (the strategy, the run fold, three
// :116 _encode_exp_static calls and the LFE's, the reuse copy).  In the
// port these ran as some forty eager passes over [N, 6, ch, 256] int32
// (ops/exponents.py:exponents_ref, the plain version).
//
// Per lane-frame row, block b, channel c, bin k, with es the block's
// exp_samples and nbc the channel's live bins (NB = 223, every encoder
// config's; the LFE's 7):
//
//   raw[b][c][k]  = 24 if coef = 0, else min(23 - floor(log2 |coef|) + es,
//                   24); coef := 0 where it is not 0 and the unclamped
//                   value is >= 24 (|coef| as unsigned: |INT_MIN| = 2^31)
//   sum[b][c]     = sum over all 256 bins of |raw[b] - raw[b-1]| (b >= 1)
//   new[b][c]     = b == 0 or sum[b][c] > 1000
//   strat[b][c]   = 0 (reuse) unless new; the LFE 1; else by the run's
//                   length (new block to the next new one): 1 -> 3 (D45),
//                   2 or 3 -> 2 (D25), longer -> 1 (D15)
//   fold[b][c][k] = the minimum of raw over the run's blocks for k < nbc,
//                   raw[b][c][k] past it
//
// then each coded (b, c), with g = 1, 2, 4 for strat 1, 2, 3 (the LFE 1)
// and ngroups = ((nbc + 3g - 4) / 3g) * 3:
//
//   v[0]   = min(fold[0], 15), v[1 + j] = min of fold[1 + j g ... j g + g]
//   f[i]   = min over j <= i of v[j] - 2j, + 2i   (forward min-plus scan)
//   h[i]   = min over j >= i of f[j] + 2j, - 2i   (backward)
//   enc[0] = h[0]; enc[1 + j g + t] = h[1 + j] (t < g); enc[k] = 0 past
//            1 + ngroups g
//
// and every block of the run holds those 256 bytes (the reuse copy);
// exp_bits = sum over coded (b, c) of 4 + 7 ngroups / 3.  D45's 57 groups
// at 223 bins reach bin 228: their minima read dead bins' unfolded raw
// exponents.  Every value is an exact int; raw lies in [-16, 24] for
// |coef| < 2^31 and es >= -9, and nothing below goes under its least value,
// so a byte holds it (ops/exponents.py says why).
//
// Bound on the card.  The function reads each coefficient (int32) and
// writes each coded exponent (a byte): 5 bytes a bin, about 0.075 ms for
// 16,384 rows of 2.0 and 0.225 ms for 5.1 at 3.35 TB/s
// (chip_smoke.py:stage_least_bytes).  Its integer work, a dozen
// instructions a bin, takes a third of that at the card's issue rate.
//
// What the design does about it.  One CTA of 256 threads a row, a thread
// a bin.  The coefficients are read once, coalesced (a warp reads 128
// contiguous bytes of one (block, channel)), and an overranging one is
// zeroed by a masked store.  The raw exponents go to shared memory as bytes
// ([6][ch][256], at most 9 KB); each thread's |diff| terms are summed per
// warp (__reduce_add_sync) and per CTA (shared atomics); one thread a
// channel takes the strategy; each thread folds its bin's column in
// place.  Then one warp a coded (block, channel): each lane takes 8
// consecutive scan entries (their group minima from shared memory), scans
// them in registers and joins the lanes with five shuffles each way, puts
// the 2-Lipschitz values in its warp's shared row, and writes the 256
// coded bytes as one 8-byte store a lane to every block of the run.  No
// intermediate leaves the chip.  Tensor cores, TMA and clusters have
// nothing to offer a byte-wide min-plus scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCKS = 6;          // audio blocks a frame
constexpr int BINS = 256;
constexpr int THREADS = BINS;      // a thread a bin
constexpr int WARPS = THREADS / 32;
constexpr int NB = 223;            // a full-band channel's live bins
constexpr int LFE_BINS = 7;
constexpr int PER_LANE = 8;        // scan entries a lane: 32 x 8 >= 1 + 222
constexpr int BIG = 1 << 20;       // a scan's identity (no entry reaches it)

template <int NCH>
__global__ void __launch_bounds__(THREADS)
exponents_kernel(int* __restrict__ coef, const int* __restrict__ exp_samples,
                 int lfe, int8_t* __restrict__ enc_exp,
                 int* __restrict__ strat_out, int* __restrict__ bits_out)
{
    __shared__ int8_t fold[BLOCKS][NCH][BINS];  // raw, then folded
    __shared__ int8_t coded[WARPS][BINS];       // a warp's scanned values
    __shared__ int sums[BLOCKS][NCH];           // |diff| sums (b >= 1)
    __shared__ int strat[BLOCKS][NCH];
    __shared__ int es[BLOCKS * NCH];

    const long long row = blockIdx.x;
    const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
    int* crow = coef + row * (BLOCKS * NCH * BINS);
    if (k < BLOCKS * NCH) {
        (&sums[0][0])[k] = 0;
        es[k] = exp_samples[row * (BLOCKS * NCH) + k];
    }
    __syncthreads();

    // raw exponents, the overrange zeroing and the |diff| sums (a channel
    // at a time: unrolled over the channels, the 3-channel instance spilled)
#pragma unroll 1
    for (int c = 0; c < NCH; ++c) {
        int prev = 0;
#pragma unroll
        for (int b = 0; b < BLOCKS; ++b) {
            const int i = (b * NCH + c) * BINS + k;
            const int x = crow[i];
            const unsigned v = x < 0 ? 0u - (unsigned)x : (unsigned)x;
            int e = 24;
            if (v != 0u) {
                e = 23 - (31 - __clz(v)) + es[b * NCH + c];
                if (e >= 24) {
                    e = 24;
                    crow[i] = 0;
                }
            }
            fold[b][c][k] = (int8_t)e;
            if (b > 0) {
                const int d = e > prev ? e - prev : prev - e;
                const unsigned s = __reduce_add_sync(0xffffffffu,
                                                     (unsigned)d);
                if (lane == 0)
                    atomicAdd(&sums[b][c], (int)s);
            }
            prev = e;
        }
    }
    __syncthreads();

    // the strategy, one thread a channel
    if (k < NCH) {
        const bool is_lfe = lfe && k == NCH - 1;
        int nxt = BLOCKS;                 // the next new block after b
        for (int b = BLOCKS - 1; b >= 0; --b) {
            int s = 0;
            if (b == 0 || sums[b][k] > 1000) {
                const int run = nxt - b;
                s = is_lfe ? 1 : (run == 1 ? 3 : (run <= 3 ? 2 : 1));
                nxt = b;
            }
            strat[b][k] = s;
        }
    }
    __syncthreads();
    if (k < BLOCKS * NCH)
        strat_out[row * (BLOCKS * NCH) + k] = (&strat[0][0])[k];
    if (k == 0) {
        int bits = 0;
        for (int p = 0; p < BLOCKS * NCH; ++p) {
            const int s = (&strat[0][0])[p];
            if (s == 0)
                continue;
            const bool is_lfe = lfe && p % NCH == NCH - 1;
            const int g = is_lfe ? 1 : (s == 3 ? 4 : s);
            const int nbc = is_lfe ? LFE_BINS : NB;
            bits += 4 + ((nbc + 3 * g - 4) / (3 * g)) * 7;
        }
        bits_out[row] = bits;
    }

    // the run fold on the live bins, each thread its bin's column
#pragma unroll 1
    for (int c = 0; c < NCH; ++c) {
        if (k >= ((lfe && c == NCH - 1) ? LFE_BINS : NB))
            continue;
        int b0 = 0;
        while (b0 < BLOCKS) {
            int b1 = b0 + 1;
            while (b1 < BLOCKS && strat[b1][c] == 0)
                ++b1;
            int m = fold[b0][c][k];
            for (int b = b0 + 1; b < b1; ++b)
                m = min(m, (int)fold[b][c][k]);
            for (int b = b0; b < b1; ++b)
                fold[b][c][k] = (int8_t)m;
            b0 = b1;
        }
    }
    __syncthreads();

    // the coding, one warp a coded (block, channel)
    for (int p = warp; p < BLOCKS * NCH; p += WARPS) {
        const int b = p / NCH, c = p % NCH;
        const int s = strat[b][c];
        if (s == 0)
            continue;
        const bool is_lfe = lfe && c == NCH - 1;
        const int lg = is_lfe ? 0 : s - 1;          // log2 of the group size
        const int g = 1 << lg;
        const int nbc = is_lfe ? LFE_BINS : NB;
        const int ngroups = (nbc + 3 * g - 4) / (3 * g) * 3;
        const int nv = ngroups + 1;
        const int8_t* e = fold[b][c];
        // forward: a lane's 8 entries, v - 2i, inclusive prefix minima
        int a[PER_LANE];
        int run = BIG;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
            const int i = lane * PER_LANE + j;
            int v = BIG;
            if (i == 0) {
                v = min((int)e[0], 15) - 0;
            } else if (i < nv) {
                const int base = 1 + ((i - 1) << lg);
                v = e[base];
                for (int t = 1; t < g; ++t)
                    v = min(v, (int)e[base + t]);
                v -= 2 * i;
            }
            run = min(run, v);
            a[j] = run;
        }
        int x = run;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d)
                x = min(x, y);
        }
        int before = __shfl_up_sync(0xffffffffu, x, 1);
        if (lane == 0)
            before = BIG;
        // backward: f + 2i = min(before, a) + 4i, suffix minima
        run = BIG;
#pragma unroll
        for (int j = PER_LANE - 1; j >= 0; --j) {
            const int i = lane * PER_LANE + j;
            const int h = i < nv ? min(before, a[j]) + 4 * i : BIG;
            run = min(run, h);
            a[j] = run;
        }
        x = run;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int y = __shfl_down_sync(0xffffffffu, x, d);
            if (lane + d < 32)
                x = min(x, y);
        }
        int after = __shfl_down_sync(0xffffffffu, x, 1);
        if (lane == 31)
            after = BIG;
#pragma unroll
        for (int j = 0; j < PER_LANE; ++j) {
            const int i = lane * PER_LANE + j;
            if (i < nv)
                coded[warp][i] = (int8_t)(min(after, a[j]) - 2 * i);
        }
        __syncwarp();
        // fan out: bins 8 lane .. 8 lane + 7 as one 8-byte word
        uint32_t w[2] = {0u, 0u};
#pragma unroll
        for (int t = 0; t < 8; ++t) {
            const int bin = lane * 8 + t;
            int val = 0;
            if (bin == 0)
                val = coded[warp][0];
            else if (bin <= (ngroups << lg))
                val = coded[warp][1 + ((bin - 1) >> lg)];
            w[t >> 2] |= (uint32_t)(uint8_t)val << (8 * (t & 3));
        }
        int b1 = b + 1;
        while (b1 < BLOCKS && strat[b1][c] == 0)
            ++b1;
        for (int bb = b; bb < b1; ++bb) {
            uint2* dst = reinterpret_cast<uint2*>(
                enc_exp + ((row * BLOCKS + bb) * NCH + c) * BINS) + lane;
            *dst = make_uint2(w[0], w[1]);
        }
        __syncwarp();
    }
}

template <int NCH>
cudaError_t launch(void* coef, const void* exp_samples, int lfe,
                   void* enc_exp, void* strat, void* bits, long long N,
                   cudaStream_t s)
{
    exponents_kernel<NCH><<<(unsigned)N, THREADS, 0, s>>>(
        (int*)coef, (const int*)exp_samples, lfe, (int8_t*)enc_exp,
        (int*)strat, (int*)bits);
    return cudaGetLastError();
}

}  // namespace

extern "C" int exponents_launch(void* coef, const void* exp_samples, int lfe,
                                void* enc_exp, void* strat, void* bits,
                                long long N, int nch, void* stream)
{
    if (N == 0)
        return 0;
    if (N < 0 || N > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    lfe = lfe != 0;
    switch (nch) {
    case 1: return (int)launch<1>(coef, exp_samples, lfe, enc_exp, strat, bits, N, s);
    case 2: return (int)launch<2>(coef, exp_samples, lfe, enc_exp, strat, bits, N, s);
    case 3: return (int)launch<3>(coef, exp_samples, lfe, enc_exp, strat, bits, N, s);
    case 4: return (int)launch<4>(coef, exp_samples, lfe, enc_exp, strat, bits, N, s);
    case 5: return (int)launch<5>(coef, exp_samples, lfe, enc_exp, strat, bits, N, s);
    case 6: return (int)launch<6>(coef, exp_samples, lfe, enc_exp, strat, bits, N, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* exponents_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
