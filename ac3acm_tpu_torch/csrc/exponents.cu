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
// What the design does about it.  Persistent CTAs of 256 threads (a thread
// a bin), as many as fit on each SM, walk the rows (row blockIdx, then
// + gridDim).  A row's coefficients (12 KB at 2.0, 36 KB at 5.1) arrive
// in shared memory by one bulk copy (cp.async.bulk, TMA's 1-D form) that
// completes an mbarrier; the copy of the CTA's next row is issued as soon
// as this row's raw exponents have read the stage, so it lands while the
// strategy, the fold and the coding run (and the next row's exp_samples
// are loaded at the row's start).  The raw exponents go to shared memory
// as bytes ([6][ch][256], at most 9 KB); an overranging coefficient is
// zeroed in place in device memory by a masked store; each thread's
// |diff| terms are summed per warp (__reduce_add_sync) and per CTA
// (shared atomics).  The strategy is one warp's: a lane a (block,
// channel) votes whether its block is new (__ballot_sync), reads its
// channel's 6-bit mask of new blocks out of the vote, and takes its run's
// length from the next set bit (__ffs); exp_bits is the warp's sum
// (__reduce_add_sync), and the coded (block, channel)s are listed in
// order (a ballot's prefix count) so that the coding warps share them
// evenly.  Each thread folds its bin's column into the run's first block.
// Then one warp a coded (block, channel): lane j computes the scan
// entries j, j + 32, ... from the group's bins (g consecutive bytes,
// lanes on consecutive groups: no bank conflict) into the warp's int16
// row; each lane reads its 8 consecutive entries as one 16-byte load
// (conflict-free), scans them in registers and joins the lanes with five
// shuffles each way, stores its 8 coded bytes as one 8-byte word, and the
// warp writes the 256 coded bytes as 16-byte stores (a lane's 16 bins from
// one to three words of entries by __byte_perm), half a warp a block, to
// every block of the run.  No intermediate leaves the chip.  Tensor
// cores and clusters have nothing to offer a byte-wide min-plus scan.
//
// Measured on an H100 (PERF.md): the first design, one CTA a row with 4-byte
// loads, one thread a channel for the strategy, one thread's exp_bits loop
// and 8-way bank conflicts on D45's group minima, ran at 39% / 54% of the
// byte bound.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int BLOCKS = 6;          // audio blocks a frame
constexpr int BINS = 256;
constexpr int THREADS = BINS;      // a thread a bin
constexpr int WARPS = THREADS / 32;
constexpr int NB = 223;            // a full-band channel's live bins
constexpr int LFE_BINS = 7;
constexpr int PER_LANE = 8;        // scan entries a lane: 32 x 8 >= 1 + 222
constexpr int BIG = 1 << 20;       // a scan's identity (no entry reaches it)

// the CTAs an SM the registers are sized for: 5 up to two channels, 4
// above (registers for 3 ran no faster on an H100, PERF.md)
__host__ __device__ constexpr int ctas_for(int nch)
{
    return nch <= 2 ? 5 : 4;
}

// shared memory (bytes) of the NCH instance: the coefficient stage, the
// raw / folded exponents, each warp's scan row (int16) and coded bytes,
// the sums, strategies, exp_samples and the coded list, the mbarrier
template <int NCH>
struct Smem {
    static constexpr int NST = BLOCKS * NCH;
    static constexpr int STAGE = 0;
    static constexpr int FOLD = STAGE + 4 * NST * BINS;
    static constexpr int VROW = FOLD + NST * BINS;
    static constexpr int CODED = VROW + 2 * WARPS * BINS;
    static constexpr int INTS = CODED + WARPS * BINS;
    static constexpr int BAR = (INTS + 4 * (4 * NST + 4) + 15) & ~15;
    static constexpr int BYTES = BAR + 16;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// into shared memory, completing the mbarrier's current phase
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar)
{
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
                 "::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar))
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    asm volatile("{\n"
                 ".reg .pred done;\n"
                 "WAIT_%=:\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
                 "@!done bra WAIT_%=;\n"
                 "}\n"
                 :: "r"(smem_addr(bar)), "r"(parity) : "memory");
}

template <int NCH>
__global__ void __launch_bounds__(THREADS, ctas_for(NCH))
exponents_kernel(int* __restrict__ coef, const int* __restrict__ exp_samples,
                 int lfe, int8_t* __restrict__ enc_exp,
                 int* __restrict__ strat_out, int* __restrict__ bits_out,
                 long long N)
{
    using S = Smem<NCH>;
    constexpr int NST = S::NST;
    extern __shared__ __align__(16) unsigned char smem[];
    const int* stage = reinterpret_cast<const int*>(smem + S::STAGE);
    int8_t* fold = reinterpret_cast<int8_t*>(smem + S::FOLD);  // [b][c][k]
    int16_t* vrow = reinterpret_cast<int16_t*>(smem + S::VROW);
    int8_t* coded = reinterpret_cast<int8_t*>(smem + S::CODED);
    int* sums = reinterpret_cast<int*>(smem + S::INTS);        // [b * NCH + c]
    int* strat = sums + NST;
    int* es = strat + NST;
    int* list = es + NST;                                      // coded pairs
    int* ncoded = list + NST;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::BAR);

    const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
    constexpr uint32_t ROW_BYTES = 4u * NST * BINS;
    long long r = blockIdx.x;
    if (k == 0) {
        mbar_init(bar);
        if (r < N)
            bulk_load(smem + S::STAGE, coef + r * (NST * BINS), ROW_BYTES,
                      bar);
    }
    int es_next = (k < NST && r < N) ? __ldg(exp_samples + r * NST + k) : 0;
    // the mbarrier is set up before any thread waits on it
    __syncthreads();

    for (uint32_t phase = 0; r < N; r += gridDim.x, phase ^= 1u) {
        const long long rn = r + gridDim.x;       // this CTA's next row
        if (k < NST) {
            es[k] = es_next;
            sums[k] = 0;
            if (rn < N)
                es_next = __ldg(exp_samples + rn * NST + k);
        }
        mbar_wait(bar, phase);
        // the row has landed; es and sums are set; the last row's coding
        // is done with fold, strat and the list
        __syncthreads();

        // raw exponents, the overrange zeroing and the |diff| sums (a
        // channel at a time)
        int* crow = coef + r * (NST * BINS);
#pragma unroll 1
        for (int c = 0; c < NCH; ++c) {
            int prev = 0;
#pragma unroll
            for (int b = 0; b < BLOCKS; ++b) {
                const int i = (b * NCH + c) * BINS + k;
                const int x = stage[i];
                const unsigned v = x < 0 ? 0u - (unsigned)x : (unsigned)x;
                int e = 24;
                if (v != 0u) {
                    e = 23 - (31 - __clz(v)) + es[b * NCH + c];
                    if (e >= 24) {
                        e = 24;
                        crow[i] = 0;
                    }
                }
                fold[i] = (int8_t)e;
                if (b > 0) {
                    const int d = e > prev ? e - prev : prev - e;
                    const unsigned s = __reduce_add_sync(0xffffffffu,
                                                         (unsigned)d);
                    if (lane == 0)
                        atomicAdd(&sums[b * NCH + c], (int)s);
                }
                prev = e;
            }
        }
        __syncthreads();
        // the stage is read: the next row's copy runs under the rest
        if (k == 0 && rn < N)
            bulk_load(smem + S::STAGE, coef + rn * (NST * BINS), ROW_BYTES,
                      bar);

        // the strategy: one warp, a lane a (block, channel)
        if (warp == 0) {
            uint32_t vote[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int p = lane + 32 * h;
                vote[h] = __ballot_sync(0xffffffffu, p < NST
                                        && (p < NCH || sums[p] > 1000));
            }
            const unsigned long long m = vote[0]
                                         | ((unsigned long long)vote[1] << 32);
            int bits = 0, s_of[2] = {0, 0};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int p = lane + 32 * h;
                if (p >= NST)
                    continue;
                const int b = p / NCH, c = p - b * NCH;
                uint32_t chmask = 0;          // the channel's new blocks
#pragma unroll
                for (int bb = 0; bb < BLOCKS; ++bb)
                    chmask |= (uint32_t)((m >> (bb * NCH + c)) & 1u) << bb;
                int s = 0;
                if ((chmask >> b) & 1u) {
                    const bool is_lfe = lfe && c == NCH - 1;
                    const uint32_t above = chmask >> (b + 1);
                    const int run = above ? __ffs(above) : BLOCKS - b;
                    s = is_lfe ? 1 : (run == 1 ? 3 : (run <= 3 ? 2 : 1));
                    const int g = is_lfe ? 1 : (s == 3 ? 4 : s);
                    const int nbc = is_lfe ? LFE_BINS : NB;
                    bits += 4 + ((nbc + 3 * g - 4) / (3 * g)) * 7;
                }
                s_of[h] = s;
                strat[p] = s;
                strat_out[r * NST + p] = s;
            }
            bits = (int)__reduce_add_sync(0xffffffffu, (unsigned)bits);
            if (lane == 0)
                bits_out[r] = bits;
            // the coded pairs in order, for the coding warps
            int base = 0;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int p = lane + 32 * h;
                const uint32_t q = __ballot_sync(0xffffffffu,
                                                 p < NST && s_of[h] != 0);
                if (p < NST && s_of[h] != 0)
                    list[base + __popc(q & ((1u << lane) - 1u))] = p;
                base += __popc(q);
            }
            if (lane == 0)
                *ncoded = base;
        }
        __syncthreads();

        // the run fold on the live bins, each thread its bin's column,
        // into the run's first (coded) block: the only one the coding reads
#pragma unroll 1
        for (int c = 0; c < NCH; ++c) {
            if (k >= ((lfe && c == NCH - 1) ? LFE_BINS : NB))
                continue;
            int b0 = 0;
            while (b0 < BLOCKS) {
                int b1 = b0 + 1;
                while (b1 < BLOCKS && strat[b1 * NCH + c] == 0)
                    ++b1;
                int m = fold[(b0 * NCH + c) * BINS + k];
                for (int b = b0 + 1; b < b1; ++b)
                    m = min(m, (int)fold[(b * NCH + c) * BINS + k]);
                fold[(b0 * NCH + c) * BINS + k] = (int8_t)m;
                b0 = b1;
            }
        }
        __syncthreads();

        // the coding, one warp a coded (block, channel)
        int16_t* vr = vrow + warp * BINS;
        int8_t* cw = coded + warp * BINS;
        for (int j = warp; j < *ncoded; j += WARPS) {
            const int p = list[j];
            const int b = p / NCH, c = p - b * NCH;
            const int s = strat[p];
            const bool is_lfe = lfe && c == NCH - 1;
            const int lg = is_lfe ? 0 : s - 1;          // log2 of the group size
            const int g = 1 << lg;
            const int nbc = is_lfe ? LFE_BINS : NB;
            const int ngroups = (nbc + 3 * g - 4) / (3 * g) * 3;
            const int nv = ngroups + 1;
            const int8_t* e = fold + p * BINS;
            // entry i = lane + 32 t from its group's g bytes, minus 2i
#pragma unroll
            for (int t = 0; t < PER_LANE; ++t) {
                const int i = lane + 32 * t;
                if (i >= nv)
                    break;
                int v;
                if (i == 0) {
                    v = min((int)e[0], 15);
                } else {
                    const int base = 1 + ((i - 1) << lg);
                    v = e[base];
                    for (int u = 1; u < g; ++u)
                        v = min(v, (int)e[base + u]);
                    v -= 2 * i;
                }
                vr[i] = (int16_t)v;
            }
            __syncwarp();
            // forward: a lane's 8 consecutive entries (one 16-byte load),
            // inclusive prefix minima
            const int4 raw = reinterpret_cast<const int4*>(vr)[lane];
            const int w[4] = {raw.x, raw.y, raw.z, raw.w};
            int a[PER_LANE];
            int run = BIG;
#pragma unroll
            for (int t = 0; t < PER_LANE; ++t) {
                const int i = lane * PER_LANE + t;
                const int half = (t & 1) ? (w[t >> 1] >> 16)
                                         : (int)(int16_t)(w[t >> 1] & 0xFFFF);
                run = min(run, i < nv ? half : BIG);
                a[t] = run;
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
            for (int t = PER_LANE - 1; t >= 0; --t) {
                const int i = lane * PER_LANE + t;
                const int h = i < nv ? min(before, a[t]) + 4 * i : BIG;
                run = min(run, h);
                a[t] = run;
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
            uint32_t word[2] = {0u, 0u};
#pragma unroll
            for (int t = 0; t < PER_LANE; ++t) {
                const int i = lane * PER_LANE + t;
                const int val = i < nv ? min(after, a[t]) - 2 * i : 0;
                word[t >> 2] |= (uint32_t)(uint8_t)val << (8 * (t & 3));
            }
            reinterpret_cast<uint2*>(cw)[lane] = make_uint2(word[0], word[1]);
            __syncwarp();
            // fan out: bin 16 m + t (m = lane % 16) takes entry
            // (16 m >> lg) + ((t + g - 1) >> lg), 0 past the groups (the
            // entries past nv are 0): 16 bytes out of 16, 9 or 5 entries
            // by __byte_perm, one store, half a warp a block of the run
            const int m = lane & 15;
            const uint32_t* cw32 = reinterpret_cast<const uint32_t*>(cw);
            uint4 out;
            if (lg == 0) {
                out = reinterpret_cast<const uint4*>(cw)[m];
            } else if (lg == 1) {
                const uint32_t x = cw32[2 * m], y = cw32[2 * m + 1];
                const uint32_t z = cw32[2 * m + 2];
                out = make_uint4(__byte_perm(x, y, 0x2110),
                                 __byte_perm(x, y, 0x4332),
                                 __byte_perm(y, z, 0x2110),
                                 __byte_perm(y, z, 0x4332));
            } else {
                const uint32_t x = cw32[m], y = cw32[m + 1];
                out = make_uint4(__byte_perm(x, y, 0x1110),
                                 __byte_perm(x, y, 0x2221),
                                 __byte_perm(x, y, 0x3332),
                                 __byte_perm(x, y, 0x4443));
            }
            int b1 = b + 1;
            while (b1 < BLOCKS && strat[b1 * NCH + c] == 0)
                ++b1;
            for (int bb = b + (lane >> 4); bb < b1; bb += 2)
                reinterpret_cast<uint4*>(
                    enc_exp + ((r * BLOCKS + bb) * NCH + c) * BINS)[m] = out;
            __syncwarp();
        }
    }
}

// the CTAs an SM holds of the NCH instance
template <int NCH>
cudaError_t resident(int* per_sm)
{
    cudaError_t e = cudaFuncSetAttribute(
        exponents_kernel<NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<NCH>::BYTES);
    if (e != cudaSuccess)
        return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, exponents_kernel<NCH>, THREADS, Smem<NCH>::BYTES);
}

// the CTAs the card holds at once (its SMs times the CTAs an SM) of the
// NCH instance, asked of the runtime (and the shared-memory attribute set)
// once a device, then remembered
constexpr int MAX_DEVICES = 64;

template <int NCH>
cudaError_t card_ctas(long long* ctas)
{
    static std::mutex mu;
    static long long seen[MAX_DEVICES];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess)
        return e;
    if (dev < 0 || dev >= MAX_DEVICES)
        return cudaErrorInvalidDevice;
    std::lock_guard<std::mutex> hold(mu);
    if (seen[dev] == 0) {
        int per_sm = 0, sms = 0;
        e = resident<NCH>(&per_sm);
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e != cudaSuccess)
            return e;
        if (per_sm < 1)
            return cudaErrorInvalidConfiguration;
        seen[dev] = (long long)sms * per_sm;
    }
    *ctas = seen[dev];
    return cudaSuccess;
}

template <int NCH>
cudaError_t launch(void* coef, const void* exp_samples, int lfe,
                   void* enc_exp, void* strat, void* bits, long long N,
                   cudaStream_t s)
{
    long long card = 0;
    const cudaError_t e = card_ctas<NCH>(&card);
    if (e != cudaSuccess)
        return e;
    const long long ctas = N < card ? N : card;
    exponents_kernel<NCH><<<(unsigned)ctas, THREADS, Smem<NCH>::BYTES, s>>>(
        (int*)coef, (const int*)exp_samples, lfe, (int8_t*)enc_exp,
        (int*)strat, (int*)bits, N);
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

// the CTAs X1 keeps on one SM for nch channels (each walks rows); a
// negative CUDA error code on failure
extern "C" int exponents_resident(int nch)
{
    int per_sm = 0;
    cudaError_t e = cudaErrorInvalidValue;
    switch (nch) {
    case 1: e = resident<1>(&per_sm); break;
    case 2: e = resident<2>(&per_sm); break;
    case 3: e = resident<3>(&per_sm); break;
    case 4: e = resident<4>(&per_sm); break;
    case 5: e = resident<5>(&per_sm); break;
    case 6: e = resident<6>(&per_sm); break;
    default: break;
    }
    return e == cudaSuccess ? per_sm : -(int)e;
}

extern "C" const char* exponents_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
