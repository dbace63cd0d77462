// Q1: the encoder's quantizer for Hopper (sm_90a): a code per coefficient
// by its bap class, in one launch.
//
// Replaces what the JAX package leaves to XLA inside the encoder's frame
// core (no pallas_call): ac3acm_tpu/models/encoder.py:148-180 quantize
// (_sym_quant, _asym_quant and the per-class select).  In the port it ran
// as about twenty eager passes over int64 words (ops/quantize.py:
// quantize_ref, the plain version), whose temporaries set the encoder's
// peak memory.
//
// Per coefficient c (int32) with exponent difference e = enc_exp -
// global_exp (int32, wrapping) and class cls:
//
//   cls 0         0
//   cls 1..5      L = 3, 5, 7, 11, 15; x = |c| << e; v = (((L x) >> 24)
//                 + 1) >> 1; L/2 + v if c >= 0, else L/2 - v
//   cls 6..15     q = cls - 1 (6..13), 14, 16; s = e + q - 24 (exact);
//                 v = c << s if s >= 0, else c >> -s; v = (v + 1) >> 1;
//                 min(v, 2^(q-1) - 1) & (2^q - 1)
//
// with XLA's int32 semantics, which C++ leaves undefined and so are
// written out here: |c|, L x and v + 1 wrap (unsigned arithmetic); a left
// shift by a count outside [0, 31] gives 0; an arithmetic right shift by
// one fills with the sign.  A class outside 0..15 gives 0.
//
// Codes leave in one of two forms, a template parameter: int32, the value
// above (JAX's dtype, what the public functions return), or int16, its low
// 16 bits (every code of the encoder fits 16 bits: classes 1-5 give 0..14,
// classes 6-15 are masked to q <= 16 bits).  A reader widens an int16 code
// as unsigned (& 0xFFFF): class-15 codes from 32,768 up are negative as
// int16.  The device-pack path hands the int16 form to the packer (P1).
//
// Bound on the card.  The function reads each class (a byte) and writes
// each code (16 bits at the narrowest); a class-0 code is 0 whatever its
// coefficient, so it needs a coefficient (int32) and a coded exponent (a
// byte) only where the class is not 0, and a block's global exponent only
// where one of its classes is not 0.  chip_smoke.py:q1_least_bytes counts
// that from each call's own classes.  Its integer work, some sixteen
// instructions a coefficient of a class other than 0, takes less time
// than those bytes at the card's issue rate.  The int32 form writes twice
// the codes' bytes, so at the card's full rate it reaches at most about
// 60% of that bound.
//
// What the design does about it.  A streaming pass whose bytes are its
// classes in and its codes out; about 1% of the encoder's bins carry a
// class, but most warps' 512 bins hold some:
//  * a thread takes a chunk of 16 consecutive bins of one row (the row
//    length is a multiple of 16), its classes one 16-byte load, the 32
//    lanes of a warp consecutive chunks; the next pass's class loads are
//    issued before the thread branches on this pass's classes;
//  * the warp lists its quads of 4 bins whose classes are not all 0 (a
//    ballot a quad position) and its lanes share them out, a quad a lane:
//    the lane loads the quad's 4 coefficients (16 bytes), its 4 exponents
//    (4 bytes as int8, 16 as int32) and its row's global exponent (the row
//    index by a 32-bit division), all the warp's such loads in flight at
//    once.  The first design's lane coded its own 16 bins, the others
//    idle;
//  * the passes are pipelined: a pass's coded loads are issued, then the
//    pass before computes its codes from the loads it issued and stores,
//    so a warp waits on no load issued in the same pass (a pass past the
//    first 32 coded quads takes the rest at once, in its own pass);
//  * every shift count is clamped to [-64, 64] first (any count outside
//    [-31, 31] shifts as one at that end does), so no arithmetic is wider
//    than 32 bits;
//  * the codes gather in the warp's slice of shared memory (zeros, then the
//    coded quads), and lane l stores the warp's 16-byte words l, l + 32,
//    ...: two 512-byte runs a pass as int16, four as int32.  A lane that
//    stored its own chunk's words, 32 or 64 bytes from its neighbour's, ran
//    the int32 form slower than the first design;
//  * the grid is the CTAs the card holds at once (its SMs times the CTAs
//    an SM, asked of the runtime once a device), fewer for a call of fewer
//    chunks than threads.
// Each byte of device memory is touched once.

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>

namespace {

constexpr int THREADS = 256;
constexpr int LANES = 32;
constexpr int CHUNK = 16;        // bins a thread takes at once

__device__ __forceinline__ int shl32(int x, int s)
{
    return (s >= 0 && s < 32) ? (int)((unsigned)x << s) : 0;
}

__device__ __forceinline__ int sar32(int x, int s)
{
    return x >> ((s < 0 || s > 31) ? 31 : s);
}

__device__ __forceinline__ int quant_one(int c, int e, int cls)
{
    // e past +-64 shifts as +-64 does (every count then leaves [-31, 31]
    // the same way), so e + q - 24 is exact in 32 bits
    e = max(-64, min(e, 64));
    if (cls >= 6 && cls <= 15) {
        const int q = cls < 14 ? cls - 1 : (cls == 14 ? 14 : 16);
        const int ls = e + q - 24;
        int v = ls >= 0 ? shl32(c, ls) : sar32(c, -ls);
        v = (int)((unsigned)v + 1u) >> 1;
        const int m = 1 << (q - 1);
        if (v >= m)
            v = m - 1;
        return v & ((1 << q) - 1);
    }
    if (cls >= 1 && cls <= 5) {
        const int L = cls == 1 ? 3 : cls == 2 ? 5 : cls == 3 ? 7
                    : cls == 4 ? 11 : 15;
        const unsigned a = c < 0 ? 0u - (unsigned)c : (unsigned)c;
        const int x = shl32((int)a, e);
        const int p = (int)((unsigned)L * (unsigned)x);
        const int v = ((p >> 24) + 1) >> 1;
        return c >= 0 ? (L >> 1) + v : (L >> 1) - v;
    }
    return 0;
}

__device__ __forceinline__ int lane_of(const int4& v, int j)
{
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// two codes as one word of int16s (the first in the low half)
__device__ __forceinline__ int pair16(int a, int b)
{
    return (int)(((unsigned)a & 0xFFFFu) | ((unsigned)b << 16));
}

// the 16-byte words of a chunk's codes: 2 of int16, 4 of int32
template <typename Code>
__host__ __device__ constexpr int words_of()
{
    return CHUNK * (int)sizeof(Code) / 16;
}

// word q of a warp's chunk c in its staging slice: 8 lanes' 16-byte
// accesses (a shared-memory phase) land in 8 distinct bank groups both
// when each lane writes word q of its own chunk and when 8 lanes read 8
// consecutive words of the warp's codes
template <int V>
__device__ __forceinline__ int slot(int c, int q)
{
    return c * V + (q ^ ((c / (8 / V)) & (V - 1)));
}

// a coded quad (4 bins whose classes w are not all 0) of a warp's chunk c
// at position q: its coefficients, exponents and global exponent, loaded
template <typename Exp>
struct Quad {
    int4 cf;
    int4 ex;             // int32 exponents; int8 ones packed in ex.x
    unsigned ge, w;
    int c, q;
};

// the loads of the quad that item e of a warp whose first chunk is
// `first` lists ((c << 2 | q), w)
template <typename Exp>
__device__ __forceinline__ void quad_load(
    Quad<Exp>& d, const int4* __restrict__ coef, const Exp* __restrict__ enc,
    const int* __restrict__ gexp, unsigned row16, unsigned first, uint2 e)
{
    d.c = (int)(e.x >> 2);
    d.q = (int)(e.x & 3u);
    d.w = e.y;
    const unsigned chunk = first + d.c;
    const size_t g = (size_t)chunk * 4 + d.q;
    d.cf = __ldg(coef + g);
    if constexpr (sizeof(Exp) == 4)
        d.ex = __ldg(reinterpret_cast<const int4*>(enc) + g);
    else
        d.ex.x = (int)__ldg(reinterpret_cast<const unsigned*>(enc) + g);
    d.ge = (unsigned)__ldg(gexp + chunk / row16);
}

// a loaded quad's 4 codes into the warp's stage
template <typename Exp, typename Code>
__device__ __forceinline__ void quad_codes(const Quad<Exp>& d, int4* st)
{
    int r[4];
#pragma unroll
    for (int b = 0; b < 4; b++) {
        const int e = sizeof(Exp) == 4 ? lane_of(d.ex, b)
                                       : (int)(int8_t)((unsigned)d.ex.x
                                                       >> (8 * b));
        r[b] = quant_one(lane_of(d.cf, b), (int)((unsigned)e - d.ge),
                         (int)(int8_t)(d.w >> (8 * b)));
    }
    if constexpr (sizeof(Code) == 2)
        reinterpret_cast<int2*>(st)[slot<2>(d.c, d.q >> 1) * 2 + (d.q & 1)] =
            make_int2(pair16(r[0], r[1]), pair16(r[2], r[3]));
    else
        st[slot<4>(d.c, d.q)] = make_int4(r[0], r[1], r[2], r[3]);
}

template <typename Exp, typename Code>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const int4* __restrict__ coef, const Exp* __restrict__ enc,
                const int* __restrict__ gexp, const int4* __restrict__ bap,
                Code* __restrict__ out, unsigned nchunks, unsigned row16)
{
    constexpr int V = words_of<Code>();
    // a warp's 32 chunks of codes, and its coded quads ((chunk << 2 |
    // position), classes)
    __shared__ int4 stage[THREADS * V];
    __shared__ uint2 items[THREADS * 4];
    const int lane = threadIdx.x & (LANES - 1);
    const int warp0 = threadIdx.x - lane;
    int4* st = stage + warp0 * V;
    uint2* it = items + warp0 * 4;
    const unsigned below = (1u << lane) - 1u;
    const unsigned stride = gridDim.x * THREADS;
    // lanes take consecutive chunks: i0 - lane, the warp's first, is the
    // same on every lane, so every branch on it is warp-uniform
    unsigned i0 = blockIdx.x * THREADS + threadIdx.x;
    int4 next = i0 < nchunks ? __ldg(bap + i0) : make_int4(0, 0, 0, 0);
    // the last pass's coded quad of this lane, its loads in flight
    Quad<Exp> prev;
    bool has_prev = false, had_pass = false;
    unsigned prev_first = 0;
    for (;; i0 += stride) {
        const unsigned first = i0 - lane;
        const bool live = first < nchunks;
        Quad<Exp> cur;
        bool has_cur = false;
        int n = 0;
        if (live) {
            const int4 k = next;
            // the next pass's classes in flight before any branch on these
            const unsigned i1 = i0 + stride;
            next = i1 < nchunks ? __ldg(bap + i1) : make_int4(0, 0, 0, 0);
            const unsigned w[4] = {(unsigned)k.x, (unsigned)k.y,
                                   (unsigned)k.z, (unsigned)k.w};
            // the warp's coded quads, listed in (position, lane) order
#pragma unroll
            for (int q = 0; q < 4; q++) {
                const bool coded = w[q] != 0u;
                const unsigned m = __ballot_sync(0xffffffffu, coded);
                if (coded)
                    it[n + __popc(m & below)] =
                        make_uint2((unsigned)(lane << 2 | q), w[q]);
                n += __popc(m);
            }
            __syncwarp();
            // a quad a lane: its loads in flight while the last pass ends
            if (lane < n) {
                quad_load(cur, coef, enc, gexp, row16, first, it[lane]);
                has_cur = true;
            }
        }
        // the last pass: its first 32 coded quads' codes, then its store
        if (had_pass) {
            if (has_prev)
                quad_codes<Exp, Code>(prev, st);
            __syncwarp();
            int4* o = reinterpret_cast<int4*>(out) + (size_t)prev_first * V;
#pragma unroll
            for (int j = 0; j < V; j++) {
                const int t = j * LANES + lane, c = t / V;
                if (prev_first + c < nchunks)
                    o[t] = st[slot<V>(c, t % V)];
            }
            __syncwarp();
        }
        if (!live)
            break;
        // this pass's stage: zeros, then any coded quads past the first 32
        // at once
#pragma unroll
        for (int q = 0; q < V; q++)
            st[slot<V>(lane, q)] = make_int4(0, 0, 0, 0);
        __syncwarp();
        for (int j = lane + LANES; j < n; j += LANES) {
            Quad<Exp> d;
            quad_load(d, coef, enc, gexp, row16, first, it[j]);
            quad_codes<Exp, Code>(d, st);
        }
        __syncwarp();
        prev = cur;
        has_prev = has_cur;
        had_pass = true;
        prev_first = first;
    }
}

// the CTAs the card holds at once of one instance (its SMs times the CTAs
// an SM), asked of the runtime once a device, then remembered
template <typename Exp, typename Code>
cudaError_t card_ctas(long long* ctas)
{
    static std::mutex mu;
    static std::map<int, long long> seen;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess)
        return e;
    std::lock_guard<std::mutex> hold(mu);
    const auto it = seen.find(dev);
    if (it != seen.end()) {
        *ctas = it->second;
        return cudaSuccess;
    }
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quantize_kernel<Exp, Code>, THREADS, 0);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess)
        return e;
    if (per_sm < 1)
        return cudaErrorInvalidConfiguration;
    *ctas = seen[dev] = (long long)sms * per_sm;
    return cudaSuccess;
}

template <typename Exp, typename Code>
cudaError_t launch(const void* coef, const void* enc, const void* gexp,
                   const void* bap, void* out, long long n, int row,
                   cudaStream_t s)
{
    long long card = 0;
    const cudaError_t e = card_ctas<Exp, Code>(&card);
    if (e != cudaSuccess)
        return e;
    const long long nchunks = n / CHUNK;
    const long long need = (nchunks + THREADS - 1) / THREADS;
    const long long ctas = need < card ? need : card;
    quantize_kernel<Exp, Code><<<(unsigned)ctas, THREADS, 0, s>>>(
        (const int4*)coef, (const Exp*)enc, (const int*)gexp,
        (const int4*)bap, (Code*)out, (unsigned)nchunks,
        (unsigned)(row / CHUNK));
    return cudaGetLastError();
}

template <typename Exp>
cudaError_t launch_exp(const void* coef, const void* enc, const void* gexp,
                       const void* bap, void* out, int code_bytes,
                       long long n, int row, cudaStream_t s)
{
    return code_bytes == 2
        ? launch<Exp, int16_t>(coef, enc, gexp, bap, out, n, row, s)
        : launch<Exp, int32_t>(coef, enc, gexp, bap, out, n, row, s);
}

}  // namespace

// n codes of rows of `row` bins (a multiple of 16), each tensor 16-byte
// aligned; enc int32 or int8, the codes int16 (code_bytes 2) or int32 (4)
extern "C" int quantize_launch(const void* coef, const void* enc,
                               int enc_int32, const void* gexp,
                               const void* bap, void* out, int code_bytes,
                               long long n, int row, void* stream)
{
    if (n == 0)
        return 0;
    if (n < 0 || row <= 0 || row % CHUNK || n % row
        || n / CHUNK > 0x3fffffffLL || (code_bytes != 2 && code_bytes != 4))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)(enc_int32
        ? launch_exp<int>(coef, enc, gexp, bap, out, code_bytes, n, row, s)
        : launch_exp<int8_t>(coef, enc, gexp, bap, out, code_bytes, n, row,
                             s));
}

extern "C" const char* quantize_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
