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
// Bound on the card.  The function reads each class (a byte) and writes
// each code (16 bits at the narrowest); a class-0 code is 0 whatever its
// coefficient, so it needs a coefficient (int32) and a coded exponent (a
// byte) only where the class is not 0, and a block's global exponent only
// where one of its classes is not 0.  chip_smoke.py:q1_least_bytes counts
// that from each call's own classes.  Its integer work, some sixteen
// instructions a coefficient of a class other than 0, takes less time
// than those bytes at the card's issue rate.
//
// What the design does about it.  A streaming elementwise pass: a thread
// takes 4 consecutive bins of one row (the row length is a multiple of
// 4), reads their classes as one 4-byte load and, unless all four are 0,
// their coefficients as one 16-byte load, their exponents as one 4-byte
// load (16 bytes for int32 exponents) and the row's global exponent; it
// writes the 4 codes as one 16-byte store.  A 32-byte sector of
// coefficients (two threads) or of exponents (eight) that only class-0
// bins own is never fetched: the dead bins past a channel's last live one
// and the class-0 runs of the live ones.  The output stays int32, the
// layout the packer (P1) reads.  Nothing is staged: each byte is touched
// once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int shl32(int x, long long s)
{
    return (s >= 0 && s < 32) ? (int)((unsigned)x << (int)s) : 0;
}

__device__ __forceinline__ int sar32(int x, long long s)
{
    return x >> ((s < 0 || s > 31) ? 31 : (int)s);
}

__device__ __forceinline__ int quant_one(int c, int e, int cls)
{
    if (cls >= 6 && cls <= 15) {
        const int q = cls < 14 ? cls - 1 : (cls == 14 ? 14 : 16);
        const long long ls = (long long)e + q - 24;
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

template <typename Exp>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const int4* __restrict__ coef, const Exp* __restrict__ enc,
                const int* __restrict__ gexp, const char4* __restrict__ bap,
                int4* __restrict__ out, long long n4, int row4)
{
    for (long long i = blockIdx.x * (long long)THREADS + threadIdx.x; i < n4;
         i += (long long)gridDim.x * THREADS) {
        const char4 k = bap[i];
        int4 r = make_int4(0, 0, 0, 0);
        if (k.x | k.y | k.z | k.w) {   // four of class 0 skip every load
            const int4 c = coef[i];
            const unsigned g = (unsigned)gexp[i / row4];
            int e0, e1, e2, e3;
            if constexpr (sizeof(Exp) == 4) {
                const int4 ee = reinterpret_cast<const int4*>(enc)[i];
                e0 = ee.x; e1 = ee.y; e2 = ee.z; e3 = ee.w;
            } else {
                const char4 ee = reinterpret_cast<const char4*>(enc)[i];
                e0 = ee.x; e1 = ee.y; e2 = ee.z; e3 = ee.w;
            }
            r.x = quant_one(c.x, (int)((unsigned)e0 - g), k.x);
            r.y = quant_one(c.y, (int)((unsigned)e1 - g), k.y);
            r.z = quant_one(c.z, (int)((unsigned)e2 - g), k.z);
            r.w = quant_one(c.w, (int)((unsigned)e3 - g), k.w);
        }
        out[i] = r;
    }
}

}  // namespace

extern "C" int quantize_launch(const void* coef, const void* enc,
                               int enc_int32, const void* gexp,
                               const void* bap, void* out, long long n,
                               int row, void* stream)
{
    if (n == 0)
        return 0;
    if (n < 0 || row <= 0 || row % 4 || n % row)
        return (int)cudaErrorInvalidValue;
    const long long n4 = n / 4;
    long long blocks = (n4 + THREADS - 1) / THREADS;
    if (blocks > 132 * 64)
        blocks = 132 * 64;        // a grid-stride loop past 64 CTAs an SM
    cudaStream_t s = (cudaStream_t)stream;
    if (enc_int32)
        quantize_kernel<int><<<(unsigned)blocks, THREADS, 0, s>>>(
            (const int4*)coef, (const int*)enc, (const int*)gexp,
            (const char4*)bap, (int4*)out, n4, row / 4);
    else
        quantize_kernel<int8_t><<<(unsigned)blocks, THREADS, 0, s>>>(
            (const int4*)coef, (const int8_t*)enc, (const int*)gexp,
            (const char4*)bap, (int4*)out, n4, row / 4);
    return (int)cudaGetLastError();
}

extern "C" const char* quantize_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
