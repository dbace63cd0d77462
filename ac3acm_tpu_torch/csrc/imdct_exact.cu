// Order-exact float IMDCT (z, d) split for Hopper (sm_90a): B1.
//
// The function of ac3acm_tpu_torch/ops/imdct_exact.py:split_fb_exact, the
// counterpart of ac3acm_tpu/ops/imdct_exact.py:imdct512_z / imdct256_z
// (XLA there; no pallas_call).  Per row of 256 coefficients:
//
//   long row   a52_imdct_512 (imdct.c:258-293): pre-twiddle of the
//              fftorder-permuted pairs, the 128-point split-radix IFFT,
//              post-twiddle, scatter to z [256] (the "- a*w" terms as a
//              sign flip) and d [128]
//   short row  a52_imdct_256 (imdct.c:295-345): the same with two
//              64-point IFFTs of the interleaved halves
//
// Bit-identical to the compiled float liba52.  Every multiply is
// __fmul_rn and every add or subtract __fadd_rn / __fsub_rn, which nvcc
// never contracts into an FFMA (its default --fmad=true would otherwise
// fuse a product into the add that follows it and move the result by an
// ulp); each butterfly takes its operands in the reference's order.  The
// twiddles are the float32 tables of tables.imdct_twiddles(), packed by
// the wrapper (ops/imdct_exact.py:_PACKED names the offsets below); they
// are never recomputed on the card.
//
// Bound on the card: bytes.  A row reads 1 KB of coefficients and writes
// 1.5 KB of (z, d), against about 4,400 FP32 operations: at the main
// path's chunk (786,432 rows) 2.01 GB, 0.601 ms at 3.35 TB/s, where the
// operations take 0.05 ms at 67 TFLOP/s.
//
// What the design does about it: it is the simple one.  One warp a row,
// 8 rows a CTA.  The row is staged in shared memory with coalesced
// 16-byte loads; the IFFT runs in place on the row's 128 complex values
// in shared memory, level by level (the leaves, ifft8 and ifft4, one per
// lane in registers; then each ifft_pass level, one butterfly per lane),
// with __syncwarp between levels; z and d are staged in shared memory and
// written with 16-byte stores.  A level's butterflies are independent, so
// this schedule computes every value with the reference's own operations.
// Fusing the window, the OLA chain and int16 into it, as the fused steady
// kernel does for the matmul path, is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                // rows a CTA, one warp a row

// packed twiddle table (floats), ops/imdct_exact.py:_PACKED
enum : int {
    PRE1_R = 0, PRE1_I = 128, POST1_R = 256, POST1_I = 320,
    PRE2_R = 384, PRE2_I = 448, POST2_R = 512, POST2_I = 544,
    ROOTS16 = 576, ROOTS32 = 579, ROOTS64 = 586, ROOTS128 = 601,
    TAB_SIZE = 632
};

// the split-radix recursion (ifft 4n = ifft 2n, ifft n, ifft n, pass n)
// unrolled: leaf offsets (ifft8 flagged with 0x100, else ifft4) and the
// node offsets of each ifft_pass level, for the 128-point IFFT of a long
// row and the two 64-point IFFTs (at 0 and 64) of a short row
__constant__ int LEAVES_LONG[21] = {
    0x100 | 0, 0x100 | 16, 0x100 | 24, 0x100 | 32, 0x100 | 48, 0x100 | 64,
    0x100 | 80, 0x100 | 88, 0x100 | 96, 0x100 | 112, 0x100 | 120,
    8, 12, 40, 44, 56, 60, 72, 76, 104, 108};
__constant__ int LEAVES_SHORT[22] = {
    0x100 | 0, 0x100 | 16, 0x100 | 24, 0x100 | 32, 0x100 | 48, 0x100 | 64,
    0x100 | 80, 0x100 | 88, 0x100 | 96, 0x100 | 112,
    8, 12, 40, 44, 56, 60, 72, 76, 104, 108, 120, 124};
__constant__ int PASS16_LONG[5] = {0, 32, 48, 64, 96};
__constant__ int PASS32_LONG[3] = {0, 64, 96};
__constant__ int PASS16_SHORT[6] = {0, 32, 48, 64, 96, 112};
__constant__ int PASS_0_64[2] = {0, 64};     // 128-point pass; ifft32/64 x2

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the four butterflies of imdct.c, in place on (a0, a1, a2, a3); the
// outputs keep the inputs' slots: a0 + t, a1 + t', a0 - t, a1 - t'
__device__ __forceinline__ void finish(float& a0r, float& a0i, float& a1r,
                                       float& a1i, float& a2r, float& a2i,
                                       float& a3r, float& a3i, float t1,
                                       float t2, float t3, float t4)
{
    const float b0r = a0r, b0i = a0i, b1r = a1r, b1i = a1i;
    a0r = add(b0r, t1); a0i = add(b0i, t2);
    a1r = add(b1r, t3); a1i = add(b1i, t4);
    a2r = sub(b0r, t1); a2i = sub(b0i, t2);
    a3r = sub(b1r, t3); a3i = sub(b1i, t4);
}

__device__ __forceinline__ void bf_zero(float& a0r, float& a0i, float& a1r,
                                        float& a1i, float& a2r, float& a2i,
                                        float& a3r, float& a3i)
{
    const float t1 = add(a2r, a3r), t2 = add(a2i, a3i);
    const float t3 = sub(a2i, a3i), t4 = sub(a3r, a2r);
    finish(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, t1, t2, t3, t4);
}

__device__ __forceinline__ void bf_half(float& a0r, float& a0i, float& a1r,
                                        float& a1i, float& a2r, float& a2i,
                                        float& a3r, float& a3i, float w)
{
    const float t5 = mul(add(a2r, a2i), w), t6 = mul(sub(a2i, a2r), w);
    const float t7 = mul(sub(a3r, a3i), w), t8 = mul(add(a3i, a3r), w);
    finish(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i,
           add(t5, t7), add(t6, t8), sub(t6, t8), sub(t7, t5));
}

__device__ __forceinline__ void bf(float& a0r, float& a0i, float& a1r,
                                   float& a1i, float& a2r, float& a2i,
                                   float& a3r, float& a3i, float wr, float wi)
{
    const float t5 = add(mul(wi, a2i), mul(wr, a2r));
    const float t6 = sub(mul(wr, a2i), mul(wi, a2r));
    const float t8 = add(mul(wi, a3r), mul(wr, a3i));
    const float t7 = sub(mul(wr, a3r), mul(wi, a3i));
    finish(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i,
           add(t5, t7), add(t6, t8), sub(t6, t8), sub(t7, t5));
}

__device__ __forceinline__ void ifft2(float* r, float* i)
{
    const float r0 = r[0], i0 = i[0];
    r[0] = add(r0, r[1]); r[1] = sub(r0, r[1]);
    i[0] = add(i0, i[1]); i[1] = sub(i0, i[1]);
}

__device__ __forceinline__ void ifft4(float* r, float* i)
{
    const float t1 = add(r[0], r[1]), t2 = add(r[3], r[2]);
    const float t3 = add(i[0], i[1]), t4 = add(i[2], i[3]);
    const float t5 = sub(r[0], r[1]), t6 = sub(i[0], i[1]);
    const float t7 = sub(i[2], i[3]), t8 = sub(r[3], r[2]);
    r[0] = add(t1, t2); r[1] = add(t5, t7); r[2] = sub(t1, t2); r[3] = sub(t5, t7);
    i[0] = add(t3, t4); i[1] = add(t6, t8); i[2] = sub(t3, t4); i[3] = sub(t6, t8);
}

// ifft8: ifft4 on [0, 4), ifft2 on [4, 6) and [6, 8), then bf_zero on
// slots 0/2/4/6 and bf_half on 1/3/5/7 (whose outputs are the reference's
// order [a0, b0, a1, b1, a2, b2, a3, b3])
__device__ __forceinline__ void ifft8(float* r, float* i, float w)
{
    ifft4(r, i);
    ifft2(r + 4, i + 4);
    ifft2(r + 6, i + 6);
    bf_zero(r[0], i[0], r[2], i[2], r[4], i[4], r[6], i[6]);
    bf_half(r[1], i[1], r[3], i[3], r[5], i[5], r[7], i[7], w);
}

// the leaves of one IFFT level 0, one per lane, in registers
__device__ __forceinline__ void leaves(float* re, float* im, const int* list,
                                       int count, float w16, int lane)
{
    if (lane >= count)
        return;
    const int e = list[lane], o = e & 0xff;
    float r[8], i[8];
    if (e & 0x100) {
#pragma unroll
        for (int k = 0; k < 8; ++k) { r[k] = re[o + k]; i[k] = im[o + k]; }
        ifft8(r, i, w16);
#pragma unroll
        for (int k = 0; k < 8; ++k) { re[o + k] = r[k]; im[o + k] = i[k]; }
    } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) { r[k] = re[o + k]; i[k] = im[o + k]; }
        ifft4(r, i);
#pragma unroll
        for (int k = 0; k < 4; ++k) { re[o + k] = r[k]; im[o + k] = i[k]; }
    }
}

// one ifft_pass level: nodes of 4n points at offs[], butterfly k of a
// node on slots k, n + k, 2n + k, 3n + k with weights roots[k - 1] and
// roots[n - 1 - k] (k = 0: bf_zero)
__device__ __forceinline__ void pass_level(float* re, float* im,
                                           const int* offs, int nodes, int n,
                                           const float* roots, int lane)
{
    for (int t = lane; t < nodes * n; t += 32) {
        const int node = t / n, k = t - node * n;
        const int p0 = offs[node] + k, p1 = p0 + n, p2 = p1 + n, p3 = p2 + n;
        float a0r = re[p0], a0i = im[p0], a1r = re[p1], a1i = im[p1];
        float a2r = re[p2], a2i = im[p2], a3r = re[p3], a3i = im[p3];
        if (k == 0)
            bf_zero(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i);
        else
            bf(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, roots[k - 1],
               roots[n - 1 - k]);
        re[p0] = a0r; im[p0] = a0i; re[p1] = a1r; im[p1] = a1i;
        re[p2] = a2r; im[p2] = a2i; re[p3] = a3r; im[p3] = a3i;
    }
}

// x: the row's coefficients in, z out; re/im: the IFFT buffer; dd: d out
__device__ void long_row(float* x, float* re, float* im, float* dd,
                         const float* tab, const int* order, int lane)
{
    for (int k = lane; k < 128; k += 32) {
        const int o = order[k];
        const float dk = x[o], dm = x[255 - o];
        const float tr = tab[PRE1_R + k], ti = tab[PRE1_I + k];
        re[k] = add(mul(ti, dm), mul(tr, dk));
        im[k] = sub(mul(tr, dm), mul(ti, dk));
    }
    __syncwarp();
    leaves(re, im, LEAVES_LONG, 21, tab[ROOTS16 + 1], lane);
    __syncwarp();
    pass_level(re, im, PASS16_LONG, 5, 4, tab + ROOTS16, lane);
    __syncwarp();
    pass_level(re, im, PASS32_LONG, 3, 8, tab + ROOTS32, lane);
    __syncwarp();
    pass_level(re, im, PASS_0_64, 1, 16, tab + ROOTS64, lane);
    __syncwarp();
    pass_level(re, im, PASS_0_64, 1, 32, tab + ROOTS128, lane);
    __syncwarp();
    for (int i = lane; i < 64; i += 32) {
        const float tr = tab[POST1_R + i], ti = tab[POST1_I + i];
        const float fr = re[i], fi = im[i], gr = re[127 - i], gi = im[127 - i];
        const float a_r = add(mul(tr, fr), mul(ti, fi));
        const float a_i = sub(mul(ti, fr), mul(tr, fi));
        const float b_r = add(mul(ti, gr), mul(tr, gi));
        const float b_i = sub(mul(tr, gr), mul(ti, gi));
        x[255 - 2 * i] = a_r;
        x[2 * i] = -a_r;
        x[2 * i + 1] = b_r;
        x[254 - 2 * i] = -b_r;
        dd[2 * i] = a_i;
        dd[2 * i + 1] = b_i;
    }
}

__device__ void short_row(float* x, float* re, float* im, float* dd,
                          const float* tab, const int* order, int lane)
{
    for (int c = lane; c < 64; c += 32) {
        const int k = order[c];
        const float d1a = x[k], d1b = x[254 - k];
        const float d2a = x[k + 1], d2b = x[255 - k];
        const float tr = tab[PRE2_R + c], ti = tab[PRE2_I + c];
        re[c] = add(mul(ti, d1b), mul(tr, d1a));
        im[c] = sub(mul(tr, d1b), mul(ti, d1a));
        re[64 + c] = add(mul(ti, d2b), mul(tr, d2a));
        im[64 + c] = sub(mul(tr, d2b), mul(ti, d2a));
    }
    __syncwarp();
    leaves(re, im, LEAVES_SHORT, 22, tab[ROOTS16 + 1], lane);
    __syncwarp();
    pass_level(re, im, PASS16_SHORT, 6, 4, tab + ROOTS16, lane);
    __syncwarp();
    pass_level(re, im, PASS_0_64, 2, 8, tab + ROOTS32, lane);
    __syncwarp();
    pass_level(re, im, PASS_0_64, 2, 16, tab + ROOTS64, lane);
    __syncwarp();
    const int i = lane;                                  // 32 outputs
    const float tr = tab[POST2_R + i], ti = tab[POST2_I + i];
    const float b1r = re[i], b1i = im[i], g1r = re[63 - i], g1i = im[63 - i];
    const float b2r = re[64 + i], b2i = im[64 + i];
    const float g2r = re[127 - i], g2i = im[127 - i];
    const float a_r = add(mul(tr, b1r), mul(ti, b1i));
    const float a_i = sub(mul(ti, b1r), mul(tr, b1i));
    const float b_r = add(mul(ti, g1r), mul(tr, g1i));
    const float b_i = sub(mul(tr, g1r), mul(ti, g1i));
    const float c_r = add(mul(tr, b2r), mul(ti, b2i));
    const float c_i = sub(mul(ti, b2r), mul(tr, b2i));
    const float d_r = add(mul(ti, g2r), mul(tr, g2i));
    const float d_i = sub(mul(tr, g2r), mul(ti, g2i));
    x[255 - 2 * i] = a_r;
    x[2 * i] = -a_r;
    x[128 + 2 * i] = a_i;
    x[127 - 2 * i] = -a_i;
    x[129 + 2 * i] = b_r;
    x[126 - 2 * i] = -b_r;
    x[254 - 2 * i] = b_i;
    x[2 * i + 1] = -b_i;
    dd[127 - 2 * i] = c_r;
    dd[2 * i] = c_i;
    dd[2 * i + 1] = d_r;
    dd[126 - 2 * i] = d_i;
}

__global__ void __launch_bounds__(WARPS * 32)
imdct_exact_kernel(const float* __restrict__ coeffs,
                   const uint8_t* __restrict__ blksw,
                   const float* __restrict__ tab_g,
                   const int* __restrict__ order_g, float* __restrict__ z,
                   float* __restrict__ d, long long rows)
{
    __shared__ float tab[TAB_SIZE];
    __shared__ int order[128];
    __shared__ __align__(16) float xbuf[WARPS][256];
    __shared__ float rebuf[WARPS][128], imbuf[WARPS][128];
    __shared__ __align__(16) float dbuf[WARPS][128];
    for (int t = threadIdx.x; t < TAB_SIZE; t += blockDim.x)
        tab[t] = tab_g[t];
    for (int t = threadIdx.x; t < 128; t += blockDim.x)
        order[t] = order_g[t];
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * WARPS + warp;
    if (row >= rows)
        return;
    float* x = xbuf[warp];
    float4* x4 = reinterpret_cast<float4*>(x);
    const float4* src = reinterpret_cast<const float4*>(coeffs + row * 256);
    x4[lane] = src[lane];
    x4[lane + 32] = src[lane + 32];
    __syncwarp();
    if (blksw != nullptr && blksw[row])
        short_row(x, rebuf[warp], imbuf[warp], dbuf[warp], tab, order, lane);
    else
        long_row(x, rebuf[warp], imbuf[warp], dbuf[warp], tab, order, lane);
    __syncwarp();
    float4* zo = reinterpret_cast<float4*>(z + row * 256);
    zo[lane] = x4[lane];
    zo[lane + 32] = x4[lane + 32];
    reinterpret_cast<float4*>(d + row * 128)[lane] =
        reinterpret_cast<const float4*>(dbuf[warp])[lane];
}

}  // namespace

extern "C" int imdct_exact_launch(const void* coeffs, const void* blksw,
                                  const void* tab, const void* order, void* z,
                                  void* d, long long rows, void* stream)
{
    if (rows <= 0)
        return 0;
    const long long blocks = (rows + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    imdct_exact_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                         (cudaStream_t)stream>>>(
        (const float*)coeffs, (const uint8_t*)blksw, (const float*)tab,
        (const int*)order, (float*)z, (float*)d, rows);
    return (int)cudaGetLastError();
}

extern "C" const char* imdct_exact_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
