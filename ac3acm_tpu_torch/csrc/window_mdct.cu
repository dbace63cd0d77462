// M1: the encoder's window, block-float normalize and 512-point MDCT for
// Hopper (sm_90a), one transform a warp, in one launch.
//
// Replaces what the JAX package leaves to XLA inside the encoder's frame
// core (no pallas_call): ac3acm_tpu/ops/mdct.py:162 window_norm_block, then
// :129 mdct512 with its :64 _fft128, called from
// ac3acm_tpu/models/encoder.py:318-319.  In the port these ran as about 700
// eager int32 passes a core call (ops/mdct.py, the seven butterfly passes'
// stack, reshape, shift, mask and int16 wrap), now the plain version
// ops/window_mdct.py:window_mdct_ref.
//
// Per transform (lane-frame row, block, channel) of prev, cur [256], with w
// the encoder's int16 window, wrap16 the value of (int16)x, and >> the
// arithmetic shift (nvcc shifts a negative int arithmetically, and converts
// an out-of-range unsigned to int modulo 2^32; both are relied on):
//
//   x[i]       = wrap16((prev[i] w[i]) >> 15),  x[256 + i] =
//                wrap16((cur[i] w[255 - i]) >> 15)                (i < 256)
//   v          = clamp(14 - floor(log2(OR of |x|)), 0, 14) (log2(0) = 0);
//                x := wrap16(x << v); exp_samples = v - 9
//   rot[n]     = wrap16(-x[n + 384]) (n < 128), x[n - 128] (n >= 128)
//   reA[i]     = (rot[2i] - rot[511 - 2i]) >> 1
//   imA[i]     = (-(rot[256 + 2i] - rot[255 - 2i])) >> 1          (i < 128)
//   z[i]       = (wrap16((-xc reA - xs imA) >> 15),
//                 wrap16((xs reA - xc imA) >> 15))   (xc, xs = xcos1, xsin1)
//   Z          = the 128-point radix-2 FFT of z in bit-reversed order: each
//                butterfly (p, q) -> (wrap16((p + t) >> 1), wrap16((p - t)
//                >> 1)) with t = q in pass 0 and at l = 0, (q.im, -q.re) at
//                l = 1 of pass 1 (-q.re not wrapped), else ((c q.re + s
//                q.im) >> 15, (c q.im - s q.re) >> 15) with (c, s) =
//                (costab, sintab)[l], not wrapped before the butterfly
//   coef[2j]   = (Z.re xc + Z.im xs) >> 15 at j,
//   coef[2j+1] = (Z.re xs - Z.im xc) >> 15 at 127 - j             (j < 128)
//
// which is ops/mdct.py:77-178 line by line.  The only values the function
// can take outside int16 are prev and cur; the products are formed as
// unsigned (wrapping, as PyTorch's and XLA's int32 do), so the kernel equals
// the plain version on any int32 input, and past the window every operand
// is int16-valued, so no sum or product there can overflow (ops/mdct.py's
// docstring).  No float arithmetic: the window and twiddles are the plain
// version's numpy tables, passed in as one int32 array.
//
// Bound on the card.  The function reads the two input blocks (int16
// samples) and writes 256 coefficients (int32) and a shift (a byte): 2,049
// B a transform, 0.120 ms for config 3's core call (196,608 transforms) and
// 0.361 ms for config 4's (589,824) at 3.35 TB/s
// (chip_smoke.py:stage_least_bytes).  Its least integer work, 13,670
// instructions a transform (chip_smoke.py:M1_TRANSFORM_OPS), takes 0.080 /
// 0.241 ms at the card's issue rate: bytes bound the function.  A design
// issues more than that least count (index arithmetic, int16 packing, the
// shared-memory traffic), so issue may bound the kernel: chip_smoke.py
// models it from this kernel's SASS count on M1's log line.
//
// What the design does about it.  A warp a transform, eight warps a CTA,
// the CTAs resident at once walking the transforms in a grid-stride loop
// (the 2.5 KB of tables are staged in shared memory once a CTA).  Each lane
// loads 8 ints of prev and 8 of cur as four 16-byte loads, each warp-wide
// load 512 contiguous bytes; the window and the normalize run in registers
// (the block's OR by __reduce_or_sync); the normalized block goes to the
// warp's shared row as int16, the pre-rotation stores z at bit-reversed
// positions as packed (re, im) int16 pairs, and each of the seven passes
// takes two butterflies a lane between __syncwarp()s; the post-rotation
// writes 4 interleaved coefficients a lane as one 16-byte store, each
// warp-wide store 512 contiguous bytes.  No intermediate leaves the chip.
// Tensor cores have nothing to offer a truncating int16 FFT.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;                 // transforms in flight a CTA
constexpr int THREADS = 32 * WARPS;
// the table's layout (ops/window_mdct.py:LAYOUT): the window, xcos1,
// xsin1, costab, sintab, int32 each
constexpr int TAB_WINDOW = 0;
constexpr int TAB_XCOS = 256;
constexpr int TAB_XSIN = 384;
constexpr int TAB_COS = 512;
constexpr int TAB_SIN = 576;
constexpr int TAB_INTS = 640;

__device__ __forceinline__ int mul(int a, int b)
{
    return (int)((unsigned)a * (unsigned)b);
}

__device__ __forceinline__ int add(int a, int b)
{
    return (int)((unsigned)a + (unsigned)b);
}

__device__ __forceinline__ int sub(int a, int b)
{
    return (int)((unsigned)a - (unsigned)b);
}

__device__ __forceinline__ int wrap16(int x)
{
    return (int)((unsigned)x << 16) >> 16;
}

__device__ __forceinline__ unsigned pack(int re, int im)
{
    return ((unsigned)re & 0xffffu) | ((unsigned)im << 16);
}

__device__ __forceinline__ int lo16(unsigned w)
{
    return (int)(w << 16) >> 16;
}

__device__ __forceinline__ int hi16(unsigned w)
{
    return (int)w >> 16;
}

// the windowed sample: wrap16((s w) >> 15)
__device__ __forceinline__ int windowed(int s, int w)
{
    return wrap16(mul(s, w) >> 15);
}

__global__ void __launch_bounds__(THREADS)
window_mdct_kernel(const int* __restrict__ prev, const int* __restrict__ cur,
                   const int* __restrict__ tables, int* __restrict__ coef,
                   int* __restrict__ exp_samples, long long count)
{
    __shared__ __align__(16) int tab[TAB_INTS];
    __shared__ __align__(16) short xbuf[WARPS][512];  // normalized block
    __shared__ unsigned zbuf[WARPS][128];             // (re, im) int16
    for (int i = threadIdx.x; i < TAB_INTS; i += THREADS)
        tab[i] = tables[i];
    __syncthreads();
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    short* x = xbuf[warp];
    unsigned* z = zbuf[warp];
    const long long stride = (long long)gridDim.x * WARPS;
    for (long long t = (long long)blockIdx.x * WARPS + warp; t < count;
         t += stride) {
        // window: lane owns samples 4 lane + k and 128 + 4 lane + k of
        // each half (k < 4); v[0..7] the front, v[8..15] the back
        const int4* p4 = reinterpret_cast<const int4*>(prev + t * 256);
        const int4* c4 = reinterpret_cast<const int4*>(cur + t * 256);
        const int4 pa = __ldg(p4 + lane), pb = __ldg(p4 + lane + 32);
        const int4 ca = __ldg(c4 + lane), cb = __ldg(c4 + lane + 32);
        const int ps[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
        const int cs[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
        // w[i] for the front; w[255 - i] for the back is the aligned int4
        // at 252 - i read backwards
        const int4* w4 = reinterpret_cast<const int4*>(tab + TAB_WINDOW);
        const int4 fa = w4[lane], fb = w4[lane + 32];
        const int4 ba = w4[63 - lane], bb = w4[31 - lane];
        const int ws[8] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
        const int wr[8] = {ba.w, ba.z, ba.y, ba.x, bb.w, bb.z, bb.y, bb.x};
        int v[16];
        unsigned ored = 0;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            v[k] = windowed(ps[k], ws[k]);
            v[8 + k] = windowed(cs[k], wr[k]);
            ored |= (unsigned)(v[k] < 0 ? -v[k] : v[k])
                  | (unsigned)(v[8 + k] < 0 ? -v[8 + k] : v[8 + k]);
        }
        // normalize: the block's top set bit (|-32768| = 2^15: shift 0)
        ored = __reduce_or_sync(0xffffffffu, ored);
        const int top = ored ? 31 - __clz((int)ored) : 0;
        const int sh = min(max(14 - top, 0), 14);
#pragma unroll
        for (int k = 0; k < 16; ++k)
            v[k] = wrap16((int)((unsigned)v[k] << sh));
        // x[4 lane + k] (+128, +256, +384) as 8-byte stores
        uint2* x2 = reinterpret_cast<uint2*>(x);
#pragma unroll
        for (int g = 0; g < 4; ++g)
            x2[lane + 32 * g] = make_uint2(pack(v[4 * g], v[4 * g + 1]),
                                           pack(v[4 * g + 2], v[4 * g + 3]));
        if (lane == 0)
            exp_samples[t] = sh - 9;
        __syncwarp();
        // rotation and pre-rotation, i = lane + 32 j; z stored bit-reversed
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int i = lane + 32 * j;
            // rot[2i]: -x[2i + 384] below 128; rot[255 - 2i]: x[127 - 2i]
            // down to 128, -x[639 - 2i] below
            const int r0 = j < 2 ? wrap16(sub(0, x[2 * i + 384]))
                                 : (int)x[2 * i - 128];
            const int r1 = x[383 - 2 * i];
            const int r2 = x[128 + 2 * i];
            const int r3 = j < 2 ? (int)x[127 - 2 * i]
                                 : wrap16(sub(0, x[639 - 2 * i]));
            const int reA = sub(r0, r1) >> 1;
            const int imA = sub(0, sub(r2, r3)) >> 1;
            const int nxc = sub(0, tab[TAB_XCOS + i]);
            const int xs = tab[TAB_XSIN + i];
            const int zre = wrap16(sub(mul(reA, nxc), mul(imA, xs)) >> 15);
            const int zim = wrap16(add(mul(reA, xs), mul(nxc, imA)) >> 15);
            z[__brev(i) >> 25] = pack(zre, zim);
        }
        __syncwarp();
        // the FFT: pass s, butterflies b = lane and lane + 32
#pragma unroll
        for (int s = 0; s < 7; ++s) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int b = lane + 32 * h;
                const int half = 1 << s;
                const int l = b & (half - 1);
                const int p = ((b >> s) << (s + 1)) | l;
                const int q = p + half;
                const unsigned P = z[p], Q = z[q];
                const int pre = lo16(P), pim = hi16(P);
                const int qre = lo16(Q), qim = hi16(Q);
                int tre = qre, tim = qim;
                if (s == 1 && l == 1) {
                    tre = qim;
                    tim = sub(0, qre);
                } else if (s >= 2 && l != 0) {
                    const int c = tab[TAB_COS + (l << (6 - s))];
                    const int sn = tab[TAB_SIN + (l << (6 - s))];
                    tre = add(mul(c, qre), mul(sn, qim)) >> 15;
                    tim = sub(mul(c, qim), mul(sn, qre)) >> 15;
                }
                z[p] = pack(wrap16(add(pre, tre) >> 1),
                            wrap16(add(pim, tim) >> 1));
                z[q] = pack(wrap16(sub(pre, tre) >> 1),
                            wrap16(sub(pim, tim) >> 1));
            }
            __syncwarp();
        }
        // post-rotation, full precision: lane writes coef[4m .. 4m + 3],
        // m = lane + 32 h: im1[2m], re1[127 - 2m], im1[2m + 1], re1[126 - 2m]
        int4* out = reinterpret_cast<int4*>(coef + t * 256);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int m = lane + 32 * h;
            int o[4];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                const int j = 2 * m + k;
                const unsigned Zj = z[j];
                o[2 * k] = add(mul(lo16(Zj), tab[TAB_XCOS + j]),
                               mul(tab[TAB_XSIN + j], hi16(Zj))) >> 15;
                const int r = 127 - j;
                const unsigned Zr = z[r];
                o[2 * k + 1] = sub(mul(lo16(Zr), tab[TAB_XSIN + r]),
                                   mul(hi16(Zr), tab[TAB_XCOS + r])) >> 15;
            }
            out[m] = make_int4(o[0], o[1], o[2], o[3]);
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" int window_mdct_layout(int what)
{
    switch (what) {
    case 0: return TAB_WINDOW;
    case 1: return TAB_XCOS;
    case 2: return TAB_XSIN;
    case 3: return TAB_COS;
    case 4: return TAB_SIN;
    case 5: return TAB_INTS;
    default: return -1;
    }
}

extern "C" int window_mdct_launch(const void* prev, const void* cur,
                                  const void* tables, void* coef,
                                  void* exp_samples, long long count,
                                  void* stream)
{
    if (count == 0)
        return 0;
    if (count < 0)
        return (int)cudaErrorInvalidValue;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, window_mdct_kernel, THREADS, 0);
    if (e != cudaSuccess)
        return (int)e;
    const long long want = (count + WARPS - 1) / WARPS;
    const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
    const unsigned grid = (unsigned)(want < resident ? want : resident);
    window_mdct_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)prev, (const int*)cur, (const int*)tables, (int*)coef,
        (int*)exp_samples, count);
    return (int)cudaGetLastError();
}

extern "C" const char* window_mdct_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
