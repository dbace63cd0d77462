// Order-exact IMDCT for Hopper (sm_90a): B1, the float (z, d) split; B1Q,
// the same split in the fixed-point (int32 Q30) sample type; B1F, the
// fused steady tail built on the same transform code; and B1QS, the
// fixed-point decode's whole block chain on B1Q's transform code.
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
// What the design does about it: one warp a row, 8 rows a CTA.  The row
// is staged in shared memory from coalesced 16-byte loads; the IFFT runs
// in place on the row's 128 complex values in shared memory, level by
// level (the leaves, ifft8 and ifft4, one per lane in registers; then each
// ifft_pass level, one butterfly per lane), with __syncwarp between
// levels; z and d are written from shared memory with coalesced stores.
// A level's butterflies are independent, so this schedule computes every
// value with the reference's own operations.  The transform was bound by
// shared-memory bank conflicts (about 650 wavefronts a long row: the
// fftorder gather 8-way, the leaves and first pass levels 3- to 4-way);
// the layouts XS, CS and DS below make every access of the schedule
// conflict-free (about 170), which took B1 from about 1.5 to about 0.9 ms
// at the main path's chunk on an H100 (PERF.md).
//
// B1 serves the block scan, whose OLA runs block by block in eager
// PyTorch.  The steady chunks take B1F below, which fuses the window, the
// OLA chain and int16 into the same transform code.
//
// B1Q: the transform is written once, over an arithmetic trait.  FloatOps
// is B1's (__fmul_rn, __fadd_rn, __fsub_rn; z takes the reference's "- a*w"
// signs).  FixedOps is the fixed build's (LIBA52_FIXED): MUL is the split
// 16-bit multiply of native/ac3sample.inc:33-38 with its intermediates in
// uint32 (mod 2^32), adds and subtracts in uint32, and z keeps each
// value's own sign, because MUL truncates with arithmetic shifts and so
// is not odd (ops/imdct_exact.py:filterbank_fixed applies the signs after
// its MULs).  imdct_fixed_kernel is the counterpart of
// ac3acm_tpu/ops/imdct_exact.py:_build("fixed") imdct512 / imdct256
// (:256, 294; XLA there, no pallas_call), on the Q30 tables of _tw_fixed,
// packed as the float ones.  Bound: the same 2.5 KB a row as B1 (0.601 ms
// at 786,432 long rows on an H100), which outweighs its integer
// instructions, 14,744 a long row at the fewest (1,724 MULs of 7 each,
// 2,676 adds; IMUL and IMAD issue to the FMA pipe beside the INT pipe):
// chip_smoke.py computes the bound, PERF.md keeps the times.  A simple
// kernel: B1's schedule, layouts and one warp a row, nothing fused.  It
// serves the public split (ops/imdct_exact.py:split_fb_fixed,
// filterbank_fixed, get_variant("fixed")) and no longer the fixed path's
// chain, which B1QS runs.
//
// B1QS: the fixed decode's whole block chain of one stream in one launch
// (ops/fixed_chain.py:fixed_chain, what models/decoder.py:
// fixed_block_pipeline calls once a frame).  The counterpart of
// ac3acm_tpu/models/decoder.py:526 (fixed_block_pipeline, a lax.scan of
// _block_step under jit; XLA there, no pallas_call) with the Q30 split of
// ac3acm_tpu/ops/imdct_exact.py:256,294.  Per block, step for step as
// _block_step: the stereo rematrix; the LFE row (long, the stream's bias,
// delay[5]); the time path (delay_t = downmixed ? U.delay : delay, each
// channel's own blksw, the bias zeroed where chanbias sets the bit, a
// zero-coefficient channel giving the bias and keeping delay_t, then
// D.out + c.bias); for a reducing mix the frequency path on D.freq
// (delay_f = downmixed ? delay : D.delay, blksw[0] on all five rows), and
// uniform = all(blksw[:nf] == blksw[0]) picking the path and setting
// downmixed.  Every step past the split is int32 arithmetic, whose adds
// wrap mod 2^32 and so associate and commute: each mixer is exactly the
// affine map M.planes + c.bias with M in {-1, 0, 1} [5, 5], which the
// wrapper derives from the port's own downmix/upmix on identity planes
// and passes by value (FixedMix), so a format switch needs no new build.
// (The float build's mixers are not affine maps bit for bit: the order of
// the adds sets the rounding there.)
//
// Design: one CTA (18 warps), since a call is one chain.  The split of a
// row does not read the carry, so groups of up to 6 blocks go in two
// phases: A, every row the chain will read split into shared memory, one
// warp a row (B1Q's long/short row code; blksw alone picks the path, so
// only the chosen path's 5 rows and the LFE are split, 36 rows a group:
// 55,296 B of (z, d), with the per-warp IFFT buffers and tables 84,392 B
// of dynamic shared memory); B, the chain block by block, every
// thread on samples and delay entries, the delay [6, 128] and downmixed
// in shared memory and registers from the first block of the call to the
// last, two __syncthreads a block.  Nothing but the blocks and the carry
// comes in; the PCM and the new carry go out to fresh tensors.
// Bound (the function's, at the card's rates): its bytes, every input
// read once and the PCM and carry written once (57,008 B a 2.0 frame,
// about 17 ns at 3.35 TB/s), outweigh its integer instructions (36 rows
// of the split and the overlap-add, 491,472 a 2.0 frame, about 15 ns at
// the card's issue rate): the rows' splits do not depend on one another
// and phase B runs per sample, so the function needs no one SM.  The
// one-CTA design's own floor is those instructions at one SM's issue
// rate, about 1.9 us a 2.0 frame (66 rows, both paths split, 3.8 us);
// chip_smoke.py prints both.  At one call a frame the call with no
// blocks (the launch and the prologue's staging) is of the same order,
// so neither is the point of this kernel: it takes the ~1,150 eager
// operations and 12 B1Q launches a frame the chain made before down to
// one launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
// row and the two 64-point IFFTs (at 0 and 64) of a short row; the leaves
// in the lane order that keeps their float4 accesses conflict-free.  Each
// CTA copies the table to shared memory: the lanes of a warp index it at
// different entries, which constant memory would serve one at a time.
enum : int {
    LEAVES_LONG = 0, LEAVES_SHORT = 21, PASS16_LONG = 43, PASS32_LONG = 48,
    PASS16_SHORT = 51, PASS_0_64 = 57,      // 128-point pass; ifft32/64 x2
    SCHED_SIZE = 59
};
__constant__ int SCHED[SCHED_SIZE] = {
    0x100 | 0, 0x100 | 16, 0x100 | 24, 0x100 | 32, 0x100 | 64, 0x100 | 80,
    0x100 | 88, 0x100 | 96, 0x100 | 48, 0x100 | 112, 0x100 | 120,
    8, 12, 40, 56, 60, 44, 72, 76, 104, 108,
    0x100 | 0, 0x100 | 16, 0x100 | 24, 0x100 | 32, 0x100 | 64, 0x100 | 80,
    0x100 | 88, 0x100 | 96, 0x100 | 48, 0x100 | 112,
    8, 12, 40, 44, 56, 60, 72, 76, 104, 108, 120, 124,
    0, 32, 48, 64, 96,
    0, 64, 96,
    0, 32, 48, 64, 96, 112,
    0, 64};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// the two sample types of the transform
struct FloatOps {
    typedef float T;
    typedef float4 T4;
    static __device__ __forceinline__ T mul(T a, T b) { return __fmul_rn(a, b); }
    static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
    static __device__ __forceinline__ T sub(T a, T b) { return __fsub_rn(a, b); }
    static __device__ __forceinline__ T neg(T a) { return -a; }
};

struct FixedOps {
    typedef int T;
    typedef int4 T4;
    // FixedOps::MUL of native/ac3sample.inc: each partial product fits in
    // int32; the sums and the << 2 wrap in uint32; >> is arithmetic
    static __device__ __forceinline__ T mul(T a, T b)
    {
        const int tc = (int)((unsigned)((a & 0xffff) * (b >> 16))
                             + (unsigned)((a >> 16) * (b & 0xffff)));
        return (int)((unsigned)(tc >> 14)
                     + ((unsigned)((a >> 16) * (b >> 16)) << 2));
    }
    static __device__ __forceinline__ T add(T a, T b)
    {
        return (int)((unsigned)a + (unsigned)b);
    }
    static __device__ __forceinline__ T sub(T a, T b)
    {
        return (int)((unsigned)a - (unsigned)b);
    }
    static __device__ __forceinline__ T neg(T a) { return a; }
};

// Shared-memory layouts, each a bijection chosen so that every access of
// the schedule below takes the fewest wavefronts its width allows (one for
// a 4-byte access of up to 32 lanes, one per 8 active lanes for a float4;
// tests/test_torch_imdct_exact.py checks this with a model of the banks):
//  XS  the row x [256] (coefficients in, z out): word i at i ^ (i>>5 & 7).
//      fftorder sends the 8 lanes of a group to words 32 apart (the same
//      bank in the natural layout: 8-way conflicts); the xor spreads them.
//  CS  the IFFT's re/im [128]: i ^ ((i>>4 & 7) << 2), which keeps every
//      4-aligned group contiguous (a leaf loads 4 values as one float4)
//      and spreads the nodes of the first pass levels.
//  DS  the delay d [128]: i ^ (i>>5 & 1), for the stride-2 writes.
__device__ __forceinline__ int XS(int i) { return i ^ ((i >> 5) & 7); }
__device__ __forceinline__ int CS(int i) { return i ^ (((i >> 4) & 7) << 2); }
__device__ __forceinline__ int DS(int i) { return i ^ ((i >> 5) & 1); }

// the four butterflies of imdct.c, in place on (a0, a1, a2, a3); the
// outputs keep the inputs' slots: a0 + t, a1 + t', a0 - t, a1 - t'
template <class O, class T = typename O::T>
__device__ __forceinline__ void finish(T& a0r, T& a0i, T& a1r,
                                       T& a1i, T& a2r, T& a2i,
                                       T& a3r, T& a3i, T t1,
                                       T t2, T t3, T t4)
{
    const T b0r = a0r, b0i = a0i, b1r = a1r, b1i = a1i;
    a0r = O::add(b0r, t1); a0i = O::add(b0i, t2);
    a1r = O::add(b1r, t3); a1i = O::add(b1i, t4);
    a2r = O::sub(b0r, t1); a2i = O::sub(b0i, t2);
    a3r = O::sub(b1r, t3); a3i = O::sub(b1i, t4);
}

template <class O, class T = typename O::T>
__device__ __forceinline__ void bf_zero(T& a0r, T& a0i, T& a1r,
                                        T& a1i, T& a2r, T& a2i,
                                        T& a3r, T& a3i)
{
    const T t1 = O::add(a2r, a3r), t2 = O::add(a2i, a3i);
    const T t3 = O::sub(a2i, a3i), t4 = O::sub(a3r, a2r);
    finish<O>(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, t1, t2, t3, t4);
}

template <class O, class T = typename O::T>
__device__ __forceinline__ void bf_half(T& a0r, T& a0i, T& a1r,
                                        T& a1i, T& a2r, T& a2i,
                                        T& a3r, T& a3i, T w)
{
    const T t5 = O::mul(O::add(a2r, a2i), w);
    const T t6 = O::mul(O::sub(a2i, a2r), w);
    const T t7 = O::mul(O::sub(a3r, a3i), w);
    const T t8 = O::mul(O::add(a3i, a3r), w);
    finish<O>(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, O::add(t5, t7),
              O::add(t6, t8), O::sub(t6, t8), O::sub(t7, t5));
}

template <class O, class T = typename O::T>
__device__ __forceinline__ void bf(T& a0r, T& a0i, T& a1r,
                                   T& a1i, T& a2r, T& a2i,
                                   T& a3r, T& a3i, T wr, T wi)
{
    const T t5 = O::add(O::mul(wi, a2i), O::mul(wr, a2r));
    const T t6 = O::sub(O::mul(wr, a2i), O::mul(wi, a2r));
    const T t8 = O::add(O::mul(wi, a3r), O::mul(wr, a3i));
    const T t7 = O::sub(O::mul(wr, a3r), O::mul(wi, a3i));
    finish<O>(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, O::add(t5, t7),
              O::add(t6, t8), O::sub(t6, t8), O::sub(t7, t5));
}

template <class O, class T = typename O::T>
__device__ __forceinline__ void ifft2(T* r, T* i)
{
    const T r0 = r[0], i0 = i[0];
    r[0] = O::add(r0, r[1]); r[1] = O::sub(r0, r[1]);
    i[0] = O::add(i0, i[1]); i[1] = O::sub(i0, i[1]);
}

template <class O, class T = typename O::T>
__device__ __forceinline__ void ifft4(T* r, T* i)
{
    const T t1 = O::add(r[0], r[1]), t2 = O::add(r[3], r[2]);
    const T t3 = O::add(i[0], i[1]), t4 = O::add(i[2], i[3]);
    const T t5 = O::sub(r[0], r[1]), t6 = O::sub(i[0], i[1]);
    const T t7 = O::sub(i[2], i[3]), t8 = O::sub(r[3], r[2]);
    r[0] = O::add(t1, t2); r[1] = O::add(t5, t7);
    r[2] = O::sub(t1, t2); r[3] = O::sub(t5, t7);
    i[0] = O::add(t3, t4); i[1] = O::add(t6, t8);
    i[2] = O::sub(t3, t4); i[3] = O::sub(t6, t8);
}

// ifft8: ifft4 on [0, 4), ifft2 on [4, 6) and [6, 8), then bf_zero on
// slots 0/2/4/6 and bf_half on 1/3/5/7 (whose outputs are the reference's
// order [a0, b0, a1, b1, a2, b2, a3, b3])
template <class O, class T = typename O::T>
__device__ __forceinline__ void ifft8(T* r, T* i, T w)
{
    ifft4<O>(r, i);
    ifft2<O>(r + 4, i + 4);
    ifft2<O>(r + 6, i + 6);
    bf_zero<O>(r[0], i[0], r[2], i[2], r[4], i[4], r[6], i[6]);
    bf_half<O>(r[1], i[1], r[3], i[3], r[5], i[5], r[7], i[7], w);
}

// 4 consecutive values of re/im (4-aligned, so contiguous under CS)
template <class O, class T = typename O::T>
__device__ __forceinline__ void ld4(const T* a, int o, T* v)
{
    const typename O::T4 t =
        *reinterpret_cast<const typename O::T4*>(a + CS(o));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

template <class O, class T = typename O::T>
__device__ __forceinline__ void st4(T* a, int o, const T* v)
{
    typename O::T4 t;
    t.x = v[0]; t.y = v[1]; t.z = v[2]; t.w = v[3];
    *reinterpret_cast<typename O::T4*>(a + CS(o)) = t;
}

// the leaves of one IFFT level 0, one per lane, in registers
template <class O, class T = typename O::T>
__device__ __forceinline__ void leaves(T* re, T* im, const int* list,
                                       int count, T w16, int lane)
{
    if (lane >= count)
        return;
    const int e = list[lane], o = e & 0xff;
    T r[8], i[8];
    if (e & 0x100) {
        ld4<O>(re, o, r); ld4<O>(re, o + 4, r + 4);
        ld4<O>(im, o, i); ld4<O>(im, o + 4, i + 4);
        ifft8<O>(r, i, w16);
        st4<O>(re, o, r); st4<O>(re, o + 4, r + 4);
        st4<O>(im, o, i); st4<O>(im, o + 4, i + 4);
    } else {
        ld4<O>(re, o, r); ld4<O>(im, o, i);
        ifft4<O>(r, i);
        st4<O>(re, o, r); st4<O>(im, o, i);
    }
}

// one ifft_pass level: nodes of 4n points at offs[], butterfly k of a
// node on slots k, n + k, 2n + k, 3n + k with weights roots[k - 1] and
// roots[n - 1 - k] (k = 0: bf_zero)
template <class O, class T = typename O::T>
__device__ __forceinline__ void pass_level(T* re, T* im,
                                           const int* offs, int nodes, int n,
                                           const T* roots, int lane)
{
    for (int t = lane; t < nodes * n; t += 32) {
        const int node = t / n, k = t - node * n;
        const int q0 = offs[node] + k, p0 = CS(q0), p1 = CS(q0 + n),
                  p2 = CS(q0 + 2 * n), p3 = CS(q0 + 3 * n);
        T a0r = re[p0], a0i = im[p0], a1r = re[p1], a1i = im[p1];
        T a2r = re[p2], a2i = im[p2], a3r = re[p3], a3i = im[p3];
        if (k == 0)
            bf_zero<O>(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i);
        else
            bf<O>(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, roots[k - 1],
                  roots[n - 1 - k]);
        re[p0] = a0r; im[p0] = a0i; re[p1] = a1r; im[p1] = a1i;
        re[p2] = a2r; im[p2] = a2i; re[p3] = a3r; im[p3] = a3i;
    }
}

// x: the row's coefficients in, z out (XS); re/im: the IFFT buffer (CS);
// dd: d out (DS)
template <class O, class T = typename O::T>
__device__ void long_row(T* x, T* re, T* im, T* dd,
                         const T* tab, const int* order,
                         const int* sched, int lane)
{
    for (int k = lane; k < 128; k += 32) {
        const int o = order[k];
        const T dk = x[XS(o)], dm = x[XS(255 - o)];
        const T tr = tab[PRE1_R + k], ti = tab[PRE1_I + k];
        re[CS(k)] = O::add(O::mul(ti, dm), O::mul(tr, dk));
        im[CS(k)] = O::sub(O::mul(tr, dm), O::mul(ti, dk));
    }
    __syncwarp();
    leaves<O>(re, im, sched + LEAVES_LONG, 21, tab[ROOTS16 + 1], lane);
    __syncwarp();
    pass_level<O>(re, im, sched + PASS16_LONG, 5, 4, tab + ROOTS16, lane);
    __syncwarp();
    pass_level<O>(re, im, sched + PASS32_LONG, 3, 8, tab + ROOTS32, lane);
    __syncwarp();
    pass_level<O>(re, im, sched + PASS_0_64, 1, 16, tab + ROOTS64, lane);
    __syncwarp();
    pass_level<O>(re, im, sched + PASS_0_64, 1, 32, tab + ROOTS128, lane);
    __syncwarp();
    for (int i = lane; i < 64; i += 32) {
        const T tr = tab[POST1_R + i], ti = tab[POST1_I + i];
        const T fr = re[CS(i)], fi = im[CS(i)];
        const T gr = re[CS(127 - i)], gi = im[CS(127 - i)];
        const T a_r = O::add(O::mul(tr, fr), O::mul(ti, fi));
        const T a_i = O::sub(O::mul(ti, fr), O::mul(tr, fi));
        const T b_r = O::add(O::mul(ti, gr), O::mul(tr, gi));
        const T b_i = O::sub(O::mul(tr, gr), O::mul(ti, gi));
        x[XS(255 - 2 * i)] = a_r;
        x[XS(2 * i)] = O::neg(a_r);
        x[XS(2 * i + 1)] = b_r;
        x[XS(254 - 2 * i)] = O::neg(b_r);
        dd[DS(2 * i)] = a_i;
        dd[DS(2 * i + 1)] = b_i;
    }
}

template <class O, class T = typename O::T>
__device__ void short_row(T* x, T* re, T* im, T* dd,
                          const T* tab, const int* order,
                          const int* sched, int lane)
{
    for (int c = lane; c < 64; c += 32) {
        const int k = order[c];
        const T d1a = x[XS(k)], d1b = x[XS(254 - k)];
        const T d2a = x[XS(k + 1)], d2b = x[XS(255 - k)];
        const T tr = tab[PRE2_R + c], ti = tab[PRE2_I + c];
        re[CS(c)] = O::add(O::mul(ti, d1b), O::mul(tr, d1a));
        im[CS(c)] = O::sub(O::mul(tr, d1b), O::mul(ti, d1a));
        re[CS(64 + c)] = O::add(O::mul(ti, d2b), O::mul(tr, d2a));
        im[CS(64 + c)] = O::sub(O::mul(tr, d2b), O::mul(ti, d2a));
    }
    __syncwarp();
    leaves<O>(re, im, sched + LEAVES_SHORT, 22, tab[ROOTS16 + 1], lane);
    __syncwarp();
    pass_level<O>(re, im, sched + PASS16_SHORT, 6, 4, tab + ROOTS16, lane);
    __syncwarp();
    pass_level<O>(re, im, sched + PASS_0_64, 2, 8, tab + ROOTS32, lane);
    __syncwarp();
    pass_level<O>(re, im, sched + PASS_0_64, 2, 16, tab + ROOTS64, lane);
    __syncwarp();
    const int i = lane;                                  // 32 outputs
    const T tr = tab[POST2_R + i], ti = tab[POST2_I + i];
    const T b1r = re[CS(i)], b1i = im[CS(i)];
    const T g1r = re[CS(63 - i)], g1i = im[CS(63 - i)];
    const T b2r = re[CS(64 + i)], b2i = im[CS(64 + i)];
    const T g2r = re[CS(127 - i)], g2i = im[CS(127 - i)];
    const T a_r = O::add(O::mul(tr, b1r), O::mul(ti, b1i));
    const T a_i = O::sub(O::mul(ti, b1r), O::mul(tr, b1i));
    const T b_r = O::add(O::mul(ti, g1r), O::mul(tr, g1i));
    const T b_i = O::sub(O::mul(tr, g1r), O::mul(ti, g1i));
    const T c_r = O::add(O::mul(tr, b2r), O::mul(ti, b2i));
    const T c_i = O::sub(O::mul(ti, b2r), O::mul(tr, b2i));
    const T d_r = O::add(O::mul(ti, g2r), O::mul(tr, g2i));
    const T d_i = O::sub(O::mul(tr, g2r), O::mul(ti, g2i));
    x[XS(255 - 2 * i)] = a_r;
    x[XS(2 * i)] = O::neg(a_r);
    x[XS(128 + 2 * i)] = a_i;
    x[XS(127 - 2 * i)] = O::neg(a_i);
    x[XS(129 + 2 * i)] = b_r;
    x[XS(126 - 2 * i)] = O::neg(b_r);
    x[XS(254 - 2 * i)] = b_i;
    x[XS(2 * i + 1)] = O::neg(b_i);
    dd[DS(127 - 2 * i)] = c_r;
    dd[DS(2 * i)] = c_i;
    dd[DS(2 * i + 1)] = d_r;
    dd[DS(126 - 2 * i)] = d_i;
}


// ---------------------------------------------------------------------------
// B1F: the fused order-exact steady tail.  Per (lane b, plane p) chain of
// n blocks, with (z_i, d_i) = the row transform above:
//
//   dprev_i    = d0[b, p] if i == 0 else d_{i-1}
//   out_i      = ((z_i * win) + (fold(dprev_i) * win_r)) + bias[b, i]
//   pcm[b,i,p] = int16 clamp(rint((out_i - 384) * 32768)), or out_i (f32)
//   dlast[b,p] = d_{n-1}                       fold(d) = d ++ reversed(d)
//
// bit for bit what _pipeline_steady(exact=True) and convert_to_int16 give
// (ops/fused_steady_exact.py:fused_steady_exact_ref), which has no
// pallas_call counterpart: the JAX package runs it as XLA
// (ac3acm_tpu/ops/imdct_exact.py:437,466 and the steady body's OLA).
//
// Bound on the card: bytes.  A row reads its 1 KB of coefficients and
// writes 512 B of int16 (1 KB of f32); each chain reads d0 and writes
// dlast once.  At the main path's chunk (786,432 rows, 8,192 chains)
// that is 1,217,921,024 B, 0.364 ms at 3.35 TB/s; the ~6,700 FP32
// operations a row take 0.08 ms at 67 TFLOP/s.  B1 followed by the eager
// chain, OLA and int16 passes moved about 18 GB a chunk.
//
// What the design does about it:
//  * nothing but the coefficients, d0 and bias comes in and nothing but
//    the PCM and dlast goes out: z, d and the OLA stay on chip;
//  * one warp walks one segment of a chain in block order, keeping the
//    previous block's d in registers, already folded (the 8 entries its
//    8 outputs need), so block i's OLA needs no second pass.  A chain is
//    cut into segments of equal length so that every warp of the grid gets
//    about the same number of rows (B1F_ITEMS segments a resident warp,
//    at least 8 rows each: the main path's 8,192 chains alone are a wave
//    and a fraction; the 256-lane float check has 512 chains); a segment
//    that does not start its chain first transforms the row before it for
//    its d (its z is not used), +1 row a segment (+2% at the main chunk);
//  * the next row, its flag and its bias are in flight while this row is
//    transformed: two row buffers a warp in shared memory, filled by
//    cp.async (4-byte copies, since XS permutes single words; each warp
//    instruction still reads 128 contiguous bytes);
//  * persistent CTAs: the grid holds every warp at once; each CTA stages
//    the packed twiddles, fftorder and the IFFT schedule once, then loops;
//  * the epilogue stays in registers: a lane owns outputs lane + 32k
//    (conflict-free reads of z and d), holds its 16 window entries in
//    registers, applies the OLA with __fmul_rn/__fadd_rn in the eager
//    order and stores coalesced int16 or floats.
// The transform itself is B1's, shared code, so the two kernels compute
// every value with the same operations.  Not done (tried on the card, no
// change within the 5% spread between runs): fewer registers for more
// resident warps (forcing 64 to 80 registers left the time as it was, or
// spilled), the window in shared memory, fewer or more segments.  Two
// rows in flight a warp, to fill the levels that keep 16 to 24 lanes
// busy, is the open design step (PERF.md).

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem)
{
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one row (256 floats) into a shared buffer in the XS layout, 8 x 4 B a
// lane (the layout permutes single words, so 16-byte copies cannot place
// them); each warp instruction still reads 128 contiguous bytes
__device__ __forceinline__ void fetch_row(float* x, const float* src,
                                          int lane)
{
#pragma unroll
    for (int k = 0; k < 8; ++k)
        cp_async4(x + XS(lane + 32 * k), src + lane + 32 * k);
    cp_async_commit();
}

// int16 of one output, as convert_to_int16: (out - 384) * 32768, rounded
// half to even, clamped
__device__ __forceinline__ unsigned to_i16(float out)
{
    float v = rintf(mul(sub(out, 384.0f), 32768.0f));
    v = fminf(fmaxf(v, -32768.0f), 32767.0f);
    return (unsigned)(unsigned short)(short)__float2int_rn(v);
}

// work items (chain segments) per resident warp that B1F's launch aims at
constexpr int B1F_ITEMS = 4;

template <bool I16>
__global__ void __launch_bounds__(WARPS * 32)
fused_steady_exact_kernel(const float* __restrict__ freq,
                          const uint8_t* __restrict__ blksw,
                          const float* __restrict__ d0,
                          const float* __restrict__ bias,
                          const float* __restrict__ tab_g,
                          const int* __restrict__ order_g,
                          const float* __restrict__ win_g,
                          void* __restrict__ pcm, float* __restrict__ dlast,
                          int n, int P, int seg_len, int nseg,
                          long long items)
{
    __shared__ float tab[TAB_SIZE];
    __shared__ int order[128], sched[SCHED_SIZE];
    __shared__ __align__(16) float xbuf[WARPS][2][256];
    __shared__ __align__(16) float rebuf[WARPS][128], imbuf[WARPS][128];
    __shared__ __align__(16) float dbuf[WARPS][128];
    for (int t = threadIdx.x; t < TAB_SIZE; t += blockDim.x)
        tab[t] = tab_g[t];
    for (int t = threadIdx.x; t < 128; t += blockDim.x)
        order[t] = order_g[t];
    for (int t = threadIdx.x; t < SCHED_SIZE; t += blockDim.x)
        sched[t] = SCHED[t];
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // this lane's outputs are j = lane + 32k, k < 8; output j folds in
    // d[j] (j < 128) or d[255 - j]: fold index f_k = FOLD(k)
#define FOLD(k) ((k) < 4 ? lane + 32 * (k) : 255 - lane - 32 * (k))
    float w[8], wr[8];                        // win[j], win_r[j]
#pragma unroll
    for (int k = 0; k < 8; ++k) {
        w[k] = win_g[lane + 32 * k];
        wr[k] = win_g[255 - lane - 32 * k];
    }
    float* re = rebuf[warp];
    float* im = imbuf[warp];
    float* dd = dbuf[warp];
    const long long stride = (long long)gridDim.x * WARPS;
    for (long long it = (long long)blockIdx.x * WARPS + warp; it < items;
         it += stride) {
        const long long chain = it / nseg;
        const int seg = (int)(it - chain * nseg);
        const long long b = chain / P;
        const int i0 = seg * seg_len;
        const int i1 = min(n, i0 + seg_len);
        const int first = i0 > 0 ? i0 - 1 : 0;  // a halo row for d
        // row of block i: (b * n + i) * P + p
        const long long row0 = b * n * P + (chain - b * P);
        float dp[8];                              // folded d of block i-1
        if (i0 == 0) {
#pragma unroll
            for (int k = 0; k < 8; ++k)
                dp[k] = d0[chain * 128 + FOLD(k)];
        }
        fetch_row(xbuf[warp][first & 1],
                  freq + (row0 + (long long)first * P) * 256, lane);
        // this row's flag and bias; the next row's are loaded a row ahead
        bool sh = blksw != nullptr && blksw[row0 + (long long)first * P];
        float bv = bias[b * n + first];
        for (int i = first; i < i1; ++i) {
            const long long row = row0 + (long long)i * P;
            float* x = xbuf[warp][i & 1];
            bool sh_next = false;
            float bv_next = 0.0f;
            if (i + 1 < i1) {
                fetch_row(xbuf[warp][(i + 1) & 1], freq + (row + P) * 256,
                          lane);
                sh_next = blksw != nullptr && blksw[row + P];
                bv_next = bias[b * n + i + 1];
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncwarp();
            if (sh)
                short_row<FloatOps>(x, re, im, dd, tab, order, sched, lane);
            else
                long_row<FloatOps>(x, re, im, dd, tab, order, sched, lane);
            __syncwarp();
            if (i >= i0) {
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const int j = lane + 32 * k;
                    const float o = add(add(mul(x[XS(j)], w[k]),
                                            mul(dp[k], wr[k])), bv);
                    if (I16)
                        static_cast<short*>(pcm)[row * 256 + j] =
                            (short)to_i16(o);
                    else
                        static_cast<float*>(pcm)[row * 256 + j] = o;
                }
            }
#pragma unroll
            for (int k = 0; k < 8; ++k)
                dp[k] = dd[DS(FOLD(k))];
            sh = sh_next;
            bv = bv_next;
            __syncwarp();
        }
        if (i1 == n) {
#pragma unroll
            for (int k = 0; k < 4; ++k)
                dlast[chain * 128 + lane + 32 * k] = dp[k];
        }
    }
#undef FOLD
}

// one row a warp: the row staged in shared memory (XS) from 16-byte loads,
// transformed in place, z and d written back with coalesced stores
template <class O, class T = typename O::T>
__device__ __forceinline__ void split_rows(const T* __restrict__ coeffs,
                                           const uint8_t* __restrict__ blksw,
                                           const T* __restrict__ tab_g,
                                           const int* __restrict__ order_g,
                                           T* __restrict__ z,
                                           T* __restrict__ d, long long rows,
                                           T* tab, int* order, int* sched,
                                           T (*xbuf)[256], T (*rebuf)[128],
                                           T (*imbuf)[128], T (*dbuf)[128])
{
    for (int t = threadIdx.x; t < TAB_SIZE; t += blockDim.x)
        tab[t] = tab_g[t];
    for (int t = threadIdx.x; t < 128; t += blockDim.x)
        order[t] = order_g[t];
    for (int t = threadIdx.x; t < SCHED_SIZE; t += blockDim.x)
        sched[t] = SCHED[t];
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * WARPS + warp;
    if (row >= rows)
        return;
    T* x = xbuf[warp];
    const typename O::T4* src =
        reinterpret_cast<const typename O::T4*>(coeffs + row * 256);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        const typename O::T4 v = src[lane + 32 * h];
        const int w = 4 * lane + 128 * h;
        x[XS(w)] = v.x; x[XS(w + 1)] = v.y; x[XS(w + 2)] = v.z;
        x[XS(w + 3)] = v.w;
    }
    __syncwarp();
    if (blksw != nullptr && blksw[row])
        short_row<O>(x, rebuf[warp], imbuf[warp], dbuf[warp], tab, order,
                     sched, lane);
    else
        long_row<O>(x, rebuf[warp], imbuf[warp], dbuf[warp], tab, order,
                    sched, lane);
    __syncwarp();
#pragma unroll
    for (int k = 0; k < 8; ++k)
        z[row * 256 + lane + 32 * k] = x[XS(lane + 32 * k)];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        d[row * 128 + lane + 32 * k] = dbuf[warp][DS(lane + 32 * k)];
}

// B1: the float split
__global__ void __launch_bounds__(WARPS * 32)
imdct_exact_kernel(const float* __restrict__ coeffs,
                   const uint8_t* __restrict__ blksw,
                   const float* __restrict__ tab_g,
                   const int* __restrict__ order_g, float* __restrict__ z,
                   float* __restrict__ d, long long rows)
{
    __shared__ float tab[TAB_SIZE];
    __shared__ int order[128], sched[SCHED_SIZE];
    __shared__ __align__(16) float xbuf[WARPS][256];
    __shared__ __align__(16) float rebuf[WARPS][128], imbuf[WARPS][128];
    __shared__ __align__(16) float dbuf[WARPS][128];
    split_rows<FloatOps>(coeffs, blksw, tab_g, order_g, z, d, rows, tab,
                         order, sched, xbuf, rebuf, imbuf, dbuf);
}

// B1Q: the fixed-point (int32 Q30) split
__global__ void __launch_bounds__(WARPS * 32)
imdct_fixed_kernel(const int* __restrict__ coeffs,
                   const uint8_t* __restrict__ blksw,
                   const int* __restrict__ tab_g,
                   const int* __restrict__ order_g, int* __restrict__ z,
                   int* __restrict__ d, long long rows)
{
    __shared__ int tab[TAB_SIZE];
    __shared__ int order[128], sched[SCHED_SIZE];
    __shared__ __align__(16) int xbuf[WARPS][256];
    __shared__ __align__(16) int rebuf[WARPS][128], imbuf[WARPS][128];
    __shared__ __align__(16) int dbuf[WARPS][128];
    split_rows<FixedOps>(coeffs, blksw, tab_g, order_g, z, d, rows, tab,
                         order, sched, xbuf, rebuf, imbuf, dbuf);
}


// ---------------------------------------------------------------------------
// B1QS: the fixed-point block chain of one stream (see the header).

constexpr int CHAIN_WARPS = 18;        // 36 row slots: two rounds of warps
constexpr int CHAIN_GROUP = 6;         // blocks split per phase A
constexpr int CHAIN_SLOTS = CHAIN_GROUP * 6;  // 5 path rows + LFE a block

// the mixers of one StreamFormat (ops/fixed_chain.py:_Mix, byte for byte):
// out[o] = sum_c down[o][c] * in[c] + cbias[o] * bias (mod 2^32), the
// upmix likewise without a bias; the format's static facts beside them
struct FixedMix {
    int8_t down[25];
    int8_t up[25];
    int32_t cbias[5];
    int32_t nf, nf_out, lfe_out, remat, chanbias;
};

// dynamic shared memory of the chain, in ints, in this order
enum : int {
    CH_Z = 0,                                   // z of each slot (XS)
    CH_D = CH_Z + CHAIN_SLOTS * 256,            // d of each slot (DS)
    CH_RE = CH_D + CHAIN_SLOTS * 128,           // IFFT re/im, per warp
    CH_IM = CH_RE + CHAIN_WARPS * 128,
    CH_DELAY = CH_IM + CHAIN_WARPS * 128,       // the carried delay [6][128]
    CH_DSEL = CH_DELAY + 6 * 128,               // the delay a block sees
    CH_WIN = CH_DSEL + 6 * 128,                 // the Q30 window [256]
    CH_TAB = CH_WIN + 256,
    CH_ORDER = CH_TAB + TAB_SIZE,
    CH_SCHED = CH_ORDER + 128,
    CH_MIX = CH_SCHED + SCHED_SIZE,             // down, up (as ints), cbias
    CH_INTS = CH_MIX + 25 + 25 + 5
};
static_assert(CH_RE % 4 == 0 && CH_IM % 4 == 0, "re/im take int4 loads");

__device__ __forceinline__ unsigned wrap_mul(int m, int v)
{
    return (unsigned)m * (unsigned)v;
}

// plane c of a block's coefficients at bin j, the stereo rematrix applied
__device__ __forceinline__ int coef(const int* __restrict__ f,
                                    const uint8_t* __restrict__ rm, int c,
                                    int j, bool remat)
{
    if (remat && c < 2 && rm[j]) {
        const unsigned s0 = (unsigned)f[j], s1 = (unsigned)f[256 + j];
        return (int)(c == 0 ? s0 + s1 : s0 - s1);
    }
    return f[c * 256 + j];
}

// the fixed overlap-add of output j: MUL(fold(d)[j], win[255 - j])
// -+ MUL(z[j], win[j]) + bias, the sign (- on the even outputs of a long
// block, on the first half of a short one) applied after its MUL
__device__ __forceinline__ int ola_fixed(const int* z, const int* d,
                                         const int* win, int j, bool shrt,
                                         int bias)
{
    const int df = j < 128 ? d[j] : d[255 - j];
    const unsigned m = (unsigned)FixedOps::mul(z[XS(j)], win[j]);
    const unsigned o = (unsigned)FixedOps::mul(df, win[255 - j]);
    const bool neg = shrt ? j < 128 : (j & 1) == 0;
    return (int)((neg ? o - m : o + m) + (unsigned)bias);
}

__global__ void __launch_bounds__(CHAIN_WARPS * 32)
fixed_chain_kernel(const int* __restrict__ freq,
                   const uint8_t* __restrict__ blksw,
                   const float* __restrict__ coeff,
                   const uint8_t* __restrict__ remat,
                   const int* __restrict__ bias,
                   const int* __restrict__ delay_in,
                   const uint8_t* __restrict__ dmx_in,
                   const int* __restrict__ tab_g,
                   const int* __restrict__ order_g,
                   const int* __restrict__ win_g, int* __restrict__ pcm,
                   int* __restrict__ delay_out, uint8_t* __restrict__ dmx_out,
                   int n, const FixedMix mix)
{
    extern __shared__ __align__(16) int sm[];
    __shared__ int freqp[CHAIN_GROUP];
    int* const tab = sm + CH_TAB;
    int* const order = sm + CH_ORDER;
    int* const sched = sm + CH_SCHED;
    int* const win = sm + CH_WIN;
    int* const delay = sm + CH_DELAY;
    int* const dsel = sm + CH_DSEL;
    int* const mdown = sm + CH_MIX;
    int* const mup = mdown + 25;
    int* const mcb = mup + 25;
    const int tid = threadIdx.x, nthr = blockDim.x;
    for (int t = tid; t < TAB_SIZE; t += nthr)
        tab[t] = tab_g[t];
    for (int t = tid; t < 128; t += nthr)
        order[t] = order_g[t];
    for (int t = tid; t < SCHED_SIZE; t += nthr)
        sched[t] = SCHED[t];
    for (int t = tid; t < 256; t += nthr)
        win[t] = win_g[t];
    for (int t = tid; t < 6 * 128; t += nthr)
        delay[t] = delay_in[t];
    if (tid == 0) {
#pragma unroll
        for (int i = 0; i < 25; ++i) {
            mdown[i] = mix.down[i];
            mup[i] = mix.up[i];
        }
#pragma unroll
        for (int i = 0; i < 5; ++i)
            mcb[i] = mix.cbias[i];
    }
    const int nf = mix.nf, nfo = mix.nf_out, lfe = mix.lfe_out;
    const int nch = nfo + lfe;
    const bool rmx = mix.remat != 0, reduces = nfo < nf;
    bool downmixed = dmx_in[0] != 0;
    __syncthreads();

    const int warp = tid >> 5, lane = tid & 31;
    for (int g0 = 0; g0 < n; g0 += CHAIN_GROUP) {
        const int G = min(CHAIN_GROUP, n - g0);
        // the path of each block: blksw alone decides it
        if (tid < G) {
            const uint8_t* bs = blksw + (long long)(g0 + tid) * 5;
            bool uniform = true;
            for (int c = 1; c < nf; ++c)
                uniform = uniform && ((bs[c] != 0) == (bs[0] != 0));
            freqp[tid] = reduces && uniform;
        }
        __syncthreads();

        // phase A: the split of every row the chain will read, one warp a
        // row; slot r < 5 is the block's path row r (time: coded channel r;
        // frequency: output r of the mixed planes), slot 5 the LFE
        for (int s = warp; s < G * 6; s += CHAIN_WARPS) {
            const int b = s / 6, r = s - b * 6;
            if (r == 5 && !lfe)
                continue;
            const long long blk = g0 + b;
            const int* f = freq + blk * 6 * 256;
            const uint8_t* rm = remat + blk * 256;
            const bool fp = freqp[b] != 0;
            int* x = sm + CH_Z + s * 256;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int j = lane + 32 * k;
                int v;
                if (r == 5) {
                    v = f[5 * 256 + j];
                } else if (!fp) {
                    v = coef(f, rm, r, j, rmx);
                } else {
                    unsigned acc = 0;
#pragma unroll
                    for (int c = 0; c < 5; ++c)
                        acc += wrap_mul(mdown[r * 5 + c], coef(f, rm, c, j,
                                                               rmx));
                    v = (int)acc;
                }
                x[XS(j)] = v;
            }
            __syncwarp();
            const bool sh = r < 5 && blksw[blk * 5 + (fp ? 0 : r)] != 0;
            int* re = sm + CH_RE + warp * 128;
            int* im = sm + CH_IM + warp * 128;
            int* dd = sm + CH_D + s * 128;
            if (sh)
                short_row<FixedOps>(x, re, im, dd, tab, order, sched, lane);
            else
                long_row<FixedOps>(x, re, im, dd, tab, order, sched, lane);
            __syncwarp();
        }
        __syncthreads();

        // phase B: the chain, block by block, the carry in shared memory
        for (int b = 0; b < G; ++b) {
            const long long blk = g0 + b;
            const bool fp = freqp[b] != 0;
            const int bv = bias[blk];
            // the delay this block's rows see: time path delay_t =
            // downmixed ? U.delay : delay; frequency path delay_f =
            // downmixed ? delay : D.delay; the LFE's own
            for (int t = tid; t < 6 * 128; t += nthr) {
                const int c = t >> 7, k = t & 127;
                int v = delay[t];
                if (c < 5 && (fp ? !downmixed : downmixed)) {
                    const int* m = (fp ? mdown : mup) + c * 5;
                    unsigned acc = 0;
#pragma unroll
                    for (int q = 0; q < 5; ++q)
                        acc += wrap_mul(m[q], delay[q * 128 + k]);
                    v = (int)acc;
                }
                dsel[t] = v;
            }
            __syncthreads();
            const int* zb = sm + CH_Z + b * 6 * 256;
            const int* db = sm + CH_D + b * 6 * 128;
            const uint8_t* bs = blksw + blk * 5;
            const float* cf = coeff + blk * 5;
            int* out = pcm + blk * nch * 256;
            for (int j = tid; j < 256; j += nthr) {
                if (lfe)
                    out[j] = ola_fixed(zb + 5 * 256, dsel + 5 * 128, win, j,
                                       false, bv);
                int* o = out + lfe * 256;
                if (fp) {
                    const bool sh = bs[0] != 0;
                    for (int p = 0; p < nfo; ++p)
                        o[p * 256 + j] = ola_fixed(zb + p * 256,
                                                   dsel + p * 128, win, j,
                                                   sh, bv);
                } else {
                    int tout[5];
#pragma unroll
                    for (int c = 0; c < 5; ++c)
                        tout[c] = cf[c] == 0.0f
                                      ? bv
                                      : ola_fixed(zb + c * 256,
                                                  dsel + c * 128, win, j,
                                                  bs[c] != 0,
                                                  (mix.chanbias >> c) & 1
                                                      ? 0 : bv);
                    for (int p = 0; p < nfo; ++p) {
                        unsigned acc = wrap_mul(mcb[p], bv);
#pragma unroll
                        for (int c = 0; c < 5; ++c)
                            acc += wrap_mul(mdown[p * 5 + c], tout[c]);
                        o[p * 256 + j] = (int)acc;
                    }
                }
            }
            // the new delay: the rows' d (DS), a zero-coefficient channel
            // of the time path keeping delay_t, the LFE's plane only when
            // it is decoded
            for (int t = tid; t < 6 * 128; t += nthr) {
                const int c = t >> 7, k = t & 127;
                if (c == 5) {
                    if (lfe)
                        delay[t] = db[5 * 128 + DS(k)];
                } else if (!fp && cf[c] == 0.0f) {
                    delay[t] = dsel[t];
                } else {
                    delay[t] = db[c * 128 + DS(k)];
                }
            }
            __syncthreads();
            downmixed = fp;
        }
    }
    for (int t = tid; t < 6 * 128; t += nthr)
        delay_out[t] = delay[t];
    if (tid == 0)
        dmx_out[0] = downmixed ? 1 : 0;
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

extern "C" int imdct_fixed_launch(const void* coeffs, const void* blksw,
                                  const void* tab, const void* order, void* z,
                                  void* d, long long rows, void* stream)
{
    if (rows <= 0)
        return 0;
    const long long blocks = (rows + WARPS - 1) / WARPS;
    if (blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    imdct_fixed_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                         (cudaStream_t)stream>>>(
        (const int*)coeffs, (const uint8_t*)blksw, (const int*)tab,
        (const int*)order, (int*)z, (int*)d, rows);
    return (int)cudaGetLastError();
}

extern "C" int fused_steady_exact_launch(const void* freq, const void* blksw,
                                         const void* d0, const void* bias,
                                         const void* tab, const void* order,
                                         const void* win, void* pcm,
                                         void* dlast, int B, int n, int P,
                                         int emit_int16, void* stream)
{
    const long long chains = (long long)B * P;
    if (chains <= 0 || n <= 0)
        return 0;
    // resident warps of the whole card: the grid holds them all at once
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    auto kernel = emit_int16 ? fused_steady_exact_kernel<true>
                             : fused_steady_exact_kernel<false>;
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          WARPS * 32, 0);
    if (e != cudaSuccess)
        return (int)e;
    const long long resident =
        (long long)sms * (per_sm > 0 ? per_sm : 1) * WARPS;
    // segments: about 4 a resident warp over the chunk, of at least 8 rows
    // (the halo row costs 1/seg_len), of equal length within a chain
    const long long rows = chains * n;
    const long long per = B1F_ITEMS * resident;
    long long target = (rows + per - 1) / per;
    if (target < 8)
        target = 8;
    const int nseg = (int)((n + target - 1) / target);
    const int seg_len = (n + nseg - 1) / nseg;
    const long long items = chains * nseg;
    const long long per_warp = (items + resident - 1) / resident;
    const long long warps = (items + per_warp - 1) / per_warp;
    const long long blocks = (warps + WARPS - 1) / WARPS;
    cudaStream_t s = (cudaStream_t)stream;
    kernel<<<(unsigned)blocks, WARPS * 32, 0, s>>>(
        (const float*)freq, (const uint8_t*)blksw, (const float*)d0,
        (const float*)bias, (const float*)tab, (const int*)order,
        (const float*)win, pcm, (float*)dlast, n, P, seg_len, nseg, items);
    return (int)cudaGetLastError();
}

extern "C" int fixed_chain_mix_size() { return (int)sizeof(FixedMix); }

extern "C" int fixed_chain_launch(const void* freq, const void* blksw,
                                  const void* coeff, const void* remat,
                                  const void* bias, const void* delay_in,
                                  const void* dmx_in, const void* tab,
                                  const void* order, const void* win,
                                  void* pcm, void* delay_out, void* dmx_out,
                                  int n, const void* mix, void* stream)
{
    if (n < 0)
        return (int)cudaErrorInvalidValue;
    const int smem = CH_INTS * (int)sizeof(int);
    // above the 48 KB a launch gets unasked (a refused launch never
    // runs); the attribute lasts as long as the process, so it is set at
    // a device's first launch (one bit a device, 64 devices)
    static std::atomic<unsigned long long> smem_set{0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess)
        return (int)e;
    const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
    if (!(smem_set.load() & bit) || !bit) {
        e = cudaFuncSetAttribute(fixed_chain_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
        if (e != cudaSuccess)
            return (int)e;
        smem_set.fetch_or(bit);
    }
    fixed_chain_kernel<<<1, CHAIN_WARPS * 32, smem, (cudaStream_t)stream>>>(
        (const int*)freq, (const uint8_t*)blksw, (const float*)coeff,
        (const uint8_t*)remat, (const int*)bias, (const int*)delay_in,
        (const uint8_t*)dmx_in, (const int*)tab, (const int*)order,
        (const int*)win, (int*)pcm, (int*)delay_out, (uint8_t*)dmx_out, n,
        *(const FixedMix*)mix);
    return (int)cudaGetLastError();
}

extern "C" const char* imdct_exact_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
