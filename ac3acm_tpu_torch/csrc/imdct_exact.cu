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
// Design: a cluster of QS_CTAS (6) CTAs, one a block of a frame, since a
// call is one chain whose splits do not depend on one another but whose
// walk is sequential; what sets its time is latency, not work.
//  * CTA c's 6 split warps take blocks c, c + 6, ..., warp r the block's
//    row slot r (its 5 path rows and the LFE).  The block's coefficients
//    (and, the first time, the tables) come in by asynchronous copies
//    while the cluster meets.  blksw alone picks the path.  Only the rows
//    the chain reads are split: a frequency-path row whose downmix row is
//    all zero has input 0 and so z = d = 0; a time-path channel without
//    coefficients gives the bias and keeps delay_t.  Each row goes into
//    CTA 0's shared memory by 16-byte stores across the cluster, and each
//    lane then arrives on CTA 0's mbarrier for the block; when the call
//    has more blocks than CTA 0 holds, a split waits for the walk to free
//    the entry first (an mbarrier in the split CTA).
//  * The chain is independent for each position k in [0, 128): outputs
//    j = k and 255 - k read fold(d) at k alone, the mixes combine
//    channels at the same k, and the new delay at k is a row's d at k or
//    the delay the block saw.  So CTA 0's 8 walk warps, a thread pair a k
//    (j = k and 255 - k), carry delay [6] at k and downmixed in registers
//    through every block, reading each block's rows from their own shared
//    memory as soon as its 6 warps have arrived: no __syncthreads between
//    blocks; the mixers' entries are read from the kernel's parameters at
//    constant indices.
// Nothing but the blocks and the carry comes in; the PCM and the new
// carry go out to fresh tensors.
// Bound (the function's, at the card's rates): its bytes, every input
// read once and the PCM and carry written once (57,008 B a 2.0 frame,
// about 17 ns at 3.35 TB/s), outweigh its integer instructions (the
// split of the rows the chain reads and the overlap-add, about 15 ns at
// the card's issue rate): the rows' splits do not depend on one another
// and the walk runs per position, so the function needs no one SM.  At
// one call a frame the launch itself (a bare launch, chip_smoke.py's
// B1QS line) is most of the call: the kernel takes the ~1,150 eager
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

// the pre-twiddle of long-row value k: its fftorder coefficients o and
// 255 - o read at words ia and ib of x, written at word c of re/im
template <class O, class T = typename O::T>
__device__ __forceinline__ void pre_long(const T* x, T* re, T* im, int ia,
                                         int ib, int c, T tr, T ti)
{
    const T dk = x[ia], dm = x[ib];
    re[c] = O::add(O::mul(ti, dm), O::mul(tr, dk));
    im[c] = O::sub(O::mul(tr, dm), O::mul(ti, dk));
}

// the pre-twiddle of short-row value c (first transform) and 64 + c
// (second): coefficients k, 254 - k, k + 1, 255 - k at words i1a, i1b,
// i2a, i2b of x, written at words c1, c2 of re/im
template <class O, class T = typename O::T>
__device__ __forceinline__ void pre_short(const T* x, T* re, T* im, int i1a,
                                          int i1b, int i2a, int i2b, int c1,
                                          int c2, T tr, T ti)
{
    const T d1a = x[i1a], d1b = x[i1b], d2a = x[i2a], d2b = x[i2b];
    re[c1] = O::add(O::mul(ti, d1b), O::mul(tr, d1a));
    im[c1] = O::sub(O::mul(tr, d1b), O::mul(ti, d1a));
    re[c2] = O::add(O::mul(ti, d2b), O::mul(tr, d2a));
    im[c2] = O::sub(O::mul(tr, d2b), O::mul(ti, d2a));
}

// the post-twiddle of long-row outputs i and 127 - i (IFFT values at
// words cf, cg of re/im) to z (x, XS) and d (dd, DS)
template <class O, class T = typename O::T>
__device__ __forceinline__ void post_long(T* x, const T* re, const T* im,
                                          T* dd, int i, int cf, int cg, T tr,
                                          T ti)
{
    const T fr = re[cf], fi = im[cf], gr = re[cg], gi = im[cg];
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

// the post-twiddle of short-row output i of both transforms (IFFT values
// at words c1 = i, g1 = 63 - i, c2 = 64 + i, g2 = 127 - i of re/im)
template <class O, class T = typename O::T>
__device__ __forceinline__ void post_short(T* x, const T* re, const T* im,
                                           T* dd, int i, int c1, int g1,
                                           int c2, int g2, T tr, T ti)
{
    const T b1r = re[c1], b1i = im[c1], g1r = re[g1], g1i = im[g1];
    const T b2r = re[c2], b2i = im[c2], g2r = re[g2], g2i = im[g2];
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

// x: the row's coefficients in, z out (XS); re/im: the IFFT buffer (CS);
// dd: d out (DS)
template <class O, class T = typename O::T>
__device__ void long_row(T* x, T* re, T* im, T* dd,
                         const T* tab, const int* order,
                         const int* sched, int lane)
{
    for (int k = lane; k < 128; k += 32) {
        const int o = order[k];
        pre_long<O>(x, re, im, XS(o), XS(255 - o), CS(k), tab[PRE1_R + k],
                    tab[PRE1_I + k]);
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
    for (int i = lane; i < 64; i += 32)
        post_long<O>(x, re, im, dd, i, CS(i), CS(127 - i), tab[POST1_R + i],
                     tab[POST1_I + i]);
}

template <class O, class T = typename O::T>
__device__ void short_row(T* x, T* re, T* im, T* dd,
                          const T* tab, const int* order,
                          const int* sched, int lane)
{
    for (int c = lane; c < 64; c += 32) {
        const int k = order[c];
        pre_short<O>(x, re, im, XS(k), XS(254 - k), XS(k + 1), XS(255 - k),
                     CS(c), CS(64 + c), tab[PRE2_R + c], tab[PRE2_I + c]);
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
    post_short<O>(x, re, im, dd, i, CS(i), CS(63 - i), CS(64 + i),
                  CS(127 - i), tab[POST2_R + i], tab[POST2_I + i]);
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
// operations a row take 0.08 ms at 67 TFLOP/s.  What keeps a design from
// it is instructions: one warp a row issues about 700 warp instructions a
// row, above the byte bound at the card's issue rate alone, because its
// ifft_pass levels and leaves keep 16 to 24 of 32 lanes busy and run both
// kinds of butterfly (with and without twiddles) one after the other in
// the same lanes.  chip_smoke.py prints this design's count beside the
// bound (b1f_pair_paths).
//
// What the design does about it:
//  * nothing but the coefficients, d0 and bias comes in and nothing but
//    the PCM and dlast goes out: z, d and the OLA stay on chip;
//  * a warp takes two chains at once (chains 2q and 2q + 1, the same
//    segment of each) and transforms their rows of the same block as a
//    pair.  Pairs of one kind (both long or both short) share the pre-
//    and post-twiddles' addresses and twiddles, and their leaves and
//    ifft_pass levels are packed: each lane takes one leaf or butterfly
//    of either row a round, from a schedule (PT_*, made by the wrapper,
//    ops/fused_steady_exact.py:pair_table, read through the read-only
//    cache) that holds each lane's four words and twiddles, so nothing is
//    recomputed a row.  The two rows' 42 (long) or 44 (short) leaves take
//    one round of ifft8s and one of ifft4s; a long pair's four levels
//    take 7 rounds of 32 butterflies, a short pair's three 5, where one
//    row alone took 8 and 6 rounds of both kinds.  Row B's IFFT values
//    sit at 128 + (CS(i) ^ 28), which keeps every packed round
//    conflict-free (tests/test_torch_imdct_exact.py models the banks).
//    A pair of kinds that differ, and the odd chain out, take the one-row
//    code (long_row / short_row, B1's), row after row;
//  * one warp walks its pair's segment in block order; each step's d goes
//    to one of two shared buffers, where the next step's OLA reads it, so
//    block i's OLA needs no second pass and no d is held in registers.
//    Chains are cut into segments of equal length so that every warp of
//    the grid gets about the same number of pair steps (B1F_ITEMS
//    segments a resident warp, at least 8 steps each); a segment that
//    does not start its chains first transforms the rows before it for
//    their d (z unused);
//  * the next pair of rows, their flags and biases are in flight while
//    this pair is transformed: two buffers a row in shared memory, filled
//    by cp.async (4-byte copies, since XS permutes single words; each
//    warp instruction reads 128 contiguous bytes);
//  * persistent CTAs of 4 warps: the grid holds every warp at once; each
//    CTA stages the packed twiddles, the window, fftorder and the one-row
//    schedule once, then loops;
//  * the epilogue: a lane owns outputs 2 lane + 64 k and the one after
//    (conflict-free 8-byte reads of z, d and the window), applies the OLA
//    with __fmul_rn/__fadd_rn in the eager order and stores both outputs
//    at once (one 4-byte int16 pair or one 8-byte float pair).
// Every value keeps the reference's operations: a pair runs the same
// butterflies as the one-row code, on other lanes.  d and the window stay
// out of registers on purpose: held there they took this design past 160
// registers a lane (2 or 3 CTAs an SM), and it ran barely faster than one
// warp a row (PERF.md).

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
}

// int16 of one output, as convert_to_int16: (out - 384) * 32768, rounded
// half to even, clamped (the lower clamp first, so that NaN gives -32768
// as rint and both clamps did; rounding commutes with a clamp at an
// integer)
__device__ __forceinline__ unsigned to_i16(float out)
{
    const float v = fmaxf(mul(sub(out, 384.0f), 32768.0f), -32768.0f);
    unsigned short h;
    asm("cvt.rni.sat.s16.f32 %0, %1;" : "=h"(h) : "f"(v));
    return h;
}

// work items (chain-pair segments) per resident warp that B1F's launch
// aims at
constexpr int B1F_ITEMS = 2;
constexpr int B1F_WARPS = 4;             // warps a CTA

// B1F's pair schedule (ints; ops/fused_steady_exact.py:pair_table): the
// leaves [kind][ifft8, ifft4][lane], then the ifft_pass rounds
// [round][lane] as int4, long's 7 (levels of 2, 2, 1, 2 rounds) before
// short's 5 (2, 1, 2)
constexpr int PAIR_XOR = 28;
enum : int { PT_LEAF = 0, PT_PASS = 128, PT_ROUNDS = 12,
             PT_SIZE = PT_PASS + 4 * 32 * PT_ROUNDS };

// word of IFFT value i of a pair's row B in its re/im buffers (row A's
// is CS(i))
__device__ __forceinline__ int CB(int i) { return 128 + (CS(i) ^ PAIR_XOR); }

__device__ __forceinline__ void ld4w(const float* a, int w, float* v)
{
    const float4 t = *reinterpret_cast<const float4*>(a + w);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void st4w(float* a, int w, const float* v)
{
    *reinterpret_cast<float4*>(a + w) = make_float4(v[0], v[1], v[2], v[3]);
}

// one leaf of a pair: e = (w4 << 16) | w0, the words of its 4 (ifft4) or
// 8 (ifft8: w0 and w4) values; -1 idle
template <bool IFFT8>
__device__ __forceinline__ void pair_leaf(float* re, float* im, int e,
                                          float w16)
{
    if (e < 0)
        return;
    const int w0 = e & 0xffff, w4 = e >> 16;
    float r[8], i[8];
    ld4w(re, w0, r); ld4w(im, w0, i);
    if (IFFT8) {
        ld4w(re, w4, r + 4); ld4w(im, w4, i + 4);
        ifft8<FloatOps>(r, i, w16);
        st4w(re, w4, r + 4); st4w(im, w4, i + 4);
    } else {
        ifft4<FloatOps>(r, i);
    }
    st4w(re, w0, r); st4w(im, w0, i);
}

// one ifft_pass butterfly of a pair: d = (a0 | a1 << 16, a2 | a3 << 16,
// wr, wi), its four words and twiddles; wr = wi = 0 a zero-twiddle
// butterfly, a0 = a1 = -1 idle
__device__ __forceinline__ void pair_bf(float* re, float* im, int4 d)
{
    if (d.x < 0)
        return;
    const int p0 = d.x & 0xffff, p1 = d.x >> 16, p2 = d.y & 0xffff,
              p3 = d.y >> 16;
    float a0r = re[p0], a0i = im[p0], a1r = re[p1], a1i = im[p1];
    float a2r = re[p2], a2i = im[p2], a3r = re[p3], a3i = im[p3];
    if ((d.z | d.w) == 0)
        bf_zero<FloatOps>(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i);
    else
        bf<FloatOps>(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i,
                     __int_as_float(d.z), __int_as_float(d.w));
    re[p0] = a0r; im[p0] = a0i; re[p1] = a1r; im[p1] = a1i;
    re[p2] = a2r; im[p2] = a2i; re[p3] = a3r; im[p3] = a3i;
}

// the transform of a pair of rows of one kind: xa, xb the rows'
// coefficients in and z out (XS); re/im the pair's IFFT buffers (row A
// at CS(i), row B at CB(i)); dd their d out (DS), row B's at dd + 128
template <bool SHORT>
__device__ void pair_rows(float* xa, float* xb, float* re, float* im,
                          float* dd, const float* tab, const int* order,
                          const int* __restrict__ pt, int lane)
{
    // this lane's leaves, loaded ahead of the pre-twiddle
    const int* leaf = pt + PT_LEAF + (SHORT ? 64 : 0);
    const int e8 = __ldg(leaf + lane), e4 = __ldg(leaf + 32 + lane);
    const float w16 = tab[ROOTS16 + 1];
    if (!SHORT) {
#pragma unroll
        for (int it = 0; it < 4; ++it) {
            const int k = lane + 32 * it, o = order[k];
            const int ia = XS(o), ib = XS(255 - o);
            const float tr = tab[PRE1_R + k], ti = tab[PRE1_I + k];
            pre_long<FloatOps>(xa, re, im, ia, ib, CS(k), tr, ti);
            pre_long<FloatOps>(xb, re, im, ia, ib, CB(k), tr, ti);
        }
    } else {
#pragma unroll
        for (int it = 0; it < 2; ++it) {
            const int c = lane + 32 * it, k = order[c];
            const int i1a = XS(k), i1b = XS(254 - k), i2a = XS(k + 1),
                      i2b = XS(255 - k);
            const float tr = tab[PRE2_R + c], ti = tab[PRE2_I + c];
            pre_short<FloatOps>(xa, re, im, i1a, i1b, i2a, i2b, CS(c),
                                CS(64 + c), tr, ti);
            pre_short<FloatOps>(xb, re, im, i1a, i1b, i2a, i2b, CB(c),
                                CB(64 + c), tr, ti);
        }
    }
    __syncwarp();
    // the leaves: a round of ifft8s, a round of ifft4s (independent)
    pair_leaf<true>(re, im, e8, w16);
    pair_leaf<false>(re, im, e4, w16);
    __syncwarp();
    // the ifft_pass levels, a level's rounds independent of one another
    const int4* ps = reinterpret_cast<const int4*>(pt + PT_PASS) + lane +
                     (SHORT ? 7 * 32 : 0);
    constexpr int NL = SHORT ? 3 : 4;
    int r = 0;
#pragma unroll
    for (int L = 0; L < NL; ++L) {
        const int nr = (SHORT ? L == 1 : L == 2) ? 1 : 2;
#pragma unroll
        for (int q = 0; q < nr; ++q, ++r)
            pair_bf(re, im, __ldg(ps + 32 * r));
        __syncwarp();
    }
    if (!SHORT) {
#pragma unroll
        for (int it = 0; it < 2; ++it) {
            const int i = lane + 32 * it;
            const float tr = tab[POST1_R + i], ti = tab[POST1_I + i];
            post_long<FloatOps>(xa, re, im, dd, i, CS(i), CS(127 - i), tr,
                                ti);
            post_long<FloatOps>(xb, re, im, dd + 128, i, CB(i), CB(127 - i),
                                tr, ti);
        }
    } else {
        const int i = lane;
        const float tr = tab[POST2_R + i], ti = tab[POST2_I + i];
        post_short<FloatOps>(xa, re, im, dd, i, CS(i), CS(63 - i),
                             CS(64 + i), CS(127 - i), tr, ti);
        post_short<FloatOps>(xb, re, im, dd + 128, i, CB(i), CB(63 - i),
                             CB(64 + i), CB(127 - i), tr, ti);
    }
}

// one row alone, on the one-row code (B1's): row r of the pair's buffers
__device__ __forceinline__ void one_row(bool sh, float* x, float* re,
                                        float* im, float* dd, int r,
                                        const float* tab, const int* order,
                                        const int* sched, int lane)
{
    if (sh)
        short_row<FloatOps>(x, re + 128 * r, im + 128 * r, dd + 128 * r,
                            tab, order, sched, lane);
    else
        long_row<FloatOps>(x, re + 128 * r, im + 128 * r, dd + 128 * r,
                           tab, order, sched, lane);
}

// the OLA and the output of one row's outputs j = 2 lane + 64 k and j + 1,
// k < 4, from z (x, XS), the previous block's d (dp, DS: fold(d) at j is
// d[j] below 128, d[255 - j] above) and the window (win, natural order)
template <bool I16>
__device__ __forceinline__ void ola_pairs(const float* x, const float* dp,
                                          const float* win, float bv,
                                          void* pcm, long long row, int lane)
{
    const int h = lane >> 4;                       // XS swaps the pair
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int j = 2 * lane + 64 * k;
        const float2 v = *reinterpret_cast<const float2*>(x + (j ^ (2 * k)));
        const float z0 = h ? v.y : v.x, z1 = h ? v.x : v.y;
        const int e = k < 2 ? j : 254 - j, f = (e >> 5) & 1;  // DS swaps
        const float2 u = *reinterpret_cast<const float2*>(dp + e);
        const float lo = f ? u.y : u.x, hi = f ? u.x : u.y;   // d[e], d[e+1]
        const float d0 = k < 2 ? lo : hi, d1 = k < 2 ? hi : lo;
        const float2 w = *reinterpret_cast<const float2*>(win + j);
        const float2 wr = *reinterpret_cast<const float2*>(win + 254 - j);
        const float o0 = add(add(mul(z0, w.x), mul(d0, wr.y)), bv);
        const float o1 = add(add(mul(z1, w.y), mul(d1, wr.x)), bv);
        if (I16)
            *reinterpret_cast<unsigned*>(static_cast<short*>(pcm) + row * 256
                                         + j) = to_i16(o0) | to_i16(o1) << 16;
        else
            *reinterpret_cast<float2*>(static_cast<float*>(pcm) + row * 256
                                       + j) = make_float2(o0, o1);
    }
}

template <bool I16>
__global__ void __launch_bounds__(B1F_WARPS * 32)
fused_steady_exact_kernel(const float* __restrict__ freq,
                          const uint8_t* __restrict__ blksw,
                          const float* __restrict__ d0,
                          const float* __restrict__ bias,
                          const float* __restrict__ tab_g,
                          const int* __restrict__ order_g,
                          const int* __restrict__ pt_g,
                          const float* __restrict__ win_g,
                          void* __restrict__ pcm, float* __restrict__ dlast,
                          int n, int P, long long chains, int seg_len,
                          int nseg, long long items)
{
    __shared__ float tab[TAB_SIZE];
    __shared__ __align__(8) float win[256];
    __shared__ int order[128], sched[SCHED_SIZE];
    __shared__ __align__(16) float xbuf[B1F_WARPS][2][2][256];
    __shared__ __align__(16) float cbuf[B1F_WARPS][2][256];
    // d of both rows (DS, row B at 128), two blocks: a step writes its d
    // into buffer i & 1 and reads the block before's from the other
    __shared__ __align__(16) float dbuf[B1F_WARPS][2][256];
    for (int t = threadIdx.x; t < TAB_SIZE; t += blockDim.x)
        tab[t] = tab_g[t];
    for (int t = threadIdx.x; t < 256; t += blockDim.x)
        win[t] = win_g[t];
    for (int t = threadIdx.x; t < 128; t += blockDim.x)
        order[t] = order_g[t];
    for (int t = threadIdx.x; t < SCHED_SIZE; t += blockDim.x)
        sched[t] = SCHED[t];
    __syncthreads();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* re = cbuf[warp][0];
    float* im = cbuf[warp][1];
    const long long stride = (long long)gridDim.x * B1F_WARPS;
    for (long long it = (long long)blockIdx.x * B1F_WARPS + warp; it < items;
         it += stride) {
        const long long pair = it / nseg;
        const int seg = (int)(it - pair * nseg);
        const long long ca = 2 * pair, cb = ca + 1;
        const bool two = cb < chains;
        const long long ba = ca / P, bb = cb / P;
        const int i0 = seg * seg_len;
        const int i1 = min(n, i0 + seg_len);
        const int first = i0 > 0 ? i0 - 1 : 0;  // a halo step for d
        // row of block i: (b * n + i) * P + p
        const long long ra0 = ba * n * P + (ca - ba * P);
        const long long rb0 = bb * n * P + (cb - bb * P);
        if (i0 == 0) {
            // the chains' d0 where block 0 reads the block before's d
            float* dp = dbuf[warp][1];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int t = lane + 32 * k;
                dp[DS(t)] = d0[ca * 128 + t];
                if (two)
                    dp[128 + DS(t)] = d0[cb * 128 + t];
            }
        }
        fetch_row(xbuf[warp][first & 1][0],
                  freq + (ra0 + (long long)first * P) * 256, lane);
        if (two)
            fetch_row(xbuf[warp][first & 1][1],
                      freq + (rb0 + (long long)first * P) * 256, lane);
        cp_async_commit();
        // this step's flags and biases; the next step's are loaded a step
        // ahead
        bool sha = blksw != nullptr && blksw[ra0 + (long long)first * P];
        bool shb = two && blksw != nullptr &&
                   blksw[rb0 + (long long)first * P];
        float bva = bias[ba * n + first];
        float bvb = two ? bias[bb * n + first] : 0.0f;
        for (int i = first; i < i1; ++i) {
            const long long rowa = ra0 + (long long)i * P;
            const long long rowb = rb0 + (long long)i * P;
            float* xa = xbuf[warp][i & 1][0];
            float* xb = xbuf[warp][i & 1][1];
            float* dd = dbuf[warp][i & 1];
            const float* dp = dbuf[warp][(i + 1) & 1];
            bool sha_next = false, shb_next = false;
            float bva_next = 0.0f, bvb_next = 0.0f;
            if (i + 1 < i1) {
                fetch_row(xbuf[warp][(i + 1) & 1][0], freq + (rowa + P) * 256,
                          lane);
                if (two)
                    fetch_row(xbuf[warp][(i + 1) & 1][1],
                              freq + (rowb + P) * 256, lane);
                cp_async_commit();
                sha_next = blksw != nullptr && blksw[rowa + P];
                shb_next = two && blksw != nullptr && blksw[rowb + P];
                bva_next = bias[ba * n + i + 1];
                bvb_next = two ? bias[bb * n + i + 1] : 0.0f;
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncwarp();
            if (two && sha == shb) {
                if (sha)
                    pair_rows<true>(xa, xb, re, im, dd, tab, order, pt_g,
                                    lane);
                else
                    pair_rows<false>(xa, xb, re, im, dd, tab, order, pt_g,
                                     lane);
            } else {
                one_row(sha, xa, re, im, dd, 0, tab, order, sched, lane);
                if (two)
                    one_row(shb, xb, re, im, dd, 1, tab, order, sched, lane);
            }
            __syncwarp();
            if (i >= i0) {
                ola_pairs<I16>(xa, dp, win, bva, pcm, rowa, lane);
                if (two)
                    ola_pairs<I16>(xb, dp + 128, win, bvb, pcm, rowb, lane);
            }
            sha = sha_next;
            shb = shb_next;
            bva = bva_next;
            bvb = bvb_next;
            __syncwarp();
        }
        if (i1 == n) {
            const float* dl = dbuf[warp][(n - 1) & 1];
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int t = lane + 32 * k;
                dlast[ca * 128 + t] = dl[DS(t)];
                if (two)
                    dlast[cb * 128 + t] = dl[128 + DS(t)];
            }
        }
        __syncwarp();
    }
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

constexpr int QS_CTAS = 6;      // a cluster: CTA c splits blocks c, c + 6, ...
constexpr int QS_SPLIT = 6;     // a CTA's split warps: warp r takes slot r
constexpr int QS_WALK = 8;      // CTA 0's walk warps: a thread pair a k
constexpr int QS_RING = 1;      // blocks of each CTA that CTA 0 holds
constexpr int QS_THREADS = (QS_SPLIT + QS_WALK) * 32;

// the mixers of one StreamFormat (ops/fixed_chain.py:_Mix, byte for byte):
// out[o] = sum_c down[o][c] * in[c] + cbias[o] * bias (mod 2^32), the
// upmix likewise without a bias; the format's static facts beside them
struct FixedMix {
    int8_t down[25];
    int8_t up[25];
    int32_t cbias[5];
    int32_t nf, nf_out, lfe_out, remat, chanbias;
};

// dynamic shared memory of each CTA of the chain, in ints, in this order
enum : int {
    // CTA 0's: the rows of each CTA's ring blocks, z (XS) and d (DS), which
    // the split warps of that CTA write there
    CH_RZ = 0,
    CH_RD = CH_RZ + QS_RING * QS_CTAS * 6 * 256,
    // each CTA's: its split warps' rows, IFFT buffers, the block being
    // split as it came in, the tables
    CH_X = CH_RD + QS_RING * QS_CTAS * 6 * 128,
    CH_DD = CH_X + QS_SPLIT * 256,
    CH_RE = CH_DD + QS_SPLIT * 128,
    CH_IM = CH_RE + QS_SPLIT * 128,
    CH_F = CH_IM + QS_SPLIT * 128,              // freq [6][256]
    CH_TAB = CH_F + 6 * 256,
    CH_ORDER = CH_TAB + TAB_SIZE,
    CH_SCHED = CH_ORDER + 128,
    CH_RM = CH_SCHED + SCHED_SIZE,              // remat [256], bytes
    CH_FACT = CH_RM + 64,                       // blksw bits, zero bits, bias
    // CTA 0's: each CTA's ring blocks' flags and bias
    CH_META = CH_FACT + 3,
    CH_BAR = (CH_META + 2 * QS_RING * QS_CTAS + 1) & ~1,   // 8-byte mbarriers
    CH_INTS = CH_BAR + 2 * (QS_RING * QS_CTAS + QS_RING)
};
static_assert(CH_X % 4 == 0 && CH_DD % 4 == 0 && CH_RE % 4 == 0 &&
              CH_IM % 4 == 0 && CH_F % 4 == 0 && CH_TAB % 4 == 0 &&
              CH_ORDER % 4 == 0 && TAB_SIZE % 4 == 0,
              "16-byte accesses and copies");

// a ring block's flags (CH_META): bit 0 the frequency path, bits 1-5 its
// blksw, bits 6-10 the channels without coefficients
enum : int { QF_FREQ = 1, QF_SHORT = 1, QF_ZERO = 6 };

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
// block, on the first half of a short one) applied after its MUL; zj =
// z[j], df = fold(d)[j], wj = win[j], wjr = win[255 - j]
__device__ __forceinline__ int ola_fixed(int zj, int df, int wj, int wjr,
                                         int j, bool shrt, int bias)
{
    const unsigned m = (unsigned)FixedOps::mul(zj, wj);
    const unsigned o = (unsigned)FixedOps::mul(df, wjr);
    const bool neg = shrt ? j < 128 : (j & 1) == 0;
    return (int)((neg ? o - m : o + m) + (unsigned)bias);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t cluster_rank()
{
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

// the cluster address of this CTA's shared address `a` in CTA `rank`
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank)
{
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r) : "r"(a), "r"(rank));
    return r;
}

__device__ __forceinline__ void st_cluster(uint32_t a, int v)
{
    asm volatile("st.shared::cluster.u32 [%0], %1;\n"
                 :: "r"(a), "r"(v) : "memory");
}

// one arrival on an mbarrier of any CTA of the cluster (release at the
// cluster's scope: this thread's shared-memory writes and reads before it
// are ordered before the phase completes)
__device__ __forceinline__ void mbar_arrive(uint32_t cluster_addr)
{
    asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, "
                 "[%0];\n" :: "r"(cluster_addr) : "memory");
}

// until the phase of the given parity of this CTA's mbarrier has
// completed (acquire at the cluster's scope)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity)
{
    asm volatile("{\n"
                 ".reg .pred done;\n"
                 "WAIT_%=:\n"
                 "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
                 "done, [%0], %1;\n"
                 "@!done bra WAIT_%=;\n"
                 "}\n"
                 :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void st_cluster4(uint32_t a, int4 v)
{
    asm volatile("st.shared::cluster.v4.u32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(smem)), "l"(gmem) : "memory");
}

// the cluster barrier, split: every thread of the cluster arrives once
// and waits once, before its first access to another CTA or to an
// mbarrier it did not set up
__device__ __forceinline__ void cluster_arrive()
{
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait()
{
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the split warps' barrier (named barrier 1, the walk warps not in it)
__device__ __forceinline__ void split_sync()
{
    asm volatile("bar.sync 1, %0;\n" :: "n"(QS_SPLIT * 32) : "memory");
}

// the split warps bring block blk into shared memory: its coefficients
// by 16-byte asynchronous copies (and, first, the tables), its remat
// flags, blksw and coefficient flags (as bits) and bias by plain loads;
// the copies are waited for by split_wait
__device__ __forceinline__ void split_stage(
    const int* __restrict__ freq, const uint8_t* __restrict__ blksw,
    const float* __restrict__ coeff, const uint8_t* __restrict__ remat,
    const int* __restrict__ bias, const int* __restrict__ tab_g,
    const int* __restrict__ order_g, long long blk, bool tables, int* sm,
    int t)
{
    const int* f = freq + blk * 6 * 256;
    for (int i = t; i < 6 * 64; i += QS_SPLIT * 32)
        cp_async16(sm + CH_F + 4 * i, f + 4 * i);
    if (tables) {
        for (int i = t; i < TAB_SIZE / 4; i += QS_SPLIT * 32)
            cp_async16(sm + CH_TAB + 4 * i, tab_g + 4 * i);
        for (int i = t; i < 32; i += QS_SPLIT * 32)
            cp_async16(sm + CH_ORDER + 4 * i, order_g + 4 * i);
        for (int i = t; i < SCHED_SIZE; i += QS_SPLIT * 32)
            sm[CH_SCHED + i] = SCHED[i];
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    uint8_t* rm = reinterpret_cast<uint8_t*>(sm + CH_RM);
    for (int i = t; i < 256; i += QS_SPLIT * 32)
        rm[i] = remat[blk * 256 + i];
    if (t < 32) {
        const int lane = t;
        const unsigned bsm = __ballot_sync(
            0xffffffffu, lane < 5 && blksw[blk * 5 + lane] != 0);
        const unsigned czm = __ballot_sync(
            0xffffffffu, lane < 5 && coeff[blk * 5 + lane] == 0.0f);
        if (lane == 0) {
            sm[CH_FACT] = (int)bsm;
            sm[CH_FACT + 1] = (int)czm;
            sm[CH_FACT + 2] = bias[blk];
        }
    }
}

__device__ __forceinline__ void split_wait()
{
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    split_sync();
}

// the split warps of CTA `cta`: warp r splits slot r (r < 5 the block's
// path row r: coded channel r on the time path, output r of the mixed
// planes on the frequency path; r = 5 the LFE) of blocks cta, cta +
// QS_CTAS, ..., writes the row into CTA 0's ring entry of the block once
// the walk has left it, and arrives on CTA 0's full barrier of the entry,
// split or not.  The CTA's first block was staged before the cluster met.
__device__ void chain_split(const int* __restrict__ freq,
                            const uint8_t* __restrict__ blksw,
                            const float* __restrict__ coeff,
                            const uint8_t* __restrict__ remat,
                            const int* __restrict__ bias,
                            const int* __restrict__ tab_g,
                            const int* __restrict__ order_g, int n,
                            const FixedMix& mix, int dzero, int* sm,
                            uint64_t* full, uint64_t* empty, int cta,
                            int r, int lane)
{
    const int* const tab = sm + CH_TAB;
    const int* const order = sm + CH_ORDER;
    const int* const sched = sm + CH_SCHED;
    const int* const f = sm + CH_F;
    const uint8_t* const rm = reinterpret_cast<const uint8_t*>(sm + CH_RM);
    int* const x = sm + CH_X + r * 256;
    int* const dd = sm + CH_DD + r * 128;
    int* const re = sm + CH_RE + r * 128;
    int* const im = sm + CH_IM + r * 128;
    const int nf = mix.nf;
    const unsigned nfm = (1u << nf) - 1;
    const bool rmx = mix.remat != 0, reduces = mix.nf_out < nf,
               lfe = mix.lfe_out != 0;
    // the downmix row r, for the frequency path's input (the rows packed
    // 2 bits an entry, -1 as 3, so that r may pick one at run time)
    unsigned long long down = 0;
#pragma unroll
    for (int i = 0; i < 25; ++i)
        down |= (unsigned long long)(mix.down[i] & 3) << (2 * i);
    int dn[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
        const int m2 = r < 5 ? (int)(down >> (2 * (r * 5 + c))) & 3 : 0;
        dn[c] = m2 == 3 ? -1 : m2;
    }
    for (int m = 0; cta + m * QS_CTAS < n; ++m) {
        const long long blk = cta + (long long)m * QS_CTAS;
        const int e = m % QS_RING;
        if (m > 0) {
            split_sync();                // every warp is done with blk - 6
            split_stage(freq, blksw, coeff, remat, bias, tab_g, order_g, blk,
                        false, sm, r * 32 + lane);
        }
        split_wait();
        // the block's path: blksw alone decides it
        const unsigned bsm = sm[CH_FACT], czm = sm[CH_FACT + 1];
        const bool uniform = (bsm & nfm) == 0 || (bsm & nfm) == nfm;
        const bool fp = reduces && uniform;
        // a frequency-path row of an all-zero mix splits to 0, a time-path
        // channel without coefficients is not read
        const bool need = r == 5 ? lfe : fp ? !((dzero >> r) & 1)
                                            : !((czm >> r) & 1);
        if (need) {
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
                        if (dn[c] != 0)
                            acc += wrap_mul(dn[c], coef(f, rm, c, j, rmx));
                    v = (int)acc;
                }
                x[XS(j)] = v;
            }
            __syncwarp();
            if (r < 5 && ((bsm >> (fp ? 0 : r)) & 1))
                short_row<FixedOps>(x, re, im, dd, tab, order, sched, lane);
            else
                long_row<FixedOps>(x, re, im, dd, tab, order, sched, lane);
            __syncwarp();
        }
        if (m == 0)
            cluster_wait();              // every mbarrier is set up
        if (m >= QS_RING)
            mbar_wait(empty + e, (m / QS_RING - 1) & 1);
        // the row into CTA 0's ring entry, in its layouts (16 B a store)
        const int slot = (e * QS_CTAS + cta) * 6 + r;
        if (need) {
            const int4* xv = reinterpret_cast<const int4*>(x);
            const int4* dv = reinterpret_cast<const int4*>(dd);
            const uint32_t zr = mapa(smem_u32(sm + CH_RZ + slot * 256), 0);
            const uint32_t dr = mapa(smem_u32(sm + CH_RD + slot * 128), 0);
            st_cluster4(zr + 16 * lane, xv[lane]);
            st_cluster4(zr + 16 * (32 + lane), xv[32 + lane]);
            st_cluster4(dr + 16 * lane, dv[lane]);
        }
        if (r == 0 && lane == 0) {
            const uint32_t meta = mapa(
                smem_u32(sm + CH_META + 2 * (e * QS_CTAS + cta)), 0);
            st_cluster(meta, (fp ? QF_FREQ : 0) | (int)bsm << QF_SHORT |
                                 (int)czm << QF_ZERO);
            st_cluster(meta + 4, sm[CH_FACT + 2]);
        }
        // every lane's arrival releases its own stores
        mbar_arrive(mapa(smem_u32(full + e * QS_CTAS + cta), 0));
    }
}

// CTA 0's walk warps: thread t takes position k = t & 127 and output j =
// k (t < 128) or 255 - k, both of which read fold(d) at k, and walks every
// block with the delay [6] at k and downmixed in registers
__device__ void chain_walk(const int* __restrict__ delay_in,
                           const uint8_t* __restrict__ dmx_in,
                           const int* __restrict__ win_g,
                           int* __restrict__ pcm, int* __restrict__ delay_out,
                           uint8_t* __restrict__ dmx_out, int n,
                           const FixedMix& mix, int dzero, const int* sm,
                           uint64_t* full, uint64_t* empty, int t)
{
    const int k = t & 127, j = t < 128 ? k : 255 - k;
    const int wj = win_g[j], wjr = win_g[255 - j];
    const int nfo = mix.nf_out, lfe = mix.lfe_out != 0;
    const int nch = nfo + lfe;
    int dl[6];
#pragma unroll
    for (int c = 0; c < 6; ++c)
        dl[c] = delay_in[c * 128 + k];
    bool dmx = dmx_in[0] != 0;
    cluster_wait();                      // the full mbarriers are set up
    for (int blk = 0; blk < n; ++blk) {
        const int c = blk % QS_CTAS, m = blk / QS_CTAS, e = m % QS_RING;
        const int ent = e * QS_CTAS + c;
        mbar_wait(full + ent, (m / QS_RING) & 1);
        const int flags = sm[CH_META + 2 * ent];
        const int bv = sm[CH_META + 2 * ent + 1];
        const bool fp = flags & QF_FREQ;
        const int* zb = sm + CH_RZ + ent * 6 * 256 + XS(j);
        const int* db = sm + CH_RD + ent * 6 * 128 + DS(k);
        // the delay this block's rows see: time path delay_t = downmixed ?
        // U.delay : delay; frequency path delay_f = downmixed ? delay :
        // D.delay; the LFE's own
        int ds[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) {
            unsigned acc = 0;
            if (fp && !dmx) {
#pragma unroll
                for (int w = 0; w < 5; ++w)
                    acc += wrap_mul(mix.down[q * 5 + w], dl[w]);
            } else if (!fp && dmx) {
#pragma unroll
                for (int w = 0; w < 5; ++w)
                    acc += wrap_mul(mix.up[q * 5 + w], dl[w]);
            }
            ds[q] = fp != dmx ? (int)acc : dl[q];
        }
        int* out = pcm + (long long)blk * nch * 256 + j;
        if (lfe) {
            out[0] = ola_fixed(zb[5 * 256], dl[5], wj, wjr, j, false, bv);
            out += 256;
        }
        if (fp) {
            const bool sh = (flags >> QF_SHORT) & 1;
#pragma unroll
            for (int p = 0; p < 5; ++p)
                if (p < nfo)
                    out[p * 256] = ola_fixed((dzero >> p) & 1 ? 0
                                                              : zb[p * 256],
                                             ds[p], wj, wjr, j, sh, bv);
        } else {
            int tout[5];
#pragma unroll
            for (int q = 0; q < 5; ++q)
                tout[q] = (flags >> (QF_ZERO + q)) & 1
                              ? bv
                              : ola_fixed(zb[q * 256], ds[q], wj, wjr, j,
                                          (flags >> (QF_SHORT + q)) & 1,
                                          (mix.chanbias >> q) & 1 ? 0 : bv);
#pragma unroll
            for (int p = 0; p < 5; ++p) {
                if (p < nfo) {
                    unsigned acc = wrap_mul(mix.cbias[p], bv);
#pragma unroll
                    for (int q = 0; q < 5; ++q)
                        acc += wrap_mul(mix.down[p * 5 + q], tout[q]);
                    out[p * 256] = (int)acc;
                }
            }
        }
        // the new delay at k: the rows' d; a frequency-path row of an
        // all-zero mix 0; a time-path channel without coefficients keeps
        // delay_t; the LFE's only when it is decoded
        if (lfe)
            dl[5] = db[5 * 128];
#pragma unroll
        for (int q = 0; q < 5; ++q)
            dl[q] = fp ? ((dzero >> q) & 1 ? 0 : db[q * 128])
                       : (flags >> (QF_ZERO + q)) & 1 ? ds[q] : db[q * 128];
        dmx = fp;
        // the entry is free for CTA c's next block, where there is one
        if (blk + QS_CTAS * QS_RING < n)
            mbar_arrive(mapa(smem_u32(empty + e), c));
    }
    if (t < 128) {
#pragma unroll
        for (int c = 0; c < 6; ++c)
            delay_out[c * 128 + k] = dl[c];
    }
    if (t == 0)
        dmx_out[0] = dmx ? 1 : 0;
}

__global__ void __cluster_dims__(QS_CTAS, 1, 1) __launch_bounds__(QS_THREADS)
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
    uint64_t* const full = reinterpret_cast<uint64_t*>(sm + CH_BAR);
    uint64_t* const empty = full + QS_RING * QS_CTAS;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int cta = (int)cluster_rank();
    // the CTA's first block and the tables start coming in while the
    // cluster meets
    if (warp < QS_SPLIT && cta < n)
        split_stage(freq, blksw, coeff, remat, bias, tab_g, order_g, cta,
                    true, sm, tid);
    // the frequency path's rows whose downmix row is all zero: their
    // input and so their z and d are 0
    int dzero = 0;
#pragma unroll
    for (int p = 0; p < 5; ++p) {
        bool z = true;
#pragma unroll
        for (int c = 0; c < 5; ++c)
            z = z && mix.down[p * 5 + c] == 0;
        dzero |= (int)z << p;
    }
    if (tid == 0) {
        if (cta == 0)
            for (int e = 0; e < QS_RING * QS_CTAS; ++e)
                mbar_init(full + e, QS_SPLIT * 32);
        for (int e = 0; e < QS_RING; ++e)
            mbar_init(empty + e, QS_WALK * 32);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // every mbarrier of the cluster is set up before any thread's wait
    // on the cluster barrier returns
    cluster_arrive();
    if (warp < QS_SPLIT)
        chain_split(freq, blksw, coeff, remat, bias, tab_g, order_g, n, mix,
                    dzero, sm, full, empty, cta, warp, lane);
    else if (cta == 0)
        chain_walk(delay_in, dmx_in, win_g, pcm, delay_out, dmx_out, n, mix,
                   dzero, sm, full, empty, tid - QS_SPLIT * 32);
    else
        cluster_wait();
    // No CTA needs to wait for the others at the end: a split CTA's last
    // access to CTA 0 is ordered before the walk's wait that returns on
    // it, and the walk touches a split CTA only to free an entry that CTA
    // still waits for.
}

// kernels that do nothing, launched with the given dynamic shared memory:
// what a launch of that shape costs on the card, the yardstick of B1QS's
// call with no blocks (one CTA, or a cluster of B1QS's QS_CTAS)
__global__ void bare_kernel() {}
__global__ void __cluster_dims__(QS_CTAS, 1, 1) bare_cluster_kernel() {}

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
                                         const void* ptab, const void* win,
                                         void* pcm, void* dlast, int B, int n,
                                         int P, int emit_int16, void* stream)
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
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, B1F_WARPS * 32, 0);
    if (e != cudaSuccess)
        return (int)e;
    const long long resident =
        (long long)sms * (per_sm > 0 ? per_sm : 1) * B1F_WARPS;
    // segments: about B1F_ITEMS a resident warp over the chunk's pair
    // steps, of at least 8 steps (the halo step costs 1/seg_len), of
    // equal length within a chain
    const long long pairs = (chains + 1) / 2;
    const long long steps = pairs * n;
    const long long per = B1F_ITEMS * resident;
    long long target = (steps + per - 1) / per;
    if (target < 8)
        target = 8;
    const int nseg = (int)((n + target - 1) / target);
    const int seg_len = (n + nseg - 1) / nseg;
    const long long items = pairs * nseg;
    const long long per_warp = (items + resident - 1) / resident;
    const long long warps = (items + per_warp - 1) / per_warp;
    const long long blocks = (warps + B1F_WARPS - 1) / B1F_WARPS;
    cudaStream_t s = (cudaStream_t)stream;
    kernel<<<(unsigned)blocks, B1F_WARPS * 32, 0, s>>>(
        (const float*)freq, (const uint8_t*)blksw, (const float*)d0,
        (const float*)bias, (const float*)tab, (const int*)order,
        (const int*)ptab, (const float*)win, pcm, (float*)dlast, n, P,
        chains, seg_len, nseg, items);
    return (int)cudaGetLastError();
}

extern "C" int fixed_chain_mix_size() { return (int)sizeof(FixedMix); }

// B1QS's launch: {dynamic shared memory bytes a CTA, threads a CTA, CTAs
// (one cluster)}, for the bare launch beside it
extern "C" void fixed_chain_shape(int* out)
{
    out[0] = CH_INTS * (int)sizeof(int);
    out[1] = QS_THREADS;
    out[2] = QS_CTAS;
}

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
    if (smem > 48 * 1024) {
        // above the 48 KB a launch gets unasked (a refused launch never
        // runs); the attribute lasts as long as the process, so it is set
        // at a device's first launch (one bit a device, 64 devices)
        static std::atomic<unsigned long long> smem_set{0};
        int dev = 0;
        cudaError_t e = cudaGetDevice(&dev);
        if (e != cudaSuccess)
            return (int)e;
        const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
        if (!(smem_set.load() & bit) || !bit) {
            e = cudaFuncSetAttribute(
                fixed_chain_kernel,
                cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
            if (e != cudaSuccess)
                return (int)e;
            smem_set.fetch_or(bit);
        }
    }
    fixed_chain_kernel<<<QS_CTAS, QS_THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)freq, (const uint8_t*)blksw, (const float*)coeff,
        (const uint8_t*)remat, (const int*)bias, (const int*)delay_in,
        (const uint8_t*)dmx_in, (const int*)tab, (const int*)order,
        (const int*)win, (int*)pcm, (int*)delay_out, (uint8_t*)dmx_out, n,
        *(const FixedMix*)mix);
    return (int)cudaGetLastError();
}

// one launch of a kernel that does nothing: `smem` bytes of dynamic shared
// memory (above 48 KB the attribute is set first) and `threads` threads a
// CTA, one CTA (cluster 1) or a cluster of QS_CTAS (cluster QS_CTAS)
extern "C" int imdct_exact_bare_launch(int smem, int threads, int cluster,
                                       void* stream)
{
    if (cluster != 1 && cluster != QS_CTAS)
        return (int)cudaErrorInvalidValue;
    const void* fn = cluster == 1 ? (const void*)bare_kernel
                                  : (const void*)bare_cluster_kernel;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess)
            return (int)e;
    }
    if (cluster == 1)
        bare_kernel<<<1, threads, smem, (cudaStream_t)stream>>>();
    else
        bare_cluster_kernel<<<QS_CTAS, threads, smem,
                              (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" const char* imdct_exact_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
