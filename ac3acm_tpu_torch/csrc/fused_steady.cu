// Fused steady decode for Hopper (sm_90a): 3xTF32 tensor-core GEMM (wgmma)
// + OLA chain + int16, in one kernel.
//
// Replaces the TPU kernel ac3acm_tpu/ops/pallas_steady.py:_kernel (built by
// fused_steady, dispatched by parallel/pipeline.py:_fused_run).  Per row
// r = (b, i, p) of the premixed long-only planes:
//
//     zd   = freq[r] @ W[256, 384];  z = zd[:256], d = zd[256:]
//     dch  = d[b, i-1, p]  (i = 0: d0[b, p])
//     out  = z*win + [dch, reverse(dch)]*win[::-1] + bias[b, i]
//     pcm  = clip(rint((out - 384) * 32768), -32768, 32767)    (int16)
//     dlast[b, p] = d[b, n-1, p]
//
// Bound on the card.  The function itself is bound by bytes: 1,536 bytes a
// row (1 KB of freq in, 512 B of int16 out) at 3.35 TB/s take longer than
// its 2*256*384 = 196,608 FLOP at the tensor cores' 495 TFLOP/s for float32
// (TF32) operands.  THIS design is bound by tensor operations: it reaches
// the contract with three TF32 passes (below), 589,824 tensor FLOP a row,
// 384 FLOP/B against the card's 148 FLOP/B ridge, which costs 2.6 times the
// function's byte bound before anything else.  (Three bf16 passes, the TPU
// kernel's split, would cost 1.3 times it at the bf16 rate, if the 16
// significant bits of an 8 + 8 split hold the contract on this content.)
//
// The split (3xTF32).  One TF32 pass keeps 11 significant bits and breaks the
// <= 1 LSB contract; x = hi + lo with hi = rna_tf32(x), lo = rna_tf32(x - hi)
// keeps 22.  W is split once on the host (ops/filterbank.py:split_tf32) into
// Wt_hi, Wt_lo = [384, 256], K contiguous, which is the only operand form
// wgmma takes for TF32; the kernel reads them cut into K steps of 8 and laid
// out as its shared memory holds them (wt_tiles_on), so a step's B operand
// is one contiguous 24,576-byte run.  freq is split here, per fragment, in
// registers: hi is rounded explicitly (cvt.rna) before it is subtracted,
// because the tensor cores would only truncate it.  Per K step the small
// terms go first: acc += hi*w_lo; acc += lo*w_hi; acc += hi*w_hi, FP32
// accumulators; lo*w_lo (2^-22 of the product) is dropped.
//
// Tiles.  A CTA is two warpgroups of 128 threads; each owns one chain
// (b, p) and walks its 64-row tiles in order.  Per tile and warpgroup the
// accumulators are 64 x 384 FP32 in registers: one m64n256k8 (z) and one
// m64n128k8 (d) wgmma per pass and K step of 8, 192 registers a thread.
// A comes from registers (loaded from a staged FP32 tile in the fragment
// layout and split there: no second shared-memory tile, and no ordinary
// store that the tensor cores read); B comes from shared memory through a
// matrix descriptor, K-major, 32-byte swizzle (a K step of 8 floats is 32
// bytes a row).
//
// Copies in flight.  A ring of STAGES = 4 K-steps in dynamic shared memory;
// a stage holds Wt_hi[384, 8], Wt_lo[384, 8] (12,288 B each, from L2) and
// the 128 x 8 freq tile of both warpgroups (4,096 B), copied with cp.async
// 16 bytes a thread, three steps ahead, with a fence.proxy.async between the
// copies' arrival and the wgmma that reads them.  The ring runs on across
// tile boundaries, so the next tile's first stages load while the epilogue
// runs.  While the wgmmas of step s run, the threads wait for stage s+1,
// start the copies of stage s+3 and load and split the A fragments of step
// s+1 into a second register set.
//
// The chain across rows.  Row i needs d of row i-1 of the same chain.  A
// warpgroup keeps one chain to itself and carries the last d row of a tile
// in shared memory to the next tile (row 0 of its d buffer; d0 before the
// first tile), so there is no halo row and nothing is computed twice.  The
// tile that holds i = n-1 writes dlast.  Rows past n are zero-filled on load
// and masked on store; an odd chain count leaves one warpgroup masked.
//
// The epilogue keeps its bits: d goes to shared memory, then each product
// and sum is rounded on its own (__fmul_rn / __fadd_rn; the half-to-even
// rounding is one more such add), so given equal z and d it equals the plain
// PyTorch version bitwise; only the GEMM differs (3xTF32 against FP32 FMA,
// both within an ulp or two of the exact sums).  The int16 tile is staged
// through shared memory (over the d buffer) so that global stores are 16
// bytes a thread, 512 B a row.  No atomics and no split-K: equal inputs give
// equal bytes.
//
// Resources (nvcc 12.9 -Xptxas -v, sm_90a): 242 registers, no spills, 256
// threads, one CTA per SM, 186,688 B of dynamic shared memory (4 x 28,672 B
// ring, 2 x 35,360 B d/int16 buffers, 1 KB window, 256 B alignment slack).
// What holds it off its bound (PERF.md has the numbers): the epilogue of a
// tile runs with the tensor cores idle (both warpgroups reach it together),
// and the 28 KB a step that every CTA pulls from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WG_ROWS = 64;               // chain rows per warpgroup tile
constexpr int NWG = 2;                    // warpgroups (chains) per CTA
constexpr int THREADS = 128 * NWG;
constexpr int BK = 8;                     // K per stage = one wgmma K step
constexpr int KDIM = 256;
constexpr int KSTEPS = KDIM / BK;         // 32
constexpr int NW = 384;                   // z (256) ++ d (128)
constexpr int NZ = 256;
constexpr int ND = 128;
constexpr int STAGES = 4;

constexpr int W_TILE_BYTES = NW * BK * 4;                    // 12,288
constexpr int A_TILE_BYTES = NWG * WG_ROWS * BK * 4;         // 4,096
constexpr int STAGE_BYTES = 2 * W_TILE_BYTES + A_TILE_BYTES; // 28,672
constexpr int DS_STRIDE = 136;            // floats; 8-bank shift a row
constexpr int DS_ROWS = WG_ROWS + 1;      // row 0 = carry, t+1 = tile row t
constexpr int EPI_BYTES = DS_ROWS * DS_STRIDE * 4;           // 35,360
constexpr int STG_OFFSET = DS_STRIDE * 4; // int16 staging starts after row 0
constexpr int STG_STRIDE = 528;           // bytes a staged int16 row
constexpr int WIN_BYTES = 256 * 4;
constexpr int ALIGN_SLACK = 256;          // swizzle pattern repeat
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + NWG * EPI_BYTES
                           + WIN_BYTES + ALIGN_SLACK;

static_assert(STG_OFFSET + WG_ROWS * STG_STRIDE <= EPI_BYTES, "staging");
static_assert(STAGE_BYTES % 256 == 0 && W_TILE_BYTES % 256 == 0, "align");
static_assert(KSTEPS % 2 == 0, "the step loop is unrolled by two");
static_assert(SMEM_BYTES <= 232448, "shared memory a block can use");

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// 16-byte global -> shared copy; src_bytes = 0 zero-fills
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes)
{
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// cp.async writes through the generic proxy, wgmma reads shared memory
// through the async proxy
__device__ __forceinline__ void fence_proxy_async()
{
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bar_sync_wg(int wg)
{
    asm volatile("bar.sync %0, 128;\n" :: "r"(wg + 1) : "memory");
}

// keeps a register live (and unmoved) up to this point: an asynchronous
// wgmma still reads or writes it after the asm that started it
__device__ __forceinline__ void keep(uint32_t& r)
{
    asm volatile("" : "+r"(r) :: "memory");
}

__device__ __forceinline__ void keep(float& r)
{
    asm volatile("" : "+f"(r) :: "memory");
}

__device__ __forceinline__ uint32_t rna_tf32(float x)
{
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

// B tile in shared memory: [rows (N)][8 floats], K-major, 32-byte swizzle.
// Row r is 32 bytes at r * 32; its two 16-byte chunks swap when bit 7 of
// the address is set (Swizzle<1,4,3>), i.e. for rows 4..7 of every 8, so
// element (r, k) lies at r * 32 + (((k >> 2) ^ ((r >> 2) & 1)) << 4)
// + (k & 3) * 4.  The host lays Wt out this way (wt_tiles_on), so the
// kernel copies a tile as it is; the tile base is 256-byte aligned.
//
// matrix descriptor: start address, leading byte offset (unused for a
// swizzled K-major tile: 1), stride byte offset (8 rows = 256 B), all in
// 16-byte units; layout type 3 = 32-byte swizzle
__device__ __forceinline__ uint64_t w_desc(uint32_t addr)
{
    return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16)
           | ((uint64_t)(256 >> 4) << 32) | ((uint64_t)3 << 62);
}

#define FS_F8(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]),            \
    "+f"(a[i + 3]), "+f"(a[i + 4]), "+f"(a[i + 5]), "+f"(a[i + 6]),       \
    "+f"(a[i + 7])
#define FS_F64(a, i) FS_F8(a, i), FS_F8(a, i + 8), FS_F8(a, i + 16),      \
    FS_F8(a, i + 24), FS_F8(a, i + 32), FS_F8(a, i + 40),                 \
    FS_F8(a, i + 48), FS_F8(a, i + 56)

// acc[64 x 256] += A[64 x 8] (registers) * B[8 x 256] (shared memory)
__device__ __forceinline__ void wgmma_n256(float (&acc)[128],
                                           const uint32_t (&a)[4],
                                           uint64_t desc)
{
    asm volatile(
        "{\n"
        "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
        " %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
        " %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        " %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
        " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
        " %120, %121, %122, %123, %124, %125, %126, %127},"
        " {%128, %129, %130, %131}, %132, 1, 1, 1;\n"
        "}\n"
        : FS_F64(acc, 0), FS_F64(acc, 64)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// acc[64 x 128] += A[64 x 8] (registers) * B[8 x 128] (shared memory)
__device__ __forceinline__ void wgmma_n128(float (&acc)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc)
{
    asm volatile(
        "{\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
        " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
        " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
        " %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, 1, 1, 1;\n"
        "}\n"
        : FS_F64(acc, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc));
}

// one output sample, each product and sum rounded on its own.  Clamping
// first and rounding after equals rounding first (the bounds are integers,
// rounding is monotone); adding 1.5 * 2^23 rounds a float of magnitude
// <= 2^22 to the nearest integer, ties to even, exactly as rintf does, and
// leaves that integer in the sum's low mantissa bits.
__device__ __forceinline__ uint32_t to_i16(float z, float wz, float dv,
                                           float wr, float bi)
{
    const float o = __fadd_rn(__fadd_rn(__fmul_rn(z, wz), __fmul_rn(dv, wr)),
                              bi);
    float x = __fmul_rn(__fsub_rn(o, 384.f), 32768.f);
    x = fminf(fmaxf(x, -32768.f), 32767.f);
    return __float_as_uint(__fadd_rn(x, 12582912.f)) & 0xffffu;
}

// kernel arguments (constant bank: they cost no registers)
struct Args {
    const float* freq;
    const float* d0;
    const float* bias;
    const float* wt;          // [KSTEPS][2][384][8]: Wt_hi, Wt_lo per K step,
                              // each tile in its shared-memory order
    const float* win;
    int16_t* pcm;
    float* dlast;
    int n, P, nchains;
};

// what the step loop keeps in registers
struct Ctx {
    uint8_t* smem;            // aligned base (generic)
    uint32_t sbase;           // the same, shared-space address
    const float* asrc;        // this thread's freq chunk in tile 0, k0 = 0
    int nsteps;
    bool valid;               // the warpgroup has a chain
};

// chain (b * P + p) of warpgroup wg; first element of its row (b, 0, p)
__device__ __forceinline__ int chain_of(int wg)
{
    return blockIdx.x * NWG + wg;
}

__device__ __forceinline__ int64_t chain_base(const Args& a, int chain)
{
    const int cc = chain < a.nchains ? chain : a.nchains - 1;
    return ((int64_t)(cc / a.P) * a.n * a.P + cc % a.P) * 256;
}

// the copies of step s: the 24,576 contiguous bytes of Wt_hi and Wt_lo for
// K step s % 32 (already in their shared-memory order), and columns
// [k0, k0 + 8) of rows [tile * 64, +64) of both warpgroups' chains
__device__ __forceinline__ void start_copies(const Args& a, const Ctx& c,
                                            int s)
{
    const int tid = threadIdx.x;
    const int tile = s / KSTEPS;
    const int ks = s % KSTEPS;
    const uint32_t buf = c.sbase + (s % STAGES) * STAGE_BYTES;
    const float* wsrc = a.wt + ks * (2 * W_TILE_BYTES / 4) + tid * 4;
#pragma unroll
    for (int v = 0; v < 2 * W_TILE_BYTES / (16 * THREADS); v++)
        cp_async16(buf + tid * 16 + v * THREADS * 16,
                   wsrc + v * THREADS * 4, 16);
    // freq: thread tid copies 16-byte chunk tid % 2 of tile row tid / 2
    // (rows 0..63 are warpgroup 0's, 64..127 warpgroup 1's: its own)
    const int i = tile * WG_ROWS + ((tid >> 1) % WG_ROWS);
    const bool ok = c.valid && i < a.n;
    const float* src = ok ? c.asrc + (int64_t)tile * WG_ROWS * a.P * 256
                                + ks * BK
                          : a.freq;
    cp_async16(buf + 2 * W_TILE_BYTES + tid * 16, src, ok ? 16 : 0);
}

// A fragments of step s, split: thread (g, q) of warp w holds rows
// 16w + g and 16w + g + 8, columns q and q + 4
__device__ __forceinline__ void load_split(const Ctx& c, int s,
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4])
{
    const int tid = threadIdx.x;
    // row = 64 wg + 16 warp + g = tid / 128 * 64 + tid % 128 / 32 * 16 + ...
    const int row = (tid >> 7) * WG_ROWS + ((tid >> 5) & 3) * 16
                    + ((tid & 31) >> 2);
    const float* a = reinterpret_cast<const float*>(
        c.smem + (s % STAGES) * STAGE_BYTES + 2 * W_TILE_BYTES)
        + row * BK + (tid & 3);
    const float x[4] = {a[0], a[8 * BK], a[4], a[8 * BK + 4]};
#pragma unroll
    for (int e = 0; e < 4; e++) {
        hi[e] = rna_tf32(x[e]);
        lo[e] = rna_tf32(x[e] - __uint_as_float(hi[e]));
    }
}

// window, OLA chain, bias, int16 and the stores of one finished tile
__device__ __forceinline__ void epilogue(const Args& a, const Ctx& c,
                                         int tile, const float (&z)[128],
                                         const float (&dd)[64])
{
    const int tid = threadIdx.x;
    const int wg = tid >> 7, t = tid & 127, q = tid & 3;
    const int row0 = ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
    const int i0 = tile * WG_ROWS;
    float* dS = reinterpret_cast<float*>(
        c.smem + STAGES * STAGE_BYTES + wg * EPI_BYTES);
    const float* winS = reinterpret_cast<const float*>(
        c.smem + STAGES * STAGE_BYTES + NWG * EPI_BYTES);
    uint8_t* stg = reinterpret_cast<uint8_t*>(dS) + STG_OFFSET;

    // d of tile row t -> dS row t + 1 (row 0 holds d of block i0 - 1)
#pragma unroll
    for (int j = 0; j < 16; j++) {
        const int col = 8 * j + 2 * q;
        *reinterpret_cast<float2*>(dS + (row0 + 1) * DS_STRIDE + col) =
            make_float2(dd[4 * j], dd[4 * j + 1]);
        *reinterpret_cast<float2*>(dS + (row0 + 9) * DS_STRIDE + col) =
            make_float2(dd[4 * j + 2], dd[4 * j + 3]);
    }
    bar_sync_wg(wg);

    const int chain = chain_of(wg);
    const int tlast = a.n - 1 - i0;
    if (c.valid && tlast < WG_ROWS)
        a.dlast[(int64_t)chain * ND + t] = dS[(tlast + 1) * DS_STRIDE + t];
    const float carry = dS[WG_ROWS * DS_STRIDE + t];

    float bi[2];
    {
        const int cc = c.valid ? chain : a.nchains - 1;
        const float* brow = a.bias + (int64_t)(cc / a.P) * a.n;
#pragma unroll
        for (int h = 0; h < 2; h++) {
            const int i = i0 + row0 + 8 * h;
            bi[h] = __ldg(brow + (i < a.n ? i : a.n - 1));
        }
    }
    uint32_t pk[64];                               // [j][h]: two samples
#pragma unroll
    for (int j = 0; j < 32; j++) {
        const int col = 8 * j + 2 * q;
        const float2 wz = *reinterpret_cast<const float2*>(winS + col);
        // (win[254 - col], win[255 - col]) = win_r at col + 1, col
        const float2 wr = *reinterpret_cast<const float2*>(winS + 254 - col);
#pragma unroll
        for (int h = 0; h < 2; h++) {
            const float* drow = dS + (row0 + 8 * h) * DS_STRIDE;
            float2 dv;
            if (j < 16) {
                dv = *reinterpret_cast<const float2*>(drow + col);
            } else {
                const float2 rv =
                    *reinterpret_cast<const float2*>(drow + 254 - col);
                dv = make_float2(rv.y, rv.x);
            }
            pk[2 * j + h] =
                to_i16(z[4 * j + 2 * h], wz.x, dv.x, wr.y, bi[h])
                | (to_i16(z[4 * j + 2 * h + 1], wz.y, dv.y, wr.x, bi[h])
                   << 16);
        }
    }
    bar_sync_wg(wg);                               // every read of dS done

    dS[t] = carry;                                 // next tile's row 0
#pragma unroll
    for (int j = 0; j < 32; j++)
#pragma unroll
        for (int h = 0; h < 2; h++)
            *reinterpret_cast<uint32_t*>(
                stg + (row0 + 8 * h) * STG_STRIDE + (4 * j + q) * 4) =
                pk[2 * j + h];
    bar_sync_wg(wg);

    // 16 bytes a thread, a 512-byte row per warp
    int16_t* prow = a.pcm + chain_base(a, chain) + (t % 32) * 8;
    const int64_t rstride = (int64_t)a.P * 256;
#pragma unroll 4
    for (int it = 0; it < WG_ROWS / 4; it++) {
        const int rr = it * 4 + t / 32;
        const int i = i0 + rr;
        if (c.valid && i < a.n)
            *reinterpret_cast<uint4*>(prow + i * rstride) =
                *reinterpret_cast<const uint4*>(
                    stg + rr * STG_STRIDE + (t % 32) * 16);
    }
}

// One K step: the six wgmmas of step s on the `cur` fragments; while they
// run, the bookkeeping of the ring and the fragments of step s + 1 (`nxt`).
__device__ __forceinline__ void step(const Args& a, const Ctx& c, int s,
                                     float (&z)[128], float (&dd)[64],
                                     uint32_t (&cur_h)[4],
                                     uint32_t (&cur_l)[4],
                                     uint32_t (&nxt_h)[4],
                                     uint32_t (&nxt_l)[4])
{
    const uint32_t wb = c.sbase + (s % STAGES) * STAGE_BYTES;
    const uint64_t hi_z = w_desc(wb);
    const uint64_t hi_d = w_desc(wb + NZ * BK * 4);
    const uint64_t lo_z = w_desc(wb + W_TILE_BYTES);
    const uint64_t lo_d = w_desc(wb + W_TILE_BYTES + NZ * BK * 4);

    wgmma_fence();
    wgmma_n256(z, cur_h, lo_z);
    wgmma_n128(dd, cur_h, lo_d);
    wgmma_n256(z, cur_l, hi_z);
    wgmma_n128(dd, cur_l, hi_d);
    wgmma_n256(z, cur_h, hi_z);
    wgmma_n128(dd, cur_h, hi_d);
    wgmma_commit();

    // step s - 1 is done: its fragments (`nxt`) and its stage are free
    wgmma_wait<1>();
#pragma unroll
    for (int e = 0; e < 4; e++) {
        keep(nxt_h[e]);
        keep(nxt_l[e]);
    }
    cp_async_wait<STAGES - 3>();    // this thread's copies of stage s + 1
    fence_proxy_async();
    __syncthreads();                // everyone's; and everyone past s - 1
    if (s + STAGES - 1 < c.nsteps)
        start_copies(a, c, s + STAGES - 1);
    cp_async_commit();
    if (s + 1 < c.nsteps)
        load_split(c, s + 1, nxt_h, nxt_l);
}

__global__ void __launch_bounds__(THREADS, 1)
fused_steady_kernel(const __grid_constant__ Args a)
{
    extern __shared__ uint8_t smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t pad = (ALIGN_SLACK - (raw & (ALIGN_SLACK - 1)))
                         & (ALIGN_SLACK - 1);
    const int tid = threadIdx.x;
    const int wg = tid >> 7;

    Ctx c;
    c.smem = smem_raw + pad;
    c.sbase = raw + pad;
    c.nsteps = ((a.n + WG_ROWS - 1) / WG_ROWS) * KSTEPS;
    c.valid = chain_of(wg) < a.nchains;
    c.asrc = a.freq + chain_base(a, chain_of(wg))
             + (int64_t)((tid >> 1) % WG_ROWS) * a.P * 256 + (tid & 1) * 4;

    // window, and the carry into the first tile
    reinterpret_cast<float*>(c.smem + STAGES * STAGE_BYTES
                             + NWG * EPI_BYTES)[tid] = __ldg(a.win + tid);
    reinterpret_cast<float*>(c.smem + STAGES * STAGE_BYTES
                             + wg * EPI_BYTES)[tid & 127] =
        c.valid ? a.d0[(int64_t)chain_of(wg) * ND + (tid & 127)] : 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; s++) {
        if (s < c.nsteps)
            start_copies(a, c, s);
        cp_async_commit();
    }
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();

    float z[128], dd[64];
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
#pragma unroll
    for (int e = 0; e < 128; e++)
        z[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 64; e++)
        dd[e] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; e++)
        ah1[e] = al1[e] = 0u;
    load_split(c, 0, ah0, al0);

    // The accumulators are written by wgmma alone inside the K loop (any
    // other write there would let the compiler copy a register that an
    // asynchronous wgmma still owns); they are read, and zeroed for the next
    // tile, only here, after wgmma_wait<0>.
    int s = 0;
#pragma unroll 1
    for (int tile = 0; tile * KSTEPS < c.nsteps; tile++) {
#pragma unroll 1
        for (int kp = 0; kp < KSTEPS / 2; kp++, s += 2) {
            step(a, c, s, z, dd, ah0, al0, ah1, al1);
            step(a, c, s + 1, z, dd, ah1, al1, ah0, al0);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int e = 0; e < 128; e++)
            keep(z[e]);
#pragma unroll
        for (int e = 0; e < 64; e++)
            keep(dd[e]);
#pragma unroll
        for (int e = 0; e < 4; e++) {
            keep(ah1[e]);
            keep(al1[e]);
        }
        epilogue(a, c, tile, z, dd);
#pragma unroll
        for (int e = 0; e < 128; e++)
            z[e] = 0.f;
#pragma unroll
        for (int e = 0; e < 64; e++)
            dd[e] = 0.f;
    }
}

}  // namespace

// wt: the TF32 split of W in the kernel's tile order (ops/filterbank.py:
// wt_tiles_on), [32][2][384][8] floats
extern "C" int fused_steady_launch(const float* freq, const float* d0,
                                   const float* bias, const float* wt,
                                   const float* win, int16_t* pcm,
                                   float* dlast, int B, int n, int P,
                                   void* stream)
{
    const long long nchains = (long long)B * P;
    if (nchains == 0 || n == 0)
        return 0;
    const long long grid = (nchains + NWG - 1) / NWG;
    if (grid > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    cudaError_t rc = cudaFuncSetAttribute(
        fused_steady_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (rc != cudaSuccess)
        return (int)rc;
    const Args a = {freq, d0, bias, wt, win, pcm, dlast, n, P, (int)nchains};
    fused_steady_kernel<<<(unsigned)grid, THREADS, SMEM_BYTES,
                          (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char* fused_steady_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
