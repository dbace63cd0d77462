// Bitfield and table gathers for Hopper (sm_90a): the device half of the
// raw-H2D bitstream unpack (ops/unpack_device.py).
//
// Replaces the three TPU kernels of ac3acm_tpu/ops/bitgather.py:
//
//   K2  _kernel_mega       (extract_fields, extract_fields_shared mega form)
//   K3  _kernel            (extract_fields_shared(per_tile=True): the
//                           coupling-dither rank lattice)
//   K4  _kernel_mega_i16   (extract_i16_table: the dither LFSR orbit)
//
// extract_fields_kernel (K2 and K3), the field of slot (row n, slot s):
//
//     w   = width[n, s]              (0..16; 0 -> the field is 0, no read;
//                                     16 for the shared form)
//     bit = off[n, s] * unit         (unit: bits per offset step; 1 for K2)
//     w24 = byte(bit >> 3) << 16 | byte(+1) << 8 | byte(+2)
//     out = (w24 >> (24 - (bit & 7) - w)) & ((1 << w) - 1)    (u16 as int16)
//
// where byte(k) is data[n * row_stride + k] for 0 <= k < nbytes and 0
// otherwise.  The per-row form (K2) has row_stride = nbytes = MB; the
// shared-table form (K3: one table of 16-bit fields for every row) has
// row_stride = 0 and no width array.  Offsets come as int32 or int16,
// widths as int32 or uint8; the kernel is instantiated for each.
//
// extract_i16_kernel (K4), one thread per 8 consecutive slots:
// out = table[idx], 0 for an index outside the table.
//
// Bound on the card: all are gathers with no arithmetic to speak of, so
// bytes bound them.  Per slot a K2 launch moves its offset (2 or 4 B), its
// width (1 or 4 B) and a 2-byte result; K3 a 4-byte ordinal (65,535 of
// them do not fit int16) and the result; K4 a 4-byte index and the
// result.  The data bytes (one frame per row, at most 3,840 B; the
// 131,070-byte orbit) are a few percent of that.
//
// What the design does about it.  No TPU byte planes, one-hot windows or
// step spans (Mosaic had no per-lane gather; here a thread reads what it
// needs).  K2/K3: one CTA a row.  In the per-row form (K2) the CTA first
// stages its frame row in shared memory with 16-byte copies (a ragged
// first or last chunk byte by byte), with zeros around it, so a field's
// window needs one range test on its offset and two aligned 32-bit shared
// loads joined by one __byte_perm, where a direct read takes three
// bounds-tested byte loads.  The shared table (K3), and a row too wide for
// the 48 KB of shared memory a CTA has by default, are read through L1
// with those three loads: on the orbit, staging it once per CTA of a
// persistent grid measured the same, both at about 85% of the card's rate
// on their wire (PERF.md), and the L1 form is the simpler.  Within a row
// each thread takes 8 consecutive slots: offsets and widths as 16-byte
// (int32: two) or 8-byte vector loads, the 8 results as one 16-byte
// store.  Slots before the row's first flat index that is a multiple of 8
// and after its last whole group of 8 (S need not be a multiple of 8) go
// one by one, as do all slots when a pointer is not 16-byte aligned (a
// sliced view; the unpack's own tensors never are).  K4: the indices of a
// row are draw ordinals that rise by 0 or 1 from slot to slot, so a
// thread's eight slots read at most 16 neighbouring table bytes; it takes
// its indices as two 16-byte loads, its eight table entries from L1
// (__ldg) and writes one 16-byte store, with the same scalar tail and
// unaligned branch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // K4
constexpr int FIELD_THREADS = 256;     // K2/K3, the most a CTA launches
constexpr int64_t MAX_STAGE_BYTES = 48 * 1024;   // a CTA's default
constexpr long long MAX_ROW_BYTES = 1LL << 27;

// shared-memory stage of a row of nbytes: row byte k sits at byte
// lead + k, lead = 16 + (row address & 15), so each 16-byte chunk of the
// stage maps to an aligned 16-byte chunk of device memory; the bytes
// around the row are zero.  A window is read for byte positions
// -2 .. nbytes - 1 and touches bytes up to lead + nbytes + 6, inside
// 16 * (nbytes / 16 + 4)
__host__ __device__ constexpr int64_t stage_chunks(int64_t nbytes)
{
    return nbytes / 16 + 4;
}

__device__ __forceinline__ void stage_row(uint4* __restrict__ stage,
                                          const uint8_t* __restrict__ row,
                                          int nbytes, int lead)
{
    const int chunks = (int)stage_chunks(nbytes);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
        const int k0 = 16 * c - lead;          // row byte at the chunk's start
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (k0 >= 0 && k0 + 16 <= nbytes) {
            v = __ldg(reinterpret_cast<const uint4*>(row + k0));
        } else if (k0 + 16 > 0 && k0 < nbytes) {
            uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
            for (int j = 0; j < 16; j++) {
                const int k = k0 + j;
                if (k >= 0 && k < nbytes)
                    w[j >> 2] |= (uint32_t)__ldg(row + k) << (8 * (j & 3));
            }
            v = make_uint4(w[0], w[1], w[2], w[3]);
        }
        stage[c] = v;
    }
}

// the field at offset off of width w; off in [omin, omax) is exactly the
// range whose window starts at a byte in -2 .. nbytes - 1 (outside it
// every byte of the window reads 0), and keeps off * unit inside int32.
// STAGED: from the row staged at lead in shared memory (sw), two aligned
// 32-bit loads; else from the row in device memory (through L1), three
// bounds-tested byte loads
template <bool STAGED>
__device__ __forceinline__ uint32_t field(const uint32_t* __restrict__ sw,
                                          int lead,
                                          const uint8_t* __restrict__ row,
                                          int nbytes, int off, int w, int unit,
                                          int omin, int omax)
{
    if (w <= 0 || off < omin || off >= omax)
        return 0u;
    const int bit = off * unit;
    const int p = bit >> 3;
    uint32_t win;                      // big-endian bytes p .. p+3
    if (STAGED) {
        const int b = lead + p;
        const int q = b >> 2;
        win = __byte_perm(sw[q], sw[q + 1],
                          0x0123u + 0x1111u * (uint32_t)(b & 3));
    } else {
        win = 0u;
#pragma unroll
        for (int k = 0; k < 3; k++)
            if (p + k >= 0 && p + k < nbytes)
                win |= (uint32_t)__ldg(row + p + k) << (24 - 8 * k);
    }
    // the fourth byte is always shifted out: 32 - 7 - 16 >= 8
    return (win >> (32 - (bit & 7) - w)) & ((1u << w) - 1u);
}

__device__ __forceinline__ void load8(const int32_t* __restrict__ p,
                                      int32_t v[8])
{
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    const int4 b = __ldg(reinterpret_cast<const int4*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const int16_t* __restrict__ p,
                                      int32_t v[8])
{
    const int4 a = __ldg(reinterpret_cast<const int4*>(p));
    const int32_t u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; e++) {
        v[2 * e] = (int16_t)(u[e] & 0xFFFF);
        v[2 * e + 1] = u[e] >> 16;
    }
}

__device__ __forceinline__ void load8(const uint8_t* __restrict__ p,
                                      int32_t v[8])
{
    const uint2 a = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int e = 0; e < 4; e++) {
        v[e] = (a.x >> (8 * e)) & 0xFF;
        v[4 + e] = (a.y >> (8 * e)) & 0xFF;
    }
}

// grid: one CTA a row.  STAGED: the row is staged in shared memory first.
// widths null: every slot has width 16.  vec: offsets, widths and out are
// 16-byte aligned
template <typename OffT, typename WT, bool STAGED>
__global__ void __launch_bounds__(FIELD_THREADS)
extract_fields_kernel(const uint8_t* __restrict__ data, int64_t row_stride,
                      int nbytes, const OffT* __restrict__ offsets,
                      const WT* __restrict__ widths,
                      int16_t* __restrict__ out, int64_t S, int unit,
                      int omin, int omax, bool vec)
{
    extern __shared__ uint4 stage[];
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(stage);
    const int64_t n = blockIdx.x;
    const uint8_t* row = data + n * row_stride;
    int lead = 0;
    if (STAGED) {
        lead = 16 + (int)((uintptr_t)row & 15);
        stage_row(stage, row, nbytes, lead);
        __syncthreads();
    }
    auto get = [&](int off, int w) {
        return field<STAGED>(sw, lead, row, nbytes, off, w, unit, omin, omax);
    };
    // slots one by one before the row's first flat index that is a
    // multiple of 8 (all of them when a pointer is unaligned), groups of 8
    // from there, one by one after the last whole group
    const int64_t base = n * S;
    int64_t head = S;
    if (vec) {
        head = (8 - (base & 7)) & 7;
        if (head > S)
            head = S;
    }
    const int64_t groups = (S - head) / 8;
    const int64_t tail = head + 8 * groups;
    auto one = [&](int64_t s) {
        const int64_t i = base + s;
        out[i] = (int16_t)get(offsets[i], widths ? (int)widths[i] : 16);
    };
    for (int64_t s = threadIdx.x; s < head; s += blockDim.x)
        one(s);
    for (int64_t g = threadIdx.x; g < groups; g += blockDim.x) {
        const int64_t i = base + head + 8 * g;
        int32_t o[8], w[8];
        load8(offsets + i, o);
        if (widths) {
            load8(widths + i, w);
        } else {
#pragma unroll
            for (int e = 0; e < 8; e++)
                w[e] = 16;
        }
        uint32_t r[4];
#pragma unroll
        for (int e = 0; e < 4; e++)
            r[e] = get(o[2 * e], w[2 * e])
                   | (get(o[2 * e + 1], w[2 * e + 1]) << 16);
        *reinterpret_cast<uint4*>(out + i) = make_uint4(r[0], r[1], r[2],
                                                        r[3]);
    }
    for (int64_t s = tail + threadIdx.x; s < S; s += blockDim.x)
        one(s);
}

__device__ __forceinline__ int16_t table_at(const int16_t* __restrict__ table,
                                            int64_t tb, int32_t k)
{
    return (k >= 0 && k < tb) ? __ldg(table + k) : (int16_t)0;
}

// eight slots a thread.  vec: idx and out are 16-byte aligned (every tensor
// the unpack makes is); a view that is not, and the ragged last group, take
// the slots one by one in the same thread
__global__ void __launch_bounds__(THREADS)
extract_i16_kernel(const int16_t* __restrict__ table, int64_t tb,
                   const int32_t* __restrict__ idx,
                   int16_t* __restrict__ out, int64_t total, bool vec)
{
    const int64_t i = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * 8;
    if (vec && i + 8 <= total) {
        const int4 a = __ldg(reinterpret_cast<const int4*>(idx + i));
        const int4 b = __ldg(reinterpret_cast<const int4*>(idx + i) + 1);
        const int32_t k[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; e++)
            w[e] = (uint32_t)(uint16_t)table_at(table, tb, k[2 * e])
                   | ((uint32_t)(uint16_t)table_at(table, tb, k[2 * e + 1])
                      << 16);
        *reinterpret_cast<uint4*>(out + i) = make_uint4(w[0], w[1], w[2],
                                                        w[3]);
    } else {
        const int64_t end = i + 8 < total ? i + 8 : total;
        for (int64_t j = i; j < end; j++)
            out[j] = table_at(table, tb, idx[j]);
    }
}

bool aligned16(const void* p)
{
    return p == nullptr || (uintptr_t)p % 16 == 0;
}

template <typename OffT, typename WT, bool STAGED>
cudaError_t launch(const uint8_t* data, int64_t row_stride, int nbytes,
                   const void* offsets, const void* widths, int16_t* out,
                   int64_t N, int64_t S, int unit, int omin, int omax,
                   cudaStream_t stream)
{
    if (N > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    // the fewest warps that take a row's groups of 8 in the fewest rounds
    const int64_t groups = (S + 7) / 8;
    const int64_t rounds = (groups + FIELD_THREADS - 1) / FIELD_THREADS;
    const int64_t per_round = (groups + rounds - 1) / rounds;
    const int threads = (int)((per_round + 31) / 32 * 32);
    const size_t smem = STAGED ? (size_t)stage_chunks(nbytes) * 16 : 0;
    const bool vec = aligned16(offsets) && aligned16(widths)
                     && aligned16(out);
    extract_fields_kernel<OffT, WT, STAGED>
        <<<(unsigned)N, threads, smem, stream>>>(
            data, row_stride, nbytes, (const OffT*)offsets,
            (const WT*)widths, out, S, unit, omin, omax, vec);
    return cudaGetLastError();
}

// a frame row is staged; the shared table, and a row whose stage would
// not fit a CTA's default shared memory, are read through L1
template <typename OffT, typename WT>
cudaError_t launch_fields(const uint8_t* data, int64_t row_stride,
                          int nbytes, const void* offsets, const void* widths,
                          int16_t* out, int64_t N, int64_t S, int unit,
                          int omin, int omax, cudaStream_t stream)
{
    if (row_stride != 0 && stage_chunks(nbytes) * 16 <= MAX_STAGE_BYTES)
        return launch<OffT, WT, true>(data, row_stride, nbytes, offsets,
                                      widths, out, N, S, unit, omin, omax,
                                      stream);
    return launch<OffT, WT, false>(data, row_stride, nbytes, offsets, widths,
                                   out, N, S, unit, omin, omax, stream);
}

}  // namespace

// offsets: off_bytes 4 (int32) or 2 (int16); widths: w_bytes 4 (int32),
// 1 (uint8) or 0 (null: every slot has width 16); unit: 1..16 bits per
// offset step; rows (or the table) shorter than 2^27 bytes, so that bit
// offsets fit int32
extern "C" int bitgather_fields_launch(const void* data, long long row_stride,
                                       long long nbytes, const void* offsets,
                                       int off_bytes, const void* widths,
                                       int w_bytes, void* out, long long N,
                                       long long S, long long unit,
                                       void* stream)
{
    if (N == 0 || S == 0)
        return 0;
    if (unit < 1 || unit > 16 || nbytes < 0 || nbytes >= MAX_ROW_BYTES)
        return (int)cudaErrorInvalidValue;
    // the offsets whose window starts at a byte in -2 .. nbytes - 1
    const long long omin = -(16 / unit);
    const long long omax = (8 * nbytes + unit - 1) / unit;
    const uint8_t* d = (const uint8_t*)data;
    int16_t* o = (int16_t*)out;
    cudaStream_t st = (cudaStream_t)stream;
    const int nb = (int)nbytes;
    cudaError_t rc = cudaErrorInvalidValue;
    if (off_bytes == 4 && w_bytes == 4)
        rc = launch_fields<int32_t, int32_t>(d, row_stride, nb, offsets,
                                             widths, o, N, S, (int)unit,
                                             (int)omin, (int)omax, st);
    else if (off_bytes == 4 && (w_bytes == 1 || w_bytes == 0))
        rc = launch_fields<int32_t, uint8_t>(d, row_stride, nb, offsets,
                                             widths, o, N, S, (int)unit,
                                             (int)omin, (int)omax, st);
    else if (off_bytes == 2 && w_bytes == 4)
        rc = launch_fields<int16_t, int32_t>(d, row_stride, nb, offsets,
                                             widths, o, N, S, (int)unit,
                                             (int)omin, (int)omax, st);
    else if (off_bytes == 2 && (w_bytes == 1 || w_bytes == 0))
        rc = launch_fields<int16_t, uint8_t>(d, row_stride, nb, offsets,
                                             widths, o, N, S, (int)unit,
                                             (int)omin, (int)omax, st);
    return (int)rc;
}

extern "C" int bitgather_i16_launch(const void* table, long long tb,
                                    const void* idx, void* out,
                                    long long total, void* stream)
{
    if (total == 0)
        return 0;
    const bool vec = ((uintptr_t)idx % 16 == 0) && ((uintptr_t)out % 16 == 0);
    const long long blocks = (total + THREADS * 8 - 1) / (THREADS * 8);
    if (blocks > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    extract_i16_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
        (const int16_t*)table, tb, (const int32_t*)idx, (int16_t*)out, total,
        vec);
    return (int)cudaGetLastError();
}

extern "C" const char* bitgather_error_string(int code)
{
    return cudaGetErrorString((cudaError_t)code);
}
