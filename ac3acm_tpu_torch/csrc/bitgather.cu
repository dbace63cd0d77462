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
// extract_fields_kernel (K2 and K3), one thread per slot (row n, slot s):
//
//     w   = width[n, s]              (0..16; 0 -> the field is 0, no read;
//                                     16 for the shared form)
//     p   = off[n, s] >> 3
//     w24 = byte(p) << 16 | byte(p+1) << 8 | byte(p+2)
//     out = (w24 >> (24 - (off & 7) - w)) & ((1 << w) - 1)    (u16 as int16)
//
// where byte(k) is data[n * row_stride + k] for 0 <= k < nbytes and 0
// otherwise (the zero-padded tail of the TPU kernel's byte planes).  The
// per-row form has row_stride = nbytes = MB; the shared-table form (one
// table of 16-bit fields for every row: K3, and K2's shared entry) has
// row_stride = 0 and no width array.
//
// extract_i16_kernel (K4), one thread per 8 consecutive slots:
// out = table[idx], 0 for an index outside the table.
//
// Bound on the card: all are gathers with no arithmetic to speak of, so
// bytes bound them.  Per slot a K2/K3 launch moves a 4-byte offset, a
// 4-byte width (none for the shared form, whose width is one constant) and
// a 2-byte result; K4 a 4-byte index and a 2-byte result.  The data bytes
// (one 1,792-byte frame per row at 448 kbps, the 131,070-byte orbit) are
// read from L2 after the first touch.
//
// What the design does about it: it moves nothing else -- no byte planes,
// no one-hot matmul, no window per 1024-slot step and so no step-span
// contract (the TPU windows and their contract existed because Mosaic has
// no per-lane gather).  K2/K3: neighbouring threads take neighbouring
// slots, so the offset, width and result streams are coalesced; the three
// byte loads of a warp fall within a few cache lines of one frame, because
// offsets rise slot by slot.  Vectorized loads and staging a row's bytes in
// shared memory are later work for K2/K3.  K4: the indices of a row are
// draw ordinals that rise by 0 or 1 from slot to slot, so a thread's eight
// slots read at most 16 neighbouring table bytes; it takes its indices as
// two 16-byte loads, its eight table entries from L1 (__ldg) and writes one
// 16-byte store.  A total that is not a multiple of 8 ends in a scalar
// tail; index or result pointers that are not 16-byte aligned (a sliced
// view; the unpack's own tensors never are) are served by the same kernel,
// each thread taking its eight slots one by one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t byte_at(const uint8_t* __restrict__ row,
                                            int64_t k, int64_t nbytes)
{
    return (k >= 0 && k < nbytes) ? (uint32_t)__ldg(row + k) : 0u;
}

// grid: x = row, y = tile of THREADS slots
__global__ void __launch_bounds__(THREADS)
extract_fields_kernel(const uint8_t* __restrict__ data, int64_t row_stride,
                      int64_t nbytes, const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ widths,
                      int16_t* __restrict__ out, int64_t S)
{
    const int64_t n = blockIdx.x;
    const int64_t s = (int64_t)blockIdx.y * THREADS + threadIdx.x;
    if (s >= S)
        return;
    const int64_t i = n * S + s;
    const int w = widths ? widths[i] : 16;
    uint32_t v = 0;
    if (w > 0) {
        const int off = offsets[i];
        const int64_t p = off >> 3;
        const uint8_t* row = data + n * row_stride;
        const uint32_t w24 = (byte_at(row, p, nbytes) << 16)
                             | (byte_at(row, p + 1, nbytes) << 8)
                             | byte_at(row, p + 2, nbytes);
        v = (w24 >> (24 - (off & 7) - w)) & ((1u << w) - 1u);
    }
    out[i] = (int16_t)(uint16_t)v;
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

}  // namespace

// widths may be null: every slot then has width 16
extern "C" int bitgather_fields_launch(const void* data, long long row_stride,
                                       long long nbytes, const void* offsets,
                                       const void* widths, void* out,
                                       long long N, long long S, void* stream)
{
    if (N == 0 || S == 0)
        return 0;
    const long long tiles = (S + THREADS - 1) / THREADS;
    if (N > 0x7fffffffLL || tiles > 65535)
        return (int)cudaErrorInvalidValue;
    dim3 grid((unsigned)N, (unsigned)tiles);
    extract_fields_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, row_stride, nbytes, (const int32_t*)offsets,
        (const int32_t*)widths, (int16_t*)out, S);
    return (int)cudaGetLastError();
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
