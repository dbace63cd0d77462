"""Bitfield and table gathers: the device half of bitstream unpack.

The raw-H2D decode path (ops.unpack_device) ships each lane's coded frame
bytes plus per-block side info, and pulls exponent groups, coupling
coordinates, mantissa codes and dither draws out of the bits on the
device.  Three entries, each with its own launch counter:

  extract_fields         per-row byte buffers [N, MB]      launches_fields
  extract_fields_shared  fields of one shared byte table
                         [TB] (width 16 by default)        launches_shared
  extract_i16_table      one shared int16 table, by index  launches_i16

On CUDA tensors each launches the hand-written kernel of
csrc/bitgather.cu (the Hopper counterpart of the TPU kernels
ac3acm_tpu/ops/bitgather.py:_kernel_mega, _kernel and _kernel_mega_i16);
on CPU tensors it runs its plain PyTorch version (``*_ref``).  There is
no other path: a CUDA tensor launches the kernel or raises.

Field semantics (BitReader.gather, liba52 bitstream.h:53-77): the field
of width w (0..16) at bit offset off is the w bits after bit off & 7 of
the 24 bits at bytes off >> 3 .. +2, big-endian.  A byte outside the
buffer reads as 0; a width-0 slot is 0 whatever its offset.  Results are
int16 carrying the unsigned 16-bit pattern (reinterpret with as_u16).

The wire: offsets are int32 or int16, widths int32 or uint8 (values
0..16); extract_fields_shared's offsets count steps of `unit` bits.  An
int16 offset is the offset itself.  The wrappers take int16 offsets only
for a buffer that ends at or before bit 32,767 * unit (a row of at most
4,095 B for unit 1), so that an offset saturated to 32,767 or -32,768
reads only bytes outside the buffer, which read 0, as the wider offset it
stands for does.  (ops/unpack_device.py:_narrow says why the unpack's
offsets, narrowed without saturating, read the same.)
"""
from __future__ import annotations

import ctypes as C

import torch

from . import _cuda

# kernel launches since the last reset, one counter per entry (incremented
# only where the CUDA kernel is launched; the CPU path leaves them alone)
launches_fields = 0
launches_shared = 0
launches_i16 = 0


def as_u16(codes):
    """Reinterpret int16 field values as their unsigned pattern (int32)."""
    return codes.to(torch.int32) & 0xFFFF


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _fields_ref(rows, bits, widths):
    """rows [N or 1, MB] uint8 (one row serves every slot row); bits
    [N, S] int64 bit offsets; widths [N, S] -> [N, S] int16."""
    N, S = bits.shape
    MB = rows.shape[1]
    data = rows.to(torch.int32).expand(N, MB)
    w = widths.to(torch.int32)
    p = bits >> 3

    def byte(k):
        idx = p + k
        ok = (idx >= 0) & (idx < MB)
        got = torch.gather(data, 1, idx.clamp(0, max(MB - 1, 0)))
        return torch.where(ok, got, 0)

    w24 = (byte(0) << 16) | (byte(1) << 8) | byte(2)
    shift = (24 - (bits & 7).to(torch.int32) - w).clamp(min=0)
    v = (w24 >> shift) & ((1 << w) - 1)
    return torch.where(w > 0, v, 0).to(torch.int16)


def extract_fields_ref(rows, offsets, widths):
    """Plain version of extract_fields: rows [N, MB] uint8; offsets/widths
    [N, S] (int32 or int16 / int32 or uint8) -> [N, S] int16."""
    return _fields_ref(rows, offsets.to(torch.int64), widths)


def extract_fields_shared_ref(table, offsets, widths=None, unit=1):
    """Plain version of extract_fields_shared."""
    if widths is None:
        widths = torch.full(offsets.shape, 16, dtype=torch.uint8,
                            device=offsets.device)
    return _fields_ref(table[None, :], offsets.to(torch.int64) * unit,
                       widths)


def extract_i16_table_ref(table, offsets):
    """Plain version of extract_i16_table."""
    TB = table.shape[0]
    idx = offsets.to(torch.int64)
    ok = (idx >= 0) & (idx < TB)
    return torch.where(ok, table[idx.clamp(0, TB - 1)],
                       torch.zeros((), dtype=table.dtype, device=table.device))


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

def _bind(lib):
    p, ll = C.c_void_p, C.c_longlong
    lib.bitgather_fields_launch.restype = C.c_int
    lib.bitgather_fields_launch.argtypes = [p, ll, ll, p, C.c_int, p,
                                            C.c_int, p, ll, ll, ll, p]
    lib.bitgather_i16_launch.restype = C.c_int
    lib.bitgather_i16_launch.argtypes = [p, ll, p, p, ll, p]
    lib.bitgather_error_string.restype = C.c_char_p
    lib.bitgather_error_string.argtypes = [C.c_int]


def _check(name, t, dtypes, shape, device):
    """Device, dtype and shape on both paths (so the CPU tests catch what
    the kernel would refuse); contiguity where the kernel reads raw
    pointers."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} is {t.dtype}, expected "
                        + " or ".join(map(str, dtypes)))
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} is on {device}: the gathers run on cuda "
                         "or cpu")


OFFSET_DTYPES = (torch.int32, torch.int16)
WIDTH_DTYPES = (torch.int32, torch.uint8)
MAX_ROW_BYTES = 1 << 27            # the kernel's bit offsets are int32


def _check_fields(rows, offsets, widths, unit, shared):
    dev = rows.device
    if offsets.dim() != 2:
        raise ValueError(f"offsets must be [N, S], got {tuple(offsets.shape)}")
    N, S = offsets.shape
    _check("offsets", offsets, OFFSET_DTYPES, (N, S), dev)
    if widths is not None:
        _check("widths", widths, WIDTH_DTYPES, (N, S), dev)
    nbytes = rows.shape[-1]
    _check("data", rows, (torch.uint8,), (nbytes,) if shared else (N, nbytes),
           dev)
    if not (isinstance(unit, int) and 1 <= unit <= 16):
        raise ValueError(f"unit must be an int in 1..16, got {unit!r}")
    if nbytes >= MAX_ROW_BYTES:
        raise ValueError(f"data rows of {nbytes} B: the kernel takes fewer "
                         f"than {MAX_ROW_BYTES}")
    if offsets.dtype == torch.int16 and 8 * nbytes > 32767 * unit:
        raise ValueError(f"int16 offsets address at most bit {32767 * unit}"
                         f"; data rows of {nbytes} B need int32 offsets")


def _launch(fn, dev, *args):
    lib = _cuda.load("bitgather", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"bitgather kernel launch failed ({fn}): "
                           + lib.bitgather_error_string(rc).decode())


def _fields(rows, offsets, widths, unit, shared):
    dev = rows.device
    N, S = offsets.shape
    nbytes = rows.shape[-1]
    out = torch.empty((N, S), dtype=torch.int16, device=dev)
    _launch("bitgather_fields_launch", dev, rows.data_ptr(),
            0 if shared else nbytes, nbytes, offsets.data_ptr(),
            offsets.element_size(),
            None if widths is None else widths.data_ptr(),
            0 if widths is None else widths.element_size(), out.data_ptr(),
            N, S, unit)
    return out


def extract_fields(data, offsets, widths):
    """data [N, MB] uint8; offsets [N, S] int32 or int16 (bit offsets into
    the slot's own row), widths [N, S] int32 or uint8 (0..16) -> [N, S]
    int16 field values."""
    global launches_fields
    _check_fields(data, offsets, widths, 1, shared=False)
    if data.device.type == "cpu":
        return extract_fields_ref(data, offsets, widths)
    out = _fields(data, offsets, widths, 1, shared=False)
    launches_fields += 1
    return out


def extract_fields_shared(table, offsets, widths=None, unit=1):
    """Fields from ONE shared byte table for every row: table [TB] uint8;
    offsets [N, S] int32 or int16, in steps of `unit` bits (1: bit
    offsets; 16: the field index of a table of 16-bit fields); widths
    [N, S] int32 or uint8 (0..16), or None for width 16 everywhere ->
    [N, S] int16."""
    global launches_shared
    _check_fields(table, offsets, widths, unit, shared=True)
    if table.device.type == "cpu":
        return extract_fields_shared_ref(table, offsets, widths, unit)
    out = _fields(table, offsets, widths, unit, shared=True)
    launches_shared += 1
    return out


def extract_i16_table(table, offsets):
    """table [TB] int16; offsets [N, S] int32 entry indices -> [N, S]
    int16 table values (0 for an index outside the table)."""
    global launches_i16
    dev = table.device
    _check("table", table, (torch.int16,), (table.shape[-1],), dev)
    _check("offsets", offsets, (torch.int32,), tuple(offsets.shape), dev)
    if dev.type == "cpu":
        return extract_i16_table_ref(table, offsets)
    out = torch.empty(offsets.shape, dtype=torch.int16, device=dev)
    _launch("bitgather_i16_launch", dev, table.data_ptr(), table.shape[0],
            offsets.data_ptr(), out.data_ptr(), offsets.numel())
    launches_i16 += 1
    return out
