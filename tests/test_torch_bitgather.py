"""Port: ops.bitgather's plain versions vs the JAX package's Pallas gathers.

The same seeded numpy inputs go through the JAX entries (their Pallas
kernels in interpret mode, as tests/test_bitgather.py runs them), through
the JAX package's numpy oracle (bitgather.reference_extract), and through
the port's entries on CPU tensors, which run the plain PyTorch versions.
Every case is bitwise.  The CUDA kernels themselves run only on the card
(chip_smoke.py holds them to these plain versions there).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import ac3acm_tpu.ops.bitgather as JBG
from ac3acm_tpu_torch.ops import bitgather as BG

JBG.INTERPRET = True


def _u16(x):
    return np.asarray(x).astype(np.int64) & 0xFFFF


def _port(data, offs, widths):
    return BG.extract_fields(torch.from_numpy(data), torch.from_numpy(offs),
                             torch.from_numpy(widths)).numpy()


def _random(rng):
    N, S, MB = 4, 4 * JBG.TS, 1536
    data = rng.integers(0, 256, (N, MB), dtype=np.uint8)
    widths = rng.integers(0, 17, (N, S)).astype(np.int32)
    gaps = rng.integers(0, 3, (N, S))
    offs = np.cumsum(widths + gaps, axis=1) - widths - gaps
    return data, np.minimum(offs, MB * 8 - 17).astype(np.int32), widths


def _dense16(rng):
    N, S = 2, 2 * JBG.TS
    MB = (S * 16) // 8 + 192
    data = rng.integers(0, 256, (N, MB), dtype=np.uint8)
    offs = np.tile(np.arange(S, dtype=np.int32) * 16, (N, 1))
    offs[1] += 5                                  # misaligned row
    return data, offs, np.full((N, S), 16, np.int32)


def _tail(rng):
    """Fields ending on the buffer's last bit: the 24-bit read runs up to
    two bytes past the end, which read as zero and are shifted out."""
    N, S, MB = 2, JBG.TS, 3840
    data = rng.integers(0, 256, (N, MB), dtype=np.uint8)
    widths = rng.integers(1, 17, (N, S)).astype(np.int32)
    offs = np.zeros((N, S), np.int32)
    for n in range(N):
        ends = MB * 8 - 16 * np.arange(S)[::-1]
        offs[n] = ends - widths[n]
    return data, offs, widths


CASES = {"random": _random, "dense16": _dense16, "tail": _tail}


@pytest.mark.parametrize("case", list(CASES))
def test_extract_fields_matches_jax(case):
    data, offs, widths = CASES[case](np.random.default_rng(7))
    got = _port(data, offs, widths)
    assert got.dtype == np.int16
    jax_out = _u16(JBG.extract_fields(jnp.asarray(data), jnp.asarray(offs),
                                      jnp.asarray(widths)))
    want = JBG.reference_extract(data, offs, widths)
    np.testing.assert_array_equal(_u16(got), want)
    np.testing.assert_array_equal(_u16(got), jax_out)


def _shared_case(rng, G):
    """Dither-orbit shape: 16-bit fields at 16*k offsets of one table,
    one base per G-slot group plus a small rank sawtooth."""
    table = rng.integers(0, 256, 262144, dtype=np.uint8)
    N, S = 3, 2 * G
    offs = np.zeros((N, S), np.int32)
    for n in range(N):
        for t in range(S // G):
            base = int(rng.integers(0, 65000))
            offs[n, t * G:(t + 1) * G] = \
                (base + np.arange(G) + rng.integers(0, 4, G)) * 16
    return table, offs


@pytest.mark.parametrize("per_tile", [False, True],
                         ids=["mega", "per_tile"])
def test_extract_fields_shared_matches_jax(per_tile):
    """One port entry serves both TPU kernels' shared-table forms."""
    G = JBG.TS if per_tile else JBG.TPG * JBG.TS
    table, offs = _shared_case(np.random.default_rng(5), G)
    got = BG.extract_fields_shared(torch.from_numpy(table),
                                   torch.from_numpy(offs)).numpy()
    jax_out = _u16(JBG.extract_fields_shared(
        jnp.asarray(table), jnp.asarray(offs), per_tile=per_tile,
        span_rows=6 if per_tile else 14))
    want = JBG.reference_extract(np.tile(table, (offs.shape[0], 1)), offs,
                                 np.full(offs.shape, 16, np.int32))
    np.testing.assert_array_equal(_u16(got), want)
    np.testing.assert_array_equal(_u16(got), jax_out)


@pytest.mark.parametrize("width_dtype", [torch.int32, torch.uint8])
def test_extract_fields_shared_widths_matches_jax(width_dtype):
    """The third slot is JAX's widths: a positional call with mixed widths
    0..16 (0 included) at bit-level offsets equals JAX's same call and
    the oracle, in either width wire; unit=16 reads the same fields at
    the field index; widths of the wrong dtype or shape are refused."""
    rng = np.random.default_rng(13)
    table, offs = _shared_case(rng, JBG.TPG * JBG.TS)
    offs += rng.integers(0, 8, offs.shape).astype(np.int32)
    widths = rng.integers(0, 17, offs.shape).astype(np.int32)
    widths[:, :17] = np.arange(17)
    t, o = torch.from_numpy(table), torch.from_numpy(offs)
    w = torch.from_numpy(widths).to(width_dtype)
    got = BG.extract_fields_shared(t, o, w).numpy()
    jax_out = _u16(JBG.extract_fields_shared(
        jnp.asarray(table), jnp.asarray(offs), jnp.asarray(widths)))
    want = JBG.reference_extract(np.tile(table, (offs.shape[0], 1)), offs,
                                 widths)
    assert (want[widths == 0] == 0).all() and (want[widths > 0] != 0).any()
    np.testing.assert_array_equal(_u16(got), want)
    np.testing.assert_array_equal(_u16(got), jax_out)
    o16 = torch.from_numpy(offs // 16 * 16)
    assert torch.equal(BG.extract_fields_shared(t, o16 // 16, w, unit=16),
                       BG.extract_fields_shared(t, o16, w))
    with pytest.raises(TypeError, match="widths"):
        BG.extract_fields_shared(t, o, w.long())
    with pytest.raises(ValueError, match="widths"):
        BG.extract_fields_shared(t, o, w[:, :-1])


def test_wrappers_refuse_what_the_kernels_refuse():
    """dtype and shape are checked on CPU tensors too, so drift that the
    card would refuse (int64 widths, say) fails the CPU tests first.  The
    wire takes int32 or int16 offsets and int32 or uint8 widths, nothing
    else."""
    data = torch.zeros((2, 8), dtype=torch.uint8)
    offs = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="widths"):
        BG.extract_fields(data, offs, offs.long())
    with pytest.raises(TypeError, match="widths"):
        BG.extract_fields(data, offs, offs.to(torch.int8))
    with pytest.raises(TypeError, match="offsets"):
        BG.extract_fields_shared(data[0], offs.long())
    for bad in (torch.int64, torch.int8, torch.uint8):
        with pytest.raises(TypeError, match="offsets"):
            BG.extract_fields(data, offs.to(bad), offs)
        with pytest.raises(TypeError, match="offsets"):
            BG.extract_fields_shared(data[0], offs.to(bad), unit=16)
    for unit in (0, 17, 2.0):
        with pytest.raises(ValueError, match="unit"):
            BG.extract_fields_shared(data[0], offs, unit=unit)
    with pytest.raises(ValueError, match="data"):
        BG.extract_fields(data[:1], offs, offs)
    with pytest.raises(TypeError, match="table"):
        BG.extract_i16_table(data[0], offs)
    # the narrow wire itself is taken, in every pairing
    for o in (torch.int32, torch.int16):
        for w in (torch.int32, torch.uint8):
            BG.extract_fields(data, offs.to(o), offs.to(w))
        BG.extract_fields_shared(data[0], offs.to(o), unit=16)


def test_extract_i16_table_matches_jax():
    """Entry-indexed int16 table values, high-bit (negative) ones too."""
    rng = np.random.default_rng(17)
    TB = 131070
    table = rng.integers(-32768, 32768, TB).astype(np.int16)
    G = JBG.TPG * JBG.TS
    N, S = 2, 2 * G
    offs = np.zeros((N, S), np.int32)
    for n in range(N):
        for t in range(S // G):
            base = int(rng.integers(0, TB - 2 * G))
            offs[n, t * G:(t + 1) * G] = \
                base + np.arange(G) + rng.integers(0, 4, G)
    got = BG.extract_i16_table(torch.from_numpy(table),
                               torch.from_numpy(offs)).numpy()
    jax_out = np.asarray(JBG.extract_i16_table(table, jnp.asarray(offs)))
    np.testing.assert_array_equal(got, table[offs])
    np.testing.assert_array_equal(got, jax_out)


def test_out_of_range_reads_are_zero():
    """The port's stated edge rules: bytes outside the buffer read as 0,
    a width-0 slot is 0 whatever its offset, and a table index outside
    the table gives 0."""
    data = np.full((1, 4), 0xFF, np.uint8)
    offs = np.array([[-8, 28, 31, 1000, 0]], np.int32)
    widths = np.array([[8, 4, 8, 0, 16]], np.int32)
    got = _u16(_port(data, offs, widths))
    np.testing.assert_array_equal(got, [[0, 0xF, 0x80, 0, 0xFFFF]])
    tab = torch.tensor([5, -7], dtype=torch.int16)
    idx = torch.tensor([[1, 2, -1, 0]], dtype=torch.int32)
    assert BG.extract_i16_table(tab, idx).tolist() == [[-7, 0, 0, 5]]


def test_as_u16_matches_jax():
    x = np.random.default_rng(3).integers(-32768, 32768, 1000).astype(np.int16)
    got = BG.as_u16(torch.from_numpy(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JBG.as_u16(jnp.asarray(x))))


def test_cpu_tensors_launch_nothing():
    before = (BG.launches_fields, BG.launches_shared, BG.launches_i16)
    data, offs, widths = _random(np.random.default_rng(1))
    _port(data, offs, widths)
    BG.extract_fields_shared(torch.from_numpy(data[0]),
                             torch.from_numpy(offs[:, :8] * 0))
    BG.extract_i16_table(torch.zeros(8, dtype=torch.int16),
                         torch.zeros((2, 3), dtype=torch.int32))
    assert (BG.launches_fields, BG.launches_shared, BG.launches_i16) \
        == before


def _orbit_run(rng, total):
    """Draw ordinals like the unpack's: a non-decreasing run (steps of 0
    or 1) inside the 65,535-entry orbit."""
    start = int(rng.integers(0, 65535 - total))
    return (start + np.cumsum(rng.integers(0, 2, total))).astype(np.int32)


@pytest.mark.parametrize("total", [1, 7, 8, 9, 8 * 37 + 3])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset_view"])
def test_extract_i16_table_ragged_totals(total, offset):
    """Totals around the kernel's 8-slot groups, from a view that starts
    one index into its buffer (the CUDA kernel's scalar path): a run like
    the unpack's against the JAX entry and numpy, then the same run with
    indices on and past both ends of the orbit mixed in (0 outside)."""
    rng = np.random.default_rng(100 * total + offset)
    table = rng.integers(-32768, 32768, 65535).astype(np.int16)
    run = _orbit_run(rng, total)

    def port(k):
        buf = torch.from_numpy(np.concatenate([np.zeros(offset, np.int32), k]))
        got = BG.extract_i16_table(torch.from_numpy(table),
                                   buf[offset:].view(1, total))
        assert got.dtype == torch.int16 and tuple(got.shape) == (1, total)
        return got.numpy()[0]

    np.testing.assert_array_equal(port(run), table[run])
    # the JAX entry reads whole 1024-slot groups: pad with the last index
    G = JBG.TPG * JBG.TS
    pad = np.full((1, G), run[-1], np.int32)
    pad[0, :total] = run
    jax_out = np.asarray(JBG.extract_i16_table(table, jnp.asarray(pad)))
    np.testing.assert_array_equal(port(run), jax_out[0, :total])

    edged = run.copy()
    edge = np.array([-1, 65534, 65535, 0, 70000], np.int32)
    edged[::3] = edge[np.arange(len(edged[::3])) % len(edge)]
    ok = (edged >= 0) & (edged < 65535)
    want = np.where(ok, table[np.clip(edged, 0, 65534)], 0)
    np.testing.assert_array_equal(port(edged), want)


def test_extract_i16_table_keeps_any_offsets_shape():
    """The wrapper takes offsets of any shape (the kernel sees them flat)
    and refuses what the kernel would: int64 indices, a 2-D table."""
    table = torch.arange(-8, 8, dtype=torch.int16)
    idx = torch.tensor([[[0, 15, 16], [-1, 7, 8]]], dtype=torch.int32)
    got = BG.extract_i16_table(table, idx)
    assert got.tolist() == [[[-8, 7, 0], [0, -1, 0]]]
    with pytest.raises(TypeError, match="offsets"):
        BG.extract_i16_table(table, idx.long())
    with pytest.raises(ValueError, match="table"):
        BG.extract_i16_table(table.view(4, 4), idx)


# ---------------------------------------------------------------------------
# the narrow wire (int16 offsets, uint8 widths) and offset units
# ---------------------------------------------------------------------------

WIRES = {"i16_u8": (torch.int16, torch.uint8),
         "i16_i32": (torch.int16, torch.int32),
         "i32_u8": (torch.int32, torch.uint8)}


@pytest.mark.parametrize("wire", list(WIRES))
@pytest.mark.parametrize("case", list(CASES))
def test_narrow_wire_matches_int32_wire(case, wire):
    """The same slots on a narrower wire give the same fields bitwise, and
    the numpy oracle's (its rows are at most 3,840 B, so every offset fits
    int16)."""
    data, offs, widths = CASES[case](np.random.default_rng(7))
    od, wd = WIRES[wire]
    assert offs.max() <= 32767 and widths.max() <= 16
    d = torch.from_numpy(data)
    o32, w32 = torch.from_numpy(offs), torch.from_numpy(widths)
    got = BG.extract_fields(d, o32.to(od), w32.to(wd))
    assert got.dtype == torch.int16
    assert torch.equal(got, BG.extract_fields(d, o32, w32))
    np.testing.assert_array_equal(_u16(got.numpy()),
                                  JBG.reference_extract(data, offs, widths))


@pytest.mark.parametrize("offset_dtype", [torch.int32, torch.int16])
def test_shared_unit16_matches_bit_offsets(offset_dtype):
    """unit=16 reads the 16-bit field of index d where unit=1 reads bit
    offset 16*d: the orbit's ordinals as the coupling path passes them
    (int32, the 131,070-byte orbit) and, on a table of at most 65,534 B,
    as int16; indices past the table's end and before it read 0."""
    rng = np.random.default_rng(11)
    TB = 131070 if offset_dtype == torch.int32 else 65534
    table = torch.from_numpy(rng.integers(0, 256, TB, dtype=np.uint8))
    d = rng.integers(0, TB // 2, (3, 8 * 40 + 5)).astype(np.int32)
    d[0, :4] = [TB // 2 - 1, TB // 2, -1, -2]
    d_t = torch.from_numpy(d)
    got = BG.extract_fields_shared(table, d_t.to(offset_dtype), unit=16)
    want = BG.extract_fields_shared(table, d_t * 16)
    assert torch.equal(got, want)
    assert got[0, 1:4].tolist() == [0, 0, 0]
    pairs = table.numpy().reshape(-1, 2).astype(np.int64)
    live = d[:, 4:]
    np.testing.assert_array_equal(_u16(got[:, 4:].numpy()),
                                  pairs[live, 0] << 8 | pairs[live, 1])


# an int16 offset that stands for one it cannot hold: saturated (32767,
# -32768) or, as ops/unpack_device.py:_narrow's sums in [32768, 65519]
# do, wrapped into [-32768, -17]
NARROWED = {"saturated_hi": (40000, 32767), "saturated_lo": (-40000, -32768),
            "wrapped_32768": (32768, -32768), "wrapped_57455": (57455, -8081),
            "wrapped_65519": (65519, -17)}


@pytest.mark.parametrize("name", list(NARROWED))
@pytest.mark.parametrize("MB", [1792, 3840, 4095])
def test_narrowed_offsets_read_zero(name, MB):
    """With a row of at most 4,095 B (the wrapper's bar for int16
    offsets) the int16 offset and the int32 one it stands for both read
    only bytes outside the row: 0, whatever the width, in both forms."""
    wide, narrow = NARROWED[name]
    data = torch.full((2, MB), 0xFF, dtype=torch.uint8)
    w = torch.tensor([[1, 7, 16, 16], [16, 3, 1, 9]], dtype=torch.uint8)
    o32 = torch.full((2, 4), wide, dtype=torch.int32)
    o16 = torch.full((2, 4), narrow, dtype=torch.int16)
    assert BG.extract_fields(data, o32, w).eq(0).all()
    assert BG.extract_fields(data, o16, w).eq(0).all()
    assert BG.extract_fields_shared(data[0], o16).eq(0).all()
    # next to them the row's first and last bits are read: a field that
    # starts on the last bit, or one bit before the row, keeps its bits
    # inside the row and reads 0 for those outside
    edge = torch.tensor([[0, 8 * MB - 16, 8 * MB - 1, -1]], dtype=torch.int16)
    got = BG.as_u16(BG.extract_fields(data[:1], edge, w[:1]))
    assert got.tolist() == [[1, 0x7F, 0x8000, 0x7FFF]]


def test_int16_offsets_refuse_a_row_past_bit_32767():
    """int16 offsets reach bit 32,767 * unit: a row of 4,096 B or more
    (unit 1), a table of 65,535 B or more (unit 16) raises on both
    paths; one byte less is taken."""
    o = torch.zeros((1, 8), dtype=torch.int16)
    w = torch.full((1, 8), 8, dtype=torch.uint8)
    BG.extract_fields(torch.zeros((1, 4095), dtype=torch.uint8), o, w)
    with pytest.raises(ValueError, match="int16 offsets"):
        BG.extract_fields(torch.zeros((1, 4096), dtype=torch.uint8), o, w)
    with pytest.raises(ValueError, match="int16 offsets"):
        BG.extract_fields_shared(torch.zeros(4096, dtype=torch.uint8), o)
    BG.extract_fields_shared(torch.zeros(65534, dtype=torch.uint8), o,
                             unit=16)
    with pytest.raises(ValueError, match="int16 offsets"):
        BG.extract_fields_shared(torch.zeros(65535, dtype=torch.uint8), o,
                                 unit=16)
    # int32 offsets take the wide row
    BG.extract_fields(torch.zeros((1, 4096), dtype=torch.uint8),
                      o.to(torch.int32), w)
