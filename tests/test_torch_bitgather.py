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


def test_wrappers_refuse_what_the_kernels_refuse():
    """dtype and shape are checked on CPU tensors too, so drift that the
    card would refuse (int64 widths, say) fails the CPU tests first."""
    data = torch.zeros((2, 8), dtype=torch.uint8)
    offs = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(TypeError, match="widths"):
        BG.extract_fields(data, offs, offs.long())
    with pytest.raises(TypeError, match="offsets"):
        BG.extract_fields_shared(data[0], offs.long())
    with pytest.raises(ValueError, match="data"):
        BG.extract_fields(data[:1], offs, offs)
    with pytest.raises(TypeError, match="table"):
        BG.extract_i16_table(data[0], offs)


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
