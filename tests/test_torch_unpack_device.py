"""Port: ops.unpack_device and ops.alloc vs the JAX package, stage by stage.

Streams (golden, and streamgen's synthetic ones) go through the port's
native side-info parser; the same frame bytes and side info then run
through the JAX unpack stages and the port's, on the CPU, and every stage
output is compared bitwise: exponents, bit allocation, coupling
coordinates, dequantized mantissas and the unpack carry.

The JAX stages run jitted, once per plan, with their Pallas gathers
replaced by the JAX package's own numpy oracle (bitgather.reference_
extract, through jax.pure_callback) -- the kernels themselves are held to
that oracle by tests/test_bitgather.py, and the port's kernels to their
plain versions by tests/test_torch_bitgather.py and chip_smoke.py.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ac3acm_tpu.ops.alloc as JA
import ac3acm_tpu.ops.bitgather as JBG
import ac3acm_tpu.ops.unpack_device as JU
import ac3acm_tpu.tables as JT
from ac3acm_tpu_torch.host.native import SideinfoBatchParser
from ac3acm_tpu_torch.ops import alloc as PA
from ac3acm_tpu_torch.ops import unpack_device as PU
from tests import streamgen

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FLAGS51 = JT.A52_STEREO | JT.A52_ADJUST_LEVEL


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _golden(name):
    return open(os.path.join(GOLDEN, name), "rb").read()


def _gen(seed, acmod, lfeon, nframes=6, **kw):
    for s in range(seed, seed + 10):
        try:
            return streamgen.gen_stream(s, acmod, lfeon, nframes=nframes,
                                        **kw)
        except OverflowError:
            continue
    raise RuntimeError("no stream fits")


class _SkipHeavyRng:
    """A numpy Generator for streamgen.gen_frame whose skip fields (the
    only integers(0, 12) draw) carry 300..511 bytes instead of 0..11."""

    def __init__(self, seed):
        self.r = np.random.default_rng(seed)
        self.skipped = 0

    def random(self):
        return self.r.random()

    def integers(self, *a, **k):
        if a == (0, 12) and not k:
            n = int(self.r.integers(300, 512))
            self.skipped += n
            return n
        return self.r.integers(*a, **k)


def _skip_heavy(seed=5, nframes=6):
    """A 3/2 stream whose blocks skip hundreds of bytes ahead of their
    mantissas (ROADMAP queue C: the TPU gather's skiple span hazard)."""
    for cap in (20, 12, 8):
        rng = _SkipHeavyRng(seed)
        st, out = None, b""
        try:
            for _ in range(nframes):
                frame, st = streamgen.gen_frame(rng, st, 7, False,
                                                csnr_cap=cap)
                out += frame
        except OverflowError:
            continue
        assert rng.skipped >= 1500, rng.skipped
        return out
    raise RuntimeError("no skip-heavy stream fits")


def _parse(streams, nfr):
    """[(es, flags)] -> frames [L, nfr, MB] uint8, meta {k: [L, 6nfr, ...]}
    in the wire dtypes; every lane must parse nfr valid frames."""
    fr, recs, mb = [], [], 128
    for es, flags in streams:
        r = SideinfoBatchParser(1).parse([es], nfr, flags, 1.0, 0.0)
        assert int(r["nframes"][0]) == nfr and r["valid"].all()
        fr.append(r["frames"][0])
        recs.append(r["recs"][0])
        mb = max(mb, -(-int(r["fsizes"].max()) // 128) * 128)
    recs = np.stack(recs)
    fu8 = np.ascontiguousarray(np.stack(fr)[:, :, :mb])
    return fu8, {k: np.ascontiguousarray(recs[k]) for k in recs.dtype.names}


# ---------------------------------------------------------------------------
# the two implementations, stage by stage
# ---------------------------------------------------------------------------

def _jax_gathers(mp):
    """Route the JAX unpack's Pallas gathers through the JAX package's
    numpy oracle (works under jit via pure_callback)."""
    def cb(fn, like, *args):
        return jax.pure_callback(
            fn, jax.ShapeDtypeStruct(like.shape, jnp.int16), *args)

    def fields(data, offs, widths):
        return cb(lambda d, o, w: JBG.reference_extract(
            np.asarray(d), np.asarray(o), np.asarray(w)).astype(np.int16),
            offs, data, offs, widths)

    def shared(table, offs, widths=None, span_rows=14, per_tile=False):
        return cb(lambda t, o: JBG.reference_extract(
            np.tile(np.asarray(t), (o.shape[0], 1)), np.asarray(o),
            np.full(o.shape, 16, np.int32)).astype(np.int16),
            offs, table, offs)

    def i16(table, offs):
        tab = np.asarray(table, np.int16)
        return cb(lambda o: tab[np.asarray(o)], offs, offs)

    mp.setattr(JU, "extract_fields", fields)
    mp.setattr(JU, "extract_fields_shared", shared)
    mp.setattr(JBG, "extract_i16_table", i16)


def _stages(U, fu8, meta, carry, nfch, cpl_fc, exp_pts, alloc_pts, emax):
    """Every stage output of the unpack module U (JAX's or the port's:
    the two share their stage functions' names and signatures)."""
    meta = U.widen_meta(meta)
    plan = U.plan_from_meta(meta, nfch, cpl_fc, exp_pts, alloc_pts, emax)
    exp, exp_rows = U.unpack_exponents(fu8, meta, carry["exp"], plan)
    bap = U.allocate_rows(exp, meta, plan)
    out = {"exp": exp, "exp_rows": exp_rows, "bap": bap}
    cplco = None
    if plan.has_cpl:
        cplco, out["cplco_carry"] = U.unpack_cplco(fu8, meta, carry["cplco"])
        out["cplco"] = cplco
    out["freq"], out["dpos"] = U.unpack_mantissas(
        fu8, exp, bap, cplco, meta, carry["dpos"], plan)
    return out


def _run_both(fu8, meta, nfch, chunk, plan_kw):
    """Both implementations over the frames in `chunk`-frame steps, the
    carry chained: -> list of (jax stages, port stages, jax carry, port
    carry, jax blocks, port blocks) per chunk, numpy."""
    L, F = fu8.shape[:2]
    jfn = jax.jit(functools.partial(_stages, JU, nfch=nfch, **plan_kw))
    jblk = jax.jit(functools.partial(JU.unpack_blocks, nfch=nfch, **plan_kw))
    jc, pc = JU.init_unpack_carry(L), PU.init_unpack_carry(L, "cpu")
    steps = []
    for f0 in range(0, F, chunk):
        fj = jnp.asarray(fu8[:, f0:f0 + chunk])
        fp = torch.from_numpy(np.ascontiguousarray(fu8[:, f0:f0 + chunk]))
        mj = {k: jnp.asarray(v[:, 6 * f0: 6 * (f0 + chunk)])
              for k, v in meta.items()}
        mp = {k: torch.from_numpy(np.ascontiguousarray(
            v[:, 6 * f0: 6 * (f0 + chunk)])) for k, v in meta.items()}
        sj = jax.device_get(jfn(fj, mj, jc))
        sp = {k: v.numpy() for k, v in _stages(
            PU, fp, mp, pc, nfch, **plan_kw).items()}
        jc, bj = jblk(fj, mj, jc, 0.0)
        pc, bp = PU.unpack_blocks(fp, mp, pc, 0.0, nfch=nfch, **plan_kw)
        steps.append((sj, sp, jax.device_get(jc),
                      {k: v.numpy() for k, v in pc.items()},
                      jax.device_get(bj), {k: v.numpy() for k, v in bp.items()}))
    return steps


# Dense plan, full meta, nfch = 5 for every lane (rows past a stream's
# channels are dead): one program covers coupling with phase flags and
# deltba, both dither routes' inputs, LFE, zero SNR and skip fields.
DENSE_LANES = {
    "bench_51_448": lambda: (_golden("bench_51_448.ac3"), FLAGS51),
    "cpl51_hazard": lambda: (_golden("cpl51_hazard.ac3"), FLAGS51),
    "stereo_192": lambda: (_golden("stereo_192.ac3"), JT.A52_STEREO),
    "stereo_cpl_phase": lambda: (_gen(11, 2, False, want_cpl=True),
                                 JT.A52_STEREO),
    "3f_cpl_deltba": lambda: (_gen(17, 3, False, want_cpl=True,
                                   want_deltba=True), JT.A52_STEREO),
    "3f2r_lfe_cpl": lambda: (_gen(14, 7, True, want_cpl=True),
                             JT.A52_STEREO | JT.A52_LFE),
    "3f2r_cpl_max_dither": lambda: (_gen(51, 7, False, want_cpl=True,
                                         cpl_mask=0b11111, zero_snr=True,
                                         force_dith=True), JT.A52_STEREO),
    "3f2r_skip_heavy": lambda: (_skip_heavy(), JT.A52_STEREO),
}


@pytest.fixture(scope="module")
def dense():
    with pytest.MonkeyPatch.context() as mp:
        _jax_gathers(mp)
        fu8, meta = _parse([f() for f in DENSE_LANES.values()], 6)
        assert meta["deltba"].any() and meta["phsflginu"].any()
        return _run_both(fu8, meta, 5, 3, dict(cpl_fc=-1, exp_pts=6,
                                                alloc_pts=6, emax=256))


@pytest.fixture(scope="module")
def compact():
    """The steady golden 5.1 lanes, pruned: exponent and allocation
    change points compacted, trimmed mantissa gather, i16 dither route."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_gathers(mp)
        fu8, meta = _parse([(_golden(n), FLAGS51) for n in (
            "bench_51_448.ac3", "realaudio_51_448.ac3")], 6)
        meta = PU.prune_raw_meta(meta)
        assert "chincpl" not in meta and "dith" in meta and "lfeon" in meta
        kw = dict(cpl_fc=-1, exp_pts=PU.static_exp_pts(meta),
                  alloc_pts=PU.static_alloc_pts(meta),
                  emax=PU.static_emax(meta))
        assert kw["exp_pts"] < 6 and kw["alloc_pts"] < 6 and kw["emax"] < 256
        return _run_both(fu8, meta, 5, 3, kw)


@pytest.fixture(scope="module")
def compact_cpl():
    """Coupling with a chunk-uniform first coupled channel (fc = 1): the
    compact coupling lattice, pruned meta."""
    with pytest.MonkeyPatch.context() as mp:
        _jax_gathers(mp)
        fu8, meta = _parse([(_gen(33, 7, True, want_cpl=True,
                                  cpl_mask=0b00110),
                             JT.A52_STEREO | JT.A52_LFE)], 6)
        meta = PU.prune_raw_meta(meta)
        assert PU.static_cpl_fc(meta) == 1 and "dith" in meta
        return _run_both(fu8, meta, 5, 3, dict(
            cpl_fc=1, exp_pts=6, alloc_pts=6, emax=256))


PROGRAMS = ["dense", "compact", "compact_cpl"]


def _each(request, name, key):
    for sj, sp, *_ in request.getfixturevalue(name):
        if key in sj:
            assert sp[key].dtype == sj[key].dtype, key
            np.testing.assert_array_equal(sp[key], sj[key], err_msg=key)


@pytest.mark.parametrize("program", PROGRAMS)
def test_unpack_exponents(request, program):
    _each(request, program, "exp")
    _each(request, program, "exp_rows")


@pytest.mark.parametrize("program", PROGRAMS)
def test_allocate_rows(request, program):
    _each(request, program, "bap")


@pytest.mark.parametrize("program", ["dense", "compact_cpl"])
def test_unpack_cplco(request, program):
    _each(request, program, "cplco")
    _each(request, program, "cplco_carry")


@pytest.mark.parametrize("program", PROGRAMS)
def test_unpack_mantissas(request, program):
    _each(request, program, "freq")
    _each(request, program, "dpos")


@pytest.mark.parametrize("program", PROGRAMS)
def test_unpack_blocks_and_carry(request, program):
    """unpack_blocks over two chained chunks: blocks and carry bitwise."""
    steps = request.getfixturevalue(program)
    assert len(steps) == 2
    for _, _, cj, cp, bj, bp in steps:
        for k in ("exp", "cplco", "dpos"):
            np.testing.assert_array_equal(cp[k], cj[k], err_msg=k)
        for k in ("freq", "blksw", "coeff", "remat", "bias"):
            np.testing.assert_array_equal(bp[k], bj[k], err_msg=k)


def test_freq_equals_native_dense_parser(dense):
    """The dequantized planes equal the native host pre-pass's (q*a)*b
    bit for bit on every dense lane (the same check chip_smoke.py makes
    on the card at 4096 lanes)."""
    from ac3acm_tpu_torch.host.native import DenseBatchParser
    for li, mk in enumerate(DENSE_LANES.values()):
        es, flags = mk()
        r = DenseBatchParser(1).parse([es], 6, flags, 1.0, 0.0)
        want = r["freq_full"][0]                        # [36, 6, 256]
        got = np.concatenate([s[5]["freq"][li] for s in dense])
        np.testing.assert_array_equal(got, want)


def test_sideinfo_parser_bitwise():
    """The port's side-info pool emits the JAX copy's records bit for bit
    (frames, sizes, records, validity, format)."""
    from ac3acm_tpu.host.native import SideinfoBatchParser as JaxParser
    es = _golden("cpl51_hazard.ac3")
    bufs = [es, _golden("bench_51_448.ac3")[1792:]]
    rp = SideinfoBatchParser(2).parse(bufs, 4, FLAGS51, 1.0, 384.0)
    rj = JaxParser(2, nthreads=1).parse(bufs, 4, FLAGS51, 1.0, 384.0)
    assert rp.keys() == rj.keys()
    for k in rj:
        np.testing.assert_array_equal(rp[k], rj[k], err_msg=k)
        assert rp[k].dtype == rj[k].dtype, k


def test_probes_and_prune_match_jax():
    fu8, meta = _parse([(_golden("cpl51_hazard.ac3"), FLAGS51),
                        (_gen(11, 2, False, want_cpl=True), JT.A52_STEREO)],
                       3)
    for fn in ("static_exp_pts", "static_alloc_pts", "static_emax",
               "static_cpl_fc"):
        assert getattr(PU, fn)(meta) == getattr(JU, fn)(meta), fn
    pj, pp = JU.prune_raw_meta(meta), PU.prune_raw_meta(meta)
    assert sorted(pj) == sorted(pp)
    nometa = {k: v for k, v in meta.items() if k not in ("chincpl", "dith")}
    for m in (meta, nometa):
        a = JU.plan_from_meta(m, 5, 0, 2, 3, 192)
        b = PU.plan_from_meta(m, 5, 0, 2, 3, 192)
        assert tuple(a) == tuple(b)
        for prop in ("rows", "R", "s2l", "l2s", "seg", "compact"):
            assert getattr(a, prop) == getattr(b, prop), prop


# ---------------------------------------------------------------------------
# ops.alloc on seeded random inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def alloc_inputs():
    rng = np.random.default_rng(21)
    L, R = 6, 7
    exp = rng.integers(0, 25, (L, R, 256)).astype(np.int32)
    end = rng.integers(1, 257, (L, R)).astype(np.int32)
    live = np.arange(256) < end[..., None]
    psd = np.where(live, 3072 - (exp << 7), -(1 << 20)).astype(np.int32)
    T = JT
    pick = lambda tab, n: np.asarray(tab)[rng.integers(0, n, (L,))]
    return dict(
        psd=psd, end=end, start=np.zeros((L, R), np.int32),
        fgain=np.asarray(T.FGAINTAB)[rng.integers(0, 8, (L, R))].astype(
            np.int32),
        sgain=pick(T.SGAINTAB, 4)[:, None].astype(np.int32),
        fdecay=pick(T.FDECAYTAB, 4)[:, None].astype(np.int32),
        sdecay=pick(T.SDECAYTAB, 4)[:, None].astype(np.int32),
        is_lfe=np.arange(R) == R - 1,
        bndstrt=rng.integers(0, 40, (L,)).astype(np.int32),
        cplfleak=rng.integers(0, 8, (L,)).astype(np.int32),
        cplsleak=rng.integers(0, 8, (L,)).astype(np.int32),
        dbknee=pick(T.DBKNEETAB, 4)[:, None, None].astype(np.int32),
        hth=np.asarray(T.HTH)[:, 0][None, None].astype(np.int32),
        deltba=rng.integers(-4, 5, (L, R, 50)).astype(np.int8),
        snro=rng.integers(-900, 300, (L, R, 1)).astype(np.int32),
        floor=pick(T.FLOORTAB, 8)[:, None, None].astype(np.int32))


def test_band_psd(alloc_inputs):
    x = alloc_inputs
    want = jax.jit(JA.band_psd)(x["psd"], x["end"])
    got = PA.band_psd(torch.from_numpy(x["psd"]), torch.from_numpy(x["end"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("variant", ["fbw_lfe", "coupling"])
def test_excitation(alloc_inputs, variant):
    x = alloc_inputs
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}
    bnd = np.asarray(jax.jit(JA.band_psd)(x["psd"], x["end"]))
    if variant == "fbw_lfe":
        want = jax.jit(JA.excitation)(bnd, x["fgain"], x["sgain"],
                                      x["fdecay"], x["sdecay"], x["is_lfe"])
        got = PA.excitation(torch.from_numpy(bnd), t["fgain"], t["sgain"],
                            t["fdecay"], t["sdecay"], t["is_lfe"])
    else:
        sq = lambda a: a[:, 0]
        want = jax.jit(lambda *a: JA.excitation(
            *a[:5], np.zeros(6, bool), bndstrt=a[5], cplfleak=a[6],
            cplsleak=a[7]))(bnd[:, 5], x["fgain"][:, 5], sq(x["sgain"]),
                            sq(x["fdecay"]), sq(x["sdecay"]), x["bndstrt"],
                            x["cplfleak"], x["cplsleak"])
        got = PA.excitation(torch.from_numpy(bnd[:, 5]), t["fgain"][:, 5],
                            sq(t["sgain"]), sq(t["fdecay"]), sq(t["sdecay"]),
                            None, bndstrt=t["bndstrt"],
                            cplfleak=t["cplfleak"], cplsleak=t["cplsleak"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_masking_curve_and_bap(alloc_inputs):
    """masking_curve with deltba, then bap_from_mask."""
    x = alloc_inputs
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}

    def jax_side(psd, end, fgain, sgain, fdecay, sdecay, dbknee, hth,
                 deltba, snro, floor, start):
        bnd = JA.band_psd(psd, end)
        exc = JA.excitation(bnd, fgain, sgain, fdecay, sdecay, x["is_lfe"])
        mask = JA.masking_curve(bnd, exc, dbknee, hth, deltba=deltba)
        return mask, JA.bap_from_mask(psd, mask, snro, floor, start, end)

    mj, bj = jax.jit(jax_side)(*(x[k] for k in (
        "psd", "end", "fgain", "sgain", "fdecay", "sdecay", "dbknee", "hth",
        "deltba", "snro", "floor", "start")))
    bnd = PA.band_psd(t["psd"], t["end"])
    exc = PA.excitation(bnd, t["fgain"], t["sgain"], t["fdecay"],
                        t["sdecay"], t["is_lfe"])
    mp = PA.masking_curve(bnd, exc, t["dbknee"], t["hth"],
                          deltba=t["deltba"])
    bp = PA.bap_from_mask(t["psd"], mp, t["snro"], t["floor"], t["start"],
                          t["end"])
    np.testing.assert_array_equal(mp.numpy(), np.asarray(mj))
    assert bp.dtype == torch.int8
    np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    assert len(np.unique(bp.numpy())) > 8        # many classes exercised
