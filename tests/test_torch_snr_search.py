"""Port: the encoder's masking curve, SNR-offset search and bap
(ops.snr_search, kernel E1) on the CPU, bitwise against the JAX package.

  * The oracle is JAX's masking curve (ops/alloc.py band_psd, excitation,
    masking_curve, as ac3acm_tpu/models/encoder.py:386-396 calls them) and
    its rate model (bits_for_snro, bap_from_mask) driven by the binary
    search of its frame core (encoder.py:407-445), replayed here on the
    same inputs.  The port's snr_search on CPU tensors (its plain version,
    mask_search_ref) must equal it in M, fstar and bap on every row from
    the coded exponents; the plain search alone (snr_search_ref) must equal
    JAX's search on JAX's curve.
  * Inputs are chip_smoke.py's crafted cases (the same ones it holds E1
    to on the card): seeded exponents in [0, 24] on the live bins and any
    byte past them; 1 to 6 channels with and without an LFE (its band-6
    lowcomp skip forced on some rows), and edge layouts; each layout at one
    of the three sample rates' hearing thresholds, and 5.1 at the
    half-rate decays (halfratecod 1 and 2); budgets that force
    M = -1 (with and without a fine fit), M = 63, fstar = 0 and 15, exact
    ties, a ceiling that tells the per-block grouping from per-channel and
    per-frame ones, and random ones.
  * The wrapper refuses what the kernel does not take, and a CPU tensor
    never launches it.
"""
from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as CS
from ac3acm_tpu import tables as JT
from ac3acm_tpu.ops import alloc as JAL
from ac3acm_tpu_torch.ops import snr_search as SS

FLOOR = int(JT.FLOORTAB[4])
R = CS.E1_ROWS_A_KIND


def _snro(c, f):
    return (((c - 15) << 4) + f) << 2


@partial(jax.jit, static_argnums=4)
def _jax_mask(psd, ends, is_lfe, hth, hr):
    lead = psd.shape[:3]
    bnd = JAL.band_psd(psd, jnp.broadcast_to(ends, lead))
    exc = JAL.excitation(bnd, int(JT.FGAINTAB[4]), int(JT.SGAINTAB[1]),
                         int(JT.FDECAYTAB[1]) >> hr,
                         int(JT.SDECAYTAB[2]) >> hr,
                         jnp.broadcast_to(is_lfe, lead))
    return JAL.masking_curve(bnd, exc, int(JT.DBKNEETAB[2]), hth)


def jax_mask(psd, nb, lfe, fscod=0, hr=0):
    """The encoder's masking curve at sample rate fscod and halfratecod
    hr from JAX's allocator (the constants of JAX's frame core,
    models/encoder.py:386-396; one compile a channel count and hr)."""
    is_lfe = np.zeros(len(nb), bool)
    is_lfe[-1] = lfe
    return np.array(_jax_mask(psd, np.asarray(nb, np.int32), is_lfe,
                              JT.HTH[:, fscod].astype(np.int32), hr))


def jax_bap(psd, mask, nb, snro):
    """JAX's bap_from_mask at one offset a row (snro [rows])."""
    ends = jnp.broadcast_to(jnp.asarray(nb), psd.shape[:3])
    return np.asarray(JAL.bap_from_mask(
        psd, mask, jnp.asarray(snro)[:, None, None, None], FLOOR,
        jnp.zeros_like(ends), ends))


def jax_search(psd, mask, avail, nb):
    """The JAX frame core's search (models/encoder.py:407-445) and its
    bap on these inputs."""
    live = jnp.arange(256)[None, :] < jnp.asarray(nb)[:, None]

    def fits(c, f):
        bits = jnp.sum(JAL.bits_for_snro(psd, live, mask,
                                         _snro(c, f)[:, None, None, None],
                                         FLOOR), axis=-1)
        return (avail - bits) >= 0

    n = psd.shape[0]
    lo = jnp.full((n,), -1, jnp.int32)
    hi = jnp.full((n,), 63, jnp.int32)
    for _ in range(7):
        mid = (lo + hi + 1) >> 1
        ok = fits(mid, jnp.zeros((n,), jnp.int32))
        lo = jnp.where(ok, mid, lo)
        hi = jnp.where(ok, hi, mid - 1)
    flo = jnp.full((n,), -1, jnp.int32)
    fhi = jnp.full((n,), 15, jnp.int32)
    for _ in range(5):
        fmid = (flo + fhi + 1) >> 1
        ok = fits(lo, fmid)
        flo = jnp.where(ok, fmid, flo)
        fhi = jnp.where(ok, fhi, fmid - 1)
    fstar = jnp.maximum(flo, 0)
    return (np.asarray(lo), np.asarray(fstar),
            jax_bap(psd, mask, nb, np.asarray(_snro(lo, fstar))))


def np_search(psd, mask, avail, nb, per):
    """The same search with e1_grouped_bits at granularity `per` over
    JAX's bap: -> (M, fstar)."""
    def fits(c, f):
        bits = CS.e1_grouped_bits(jax_bap(psd, mask, nb, _snro(c, f)), nb,
                                  per)
        return avail.astype(np.int64) - bits >= 0

    n = len(avail)
    lo, hi = np.full(n, -1), np.full(n, 63)
    for _ in range(7):
        mid = (lo + hi + 1) >> 1
        ok = fits(mid, 0)
        lo, hi = np.where(ok, mid, lo), np.where(ok, hi, mid - 1)
    flo, fhi = np.full(n, -1), np.full(n, 15)
    for _ in range(5):
        fmid = (flo + fhi + 1) >> 1
        ok = fits(lo, fmid)
        flo, fhi = np.where(ok, fmid, flo), np.where(ok, fhi, fmid - 1)
    return lo, np.maximum(flo, 0)


def port_case(exp, avail, nb, lfe, fscod, hr=0):
    """The port's outputs on one case's numpy inputs: (snr_search's (M,
    fstar, bap) from the exponents, its curve) as numpy."""
    args = (torch.from_numpy(exp), torch.from_numpy(avail)) + CS.e1_consts(
        nb, lfe, fscod, "cpu", hr)
    out = SS.snr_search(*args)
    mask = SS.masking(args[0], *args[2:])[1]
    return tuple(t.numpy() for t in out), mask.numpy()


@lru_cache(maxsize=None)
def layout_case(i, fscod=None, hr=0):
    """chip_smoke.e1_case's inputs for E1_LAYOUTS[i] (at sample rate
    i mod 3 unless fscod is given, at halfratecod hr) built on JAX's
    allocator, with JAX's and the port's outputs."""
    nb, lfe = CS.E1_LAYOUTS[i]
    fscod = i % 3 if fscod is None else fscod
    rng = np.random.default_rng(1400 + hr if hr else 1300 + i)
    exp = CS.e1_exp(rng, R * len(CS.E1_KINDS), nb)
    psd = CS.e1_psd(exp, nb)
    mask = jax_mask(psd, nb, lfe, fscod, hr)
    avail = CS.e1_budgets(rng, nb, lambda s: jax_bap(psd, mask, nb, s))
    port, port_mask = port_case(exp, avail, nb, lfe, fscod, hr)
    ref = SS.snr_search_ref(torch.from_numpy(psd), torch.from_numpy(mask),
                            torch.from_numpy(avail),
                            torch.tensor(nb, dtype=torch.int32))
    return dict(exp=exp, psd=psd, mask=mask, avail=avail, nb=nb, lfe=lfe,
                fscod=fscod, jax=jax_search(psd, mask, avail, nb), port=port,
                ref=tuple(t.numpy() for t in ref),
                mask_equal=np.array_equal(port_mask, mask))


def _ids():
    return [f"{'-'.join(map(str, nb))}{'-lfe' * lfe}"
            for nb, lfe in CS.E1_LAYOUTS]


def _assert_rows(case, got, rows, kind):
    """got (M, fstar, bap) equals JAX's on rows, with the kind's edges."""
    M, fstar, bap = got
    assert M.dtype == fstar.dtype == np.int32 and bap.dtype == np.int8
    for name, g, want in zip(("M", "fstar", "bap"), got, case["jax"]):
        assert np.array_equal(g[rows], want[rows]), (name, g[rows],
                                                     want[rows])
    if kind == "free":
        assert (M[rows] == 63).all() and (fstar[rows] == 15).all()
    if kind == "none":
        assert (M[rows] == -1).all() and (fstar[rows] == 0).all()
    dead = np.arange(256) >= np.asarray(case["nb"])[:, None]
    assert not bap[:, :, dead].any()


@pytest.mark.parametrize("kind", CS.E1_KINDS)
@pytest.mark.parametrize("layout", range(len(CS.E1_LAYOUTS)), ids=_ids())
def test_mask_search_matches_jax(layout, kind):
    """snr_search from the coded exponents (masking curve, search and bap)
    equals JAX's curve and search on the rows given this budget kind, in
    M, fstar and bap bitwise, and its curve equals JAX's."""
    case = layout_case(layout)
    k = CS.E1_KINDS.index(kind)
    assert case["mask_equal"]
    _assert_rows(case, case["port"], slice(k * R, (k + 1) * R), kind)


@pytest.mark.parametrize("fscod", [0, 1, 2])
def test_each_sample_rate_threshold(fscod):
    """The 5.1 layout at each sample rate's hearing threshold: every
    budget kind's rows equal JAX's bitwise."""
    case = layout_case(len(CS.E1_LAYOUTS) - 4, fscod)
    assert case["lfe"] and case["mask_equal"]
    for k, kind in enumerate(CS.E1_KINDS):
        _assert_rows(case, case["port"], slice(k * R, (k + 1) * R), kind)


@pytest.mark.parametrize("hr", [1, 2])
def test_half_rate_curve_matches_jax(hr):
    """The 5.1 layout at halfratecod hr (fdecay and sdecay shifted right,
    the curve of a 24 or 12 kHz encoder; the seeds chip_smoke's
    phase_check_e1 uses): the decays change the curve, and every budget
    kind's rows equal JAX's bitwise."""
    case = layout_case(len(CS.E1_LAYOUTS) - 4, 0, hr)
    assert case["lfe"] and case["mask_equal"]
    full = jax_mask(case["psd"], case["nb"], True, 0, 0)
    assert not np.array_equal(full, case["mask"])
    for k, kind in enumerate(CS.E1_KINDS):
        _assert_rows(case, case["port"], slice(k * R, (k + 1) * R), kind)


def test_lfe_band6_lowcomp_skip():
    """On the rows that carry E1_LFE_EXPS, the LFE's band 6 keeps its
    lowcomp: its curve there differs from a full-band channel's, and the
    port follows JAX with the flag either way."""
    case = layout_case(3)                       # (223, 7) with the LFE
    rows = slice(2, None, 4)
    assert case["mask_equal"]
    flip = jax_mask(case["psd"], case["nb"], False, case["fscod"])
    assert (flip[rows, :, -1, 6] != case["mask"][rows, :, -1, 6]).all()
    port, port_mask = port_case(case["exp"], case["avail"], case["nb"],
                                False, case["fscod"])
    assert np.array_equal(port_mask, flip)
    want = jax_search(case["psd"], flip, case["avail"], case["nb"])
    for g, w in zip(port, want):
        assert np.array_equal(g, w)


def test_channel_with_no_live_bins():
    """A channel with nb = 0 costs nothing and gets no bap; the others
    equal JAX's bitwise."""
    nb = (223, 0, 7)
    rng = np.random.default_rng(14)
    exp = CS.e1_exp(rng, 16, nb)
    psd = CS.e1_psd(exp, nb)
    mask = jax_mask(psd, nb, True)
    avail = rng.integers(0, 40000, 16).astype(np.int32)
    port, port_mask = port_case(exp, avail, nb, True, 0)
    assert np.array_equal(port_mask, mask)
    for g, w in zip(port, jax_search(psd, mask, avail, nb)):
        assert np.array_equal(g, w)
    assert not port[2][:, :, 1].any()


@pytest.mark.parametrize("kind", CS.E1_KINDS)
@pytest.mark.parametrize("layout", range(len(CS.E1_LAYOUTS)), ids=_ids())
def test_snr_search_matches_jax(layout, kind):
    """The plain search alone (snr_search_ref on JAX's curve): M, fstar
    and bap of the rows given this budget kind, bitwise."""
    case = layout_case(layout)
    k = CS.E1_KINDS.index(kind)
    _assert_rows(case, case["ref"], slice(k * R, (k + 1) * R), kind)


def _all_rows(kind):
    """Every layout's rows of one budget kind: (case, row slice) pairs."""
    k = CS.E1_KINDS.index(kind)
    return [(layout_case(i), slice(k * R, (k + 1) * R))
            for i in range(len(CS.E1_LAYOUTS))]


def _bits_at(case, M, fstar):
    """The bits of every row of a case at its (M, fstar)."""
    bap = jax_bap(case["psd"], case["mask"], case["nb"], _snro(M, fstar))
    return CS.e1_grouped_bits(bap, case["nb"])


@pytest.mark.parametrize("edge", ["M=-1 with a fine fit", "fstar=0",
                                  "fstar=15", "coarse tie", "fine tie"])
def test_budget_kinds_reach_their_edges(edge):
    """The crafted budgets do force what they are for, somewhere among
    the layouts (the port equals JAX on those rows by the test above)."""
    kind = {"M=-1 with a fine fit": "neg_fine", "fstar=0": "coarse_tie",
            "fstar=15": "f15", "coarse tie": "coarse_tie",
            "fine tie": "fine_tie"}[edge]
    hits = 0
    for case, rows in _all_rows(kind):
        M, fstar, _ = (t[rows] for t in case["port"])
        if edge == "M=-1 with a fine fit":
            hits += int(((M == -1) & (fstar > 0)).sum())
        elif edge == "fstar=0":
            hits += int(((M >= 0) & (M < 63) & (fstar == 0)).sum())
        elif edge == "fstar=15":
            hits += int(((M < 63) & (fstar == 15)).sum())
        else:
            bits = _bits_at(case, *case["port"][:2])[rows]
            hits += int(((bits == case["avail"][rows]) & (M < 63)).sum())
    assert hits > 0, edge


@pytest.mark.parametrize("per", ["channel", "frame"])
def test_ceiling_granularity_is_told_apart(per):
    """On the "ceiling" rows, a search that takes the grouped ceilings per
    (block, channel) or per frame lands elsewhere than JAX's, while the
    same numpy count per block lands where JAX's does."""
    differs = 0
    for case, rows in _all_rows("ceiling"):
        args = case["psd"], case["mask"], case["avail"], case["nb"]
        want = case["jax"][0][rows], case["jax"][1][rows]
        block = [t[rows] for t in np_search(*args, "block")]
        assert all(np.array_equal(a, b) for a, b in zip(block, want))
        other = [t[rows] for t in np_search(*args, per)]
        differs += int(((other[0] != want[0]) | (other[1] != want[1])).sum())
    assert differs > 0, per


def test_grouped_bits_helper_is_jax_rate_model():
    """chip_smoke.e1_grouped_bits (per block) equals JAX's bits_for_snro
    summed over blocks, at several offsets."""
    case = layout_case(len(CS.E1_LAYOUTS) - 1)
    psd, mask, nb = case["psd"], case["mask"], case["nb"]
    live = jnp.arange(256)[None, :] < jnp.asarray(nb)[:, None]
    for c, f in ((-1, 0), (0, 7), (20, 3), (63, 15)):
        s = np.full(len(psd), _snro(c, f), np.int32)
        want = np.asarray(JAL.bits_for_snro(psd, live, mask,
                                            jnp.asarray(s)[:, None, None,
                                                           None],
                                            FLOOR)).sum(-1)
        assert np.array_equal(CS.e1_grouped_bits(jax_bap(psd, mask, nb, s),
                                                 nb), want)


@pytest.mark.parametrize("gap", [0, 1000, 3000])
def test_budget_near_int32_min_wraps_like_jax(gap):
    """avail - bits is taken in int32, where it wraps, in JAX and in the
    plain version alike (the encoder's budgets never come near; E1 wraps
    the same way): rows whose bits pass avail - INT32_MIN fit."""
    nb = (223, 7)
    rng = np.random.default_rng(gap)
    exp = CS.e1_exp(rng, 8, nb)
    psd = CS.e1_psd(exp, nb)
    mask = jax_mask(psd, nb, True)
    avail = (np.iinfo(np.int32).min + gap
             + rng.integers(0, 20000, 8)).astype(np.int32)
    want = jax_search(psd, mask, avail, nb)
    got, _ = port_case(exp, avail, nb, True, 0)
    for name, g, w in zip(("M", "fstar", "bap"), got, want):
        assert np.array_equal(g, w), name
    assert (want[0] > -1).any(), "no row's budget wrapped"


def _good(rows=3, nb=(223, 7)):
    rng = np.random.default_rng(7)
    exp = torch.from_numpy(CS.e1_exp(rng, rows, nb))
    avail = torch.full((rows,), 9000, dtype=torch.int32)
    return [exp, avail, *CS.e1_consts(nb, True, 0, "cpu")]


@pytest.mark.parametrize("bad", [
    "enc_exp int32", "avail int64", "nb int64", "is_lfe int32",
    "hth int64", "hth 49 bands", "enc_exp 255 bins", "avail short",
    "nb long", "is_lfe long", "7 channels", "enc_exp strided",
    "enc_exp unaligned", "halfratecod 3", "halfratecod -1"])
def test_wrapper_refuses(bad):
    """The wrapper's checks hold on the CPU as on the card, and no CPU
    call launches the kernel."""
    args = _good()
    if bad == "7 channels":
        args = _good(nb=(223,) * 6 + (7,))
    name = "enc_exp" if bad == "7 channels" else bad.split()[0]
    i = ("enc_exp", "avail", "nb", "is_lfe", "hth",
         "halfratecod").index(name)
    t = args[i]
    flat = torch.zeros(t.numel() + 16, dtype=torch.uint8) \
        if name == "enc_exp" else None
    args[i] = {"enc_exp int32": lambda: t.to(torch.int32),
               "avail int64": lambda: t.long(),
               "nb int64": lambda: t.long(),
               "is_lfe int32": lambda: t.to(torch.int32),
               "hth int64": lambda: t.long(),
               "hth 49 bands": lambda: t[:49].contiguous(),
               "enc_exp 255 bins": lambda: t[..., :255].contiguous(),
               "avail short": lambda: t[:-1],
               "nb long": lambda: torch.cat([t, t[:1]]),
               "is_lfe long": lambda: torch.cat([t, t[:1]]),
               "7 channels": lambda: t,
               "enc_exp strided": lambda: t.transpose(0, 1).contiguous()
               .transpose(0, 1),
               "enc_exp unaligned": lambda: flat[1:1 + t.numel()]
               .view(t.shape),
               "halfratecod 3": lambda: 3,
               "halfratecod -1": lambda: -1}[bad]()
    err = TypeError if "int" in bad else ValueError
    before = SS.launches_snr_search
    with pytest.raises(err):
        SS.snr_search(*args)
    SS.snr_search(*_good())
    assert SS.launches_snr_search == before == 0
