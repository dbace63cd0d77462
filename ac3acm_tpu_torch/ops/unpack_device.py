"""Device-side bitstream unpack: raw AC-3 frame bytes -> dequantized planes.

The raw-H2D decode path ships each lane's coded frame bytes plus a small
per-block side-info record (host.native.SideinfoBatchParser) and
reconstructs everything else on the device:

    exponent fields --bitgather--> grouped deltas --cumsum--> exp[row, bin]
    exp + side-info --ops.alloc--> bap[row, bin]           (recompute-always)
    bap             --cumsums---> per-slot widths + bit offsets + dither
                                   ordinals (the coded-order lattice)
    frame bytes     --bitgather--> mantissa codes
    codes           --arith------> quantizer values ((q, a, b) dequant
                                   factors, bit-identical to the host
                                   pre-pass and therefore to liba52)

Reference semantics: liba52 parse.c (parse_exponents:218, coeff_get:336,
coeff_get_coupling:435, dither_gen:310) and bit_allocate.c:124-265.

Every tensor is shaped [L, S, ...] with L = lanes and S = 6 * nframes
blocks in stream order; cross-block state (exponent reuse, coupling
coordinates, the dither LFSR position) resolves by last-setter selection
along S plus an explicit carry at chunk boundaries.

Static specialization (RowPlan): the host knows, per chunk, how many
full-bandwidth channels the format has and whether ANY block uses
coupling, dither or the LFE channel.  prune_raw_meta drops the meta keys
for absent features, and every stage sizes its row set and slot lattice
to the active plan.  Dead rows pass their carry state through unchanged,
like liba52's untouched a52_state_t fields.

The bitfield reads are the kernels of ops.bitgather; everything else is
plain PyTorch.  Integer tensors are int32 (cumsums name their dtype)
except the gathers' wire, which each stage builds narrow from the start:
slot widths uint8 (bap int8 on the mantissa lattice), slot offsets int16
(_narrow), the dither ordinals in steps of 16 bits.  Each float product
of the dequantization is its own op, so
``freq`` equals liba52's (q * a) * b bit for bit.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .. import tables as T
from ..host.native import RAW_REC_DTYPE
from ..utils.device import resolve_device
from ..utils.trace import span
from . import alloc as A
from . import bitgather as BG

EXP_ROW_SLOTS = 86           # abs + 85 groups per row
CPLCO_SLOTS = 5 * 37 + 18    # per block: 5 ch x (mstr + 18 x (exp, mant)),
                             # then 18 phase-flag bits

_BIG_NEG = -(1 << 20)


class RowPlan(NamedTuple):
    """Static per-dispatch row configuration.

    nfch: full-bandwidth channel count of the format-homogeneous batch;
    has_cpl/has_lfe/has_dith: whether any block in the chunk uses the
    feature (from meta key presence); cpl_fc: the first-coupled channel
    when it is chunk-uniform (static_cpl_fc), else -1.  cpl_fc >= 0
    selects the COMPACT mantissa lattice (one coupling segment after
    channel cpl_fc) instead of a coupling copy after every channel.

    exp_pts / alloc_pts (from static_exp_pts / static_alloc_pts): at most
    that many blocks per frame carry new exponents / change any
    bit-allocation input; 6 = dense.  Steady streams compact 6x: the
    exponent decode and the allocator's band math run once per frame and
    forward-fill, the device twin of liba52's do_bit_alloc caching.

    emax (from static_emax): per-channel extent of the mantissa gather on
    no-coupling chunks; slots past every stream's endmant are dead, so the
    gather runs on [0:emax) of each channel (+ 64 LFE slots).  256 = no
    trim."""
    nfch: int = 5
    has_cpl: bool = True
    has_lfe: bool = True
    has_dith: bool = True
    cpl_fc: int = -1
    exp_pts: int = 6
    alloc_pts: int = 6
    emax: int = 256

    @property
    def rows(self):
        """Active rows in fixed-7 logical indexing (fbw0..4=0-4, cpl=5,
        lfe=6)."""
        return (tuple(range(self.nfch))
                + ((5,) if self.has_cpl else ())
                + ((6,) if self.has_lfe else ()))

    @property
    def R(self):
        return len(self.rows)

    @property
    def cpl(self):
        """Active-row index of the coupling row (valid iff has_cpl)."""
        return self.nfch

    @property
    def lfe(self):
        """Active-row index of the LFE row (valid iff has_lfe)."""
        return self.R - 1

    @property
    def s2l(self):
        """Stream position -> active-row index.  Stream order (the order
        exponent fields appear in the bits): cpl, fbw0.., lfe."""
        return (((self.cpl,) if self.has_cpl else ())
                + tuple(range(self.nfch))
                + ((self.lfe,) if self.has_lfe else ()))

    @property
    def l2s(self):
        """Active-row index -> stream position (inverse of s2l)."""
        return tuple(int(i) for i in np.argsort(np.asarray(self.s2l)))

    @property
    def compact(self):
        """True when the lattice carries ONE coupling segment at a static
        position (after channel cpl_fc) instead of a per-channel copy."""
        return self.has_cpl and self.cpl_fc >= 0

    @property
    def seg(self):
        """Mantissa lattice slots per block: fbw rows (+ one cpl segment
        when compact, or a cpl copy interleaved per channel otherwise)
        + the LFE row."""
        if self.compact:
            main = (self.nfch + 1) * 256
        else:
            main = self.nfch * (512 if self.has_cpl else 256)
        return main + (128 if self.has_lfe else 0)

    @property
    def cpl_seg(self):
        """Slot offset of the coupling segment (compact layout only)."""
        assert self.compact
        return (self.cpl_fc + 1) * 256


def plan_from_meta(meta, nfch: int = 5, cpl_fc: int = -1,
                   exp_pts: int = 6, alloc_pts: int = 6,
                   emax: int = 256) -> RowPlan:
    return RowPlan(nfch=nfch,
                   has_cpl="chincpl" in meta,
                   has_lfe="lfeon" in meta,
                   has_dith="dith" in meta,
                   cpl_fc=cpl_fc if "chincpl" in meta else -1,
                   exp_pts=exp_pts, alloc_pts=alloc_pts,
                   emax=emax if "chincpl" not in meta else 256)


# ---------------------------------------------------------------------------
# host-side probes and meta preparation (numpy)
# ---------------------------------------------------------------------------

def static_emax(meta) -> int:
    """The chunk's max fbw endmant, laddered to {128, 160, 192, 224, 256}
    (a small ladder keeps the set of plans small).  Feeds RowPlan.emax."""
    em = int(np.asarray(meta["endmant"]).max(initial=0))
    for cap in (128, 160, 192, 224):
        if em <= cap:
            return cap
    return 256


# meta keys whose change between consecutive blocks invalidates the
# cached bit allocation (parse.c's do_bit_alloc triggers); new exponents
# (exp_off >= 0) always do.
_ALLOC_KEYS = ("endmant", "chincpl", "cplstrt", "cplend", "cplstrtbnd",
               "ncplbnd", "bai", "csnroffst", "cplbai", "babai", "lfebai",
               "cplfleak", "cplsleak", "lfeon", "fscod", "halfrate",
               "deltba")


def static_exp_pts(meta) -> int:
    """Max blocks per frame carrying new exponents (any row), over every
    lane/frame of the chunk.  [.., S, ..] meta, S = 6F."""
    eo = np.asarray(meta["exp_off"])
    has = (eo >= 0).any(-1)
    has = has.reshape(has.shape[:-1] + (-1, 6))
    return max(1, int(has.sum(-1).max()))


def static_alloc_pts(meta) -> int:
    """Max blocks per frame where any bit-allocation input changes vs the
    previous block.  Block 0 of EVERY frame counts as a point: chunks
    start at frame boundaries and the device forces a point at each
    chunk's first block, so the bound must hold for any frame-aligned
    chunking."""
    eo = np.asarray(meta["exp_off"])
    lead = eo.shape[:-2]
    S = eo.shape[-2]
    ch = (eo >= 0).any(-1).reshape(-1, S).copy()
    ch[:, ::6] = True
    for k in _ALLOC_KEYS:
        if k not in meta:
            continue
        v = np.asarray(meta[k]).reshape(np.prod(lead, dtype=int), S, -1)
        ch[:, 1:] |= (v[:, 1:] != v[:, :-1]).any(-1)
    return max(1, int(ch.reshape(-1, S // 6, 6).sum(-1).max()))


def static_cpl_fc(meta) -> int:
    """The first-coupled channel index if it is the same for EVERY coupled
    block in the chunk, else -1 (selects the compact lattice)."""
    ch = np.asarray(meta.get("chincpl", 0)).ravel()
    ch = ch[ch != 0]
    if ch.size == 0:
        return -1
    fc = np.unique(ch & -ch)
    return int(fc[0]).bit_length() - 1 if fc.size == 1 else -1


# meta keys that only serve one feature; prune_raw_meta drops each group
# when the feature is absent from the whole chunk
_CPL_KEYS = ("cplco_off", "phs_off", "chincpl", "phsflginu", "cplstrt",
             "cplend", "cplbndstrc", "ncplbnd", "cplstrtbnd", "cplbai",
             "cplfleak", "cplsleak")
_LFE_KEYS = ("lfebai", "lfe_scale", "lfeon", "lfe_out")


def prune_raw_meta(meta: dict) -> dict:
    """Drop meta keys for features absent from the whole chunk (delta bit
    allocation, coupling, dither, LFE): the plan specializes on what
    remains, and the dropped arrays never cross the host link."""
    meta = dict(meta)
    if "deltba" in meta and not np.asarray(meta["deltba"]).any():
        del meta["deltba"]
    if "chincpl" in meta and not np.asarray(meta["chincpl"]).any():
        for k in _CPL_KEYS:
            meta.pop(k, None)
    if "dith" in meta and not np.asarray(meta["dith"]).any():
        del meta["dith"]
    if "lfeon" in meta and not np.asarray(meta["lfeon"]).any():
        for k in _LFE_KEYS:
            meta.pop(k, None)
    return meta


# ---------------------------------------------------------------------------
# meta stacking for the Python side-info parser (host side, numpy)
# ---------------------------------------------------------------------------

def null_raw_rec() -> dict:
    """A benign per-block record for invalid lane-frames: no exponent or
    coupling fields, csnroffst 0 with all bai clear -> the zero-SNR
    shortcut zeroes every bap, so the device emits silence for the block
    (the lane's valid mask flags it downstream)."""
    return {
        "exp_off": np.full(7, -1, np.int32), "expstr": np.zeros(7, np.int32),
        "ngrps": np.zeros(7, np.int32),
        "cplco_off": np.full(5, -1, np.int32), "phs_off": -1, "man_off": 0,
        "endmant": np.zeros(5, np.int32), "chincpl": 0, "phsflginu": 0,
        "cplstrt": 37, "cplend": 37, "cplbndstrc": 0, "ncplbnd": 0,
        "cplstrtbnd": 0, "bai": 0, "csnroffst": 0, "cplbai": 0,
        "babai": np.zeros(5, np.int32), "lfebai": 0, "cplfleak": 0,
        "cplsleak": 0, "dith": np.zeros(5, np.int32),
        "blksw": np.zeros(5, np.int32), "coeff": np.zeros(5, np.float32),
        "chanbias": 0, "rematflg": 0, "lfe_scale": np.float32(0.0),
        "lfeon": 0, "lfe_out": 0, "fscod": 0, "halfrate": 0,
        "deltba": np.zeros((7, 50), np.int8), "raw_ok": False,
    }


def stack_raw_meta(recs: list) -> dict:
    """Stack host.parse.A52Parser raw records (one per block) into [S, ...]
    arrays, each key in the wire dtype the native side-info parser gives
    it (host.native.RAW_REC_DTYPE), so that parser="raw_py" ships the same
    meta as parser="raw"; plus "raw_ok" [S] bool.  The -1 offset sentinels
    survive: every integer wire dtype is signed."""
    out = {}
    for k in RAW_REC_DTYPE.names:
        vals = [r[k] for r in recs]
        dt = RAW_REC_DTYPE[k].base
        if isinstance(vals[0], np.ndarray):
            out[k] = np.stack(vals).astype(dt)
        else:
            out[k] = np.asarray(vals, dt)
    out["raw_ok"] = np.asarray([bool(r["raw_ok"]) for r in recs], bool)
    return out


def widen_meta(meta: dict) -> dict:
    """Upcast the wire meta (narrow ints) to int32 on its device; float32
    and bool keys pass through."""
    return {k: v if v.dtype in (torch.float32, torch.bool)
            else v.to(torch.int32) for k, v in meta.items()}


def init_unpack_carry(L: int, device=None) -> dict:
    """Zero unpack carry for L lanes on `device` (None: the CUDA card)."""
    device = resolve_device(device)
    return {
        "exp": torch.zeros((L, 7, 256), dtype=torch.int32, device=device),
        "cplco": torch.zeros((L, 5, 18), dtype=torch.float32, device=device),
        "dpos": torch.zeros((L,), dtype=torch.int32, device=device),
    }


# ---------------------------------------------------------------------------
# small helpers
# ---------------------------------------------------------------------------

def _ar(n, ref):
    return torch.arange(n, dtype=torch.int32, device=ref.device)


def _excl_cumsum(x, dim=-1):
    return torch.cumsum(x, dim=dim, dtype=torch.int32) - x


def _narrow(a, b):
    """Slot bit offsets a + b as int16, written by the add itself (no pass
    of its own) for the bitfield gathers' narrow wire.

    Every slot offset here is a side-info bit position of the wire record
    (exp_off, cplco_off, phs_off, man_off: the parser's cursor stored as
    int16) plus the bits of the block's earlier fields of the same kind, at
    most 16 for each of 5 x 256 + 256 + 7 = 1,543 live mantissa slots, so
    the int32 sum lies in [-32768, 57455].  Up to 32,767 the int16 is the
    sum itself; above it the int16 wraps into [-32768, -8081], before the
    row, where the sum lies past bit 32,767, after any frame (at most
    3,840 B): both read 0, so the gathers give what int32 offsets give."""
    out = torch.empty(torch.broadcast_shapes(a.shape, b.shape),
                      dtype=torch.int16, device=a.device)
    return torch.add(a, b, out=out)


def _pow2(e):
    """Exact float32 2**e for integer e (clamped to the normal range; a
    clamped value only ever lands in a masked-out lane)."""
    e = torch.clamp(e, -126, 127)
    return ((e + 127) << 23).to(torch.int32).view(torch.float32)


def _ldexp(x, e):
    """x * 2**e, exact: a product with an exact power of two rounds like
    ldexp."""
    return x * _pow2(e)


def _take_blocks(x, sidx):
    """x [L, S, ...] -> [L, P, ...] rows at sidx [L, P]."""
    lane = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[lane, sidx.long()]


def resolve_setters(new_vals, set_mask, carry):
    """Last-setter selection along the block axis (EXP_REUSE semantics).

    new_vals [L, S, R, K]: per-block freshly decoded values (garbage where
    not set); set_mask [L, S, R] bool; carry [L, R, K] the value entering
    the chunk.  Returns (resolved [L, S, R, K], new_carry)."""
    L, S, R, K = new_vals.shape
    s_idx = _ar(S, new_vals)[None, :, None]
    idx = torch.cummax(torch.where(set_mask, s_idx, -1), dim=1).values
    allv = torch.cat([carry[:, None], new_vals], dim=1)
    out = torch.gather(allv, 1, (idx + 1).long()[..., None].expand(
        L, S, R, K))
    return out, out[:, -1]


def _frame_points(flag, E):
    """flag [L, S=6F] bool -> (sidx [L, F*E] global block index of the
    e-th flagged block per frame (padding -> block 0 of the frame), valid
    [L, F*E]).  The static bound E >= max flagged blocks per frame is the
    caller's contract (static_exp_pts / static_alloc_pts)."""
    L, S = flag.shape
    F = S // 6
    hf = flag.reshape(L, F, 6)
    hi = hf.to(torch.int32)
    rank = torch.cumsum(hi, dim=-1, dtype=torch.int32) - hi    # exclusive
    b6 = _ar(6, flag)
    pos, valid = [], []
    for e in range(E):
        sel = hf & (rank == e)                   # <= one block per frame
        pos.append(torch.where(sel, b6, 0).sum(-1, dtype=torch.int32))
        valid.append(sel.any(-1))
    pos = torch.stack(pos, dim=-1)               # [L, F, E]
    valid = torch.stack(valid, dim=-1)
    sidx = (_ar(F, flag) * 6)[None, :, None] + pos
    return sidx.reshape(L, F * E), valid.reshape(L, F * E)


def _fill_from_points(vals, pos, valid, init):
    """State fill from per-frame change points.

    vals [L, F, E, R, K] point values; pos [L, F, E] block position (0..5)
    of each point within its frame; valid [L, F, E, R] per-row point
    validity; init [L, R, K] chunk-entry state.  Returns (out [L, 6F, R,
    K], carry [L, R, K]): block b of frame f sees the latest valid point
    at (f' < f) or (f' == f, pos <= b); before any point, init."""
    L, F, E, R, K = vals.shape
    # frame-final state per row (last valid point of the frame)
    fv = torch.zeros((L, F, R, K), dtype=vals.dtype, device=vals.device)
    fh = torch.zeros((L, F, R), dtype=torch.bool, device=vals.device)
    for e in range(E):
        fv = torch.where(valid[:, :, e, :, None], vals[:, :, e], fv)
        fh = fh | valid[:, :, e]
    # forward-fill across frames, seeded with init before frame 0
    v = torch.cat([init[:, None], fv], dim=1)             # [L, F+1, R, K]
    h = torch.cat([torch.ones((L, 1, R), dtype=torch.bool,
                              device=vals.device), fh], dim=1)
    src = torch.cummax(torch.where(h, _ar(F + 1, h)[None, :, None], 0),
                       dim=1).values
    v = torch.gather(v, 1, src.long()[..., None].expand(L, F + 1, R, K))
    prev = v[:, :-1]                                      # state BEFORE f
    # within-frame: apply points at pos <= b in ascending order
    outs = []
    for b in range(6):
        ob = prev
        for e in range(E):
            sel = valid[:, :, e] & (pos[:, :, e, None] <= b)
            ob = torch.where(sel[..., None], vals[:, :, e], ob)
        outs.append(ob)
    out = torch.stack(outs, dim=2).reshape(L, 6 * F, R, K)
    return out, v[:, -1]


# ---------------------------------------------------------------------------
# stage 1: exponents
# ---------------------------------------------------------------------------

def _exp_slots(meta, plan: RowPlan):
    """[L, S, R, 86] bit offsets + widths of the exponent fields, rows in
    stream order.  Slots without a field have width 0 (read as 0)."""
    sel = [plan.rows[i] for i in plan.s2l]
    exp_off = meta["exp_off"][..., sel]                  # [L, S, R] stream
    ngrps = meta["ngrps"][..., sel]
    g = _ar(EXP_ROW_SLOTS, exp_off)
    # slot offsets: abs at +0 (4 bits), group k at +4 + 7k
    offs = _narrow(exp_off[..., None], torch.where(g == 0, 0, 4 + 7 * (g - 1)))
    live = (exp_off >= 0)[..., None] & ((g == 0) | (g - 1 < ngrps[..., None]))
    widths = torch.where(live, torch.where(g == 0, 4, 7).to(torch.uint8), 0)
    return offs, widths


def _interleave(deltas, fan: int, lead: int):
    """Place deltas[..., j] at bin lead + fan*j of a [..., 256] array."""
    out = torch.zeros(deltas.shape[:-1] + (256,), dtype=deltas.dtype,
                      device=deltas.device)
    n = min(len(range(lead, 256, fan)), deltas.shape[-1])
    out[..., lead:lead + fan * n:fan] = deltas[..., :n]
    return out


def _by_strategy(deltas, expstr, lead):
    """Deltas laid out at the grouping of each row's exponent strategy
    (D15/D25/D45 -> 1/2/4 bins per delta)."""
    v1, v2, v4 = (_interleave(deltas, f, lead) for f in (1, 2, 4))
    es = expstr[..., None]
    return torch.where(es == 1, v1, torch.where(es == 2, v2, v4))


def decode_exponents(codes, meta, plan: RowPlan):
    """codes [L, S, R, 86] (stream-row order) -> exp_new [L, S, R, 256]
    int32 in ACTIVE row order (fbw0..nfch-1[, cpl][, lfe]).  Rows without
    new exponents hold garbage -- resolved by the setter selection."""
    sel = [plan.rows[i] for i in plan.s2l]
    absexp = codes[..., 0]                               # [L, S, R]
    gc = codes[..., 1:]                                  # [L, S, R, 85]
    deltas = torch.stack([gc // 25 - 2, (gc % 25) // 5 - 2, gc % 5 - 2],
                         dim=-1).reshape(gc.shape[:-1] + (255,))
    ngrps = meta["ngrps"][..., sel]
    j = _ar(255, codes)
    deltas = torch.where((j // 3) < ngrps[..., None], deltas, 0)

    expstr = meta["expstr"][..., sel]                    # [L, S, R]
    # fbw/lfe rows: first delta lands at bin 1 (bin 0 = absexp)
    dbins = _by_strategy(deltas, expstr, 1)
    if plan.has_cpl:
        # cpl row (stream row 0): deltas start at bin cplstrt = 37 + 12 *
        # cplbegf, base = absexp << 1; shift the row there with one gather
        row = _by_strategy(deltas[..., 0, :], expstr[..., 0], 0)
        cplbegf = (meta["cplstrt"] - 37) // 12           # [L, S]
        k = _ar(256, row)
        src = k - (37 + 12 * cplbegf)[..., None]
        ok = (src >= 0) & ((cplbegf >= 0) & (cplbegf < 16))[..., None]
        shifted = torch.where(
            ok, torch.gather(row, -1, src.clamp(0, 255).long()), 0)
        dbins[..., 0, :] = shifted
        base = torch.cat([absexp[..., :1] << 1, absexp[..., 1:]], dim=-1)
    else:
        base = absexp
    exps = base[..., None] + torch.cumsum(dbins, dim=-1, dtype=torch.int32)
    return exps[..., list(plan.l2s), :]


def unpack_exponents(frames_u8, meta, carry_exp, plan: RowPlan = None):
    """frames_u8 [L, F, MB] uint8 + meta [L, S=6F, ...] -> resolved
    exponents [L, S, R, 256] int32 (active rows) + new carry rows
    [L, R, 256].

    When plan.exp_pts < 6 the field reads and the decode run only on the
    (at most exp_pts per frame) blocks that carry new exponents; every
    other block takes the last setter's row -- 6x less exponent work on
    steady streams (EXP_REUSE everywhere but block 0)."""
    if plan is None:
        plan = plan_from_meta(meta)
    L, F, MB = frames_u8.shape
    S = 6 * F
    R = plan.R
    rows7 = list(plan.rows)
    E = plan.exp_pts
    compact = E < 6
    if compact:
        has = (meta["exp_off"][..., rows7] >= 0).any(-1)  # [L, S]
        sidx, pvalid = _frame_points(has, E)
        keys = ("exp_off", "ngrps", "expstr", "cplstrt")
        mc = {k: _take_blocks(meta[k], sidx) for k in keys if k in meta}
        # padding points must decode as "no exponent fields"
        mc["exp_off"] = torch.where(pvalid[..., None], mc["exp_off"], -1)
        Sp = F * E
    else:
        mc = meta
        Sp = S

    offs, widths = _exp_slots(mc, plan)
    n = (Sp // F) * R * EXP_ROW_SLOTS
    codes = BG.as_u16(BG.extract_fields(
        frames_u8.reshape(L * F, MB), offs.reshape(L * F, n).contiguous(),
        widths.reshape(L * F, n).contiguous()))
    del offs, widths
    exp_new = decode_exponents(codes.reshape(L, Sp, R, EXP_ROW_SLOTS), mc,
                               plan)                     # [L, Sp, R, 256]
    if not compact:
        return resolve_setters(exp_new, meta["exp_off"][..., rows7] >= 0,
                               carry_exp[:, rows7])
    valid_er = (mc["exp_off"][..., rows7] >= 0).reshape(L, F, E, R)
    pos = (sidx % 6).reshape(L, F, E)
    return _fill_from_points(exp_new.reshape(L, F, E, R, 256), pos,
                             valid_er, carry_exp[:, rows7])


# ---------------------------------------------------------------------------
# stage 2: bit allocation (recompute-always, reference-identical inputs)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _alloc_tables_on(device: torch.device):
    """Small lookup tensors: the five bai-indexed tables and the hearing
    threshold rows HTH[b >> halfrate][fscod] for halfrate/fscod 0..3
    (3 = out of range -> zeros)."""
    tabs = {name: torch.tensor(np.asarray(getattr(T, name)),
                               dtype=torch.int32, device=device)
            for name in ("SDECAYTAB", "FDECAYTAB", "SGAINTAB", "DBKNEETAB",
                         "FLOORTAB", "FGAINTAB")}
    hth = np.zeros((4, 4, 50), np.int32)
    for hr in range(3):
        for fs in range(3):
            hth[hr, fs] = np.asarray(T.HTH)[np.arange(50) >> hr, fs]
    tabs["HTH"] = torch.tensor(hth, device=device)
    return tabs


def allocate_rows(exp, meta, plan: RowPlan = None):
    """exp [L, S, R, 256] (active rows) + meta -> bap [L, S, R, 256] int8.

    Recomputes a52_bit_allocate from the resolved side info; identical
    inputs to liba52's cached calls give identical outputs.  When
    plan.alloc_pts < 6 the band math runs only at change points (blocks
    where any allocation input differs from the previous block, or new
    exponents landed -- parse.c's do_bit_alloc triggers) and every other
    block takes the last point's bap."""
    if plan is None:
        plan = plan_from_meta(meta)
    if plan.alloc_pts >= 6:
        return _allocate_dense(exp, meta, plan)
    L, S = exp.shape[:2]
    ch = (meta["exp_off"][..., list(plan.rows)] >= 0).any(-1)   # [L, S]
    for k in _ALLOC_KEYS:
        if k in meta:
            v = meta[k].reshape(L, S, -1)
            ch[:, 1:] |= (v[:, 1:] != v[:, :-1]).any(-1)
    ch[:, 0] = True
    Ea = plan.alloc_pts
    F = S // 6
    sidx, pvalid = _frame_points(ch, Ea)
    mc = {k: _take_blocks(v, sidx) for k, v in meta.items()}
    bap_c = _allocate_dense(_take_blocks(exp, sidx), mc, plan)
    R = bap_c.shape[2]
    valid = pvalid.reshape(L, F, Ea, 1).expand(L, F, Ea, R)
    pos = (sidx % 6).reshape(L, F, Ea)
    # chunk block 0 is always a point, so the zero init is never observed
    bap, _ = _fill_from_points(bap_c.reshape(L, F, Ea, R, 256), pos, valid,
                               torch.zeros((L, R, 256), dtype=bap_c.dtype,
                                           device=bap_c.device))
    return bap


def _allocate_dense(exp, meta, plan: RowPlan):
    L, S = exp.shape[:2]
    nfch = plan.nfch
    tab = _alloc_tables_on(exp.device)
    endm = meta["endmant"][..., :nfch]                   # [L, S, nfch]
    zerocol = torch.zeros((L, S, 1), dtype=torch.int32, device=exp.device)
    start = [torch.zeros((L, S, nfch), dtype=torch.int32, device=exp.device)]
    end = [endm]
    rbai = [meta["babai"][..., :nfch]]
    if plan.has_cpl:
        has_cpl = meta["chincpl"] != 0
        start.append(meta["cplstrt"][..., None])
        end.append(torch.where(has_cpl, meta["cplend"], 0)[..., None])
        rbai.append(meta["cplbai"][..., None])
    if plan.has_lfe:
        lfeon = meta["lfeon"] != 0
        start.append(zerocol)
        end.append(torch.where(lfeon, 7, torch.zeros_like(endm[..., 0]))
                   [..., None])
        rbai.append(meta["lfebai"][..., None])
    start = torch.cat(start, dim=-1)                     # [L, S, R]
    end = torch.cat(end, dim=-1)
    rbai = torch.cat(rbai, dim=-1)

    bai = meta["bai"]
    hr = meta["halfrate"]
    sdecay = tab["SDECAYTAB"][(bai >> 9) & 3] >> hr
    fdecay = tab["FDECAYTAB"][(bai >> 7) & 3] >> hr
    sgain = tab["SGAINTAB"][(bai >> 5) & 3]
    dbknee = tab["DBKNEETAB"][(bai >> 3) & 3]
    floor = tab["FLOORTAB"][bai & 7]

    snro = ((meta["csnroffst"][..., None] - 15) * 16 + (rbai >> 3)) * 4
    fgain = tab["FGAINTAB"][rbai & 7]

    bins = _ar(256, exp)
    live = (bins >= start[..., None]) & (bins < end[..., None])
    psd = torch.where(live, 3072 - (exp << 7), _BIG_NEG)
    bndpsd = A.band_psd(psd, end)                        # [L, S, R, 50]

    hth = tab["HTH"][hr.clamp(0, 3), meta["fscod"].clamp(0, 3)][..., None, :]

    # full-bandwidth + lfe rows
    is_lfe = torch.zeros(plan.R, dtype=torch.bool, device=exp.device)
    if plan.has_lfe:
        is_lfe[plan.lfe] = True
    excite = A.excitation(bndpsd, fgain, sgain[..., None], fdecay[..., None],
                          sdecay[..., None], is_lfe)
    if plan.has_cpl:
        # coupling row (leak-init variant)
        c = plan.cpl
        excite[..., c, :] = A.excitation(
            bndpsd[..., c, :], fgain[..., c], sgain, fdecay, sdecay, None,
            bndstrt=meta["cplstrtbnd"], cplfleak=meta["cplfleak"],
            cplsleak=meta["cplsleak"])

    deltba = meta.get("deltba")
    if deltba is not None:
        deltba = deltba[..., list(plan.rows), :]
    mask = A.masking_curve(bndpsd, excite, dbknee[..., None, None], hth,
                           deltba=deltba)
    bap = A.bap_from_mask(psd, mask, snro[..., None],
                          floor[..., None, None], start, end)

    # zero-SNR shortcut (parse.c:296-308): all baps zero for the block.
    # endmant is zero for channels >= nfchans, so endmant > 0 is exactly
    # "i < nfchans".
    zero = meta["csnroffst"] == 0
    if plan.has_cpl:
        zero &= ~(has_cpl & ((meta["cplbai"] >> 3) != 0))
    if plan.has_lfe:
        zero &= ~(lfeon & ((meta["lfebai"] >> 3) != 0))
    zero &= ((endm <= 0) | ((meta["babai"][..., :nfch] >> 3) == 0)).all(-1)
    return torch.where(zero[..., None, None], torch.zeros_like(bap), bap)


# ---------------------------------------------------------------------------
# stage 3: coupling coordinates + phase flags
# ---------------------------------------------------------------------------

def _cplco_slots(meta):
    """[L, S, 203] offsets/widths of the coupling-coordinate fields.

    Per channel: mstrcplco (2 bits) then ncplbnd x (cplcoexp 4 +
    cplcomant 4); after all channels, ncplbnd phase-flag bits (acmod 2
    only)."""
    off = meta["cplco_off"]                              # [L, S, 5]
    ncpl = meta["ncplbnd"]                               # [L, S]
    L, S = ncpl.shape
    k = _ar(37, off)
    j = (k - 1) // 2
    is_exp = (k % 2) == 1
    foff = torch.where(k == 0, 0, torch.where(is_exp, 2 + 8 * j, 6 + 8 * j))
    offs = _narrow(off[..., None], foff)                 # [L, S, 5, 37]
    live = (off[..., None] >= 0) & ((k == 0) | (j < ncpl[..., None, None]))
    w = torch.where(live, torch.where(k == 0, 2, 4).to(torch.uint8), 0)

    ph = meta["phs_off"]                                 # [L, S]
    pj = _ar(18, ph)
    ph_offs = _narrow(ph[..., None], pj)
    ph_w = ((ph[..., None] >= 0) & (pj < ncpl[..., None])).to(torch.uint8)
    return (torch.cat([offs.reshape(L, S, 185), ph_offs], -1),
            torch.cat([w.reshape(L, S, 185), ph_w], -1))


def unpack_cplco(frames_u8, meta, carry_cplco):
    """Decode + resolve coupling coordinates (incl. stereo phase flags).

    Returns (cplco [L, S, 5, 18] f32 signed values, new_carry [L, 5, 18]).
    Phase flips compose across blocks: value = fresh[src] * (-1)^(#flips
    since src), with the chunk carry already carrying all past flips."""
    L, F, MB = frames_u8.shape
    S = 6 * F
    offs, widths = _cplco_slots(meta)
    codes = BG.as_u16(BG.extract_fields(
        frames_u8.reshape(L * F, MB),
        offs.reshape(L * F, 6 * CPLCO_SLOTS).contiguous(),
        widths.reshape(L * F, 6 * CPLCO_SLOTS).contiguous()))
    codes = codes.reshape(L, S, CPLCO_SLOTS)

    c = codes[..., :185].reshape(L, S, 5, 37)
    mstr = 3 * c[..., 0]                                 # [L, S, 5]
    cexp = c[..., 1::2]                                  # [L, S, 5, 18]
    cmant = c[..., 2::2]
    mant = torch.where(cexp == 15, cmant << 14, (cmant | 16) << 13)
    fresh = _ldexp(mant.to(torch.float32), -(cexp + mstr[..., None] + 15))

    set_mask = meta["cplco_off"] >= 0                    # [L, S, 5]
    resolved, _ = resolve_setters(fresh, set_mask, carry_cplco)

    # phase flags flip ch1's coordinates cumulatively (parse.c:647-650)
    pj = _ar(18, codes)
    ph = torch.where((meta["phs_off"][..., None] >= 0)
                     & (pj < meta["ncplbnd"][..., None]),
                     codes[..., 185:203], 0)             # [L, S, 18] bits
    P = torch.cumsum(ph, dim=1, dtype=torch.int32)       # inclusive
    s_idx = _ar(S, codes)[None, :]
    idx1 = torch.cummax(torch.where(set_mask[..., 1], s_idx, -1),
                        dim=1).values                    # [L, S]
    # parity counts flips at blocks src..b INCLUSIVE (the setter block's
    # own flags apply right after its coordinates decode); src = -1 (the
    # carry) counts every flip since the chunk start
    Pext = torch.cat([torch.zeros((L, 1, 18), dtype=P.dtype,
                                  device=P.device), P], dim=1)
    Psrc = torch.gather(Pext, 1, idx1.clamp(min=0).long()[..., None].expand(
        L, S, 18))
    flip1 = torch.where(((P - Psrc) & 1) == 1, -1.0, 1.0)
    resolved[..., 1, :] *= flip1
    return resolved, resolved[:, -1]


# ---------------------------------------------------------------------------
# stage 4: mantissa lattice -> dequantized frequency planes
# ---------------------------------------------------------------------------

# quantizer levels (liba52 tables.h Q(x) values)
_LVL3 = (-21845.0, 0.0, 21845.0)
_LVL5 = (-26214.0, -13107.0, 0.0, 13107.0, 26214.0)
_LVL11 = (-29789.0, -23831.0, -17873.0, -11916.0, -5958.0, 0.0,
          5958.0, 11916.0, 17873.0, 23831.0, 29789.0)


@lru_cache(maxsize=8)
def _levels_on(device: torch.device):
    """Level tables indexed by code: grouped classes 1, 2, 4 and plain 3, 5
    (the last two carry liba52's 0.0 tails)."""
    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)
    return (f32(_LVL3), f32(_LVL5), f32(T.Q_3), f32(_LVL11), f32(T.Q_5))


@lru_cache(maxsize=1)
def _dither_orbit_np() -> np.ndarray:
    """LFSR orbit (period 65535) as u16 states: draw k starting from state
    1 returns orbit[k mod 65535] (dither_gen semantics, parse.c:310-319)."""
    lut = np.asarray(T.dither_lut(), np.uint32)
    vals = np.empty(65535, np.uint16)
    s = 1
    for k in range(65535):
        s = int(lut[s >> 8] ^ ((s << 8) & 0xFFFF))
        vals[k] = s
    return vals


@lru_cache(maxsize=8)
def _dither_orbit_on(device: torch.device):
    """(orbit as int16 [65535], its big-endian bytes uint8 [131070])."""
    orb = _dither_orbit_np()
    return (torch.from_numpy(orb.view(np.int16).copy()).to(device),
            torch.from_numpy(np.frombuffer(orb.astype(">u2").tobytes(),
                                           np.uint8).copy()).to(device))


def _first_cpl(chincpl, nfch):
    """Index of the lowest set bit (first coupled channel)."""
    fc = torch.zeros_like(chincpl)
    for i in range(nfch - 1, -1, -1):
        fc = torch.where(((chincpl >> i) & 1) != 0, i, fc)
    return fc


def _lattice(fbw, cpl, lfe, plan: RowPlan):
    """fbw [..., nfch, 256] (+ cpl + lfe [..., 128] when live) -> [..., seg]
    slot layout in coded order.

    Interleaved layout (cpl_fc < 0): a 256-slot coupling copy follows
    every channel; cpl may be [..., 256] (broadcast to every copy) or
    [..., nfch, 256] (per channel).  Compact layout (cpl_fc >= 0): ONE
    coupling segment after channel cpl_fc; cpl must be [..., 256]."""
    lead = fbw.shape[:-2]
    nfch = plan.nfch
    if plan.compact:
        k = plan.cpl_fc + 1
        main = torch.cat([fbw[..., :k, :].reshape(lead + (k * 256,)), cpl,
                          fbw[..., k:, :].reshape(lead + ((nfch - k) * 256,))],
                         dim=-1)
    elif plan.has_cpl:
        cplb = cpl if cpl.dim() == fbw.dim() else \
            cpl[..., None, :].expand(fbw.shape)
        main = torch.stack([fbw, cplb], dim=-2).reshape(lead + (nfch * 512,))
    else:
        main = fbw.reshape(lead + (nfch * 256,))
    if plan.has_lfe:
        main = torch.cat([main, lfe], dim=-1)
    return main


def _split_lattice(x, plan: RowPlan, fc=None):
    """Inverse of _lattice for per-slot values: (fbw [..., nfch, 256],
    cpl [..., 256] | None, lfe [..., 128] | None).  In the interleaved
    layout the coupling values live at the copy after the DYNAMIC first
    coupled channel fc [L, S]."""
    nfch = plan.nfch
    L, S = x.shape[:2]
    lfe = x[..., plan.seg - 128:] if plan.has_lfe else None
    if not plan.has_cpl:
        return x[..., :nfch * 256].reshape(L, S, nfch, 256), None, lfe
    if plan.compact:
        cs = plan.cpl_seg
        k = plan.cpl_fc + 1
        fbw = torch.cat([x[..., :cs].reshape(L, S, k, 256),
                         x[..., cs + 256: cs + 256 + (nfch - k) * 256]
                         .reshape(L, S, nfch - k, 256)], dim=-2)
        return fbw, x[..., cs:cs + 256], lfe
    view = x[..., :nfch * 512].reshape(L, S, nfch, 2, 256)
    cpl = torch.gather(view[..., 1, :], 2,
                       fc.long()[..., None, None].expand(L, S, 1, 256))
    return view[..., 0, :], cpl[:, :, 0], lfe


def _cpl_band_index(meta):
    """[L, S, 256] coupling band index per bin (cplbndstrc merge rules)."""
    bins = _ar(256, meta["cplstrt"])
    sub = torch.clamp((bins - meta["cplstrt"][..., None]) // 12, min=0)
    strc = meta["cplbndstrc"][..., None]
    merged = torch.zeros_like(sub)
    for i in range(17):
        merged += ((strc >> i) & 1) * (i < sub).to(torch.int32)
    return sub - merged


def _lookup(table, idx):
    """table[idx] for idx in range; any value where idx is out of range
    (those slots are never selected)."""
    return table[idx.clamp(0, table.shape[0] - 1)]


def unpack_mantissas(frames_u8, exp, bap, cplco, meta, carry_dpos,
                     plan: RowPlan = None):
    """The coded-order lattice: widths -> offsets -> codes -> (q, a, b).

    exp/bap [L, S, R, 256] in active-row order; cplco [L, S, 5, 18] (None
    when the plan has no coupling).  Returns (freq [L, S, 6, 256] f32,
    new_dpos [L]).  freq rows are the fixed 5 fbw planes + LFE; rows
    beyond the plan are zero.  freq is bit-identical to the host
    pre-pass's (q*a)*b (parse.c:321-556)."""
    if plan is None:
        plan = plan_from_meta(meta)
    L, F, MB = frames_u8.shape
    S = 6 * F
    nfch = plan.nfch
    seg = plan.seg
    dev = exp.device
    bins = _ar(256, exp)
    bap = bap.to(torch.int8)      # so the slot widths below are int8 too

    endm = meta["endmant"][..., :nfch]                   # [L, S, nfch]
    fbw_act = bins < endm[..., None]                     # [L, S, nfch, 256]
    chN = _ar(nfch, exp)
    fc = cpl_act = cpl_base = bap_cpl = exp_cpl = None
    if plan.has_cpl:
        fc = _first_cpl(meta["chincpl"], nfch)
        cpl_base = (meta["chincpl"] != 0)[..., None] \
            & (bins >= meta["cplstrt"][..., None]) \
            & (bins < meta["cplend"][..., None])         # [L, S, 256]
        # only the first coupled channel's walk consumes coupling
        # mantissas: one static segment (compact), or per-channel copies
        # masked by chN == fc (interleaved)
        cpl_act = cpl_base if plan.compact else \
            cpl_base[..., None, :] & (chN[:, None] == fc[..., None, None])
        bap_cpl = bap[..., plan.cpl, :]
        exp_cpl = exp[..., plan.cpl, :]
    lfe_act = bap_lfe = exp_lfe = None
    if plan.has_lfe:
        lfe_act = (meta["lfeon"][..., None] != 0) & (_ar(128, exp) < 7)
        bap_lfe = bap[..., plan.lfe, :128]
        exp_lfe = exp[..., plan.lfe, :128]

    b = torch.where(_lattice(fbw_act, cpl_act, lfe_act, plan),
                    _lattice(bap[..., :nfch, :], bap_cpl, bap_lfe, plan), 0)

    # --- dither draw lattice -------------------------------------------
    zlfe = (torch.zeros((L, S, 128), dtype=torch.int32, device=dev)
            if plan.has_lfe else None)
    draws = None
    if plan.has_dith:
        dith = meta["dith"][..., :nfch]                  # [L, S, nfch]
        dith_fbw = (dith != 0)[..., None] & fbw_act & \
            (bap[..., :nfch, :] == 0)                    # [L, S, nfch, 256]
        draws_cpl = None
        if plan.has_cpl:
            coupled_ch = ((meta["chincpl"][..., None] >> chN) & 1) != 0
            cpl_dmask = torch.where((dith != 0) & coupled_ch, 1 << chN,
                                    0).sum(-1, dtype=torch.int32)   # [L, S]
            ndith = torch.zeros_like(cpl_dmask)
            for i in range(nfch):
                ndith += (cpl_dmask >> i) & 1
            if plan.compact:
                draws_cpl = torch.where(cpl_act & (bap_cpl == 0),
                                        ndith[..., None], 0)
            else:
                draws_cpl = torch.where(
                    cpl_act & (bap_cpl[..., None, :] == 0),
                    ndith[..., None, None], 0)
        draws = _lattice(dith_fbw.to(torch.int32), draws_cpl, zlfe, plan)
        del draws_cpl

    # --- slot counters (exclusive prefix sums along the block's slots) --
    # a grouped read (classes 1, 2, 4) costs 5/7/7 bits per 3/3/2 members,
    # so the bits consumed before a slot follow arithmetically from the
    # per-class counts (parse.c:354-432's running cursor in closed form)
    is1, is2, is4 = b == 1, b == 2, b == 4
    w6 = torch.where(b == 15, 16, torch.where(b == 14, 14, b - 1))
    w_simple = torch.where(b == 3, 3, torch.where(b == 5, 4, torch.where(
        b >= 6, w6, 0)))
    cnt1 = _excl_cumsum(is1.to(torch.int32))
    cnt2 = _excl_cumsum(is2.to(torch.int32))
    cnt4 = _excl_cumsum(is4.to(torch.int32))
    reads1 = is1 & (cnt1 % 3 == 0)
    reads2 = is2 & (cnt2 % 3 == 0)
    reads4 = is4 & (cnt4 % 2 == 0)
    w = torch.where(reads1, 5, torch.where(reads2 | reads4, 7, w_simple))
    offsets = _narrow(meta["man_off"][..., None] + _excl_cumsum(w_simple)
                      + 5 * ((cnt1 + 2) // 3) + 7 * ((cnt2 + 2) // 3),
                      7 * ((cnt4 + 1) // 2))
    w = w.view(torch.uint8)                              # 0..16
    del w_simple

    if not plan.has_cpl and (plan.emax < 256 or plan.has_lfe):
        # gather only the live prefix of each channel ([0:emax)) and 64
        # LFE slots (7 are ever live); dead slots read as 0 anyway
        em = plan.emax
        parts = [(c * 256, em) for c in range(nfch)]
        if plan.has_lfe:
            parts.append((nfch * 256, 64))
        segc = sum(n for _, n in parts)

        def compact_slots(x):
            return torch.cat([x[..., o:o + n] for o, n in parts],
                             dim=-1).reshape(L * F, 6 * segc)

        codes_c = BG.as_u16(BG.extract_fields(
            frames_u8.reshape(L * F, MB), compact_slots(offsets),
            compact_slots(w))).reshape(L, S, segc)
        codes = torch.zeros((L, S, seg), dtype=torch.int32, device=dev)
        pos = 0
        for o, n in parts:
            codes[..., o:o + n] = codes_c[..., pos:pos + n]
            pos += n
        del codes_c
    else:
        codes = BG.as_u16(BG.extract_fields(
            frames_u8.reshape(L * F, MB),
            offsets.reshape(L * F, 6 * seg).contiguous(),
            w.reshape(L * F, 6 * seg).contiguous())).reshape(L, S, seg)
    del offsets, w

    # grouped-class leader propagation (quantizer_set_t carries,
    # parse.c:43-50): forward-fill each group leader's code along the
    # lattice, then take the member's digit of it
    slot_no = _ar(seg, exp)

    def leader(reads):
        return torch.cummax(torch.where(reads, (slot_no << 7) | codes, -1),
                            dim=-1).values & 127

    lv3, lv5, lv7, lv11, lv15 = _levels_on(dev)
    c1 = leader(reads1)
    m1 = cnt1 % 3
    d1 = torch.where(m1 == 0, c1 // 9, torch.where(m1 == 1, (c1 % 9) // 3,
                                                   c1 % 3))
    q1 = torch.where(is1 & (c1 < 27), _lookup(lv3, d1), 0.0)
    del c1, m1, d1, cnt1, reads1
    c2 = leader(reads2)
    m2 = cnt2 % 3
    d2 = torch.where(m2 == 0, c2 // 25, torch.where(m2 == 1, (c2 % 25) // 5,
                                                    c2 % 5))
    q2 = torch.where(is2 & (c2 < 125), _lookup(lv5, d2), 0.0)
    del c2, m2, d2, cnt2, reads2
    c4 = leader(reads4)
    d4 = torch.where(cnt4 % 2 == 0, c4 // 11, c4 % 11)
    q4 = torch.where(is4 & (c4 < 121), _lookup(lv11, d4), 0.0)
    del c4, d4, cnt4, reads4

    w6 = torch.clamp(w6, min=1)
    sv = codes - ((codes >> (w6 - 1)) << w6)             # sign-extend
    v6 = (sv << (16 - w6)).to(torch.float32)
    del sv, w6
    # out-of-range grouped codes (q1 >= 27, q2 >= 125, q4 >= 121) decode
    # to 0 for every member: the reference tables' literal 0 tails
    qv = torch.where(is1, q1, torch.where(is2, q2, torch.where(
        b == 3, _lookup(lv7, codes), torch.where(is4, q4, torch.where(
            b == 5, _lookup(lv15, codes), torch.where(b >= 6, v6, 0.0))))))
    del q1, q2, q4, v6, is1, is2, is4, codes, b

    # --- dither draws: LFSR states at absolute draw ordinals ------------
    if plan.has_dith:
        ordx = _excl_cumsum(draws)                       # [L, S, seg]
        tot = draws.sum(-1, dtype=torch.int32)           # [L, S]
        del draws
        base = carry_dpos[:, None] + _excl_cumsum(tot, dim=1)
        abs_ord = base[..., None] + ordx
        new_dpos = base[:, -1] + tot[:, -1]
        del ordx
        orbit, orbit_bytes = _dither_orbit_on(dev)
        if plan.has_cpl:
            # gather lattice: fbw bins, then cpl bin-major x rank; unused
            # ranks (>= ndith) repeat the last live draw
            ord_fbw, ord_cpl, _ = _split_lattice(abs_ord, plan, fc)
            rmax = torch.clamp(ndith - 1, min=0)[..., None, None]
            d_off = torch.cat(
                [ord_fbw.reshape(L, S, nfch * 256),
                 (ord_cpl[..., None] + torch.minimum(chN, rmax)).reshape(
                     L, S, nfch * 256)], dim=-1) % 65535
            # the orbit's big-endian byte pairs through the bitfield
            # gather (the TPU path's per-tile shared-table kernel), one
            # 16-bit field per ordinal
            states = BG.extract_fields_shared(
                orbit_bytes, d_off.reshape(L * F, -1).contiguous(), unit=16)
        else:
            d_off = abs_ord[..., :nfch * 256] % 65535
            states = BG.extract_i16_table(
                orbit, d_off.reshape(L * F, -1).contiguous())
        del abs_ord, d_off
        # the int16 wire value IS the signed LFSR state
        dval = ((3 * states.to(torch.int32)) >> 2).to(torch.float32)
        dval = dval.reshape(L, S, -1)
        dv_fbw = dval[..., :nfch * 256].reshape(L, S, nfch, 256)
        dv_cpl = (dval[..., nfch * 256:].reshape(L, S, 256, nfch)
                  if plan.has_cpl else None)
    else:
        dith_fbw = torch.zeros((L, S, nfch, 256), dtype=torch.bool,
                               device=dev)
        dv_fbw = torch.zeros((L, S, nfch, 256), dtype=torch.float32,
                             device=dev)
        new_dpos = carry_dpos

    # --- assembly: (q, a, b) per channel/bin ----------------------------
    q_fbw, q_cpl, q_lfe = _split_lattice(qv, plan, fc)
    coeff = meta["coeff"][..., :nfch]                    # [L, S, nfch] f32
    b_fbw = bap[..., :nfch, :]
    a_fbw = _ldexp(coeff[..., None], -(exp[..., :nfch, :] + 15))
    val_fbw = torch.where(b_fbw == 0, torch.where(dith_fbw, dv_fbw, 0.0),
                          q_fbw)
    freq_fbw = torch.where(fbw_act & ((b_fbw != 0) | dith_fbw),
                           val_fbw * a_fbw, 0.0)
    del a_fbw, val_fbw, dv_fbw

    if plan.has_cpl:
        # coupling: the shared mantissa scattered into each coupled channel
        bnd = _cpl_band_index(meta)                      # [L, S, 256]
        cprod = cplco[..., :nfch, :] * coeff[..., None]  # MUL_L per ch
        cpl_bin = torch.where(
            (bnd < 18)[..., None, :],
            torch.gather(cprod, -1, bnd.clamp(max=17).long()[..., None, :]
                         .expand(L, S, nfch, 256)), 0.0)
        coupled = ((meta["chincpl"][..., None] >> chN) & 1) != 0
        e_cpl = -(exp_cpl + 15)
        if plan.has_dith:
            dith_c = coupled & (meta["dith"][..., :nfch] != 0)
            rank = torch.zeros_like(coupled, dtype=torch.int32)
            for i in range(nfch):
                rank += torch.where(chN > i, (cpl_dmask[..., None] >> i) & 1,
                                    0)
            # channel c takes the rank-th draw of each coupled bin
            dv_ch = torch.gather(dv_cpl, -1, rank.long()[..., None, :]
                                 .expand(L, S, 256, nfch)).transpose(-1, -2)
            dd = dv_ch * _ldexp(cpl_bin, e_cpl[..., None, :])
        else:
            dith_c = torch.zeros_like(coupled)
            dd = torch.zeros_like(cpl_bin)
        nd = (q_cpl * _pow2(e_cpl))[..., None, :] * cpl_bin   # (v*sf)*cplco
        contrib = torch.where((bap_cpl != 0)[..., None, :], nd,
                              torch.where(dith_c[..., None], dd, 0.0))
        in_cpl = cpl_base[..., None, :] & coupled[..., None]
        freq_fbw = torch.where(in_cpl, contrib, freq_fbw)

    freq = torch.zeros((L, S, 6, 256), dtype=torch.float32, device=dev)
    freq[:, :, :nfch] = freq_fbw
    if plan.has_lfe:
        a_lfe = _ldexp(meta["lfe_scale"][..., None], -(exp_lfe + 15))
        freq[:, :, 5, :128] = torch.where(
            lfe_act & (bap_lfe != 0) & (meta["lfe_out"][..., None] != 0),
            q_lfe * a_lfe, 0.0)
    return freq, new_dpos


def remat_mask(meta):
    """[L, S, 256] stereo rematrix band mask (parse.c:837-865)."""
    k = _ar(256, meta["rematflg"])
    region = torch.where(k < 25, 0, torch.where(k < 37, 1,
                                                torch.where(k < 61, 2,
                                                            torch.full_like(k, 3))))
    flag_k = ((meta["rematflg"][..., None] >> region) & 1) != 0
    end = torch.minimum(meta["endmant"][..., 0], meta["endmant"][..., 1])
    return flag_k & (k >= 13) & (k < end[..., None])


def unpack_blocks(frames_u8, meta, carry, bias, nfch: int = 5,
                  cpl_fc: int = -1, exp_pts: int = 6, alloc_pts: int = 6,
                  emax: int = 256):
    """Full raw-H2D device unpack: frame bytes + meta -> pipeline blocks.

    frames_u8 [L, F, MB] uint8 tensor; meta: side-info arrays [L, S, ...]
    as tensors on the same device, in their wire dtypes (prune_raw_meta
    may have dropped absent-feature keys -- the plan specializes on what
    remains); carry: init_unpack_carry dict; bias: scalar or [L, S] f32;
    nfch: full-bandwidth channel count of the (format-homogeneous) batch;
    cpl_fc: static first-coupled channel (static_cpl_fc -- the CALLER has
    verified every coupled block has it); exp_pts/alloc_pts/emax: see
    RowPlan.  Returns (new_carry, blocks) in the batched decode pipeline's
    layout: freq [L, S, 6, 256], blksw, coeff, remat, bias."""
    L, F, MB = frames_u8.shape
    S = 6 * F
    with span("unpack.exponents"):
        meta = widen_meta(meta)
        plan = plan_from_meta(meta, nfch, cpl_fc, exp_pts, alloc_pts, emax)
        exp, exp_rows = unpack_exponents(frames_u8, meta, carry["exp"], plan)
        # dead rows keep their carry state (liba52 leaves a52_state_t
        # untouched for absent features)
        carry_exp = carry["exp"].clone()
        carry_exp[:, list(plan.rows)] = exp_rows
    with span("unpack.alloc"):
        bap = allocate_rows(exp, meta, plan)
        if plan.has_cpl:
            cplco, carry_cplco = unpack_cplco(frames_u8, meta,
                                              carry["cplco"])
        else:
            cplco, carry_cplco = None, carry["cplco"]
    with span("unpack.mantissas"):
        freq, new_dpos = unpack_mantissas(frames_u8, exp, bap, cplco, meta,
                                          carry["dpos"], plan)
        blocks = {
            "freq": freq,
            "blksw": meta["blksw"] != 0,
            "coeff": meta["coeff"],
            "remat": remat_mask(meta),
            "bias": torch.as_tensor(bias, dtype=torch.float32,
                                    device=freq.device).expand(L, S),
        }
    new_carry = {"exp": carry_exp, "cplco": carry_cplco, "dpos": new_dpos}
    return new_carry, blocks
