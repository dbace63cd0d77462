"""Port: the device frame packer's kernel route (ops.pack_device, kernel P1)
on the CPU, byte for byte against the JAX package.

  * Inputs are chip_smoke.py's crafted fields (p1_case: the cases it holds
    P1 to on the card): 1 to 6 channels, the LFE, 32, 44.1, 48 and 24 kHz,
    frames of 256 to 3,840 bytes; every class and strategy, grouped classes
    only (groups across channel boundaries, incomplete last groups), D15,
    D25 and D45 throughout, reused exponents, a frame filled to its last
    payload bit and frames that overrun; dead bins hold any byte.
  * The port's plain version (pack_frames_ref, what pack_frames_device runs
    on CPU tensors) must equal JAX's pack_frames_device (its CPU route) and
    JAX's serial host/pack.py:pack_frame on every frame that fits, and the
    port's native packer on every frame (overrun ones too: both keep the
    first total - 2 bytes of the stream).
  * kernel_model replays csrc/pack.cu's algorithm in Python from the
    kernel's own table (ops.pack_device.kernel_table: the slot schedule,
    group counts, exponent spans, the 32 lanes' CRC multipliers), in its
    lane order (three slots a lane, 16-bin chunks, warp scans, whole-word
    stores and or-ed boundary words): it must give the plain version's
    bytes, so the table and the kernel's offset arithmetic are checked
    here, where the kernel cannot run.  Crafted kinds "dense" (every live
    bin of a block coded) and "edge" (the chunk that straddles a channel's
    last live bin) are for that design.  The frames' walk over warps and
    CTAs is modelled for 1 frame and a CTA's warps - 1 and + 1 (8 up to
    two channels, 16 above, 15 for 3,840-byte 5.1 frames, as the source's
    cta_warps gives them), and the model's frames and the CPU route's
    equal JAX's device packer there.
  * The codes come as int32 or as Q1's 16-bit form (their low 16 bits as
    int16, which the device-pack path hands over): given the crafted
    fields' codes as int16 (half of them negative there), the plain
    version, the CPU route and the kernel's model (which reads a 16-bit
    code as unsigned, as the kernel does) give the int32 codes' bytes.
  * The wrapper refuses what the kernel does not take, the native packer
    refuses int16 codes (it would widen them with their sign), and a CPU
    tensor never reaches the CUDA build.
"""
import os
import re
from functools import lru_cache

import numpy as np
import pytest
import torch

import chip_smoke as CS
from ac3acm_tpu.host import pack as JP
from ac3acm_tpu.models import encoder as JE
from ac3acm_tpu.ops import pack_device as JPD
from ac3acm_tpu_torch.host import pack as PK
from ac3acm_tpu_torch.ops import _cuda
from ac3acm_tpu_torch.ops import pack_device as PD

ROWS = CS.P1_ROWS_A_KIND
FIT = (len(CS.P1_KINDS) - 1) * ROWS      # every kind but "overrun" fits
assert CS.P1_KINDS[-1] == "overrun"
# the configs whose fields go through JAX's jitted device packer (one
# compile each): every channel count and sample rate
JAX_DEVICE_CONFIGS = ((1, 32000, 96), (2, 44100, 128), (3, 44100, 256),
                      (4, 48000, 384), (5, 32000, 448), (6, 48000, 640))


@lru_cache(maxsize=None)
def _case(config):
    """p1_case's fields of config (shared by the tests; never written)."""
    i = CS.P1_CONFIGS.index(config)
    return CS.p1_case(config, 1500 + i)


def _ref(cfg, f):
    return PD.pack_frames_ref(cfg, *(torch.from_numpy(f[k])
                                     for k in CS.P1_KEYS)).numpy()


@lru_cache(maxsize=None)
def _jax_device(config):
    """JAX's pack_frames_device on config's crafted frames that fit (one
    compile a config, shared by the tests; never written)."""
    _, f = _case(config)
    jcfg = JE.make_config(config[1], config[2] * 1000, config[0])
    return np.asarray(JPD.pack_frames_device(jcfg)(
        *(f[k][:FIT] for k in CS.P1_KEYS)))


@pytest.mark.parametrize("config", JAX_DEVICE_CONFIGS)
def test_crafted_fields_match_jax_device_packer(config):
    """pack_frames_device on CPU tensors == JAX's pack_frames_device on
    every crafted frame that fits."""
    cfg, f = _case(config)
    got = PD.pack_frames_device(cfg, *(torch.from_numpy(f[k])
                                       for k in CS.P1_KEYS)).numpy()
    assert np.array_equal(got[:FIT], _jax_device(config))


@pytest.mark.parametrize("config", CS.P1_CONFIGS)
def test_crafted_fields_match_serial_packers(config):
    """The plain version == JAX's host/pack.py:pack_frame on every frame
    that fits, and == the port's native packer on every frame."""
    cfg, f = _case(config)
    got = _ref(cfg, f)
    assert [r.tobytes() for r in got] == PK.pack_frames_native(cfg, f)
    jcfg = JE.make_config(config[1], config[2] * 1000, config[0])
    assert [got[r].tobytes() for r in range(FIT)] == [
        JP.pack_frame(jcfg, f, r) for r in range(FIT)]
    # the overrun frames really overrun, and the filled ones end on the
    # last payload bit
    bits = CS.p1_bits(cfg, f)
    cap = 8 * (cfg.frame_size * 2 - 2)
    assert (bits[FIT:] > cap).all()
    fill = CS.P1_KINDS.index("fill") * ROWS
    assert (bits[fill:fill + ROWS] == cap).all()


def _lane_len(cls):
    """P1's byte-SIMD token length of a class byte (int8): class - 1 from
    5 up (a negative byte has none), 3 -> 3, 14 -> 14, 15 -> 16, else 0."""
    return (cls - 1 if cls >= 5 else 3 if cls == 3 else 0) + (
        1 if cls == 14 else 2 if cls == 15 else 0)


def kernel_model(cfg, f, r):
    """csrc/pack.cu's algorithm on frame r, in Python, reading only the
    kernel's table, in its lane order: per block, lane l takes slot
    j0 + l, 32 at a time, its token or-ed in; then in step t the chunk of
    16 bins 16 (l % 16) of channel 2 t + l / 16 (dead bins masked); each
    step's packed counts go through a warp scan; each lane deposits its
    own bits [S, E) as whole words, or-ing only the words it shares (a
    word stored whole must still be 0: no other lane's bits are in it),
    keeps its offset as a running sum and files members and heads' offsets
    by ordinal (bin by bin: the kernel takes bin r of every lane at once
    where a lane codes more than 4 of its 16, else each lane its coded
    bins; the bits are the same); the heads and exponent groups are or-ed
    in after; the CRCs are the 32 lanes' chunk CRCs times their
    multipliers, XORed.  An int16 code is read as unsigned (its 16
    bits), an int32 one as its 32."""
    code_mask = 0xFFFF if f["qmant"].dtype == np.int16 else 0xFFFFFFFF
    tab = [int(x) for x in PD.kernel_table(cfg)]
    nch, total = cfg.channels, cfg.frame_size * 2
    fs58 = (cfg.frame_size >> 1) + (cfg.frame_size >> 3)
    nb = tab[PD._TAB_NB:PD._TAB_NB + nch]
    gmax = tab[PD._TAB_GMAX]
    limit = 8 * (total - 2)
    words = [0] * (total // 4 + 2)
    lanes = PD.LANES

    def deposit(off, ln, v):
        if ln <= 0 or off >= limit or v == 0:
            return
        w, sh = off >> 5, 32 - (off & 31) - ln
        if sh >= 0:
            words[w] |= v << sh
        else:
            words[w] |= v >> -sh
            words[w + 1] |= (v << (32 + sh)) & 0xFFFFFFFF

    class Run:
        """A lane's bits [S, E): words inside stored whole, the rest or-ed."""

        def __init__(self, s, e):
            self.s, self.e, self.wi, self.acc = s, e, -1, 0

        def flush(self):
            if self.acc:
                if self.wi * 32 >= self.s and self.wi * 32 + 32 <= self.e:
                    assert words[self.wi] == 0, "a whole word was shared"
                    words[self.wi] = self.acc
                else:
                    words[self.wi] |= self.acc
            self.acc = 0

        def put(self, off, ln, v):
            if not v:
                return
            w, sh = off >> 5, 32 - (off & 31) - ln
            if w != self.wi:
                self.flush()
                self.wi = w
            if sh >= 0:
                self.acc |= v << sh
            else:
                self.acc |= v >> -sh
                self.flush()
                self.wi = w + 1
                self.acc = (v << (32 + sh)) & 0xFFFFFFFF

    def offset(p):
        u, n1, n2, n4 = p
        return u + 5 * -(-n1 // 3) + 7 * -(-n2 // 3) + 7 * -(-n4 // 2)

    def add(p, q):
        return tuple(a + b for a, b in zip(p, q))

    def scan(vals):
        """A warp's exclusive and inclusive scans and its total."""
        ex, acc = [], (0, 0, 0, 0)
        for v in vals:
            ex.append(acc)
            acc = add(acc, v)
        return ex, [add(e, v) for e, v in zip(ex, vals)], acc

    nit = (nch + 1) // 2
    pos = 0
    for b in range(6):
        st = [int(s) for s in f["strat"][r, b]]
        ns = tab[PD._TAB_NSLOTS + b]
        base = PD._TAB_SLOTS + b * PD.MAX_SLOTS
        slots = tab[base:base + ns]
        assert ns <= PD.MAX_SLOTS

        def slot_len(slot):
            kind, ch = (slot >> 24) & 15, (slot >> 21) & 7
            ln, s = (slot >> 16) & 31, st[ch]
            sel = 1 if s == 1 else 2 if s == 2 else 3
            if kind in (PD.K_COND, PD.K_EXP0):
                return 0 if s == 0 else ln
            if kind == PD.K_GROUPS:
                return 0 if s == 0 else 7 * tab[PD._TAB_NG + 4 * ch + sel]
            return ln

        # slot j0 + l on lane l, 32 at a time: a warp scan of the lengths
        # a round; a slot's token (at most 16 bits) is or-ed in
        grpoff = {}
        tot = (0, 0, 0, 0)
        for j0 in range(0, ns, lanes):
            lens = [(slot_len(x), 0, 0, 0) for x in slots[j0:j0 + lanes]]
            ex, _, step = scan(lens)
            for slot, e in zip(slots[j0:j0 + lanes], ex):
                off, ln = pos + offset(add(tot, e)), slot_len(slot)
                kind, ch = (slot >> 24) & 15, (slot >> 21) & 7
                v = {PD.K_STRAT: st[ch],
                     PD.K_EXP0: int(f["enc_exp"][r, b, ch, 0]),
                     PD.K_CSNR: int(f["csnroffst"][r]) & 63,
                     PD.K_FSNR: int(f["fsnroffst"][r]) & 15}.get(
                         kind, slot & 0xFFFF)
                if kind == PD.K_GROUPS:
                    if ln:
                        grpoff[ch] = off
                else:
                    deposit(off, ln, v & ((1 << ln) - 1))
            tot = add(tot, step)
        # the chunks: step t, lane l -> channel 2 t + l // 16, 16 bins
        chunks = {}
        for t in range(nit):
            for l in range(lanes):
                c, k = 2 * t + l // 16, (l % 16) * 16
                cls = [int(f["bap"][r, b, c, k + i])
                       if c < nch and k + i < nb[c] else 0 for i in range(16)]
                chunks[t, l] = (c, k, cls)
        carry = tot
        pex, pin = {}, {}
        for t in range(nit):
            counts = []
            for l in range(lanes):
                cls = chunks[t, l][2]
                counts.append((sum(_lane_len(x) for x in cls),
                               cls.count(1), cls.count(2), cls.count(4)))
            ex, inc, step = scan(counts)
            for l in range(lanes):
                pex[t, l], pin[t, l] = add(carry, ex[l]), add(carry, inc[l])
            carry = add(carry, step)
        _, n1, n2, n4 = carry
        h1, h2, h4 = -(-n1 // 3), -(-n2 // 3), -(-n4 // 2)
        memb = [None] * (n1 + n2 + n4)
        head = [None] * (h1 + h2 + h4)
        for t in range(nit):
            for l in range(lanes):
                c, k, cls = chunks[t, l]
                p = pex[t, l]
                off = pos + offset(p)
                run = Run(off, pos + offset(pin[t, l]))
                o = {1: p[1], 2: p[2], 4: p[3]}
                for i, x in enumerate(cls):
                    if x <= 0:
                        continue
                    q = int(f["qmant"][r, b, c, k + i]) & code_mask
                    at = off if off < limit else None
                    if x in o:
                        g, bits = (3, 5) if x == 1 else (3, 7) if x == 2 \
                            else (2, 7)
                        mbase = {1: 0, 2: n1, 4: n1 + n2}[x]
                        hbase = {1: 0, 2: h1, 4: h1 + h2}[x]
                        memb[mbase + o[x]] = q & 15
                        if o[x] % g == 0:
                            head[hbase + o[x] // g] = at
                            off += bits
                        o[x] += 1
                    else:
                        ln = _lane_len(x)
                        if off < limit:
                            run.put(off, ln, q & ((1 << ln) - 1))
                        off += ln
                run.flush()
        # after a __syncwarp: the heads, then the exponent groups
        for h, at in enumerate(head):
            if h < h1:
                m, o, n = memb[:n1], 3 * h, n1
                v = 9 * m[o] + 3 * (m[o + 1] if o + 1 < n else 0) \
                    + (m[o + 2] if o + 2 < n else 0)
                bits = 5
            elif h < h1 + h2:
                m, o, n = memb[n1:n1 + n2], 3 * (h - h1), n2
                v = 25 * m[o] + 5 * (m[o + 1] if o + 1 < n else 0) \
                    + (m[o + 2] if o + 2 < n else 0)
                bits = 7
            else:
                m, o, n = memb[n1 + n2:], 2 * (h - h1 - h2), n4
                v = 11 * m[o] + (m[o + 1] if o + 1 < n else 0)
                bits = 7
            if at is not None:
                deposit(at, bits, v & ((1 << bits) - 1))
        for ch in range(nch):
            s = st[ch]
            if s == 0:
                continue
            sel = 1 if s == 1 else 2 if s == 2 else 3
            gs = 4 if sel == 3 else sel
            span = tab[PD._TAB_SPAN + 4 * ch + sel]

            def e(p):
                assert p < span or p >= 256, (p, span)   # what is staged
                return int(f["enc_exp"][r, b, ch, p]) if p < 256 else 0

            for g in range(min(tab[PD._TAB_NG + 4 * ch + sel], gmax)):
                p0 = 1 + 3 * gs * g
                prev = e(p0 - gs) if g else e(0)
                v = ((e(p0) - prev + 2) * 5 + (e(p0 + gs) - e(p0) + 2)) * 5 \
                    + (e(p0 + 2 * gs) - e(p0 + gs) + 2)
                deposit(grpoff[ch] + 7 * g, 7, v & 127)
        pos += offset(carry)

    def byte(i):
        return (words[i >> 2] >> (24 - 8 * (i & 3))) & 0xFF

    crc_tab = PK.crc_table()
    crcs = []
    for (a, e), mult in (((4, 2 * fs58), PD._TAB_MULT1),
                         ((2 * fs58, total - 2), PD._TAB_MULT2)):
        chunk = -(-(e - a) // lanes)
        acc = 0
        for t in range(lanes):
            crc = 0
            for i in range(a + t * chunk, min(a + (t + 1) * chunk, e)):
                crc = int(crc_tab[byte(i) ^ (crc >> 8)]) ^ ((crc << 8)
                                                             & 0xFFFF)
            acc ^= PK.mul_poly(crc, tab[mult + t], PK.CRC16_POLY)
        crcs.append(acc)
    out = bytes(byte(i) for i in range(total - 2))
    return out[:2] + crcs[0].to_bytes(2, "big") + out[4:] \
        + crcs[1].to_bytes(2, "big")


@pytest.mark.parametrize("config", CS.P1_CONFIGS)
def test_kernel_model_matches_plain_version(config):
    """The kernel's algorithm on its table gives the plain version's bytes
    on one frame of every kind (the overrun one included)."""
    cfg, f = _case(config)
    want = _ref(cfg, f)
    for r in range(0, len(want), ROWS):
        assert kernel_model(cfg, f, r) == want[r].tobytes(), (
            CS.P1_KINDS[r // ROWS])


def _int16(f):
    """The fields with Q1's 16-bit form of the codes: their low 16 bits
    as int16."""
    return dict(f, qmant=f["qmant"].astype(np.int16))


@pytest.mark.parametrize("config", CS.P1_CONFIGS[1::2])
def test_kernel_model_reads_int16_codes(config):
    """The kernel's algorithm reading 16-bit codes (as unsigned) gives the
    int32 codes' bytes on one frame of every kind."""
    cfg, f = _case(config)
    want = _ref(cfg, f)
    f16 = _int16(f)
    for r in range(0, len(want), ROWS):
        assert kernel_model(cfg, f16, r) == want[r].tobytes(), (
            CS.P1_KINDS[r // ROWS])


@pytest.mark.parametrize("config", CS.P1_CONFIGS)
def test_int16_codes_give_the_int32_bytes(config):
    """pack_frames_ref and the CPU route given int16 codes give the bytes
    they give for int32 codes (and the native packer's), on fields whose
    coded bins hold 16-bit codes from 32,768 up (negative as int16)."""
    cfg, f = _case(config)
    want = _ref(cfg, f)
    f16 = _int16(f)
    q16 = torch.from_numpy(f16["qmant"])
    live = np.arange(256) < np.asarray(cfg.nb_coefs)[:, None]
    coded = (f["bap"] > 0) & live
    assert (f16["qmant"][coded] < 0).any()
    args = [torch.from_numpy(f16[k]) for k in CS.P1_KEYS]
    assert args[1].dtype == torch.int16
    assert np.array_equal(PD.pack_frames_ref(cfg, *args).numpy(), want)
    assert np.array_equal(PD.pack_frames_device(cfg, *args).numpy(), want)
    assert torch.equal(PD.pack_frames_device(cfg)(*args),
                       PD.pack_frames_device(cfg, *args))
    assert torch.equal(q16.to(torch.int32) & 0xFFFF,
                       torch.from_numpy(f["qmant"]) & 0xFFFF)
    with pytest.raises(TypeError):
        PK.pack_frames_native(cfg, f16)


@pytest.mark.parametrize("config", CS.P1_CONFIGS[::3])
def test_dense_and_edge_kinds_reach_their_cases(config):
    """"dense" codes every live bin of block 2 in every channel, with 14-
    and 16-bit tokens that straddle words; "edge" codes the bins that end
    each channel's live bins, so a 16-bin chunk straddles the last live
    bin, and its dead bins hold 15.  The kernel's model gives the plain
    version's bytes on every row of both."""
    cfg, f = _case(config)
    nb = np.asarray(cfg.nb_coefs)
    live = np.arange(256) < nb[:, None]
    want = _ref(cfg, f)
    for kind in ("dense", "edge"):
        r0 = CS.P1_KINDS.index(kind) * ROWS
        bap = f["bap"][r0:r0 + ROWS]
        if kind == "dense":
            assert (bap[:, 2][:, live] != 0).all()
            assert ((bap[:, 2] == 15)[:, live]).any()
            assert ((bap[:, 2] == 14)[:, live]).any()
        else:
            end = (np.arange(256) >= nb[:, None] - 17) & live
            assert (bap[..., end] != 0).any()
            assert (bap[..., ~live] == 15).all()
            assert all(n % 16 for n in nb)      # a chunk straddles nb
        for r in range(r0, r0 + ROWS):
            assert kernel_model(cfg, f, r) == want[r].tobytes(), (kind, r)


def kernel_walk(n, warps, sms=132):
    """csrc/pack.cu's launch and walk of n frames with one CTA resident an
    SM: ceil(n / warps) CTAs up to the resident ones; warp w of CTA c
    takes frames c warps + w, then every warps x CTAs -> ({frame: (CTA,
    warp)} in the order the warps reach them, CTAs)."""
    ctas = min(-(-n // warps), sms)
    got = {}
    for c in range(ctas):
        for w in range(warps):
            for fr in range(c * warps + w, n, ctas * warps):
                assert fr not in got
                got[fr] = (c, w)
    return got, ctas


# a CTA's warps at each config the walk is checked on: 8 up to two
# channels, 16 above, 15 for 5.1's 3,840-byte frames (16 slices would
# pass a CTA's shared memory); _source_warps reads them from the source
WALK_WARPS = {(2, 44100, 128): 8, (6, 48000, 640): 16, (6, 32000, 640): 15}


@pytest.mark.parametrize("config,n", [
    (c, n) for c, w in WALK_WARPS.items()
    for n in ((1, w - 1, w + 1) if c[0] <= 2 else (w - 1, w + 1))])
def test_kernel_walk_packs_every_frame_once(config, n):
    """1 frame, a CTA's warps - 1 (its last warp idle) and + 1 (a second
    CTA with one frame, or, with one CTA resident, the walk's second
    pass): each frame goes to one warp, and the kernel's model on the
    frames in the walk's order, and the CPU route, equal JAX's
    pack_frames_device on those frames."""
    cfg, f = _case(config)
    warps = WALK_WARPS[config]
    assert _source_warps(cfg) == warps
    for sms in (132, 1):
        got, ctas = kernel_walk(n, warps, sms)
        assert sorted(got) == list(range(n))
        if n < warps:
            assert ctas == 1 and (0, warps - 1) not in got.values()
        else:
            assert got[warps] == ((1, 0) if sms > 1 else (0, 0))
    rows = {k: np.ascontiguousarray(f[k][:n]) for k in CS.P1_KEYS}
    want = [r.tobytes() for r in _jax_device(config)[:n]]
    model = [None] * n
    for fr in got:
        model[fr] = kernel_model(cfg, rows, fr)
    assert model == want
    cpu = PD.pack_frames_device(cfg, *(torch.from_numpy(rows[k])
                                       for k in CS.P1_KEYS)).numpy()
    assert [r.tobytes() for r in cpu] == want


def test_kernel_table_layout():
    """The table's sections fit the kernel's constants on every config of
    the crafted cases: slots a block within MAX_SLOTS, every slot within
    16 bits, group counts within gmax, spans within a row."""
    for config in CS.P1_CONFIGS:
        cfg, _ = _case(config)
        tab = PD.kernel_table(cfg)
        assert tab.dtype == np.int32 and tab.shape == (PD._TAB_SIZE,)
        counts = tab[PD._TAB_NSLOTS:PD._TAB_NSLOTS + 6]
        assert (counts > 0).all() and (counts <= PD.MAX_SLOTS).all()
        sched = PD.schedule(cfg)
        assert [len(s) for s in sched] == counts.tolist()
        assert all(ln <= 16 for s in sched for _, _, ln, _ in s)
        ng = tab[PD._TAB_NG:PD._TAB_NG + 24]
        assert (ng >= 0).all() and (ng <= tab[PD._TAB_GMAX]).all()
        span = tab[PD._TAB_SPAN:PD._TAB_SPAN + 24]
        assert (span <= 256).all()
        # a multiplier a lane for each CRC; the slots follow at once
        for sec in (PD._TAB_MULT1, PD._TAB_MULT2):
            mults = tab[sec:sec + PD.LANES]
            assert ((mults > 0) & (mults < 1 << 16)).all()
        assert PD._TAB_MULT2 - PD._TAB_MULT1 == PD.LANES
        assert PD._TAB_SLOTS - PD._TAB_MULT2 == PD.LANES


@lru_cache(maxsize=None)
def _source():
    """csrc/pack.cu's text and its constexpr int constants."""
    path = os.path.join(os.path.dirname(PD.__file__), os.pardir, "csrc",
                        "pack.cu")
    with open(path) as f:
        src = f.read()
    consts = {"P1_WARPS": int(re.search(r"#define P1_WARPS (\d+)",
                                        src).group(1))}
    for decl in re.findall(r"^constexpr int ([^;]*);", src, re.M):
        for name, expr in re.findall(r"(\w+) = ([^,]+)", decl):
            consts[name] = eval(expr, {}, dict(consts))
    return src, consts


def _source_warps(cfg):
    """csrc/pack.cu:cta_warps for cfg, from the source: its one-line
    constexpr helpers (words_padded, steps_for, warp_bytes) evaluated as
    written, with C's integer division, in the loop that cuts the warps."""
    src, consts = _source()
    scope = dict(consts)
    for name, params, expr in re.findall(
            r"constexpr int (\w+)\(([^)]*)\)\s*\{\s*return ([^;?]*);\s*\}",
            src):
        args = ", ".join(p.split()[-1] for p in params.split(","))
        scope[name] = eval(f"lambda {args}: {expr.replace('/', '//')}",
                           scope)
    assert {"words_padded", "steps_for", "warp_bytes"} <= set(scope)
    assert "return P1_WARPS > 0 ? P1_WARPS : nch <= 2 ? 8 : MAX_WARPS;" in src
    assert ("    int w = warps_for(NCH);\n"
            "    while (w > 1 && CTA_BYTES + w * warp_bytes(NCH, total) > "
            "MAX_SMEM)\n        w--;\n    return w;") in src
    nch, total = cfg.channels, cfg.frame_size * 2
    w = 8 if nch <= 2 else consts["MAX_WARPS"]
    while w > 1 and (consts["CTA_BYTES"] + w * scope["warp_bytes"](nch, total)
                     > consts["MAX_SMEM"]):
        w -= 1
    return w


def test_layout_matches_the_kernel_source():
    """pack_device.LAYOUT is csrc/pack.cu's table layout, section by
    section and in pack_frames_layout's order (what _lib() compares on the
    card); a CTA of 8 warps up to two channels and 16 above (15 where 16
    frames' slices pass a CTA's shared memory), a warp a frame (the walk
    kernel_walk models), and 32 CRC chunks a frame."""
    src, consts = _source()
    body = re.search(r"pack_frames_layout\(int\* out\)\s*\{\s*const int "
                     r"v\[\] = \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in body.split(",")]
    assert tuple(consts[n] for n in names) == PD.LAYOUT
    assert names[-2:] == ["TAB_SIZE", "MAX_SLOTS"]
    assert consts["P1_WARPS"] == 0 and consts["MAX_WARPS"] == 16
    warps = {c: _source_warps(_case(c)[0]) for c in CS.P1_CONFIGS}
    assert warps == {c: WALK_WARPS.get(c, 8 if c[0] <= 2 else 16)
                     for c in CS.P1_CONFIGS}
    assert consts["LANES"] == PD.LANES
    for line in ("const long long need = (N + warps - 1) / warps;",
                 "const long long ctas = need < card ? need : card;",
                 "long long f = (long long)blockIdx.x * warps + warp;",
                 "const long long wstride = (long long)gridDim.x * warps;",
                 "const int chunk = (e - a + LANES - 1) / LANES;"):
        assert line in src, line


@pytest.mark.parametrize("config", CS.P1_CONFIGS[::2])
def test_pack_least_bytes_counts_what_is_coded(config):
    """chip_smoke.py:pack_least_bytes (P1's bound) == a frame-by-frame
    count from JAX's group counts: a class byte a live bin, a 16-bit code
    where the class is not 0, 1 + 3 ng exponents where the strategy is not
    reuse; the strategies and offsets (int32) and the frame."""
    cfg, f = _case(config)
    nb = [int(n) for n in cfg.nb_coefs]
    want = 0
    for r in range(len(f["bap"])):
        want += 6 * len(nb) * 4 + 8 + cfg.frame_size * 2
        for b in range(6):
            for c, n in enumerate(nb):
                want += n + 2 * int((f["bap"][r, b, c, :n] != 0).sum())
                s = int(f["strat"][r, b, c])
                if s:
                    want += 1 + 3 * max(JPD._ngroups(n, (1, 2, 4)[s - 1]), 0)
    assert (f["strat"] == 0).any() and (f["bap"] == 0).any()
    assert CS.pack_least_bytes(cfg, torch.from_numpy(f["bap"]),
                               torch.from_numpy(f["strat"])) == want


def _good(config=(2, 48000, 192)):
    cfg, f = _case(config)
    return cfg, [torch.from_numpy(f[k][:2].copy()) for k in CS.P1_KEYS]


def _offset_view(t, dtype):
    """t's values in a view one element past a fresh buffer's start: not
    16-byte aligned."""
    flat = torch.zeros(t.numel() + 1, dtype=dtype)
    flat[1:] = t.reshape(-1)
    return flat[1:].view(t.shape)


BAD = {
    "bap int32": (0, lambda t: t.to(torch.int32), TypeError),
    "qmant int64": (1, lambda t: t.long(), TypeError),
    "qmant int8": (1, lambda t: t.to(torch.int8), TypeError),
    "qmant uint16": (1, lambda t: t.to(torch.uint16), TypeError),
    "qmant int16 unaligned": (1, lambda t: _offset_view(t.to(torch.int16),
                                                        torch.int16),
                              ValueError),
    "enc_exp int32": (2, lambda t: t.to(torch.int32), TypeError),
    "strat int64": (3, lambda t: t.long(), TypeError),
    "csnr int64": (4, lambda t: t.long(), TypeError),
    "fsnr int16": (5, lambda t: t.to(torch.int16), TypeError),
    "bap strided": (0, lambda t: t.transpose(0, 1).contiguous()
                    .transpose(0, 1), ValueError),
    "qmant unaligned": (1, lambda t: _offset_view(t, torch.int32),
                        ValueError),
    "enc_exp unaligned": (2, lambda t: _offset_view(t, torch.uint8),
                          ValueError),
    "bap 255 bins": (0, lambda t: t[..., :255].contiguous(), ValueError),
    "bap 3 channels": (0, lambda t: torch.cat([t, t[:, :, :1]], 2),
                       ValueError),
    "qmant short": (1, lambda t: t[:1], ValueError),
    "strat short": (3, lambda t: t[:, :5].contiguous(), ValueError),
    "csnr long": (4, lambda t: torch.cat([t, t]), ValueError),
    "fsnr short": (5, lambda t: t[:1], ValueError),
    "enc_exp on meta": (2, lambda t: t.to("meta"), ValueError),
}


@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrapper_refuses(bad):
    """The wrapper's checks hold on the CPU as on the card, and no CPU
    call launches the kernel."""
    cfg, args = _good()
    i, make, err = BAD[bad]
    args[i] = make(args[i])
    before = PD.launches_pack
    with pytest.raises(err):
        PD.pack_frames_device(cfg, *args)
    assert PD.launches_pack == before == 0


def test_cpu_never_reaches_the_cuda_build(monkeypatch):
    """CPU tensors take the plain version: the CUDA build and the kernel
    table are never touched, the launch count never moves; the clock gets
    the plain version's four marks; no frames give no bytes and no
    marks."""
    def refuse(*a, **k):
        raise AssertionError("a CPU call reached the CUDA route")

    monkeypatch.setattr(_cuda, "load", refuse)
    monkeypatch.setattr(_cuda, "build", refuse)
    monkeypatch.setattr(PD, "_lib", refuse)
    monkeypatch.setattr(PD, "_kernel_table_on", refuse)
    cfg, args = _good()

    class Clock:
        marks = []

        def mark(self, name):
            self.marks.append(name)

    clock = Clock()
    out = PD.pack_frames_device(cfg, *args, clock=clock)
    assert torch.equal(out, PD.pack_frames_ref(cfg, *args))
    assert clock.marks == ["pack: tokens", "pack: offsets", "pack: deposit",
                           "pack: CRC"]
    none = PD.pack_frames_device(cfg, *(a[:0] for a in args), clock=clock)
    assert none.shape == (0, cfg.frame_size * 2) and len(clock.marks) == 4
    lead = PD.pack_frames_device(cfg, *(a.reshape((2, 1) + a.shape[1:])
                                        for a in args))
    assert torch.equal(lead.reshape(out.shape), out)
    assert PD.launches_pack == 0


@pytest.mark.parametrize("config", [(2, 48000, 192), (6, 48000, 640)])
def test_jax_calling_form(config):
    """pack_frames_device(cfg) returns the packer of JAX's calling form,
    fn(bap, qmant, enc_exp, strat, csnr, fsnr): its frames equal the
    one-call form's; some fields but not all raise TypeError."""
    cfg, f = _case(config)
    args = [torch.from_numpy(f[k]) for k in CS.P1_KEYS]
    packer = PD.pack_frames_device(cfg)
    assert callable(packer)
    assert torch.equal(packer(*args), PD.pack_frames_device(cfg, *args))
    with pytest.raises(TypeError):
        PD.pack_frames_device(cfg, *args[:5])
    with pytest.raises(TypeError):
        PD.pack_frames_device(cfg, clock=object())
