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
    group counts, exponent spans, CRC multipliers by thread): it must give
    the plain version's bytes, so the table and the kernel's offset
    arithmetic are checked here, where the kernel cannot run.
  * The wrapper refuses what the kernel does not take, and a CPU tensor
    never reaches the CUDA build.
"""
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


@pytest.mark.parametrize("config", JAX_DEVICE_CONFIGS)
def test_crafted_fields_match_jax_device_packer(config):
    """pack_frames_device on CPU tensors == JAX's pack_frames_device on
    every crafted frame that fits."""
    cfg, f = _case(config)
    got = PD.pack_frames_device(cfg, *(torch.from_numpy(f[k])
                                       for k in CS.P1_KEYS)).numpy()
    jcfg = JE.make_config(config[1], config[2] * 1000, config[0])
    want = np.asarray(JPD.pack_frames_device(jcfg)(
        *(f[k][:FIT] for k in CS.P1_KEYS)))
    assert np.array_equal(got[:FIT], want)


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


def kernel_model(cfg, f, r):
    """csrc/pack.cu's algorithm on frame r, in Python, reading only the
    kernel's table: each block's elements (its slots, then its live bins)
    take their offsets from the packed counts before them, the heads and
    exponent groups are laid after the walk, and the CRCs are the threads'
    chunk CRCs times their multipliers, XORed."""
    tab = [int(x) for x in PD.kernel_table(cfg)]
    nch, total = cfg.channels, cfg.frame_size * 2
    fs58 = (cfg.frame_size >> 1) + (cfg.frame_size >> 3)
    nb = tab[PD._TAB_NB:PD._TAB_NB + nch]
    gmax = tab[PD._TAB_GMAX]
    limit = 8 * (total - 2)
    words = [0] * (total // 4 + 2)

    def deposit(off, ln, v):
        if ln <= 0 or off >= limit or v == 0:
            return
        w, sh = off >> 5, 32 - (off & 31) - ln
        if sh >= 0:
            words[w] |= v << sh
        else:
            words[w] |= v >> -sh
            words[w + 1] |= (v << (32 + sh)) & 0xFFFFFFFF

    def offset(u, n1, n2, n4):
        return u + 5 * -(-n1 // 3) + 7 * -(-n2 // 3) + 7 * -(-n4 // 2)

    groups = {1: (3, 5, (9, 3, 1)), 2: (3, 7, (25, 5, 1)), 4: (2, 7, (11, 1))}
    pos = 0
    for b in range(6):
        st = [int(s) for s in f["strat"][r, b]]
        ns = tab[PD._TAB_NSLOTS + b]
        base = PD._TAB_SLOTS + b * PD.MAX_SLOTS
        u, cnt = 0, {1: 0, 2: 0, 4: 0}
        memb = {1: [], 2: [], 4: []}
        heads = {1: [], 2: [], 4: []}
        grpoff = {}
        for slot in tab[base:base + ns]:
            off = pos + offset(u, cnt[1], cnt[2], cnt[4])
            kind, ch = (slot >> 24) & 15, (slot >> 21) & 7
            ln, v = (slot >> 16) & 31, slot & 0xFFFF
            s = st[ch]
            sel = 1 if s == 1 else 2 if s == 2 else 3
            if kind in (PD.K_COND, PD.K_EXP0) and s == 0:
                ln = 0
            if kind == PD.K_GROUPS:
                ln = 0 if s == 0 else 7 * tab[PD._TAB_NG + 4 * ch + sel]
                grpoff[ch] = off
            else:
                v = {PD.K_STRAT: s, PD.K_EXP0: int(f["enc_exp"][r, b, ch, 0]),
                     PD.K_CSNR: int(f["csnroffst"][r]),
                     PD.K_FSNR: int(f["fsnroffst"][r])}.get(kind, v)
                deposit(off, ln, v & ((1 << ln) - 1))
            u += ln
        for c in range(nch):
            for i in range(nb[c]):
                off = pos + offset(u, cnt[1], cnt[2], cnt[4])
                cls = int(f["bap"][r, b, c, i])
                q = int(f["qmant"][r, b, c, i]) & 0xFFFFFFFF
                if cls in groups:
                    o = cnt[cls]
                    memb[cls].append(q & 15)
                    if o % groups[cls][0] == 0:
                        heads[cls].append(off)
                    cnt[cls] += 1
                else:
                    ln = CS.P1_CLASS_BITS.get(cls, 0)
                    deposit(off, ln, q & ((1 << ln) - 1))
                    u += ln
        for cls, (g, bits, mults) in groups.items():
            m = memb[cls]
            for h, off in enumerate(heads[cls]):
                v = sum(k * (m[g * h + j] if g * h + j < len(m) else 0)
                        for j, k in enumerate(mults))
                deposit(off, bits, v & ((1 << bits) - 1))
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
        pos += offset(u, cnt[1], cnt[2], cnt[4])

    def byte(i):
        return (words[i >> 2] >> (24 - 8 * (i & 3))) & 0xFF

    crc_tab = PK.crc_table()
    threads = PD.kernel_threads(nch)
    crcs = []
    for (a, e), mult in (((4, 2 * fs58), PD._TAB_MULT1),
                         ((2 * fs58, total - 2), PD._TAB_MULT2)):
        chunk = -(-(e - a) // threads)
        acc = 0
        for t in range(threads):
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


def test_layout_matches_the_kernel_source():
    """pack_device.LAYOUT is csrc/pack.cu's table layout, section by
    section and in pack_frames_layout's order (what _lib() compares on the
    card), and the CTA sizes agree."""
    import os
    import re
    path = os.path.join(os.path.dirname(PD.__file__), os.pardir, "csrc",
                        "pack.cu")
    with open(path) as f:
        src = f.read()
    consts = {}
    for decl in re.findall(r"^constexpr int ([^;]*);", src, re.M):
        for name, expr in re.findall(r"(\w+) = ([^,]+)", decl):
            consts[name] = eval(expr, {}, dict(consts))
    body = re.search(r"pack_frames_layout\(int\* out\)\s*\{\s*const int "
                     r"v\[\] = \{([^}]*)\}", src).group(1)
    names = [n.strip() for n in body.split(",")]
    assert tuple(consts[n] for n in names) == PD.LAYOUT
    assert names[-2:] == ["TAB_SIZE", "MAX_SLOTS"]
    assert "return nch <= 2 ? 128 : 256;" in src
    assert [PD.kernel_threads(n) for n in range(1, 7)] == [128] * 2 + [256] * 4


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
