"""Fused order-exact steady tail: IMDCT, OLA chain and int16 in one kernel.

The reference-mode counterpart of ops.fused_steady.  The scan-free steady
pipeline with premixed planes reduces each (lane b, output plane p) chain
of n blocks to

    (z_i, d_i) = split_fb_exact(freq[b, i, p], blksw[b, i, p])
    dprev_i    = d0[b, p] if i == 0 else d_{i-1}
    out_i      = ((z_i * win) + (fold(dprev_i) * win_r)) + bias[b, i]
    pcm        = convert_to_int16(out) (or out as float32)
    dlast      = d_{n-1}                      fold(d) = d ++ d.flip(-1)

every operation rounded on its own, which is bit for bit what
models.decoder._pipeline_steady(exact=True) followed by convert_to_int16
computes, and so the reference float decoder's output.

``fused_steady_exact`` launches the hand-written CUDA kernel B1F
(csrc/imdct_exact.cu:fused_steady_exact_kernel, which shares B1's
transform code) on CUDA tensors: z, d and the OLA stay on chip, and only
the PCM and the carry-out are written.  For tensors on the CPU it runs
``fused_steady_exact_ref``, the plain PyTorch version.  There is no other
path: a CUDA tensor launches the kernel or raises.  The JAX package
computes the same function as XLA (ac3acm_tpu/ops/imdct_exact.py:437,466
and the steady body's OLA), with no pallas_call.
"""
from __future__ import annotations

import random
from functools import lru_cache

import numpy as np
import torch

from . import _cuda
from .filterbank import mats_on
from .fused_steady import _check, steady_epilogue
from .imdct_exact import _bind, _tw_on, split_fb_exact_ref

# kernel launches since the last reset (incremented only where the CUDA
# kernel is launched; the CPU path leaves it alone)
launches = 0

_OUT_DTYPES = (torch.int16, torch.float32)

# B1F's pair schedule (csrc/imdct_exact.cu: PT_*).  A warp transforms two
# rows of one kind (long or short) at once, row A's IFFT values at words
# CS(i) of its re/im buffers and row B's at 128 + (CS(i) ^ PAIR_XOR); the
# leaves and the ifft_pass levels, whose butterflies keep 16 to 24 lanes
# of a one-row warp busy, are packed: each lane takes one item of either
# row a round, from this table.
PAIR_XOR = 28
# the IFFT leaves of each kind (csrc/imdct_exact.cu SCHED: 0x100 flags an
# ifft8, else ifft4) and its ifft_pass levels (node offsets, n, roots)
LEAVES = {"long": (0x100 | 0, 0x100 | 16, 0x100 | 24, 0x100 | 32, 0x100 | 64,
                   0x100 | 80, 0x100 | 88, 0x100 | 96, 0x100 | 48,
                   0x100 | 112, 0x100 | 120, 8, 12, 40, 56, 60, 44, 72, 76,
                   104, 108),
          "short": (0x100 | 0, 0x100 | 16, 0x100 | 24, 0x100 | 32,
                    0x100 | 64, 0x100 | 80, 0x100 | 88, 0x100 | 96,
                    0x100 | 48, 0x100 | 112, 8, 12, 40, 44, 56, 60, 72, 76,
                    104, 108, 120, 124)}
LEVELS = {"long": (((0, 32, 48, 64, 96), 4, "roots16"),
                   ((0, 64, 96), 8, "roots32"), ((0,), 16, "roots64"),
                   ((0,), 32, "roots128")),
          "short": (((0, 32, 48, 64, 96, 112), 4, "roots16"),
                    ((0, 64), 8, "roots32"), ((0, 64), 16, "roots64"))}
# rounds of 32 lanes a level takes for a pair (pair_rows' level loop)
PAIR_ROUNDS = {"long": (2, 2, 1, 2), "short": (2, 1, 2)}
PT_LEAF, PT_PASS = 0, 128                 # ints; the pass entries are int4
PT_SIZE = PT_PASS + 4 * 32 * sum(sum(r) for r in PAIR_ROUNDS.values())


def _cs(i):
    return i ^ (((i >> 4) & 7) << 2)


def pair_word(row, i):
    """The word of IFFT value i of a pair's row (0: A, 1: B) in the re (or,
    256 words on, the im) buffer."""
    return _cs(i) if row == 0 else 128 + (_cs(i) ^ PAIR_XOR)


def _leaf_lanes(entries):
    """A lane for each leaf (row, offset) of one phase: groups of 8 lanes
    whose float4 accesses (at the offset and, for an ifft8, 4 on) fall in
    8 distinct 16-byte bank groups, so each access takes one wavefront a
    group -> [32] (row, offset) or None."""
    steps = (0, 4) if len(entries) and entries[0][2] else (0,)
    chunks = [tuple((pair_word(r, o + s) >> 2) & 7 for s in steps)
              for r, o, _ in entries]
    groups, used = [[] for _ in range(4)], [[set() for _ in steps]
                                            for _ in range(4)]
    order = sorted(range(len(entries)), key=lambda i: chunks[i])

    def place(p):
        if p == len(order):
            return True
        i = order[p]
        for g in range(4):
            if len(groups[g]) < 8 and not any(
                    chunks[i][s] in used[g][s] for s in range(len(steps))):
                groups[g].append(i)
                for s in range(len(steps)):
                    used[g][s].add(chunks[i][s])
                if place(p + 1):
                    return True
                groups[g].pop()
                for s in range(len(steps)):
                    used[g][s].discard(chunks[i][s])
        return False

    assert place(0)
    lanes = [None] * 32
    for g, members in enumerate(groups):
        for slot, i in enumerate(members):
            lanes[8 * g + slot] = entries[i][:2]
    return lanes


def _pass_rounds(offs, n, rounds, rng):
    """The butterflies (row, node offset, k) of one level of a pair dealt
    into `rounds` rounds of at most 32, each round's four loads touching
    32 distinct banks; the zero-twiddle butterflies (k = 0) go to the last
    rounds, so that fewer rounds run both kinds."""
    items = [(r, a, k) for r in (0, 1) for a in offs for k in range(n)]
    banks = lambda it, m: pair_word(it[0], it[1] + it[2] + m * n) % 32
    for _ in range(10000):
        rng.shuffle(items)
        out = [[] for _ in range(rounds)]
        for it in sorted(items, key=lambda it: it[2] == 0):
            for rd in (range(rounds) if it[2] else
                       range(rounds - 1, -1, -1)):
                if len(out[rd]) < 32 and all(
                        all(banks(it, m) != banks(o, m) for m in range(4))
                        for o in out[rd]):
                    out[rd].append(it)
                    break
            else:
                break
        else:
            return out
    raise AssertionError(f"no conflict-free rounds for {offs}, {n}")


@lru_cache(maxsize=None)
def pair_table() -> np.ndarray:
    """B1F's pair schedule as the kernel reads it (int32 [PT_SIZE]):

      PT_LEAF  [kind (long, short)][phase (ifft8, ifft4)][lane]: -1 for an
               idle lane, else (w4 << 16) | w0, the words of the leaf's
               first 4 values and (ifft8) of the next 4 in its row
      PT_PASS  [round][lane] int4 (long's 7 rounds, then short's 5):
               (a0 | a1 << 16, a2 | a3 << 16, wr, wi), the words of the
               butterfly's four values and the bits of its twiddles
               roots[k - 1], roots[n - 1 - k]; wr = wi = 0 for a
               zero-twiddle butterfly (k = 0), (-1, -1, 0, 0) idle.

    Deterministic (a fixed seed); tests/test_torch_imdct_exact.py checks
    that every leaf and butterfly of both rows runs once, in level order,
    and that every access takes its fewest wavefronts."""
    from .. import tables as T
    tw = T.imdct_twiddles()
    rng = random.Random(20)
    out = np.zeros(PT_SIZE, np.int64)
    for kk, kind in enumerate(("long", "short")):
        for ph, flag in enumerate((0x100, 0)):
            entries = [(r, e & 0xff, flag) for r in (0, 1)
                       for e in LEAVES[kind] if e & 0x100 == flag]
            for lane, got in enumerate(_leaf_lanes(entries)):
                out[PT_LEAF + (2 * kk + ph) * 32 + lane] = -1 if got is None \
                    else (pair_word(got[0], got[1] + 4) << 16) | pair_word(
                        *got)
    base = PT_PASS
    for kind in ("long", "short"):
        for (offs, n, roots), rounds in zip(LEVELS[kind], PAIR_ROUNDS[kind]):
            w = np.asarray(tw[roots], np.float32).view(np.int32)
            assert (w != 0).all()
            for rd in _pass_rounds(offs, n, rounds, rng):
                ent = np.array([[-1, -1, 0, 0]] * 32, np.int64)
                for lane, (r, a, k) in enumerate(rd):
                    q = [pair_word(r, a + k + m * n) for m in range(4)]
                    ent[lane] = (q[0] | q[1] << 16, q[2] | q[3] << 16,
                                 w[k - 1] if k else 0,
                                 w[n - 1 - k] if k else 0)
                out[base:base + 128] = ent.ravel()
                base += 128
    assert base == PT_SIZE
    return out.astype(np.int32)


_PT_ON = {}


def _pair_table_on(device):
    key = str(device)
    if key not in _PT_ON:
        _PT_ON[key] = torch.from_numpy(pair_table()).to(device)
    return _PT_ON[key]


def fused_steady_exact_ref(freq, blksw, d0, bias, out_dtype=torch.int16):
    """Plain PyTorch version of fused_steady_exact (any device): the exact
    split, then the delay chain, the eager OLA and convert_to_int16 of
    ops.fused_steady.steady_epilogue."""
    zd = torch.cat(split_fb_exact_ref(freq, blksw), dim=-1)
    return steady_epilogue(zd, d0, bias, out_dtype)


def fused_steady_exact(freq, blksw, d0, bias, out_dtype=torch.int16):
    """freq [B, n, P, 256] f32 premixed planes (block-major, the
    pipeline's layout), 16-byte aligned; blksw [B, n, P] bool (True = short
    block; a plane's flag may differ from its neighbour's) or None (every
    row long); d0 [B, P, 128] f32 carry; bias [B, n] f32.

    -> (pcm [B, n, P, 256] of out_dtype (torch.int16 or torch.float32),
        dlast [B, P, 128] f32)

    Every input must be contiguous and on one device; n >= 1."""
    global launches
    if freq.dim() != 4 or freq.shape[-1] != 256:
        raise ValueError(f"freq must be [B, n, P, 256], got "
                         f"{tuple(freq.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"out_dtype is {out_dtype}, expected torch.int16 "
                        f"or torch.float32")
    B, n, P, _ = freq.shape
    dev = freq.device
    _check("freq", freq, torch.float32, (B, n, P, 256), dev)
    if blksw is not None:
        _check("blksw", blksw, torch.bool, (B, n, P), dev)
    _check("d0", d0, torch.float32, (B, P, 128), dev)
    _check("bias", bias, torch.float32, (B, n), dev)
    if n < 1:
        raise ValueError("fused_steady_exact needs at least one block")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"fused_steady_exact runs on cuda or cpu, not {dev}")
    if freq.data_ptr() % 16:
        raise ValueError("freq must be 16-byte aligned")
    if dev.type == "cpu":
        return fused_steady_exact_ref(freq, blksw, d0, bias, out_dtype)
    pcm = torch.empty((B, n, P, 256), dtype=out_dtype, device=dev)
    dlast = torch.empty((B, P, 128), dtype=torch.float32, device=dev)
    if B * P == 0:
        return pcm, dlast
    tw = _tw_on(dev)
    win = mats_on(dev)[2]
    lib = _cuda.load("imdct_exact", _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fused_steady_exact_launch(
            freq.data_ptr(), None if blksw is None else blksw.data_ptr(),
            d0.data_ptr(), bias.data_ptr(), tw["packed"].data_ptr(),
            tw["order32"].data_ptr(), _pair_table_on(dev).data_ptr(),
            win.data_ptr(), pcm.data_ptr(),
            dlast.data_ptr(), B, n, P, int(out_dtype == torch.int16), stream)
    if rc != 0:
        raise RuntimeError("fused_steady_exact kernel launch failed: "
                           + lib.imdct_exact_error_string(rc).decode())
    launches += 1
    return pcm, dlast
