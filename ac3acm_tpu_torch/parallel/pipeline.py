"""Batched multi-stream decode: the framework's throughput path.

N streams of a common format are a leading lane axis through the decode
pipeline.  Per-lane carried state (OLA delay planes + downmixed flag) is
the checkpoint/resume unit: a plain tuple of tensors (utils.state).

Dispatch (``batched_pipeline``): a steady premixed chunk goes through a
fused kernel: in reference mode (the default) any such chunk, int16 or
float, long or with short blocks, through the fused order-exact tail
(ops.fused_steady_exact, kernel B1F); in fast mode a long-only one
converted to int16 through the fused steady kernel (ops.fused_steady,
K1).  Any other steady chunk goes through ``_pipeline_steady``, and a
chunk that is not steady through the block scan ``_pipeline_body``, whose
transforms in reference mode are the order-exact IMDCT (ops.imdct_exact,
kernel B1).  ``BatchedDecoder`` buckets a mixed-format batch by format
(``_decode_heterogeneous``).

The raw-H2D path (``raw_batched_pipeline``, ``BatchedDecoder(parser=
"raw" | "raw_py")``) ships the coded frame bytes plus side info instead
and unpacks, allocates and dequantizes on the device (ops.unpack_device,
with the bitfield kernels of ops.bitgather) before the same decode
bodies; in reference mode a steady chunk of a premixable format is
premixed on the device (models.decoder.premix_blocks_device) and takes
B1F, and a direct call with pallas=True premixes it so in fast mode and
takes K1.

``mesh`` (parallel.mesh.make_mesh) keeps the JAX package's position in
every entry point's signature.  With a mesh, the lane axis of every
operand is split over its 'data' axis and the one-device function runs
once per data row on that row's device (parallel.mesh.over_data), with
the kernels the one-device call takes (B1F, B1, K1, K2-K4): JAX drops its
Pallas kernel under a mesh only because GSPMD does not partition a
pallas_call.  Each lane's PCM is the same as without the mesh: the
reference mode, K1, K2-K4 and the block scan work lane by lane.
``tp_filterbank`` splits the filterbank product over 'model' as well.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import tables as T
from ..host.native import DenseBatchParser, SideinfoBatchParser
from ..host.parse import (A52Parser, BlockData, FrameData, downmix_coeff,
                          downmix_init, syncinfo)
from ..models.decoder import (StreamFormat, _lanes_first, _pipeline_body,
                              _pipeline_steady, _stack_blocks, default_exact,
                              frame_format, premix_blocks,
                              premix_blocks_device, steady_ok)
from ..ops.downmix import downmix
from ..ops.filterbank import convert_to_int16, mats_on
from ..ops.fused_steady import fused_steady
from ..ops.fused_steady_exact import fused_steady_exact
from ..ops.unpack_device import (init_unpack_carry, null_raw_rec,
                                 prune_raw_meta, stack_raw_meta,
                                 static_alloc_pts, static_cpl_fc,
                                 static_emax, static_exp_pts, unpack_blocks)
from ..utils.device import resolve_device
from ..utils.trace import count, log, set_step, span
from .mesh import (Mesh, Sharded, check_mesh, over_data,
                   stream_sharding)


def _expand_compact(blocks):
    """Reconstruct f32 premixed planes from the block-float H2D form:
    freq = man(int16) * scale(f32 per block, plane, 16-bin group).  The
    compact form halves host->device bytes; the product is exact."""
    if "freq_man" not in blocks:
        return blocks
    out = {k: v for k, v in blocks.items()
           if k not in ("freq_man", "freq_scale")}
    man, scale = blocks["freq_man"], blocks["freq_scale"]
    g = scale.shape[-1]
    grouped = man.reshape(man.shape[:-1] + (g, 256 // g))
    out["freq"] = (grouped.to(torch.float32)
                   * scale[..., None]).reshape(man.shape)
    return out


def _fused_run(fmt: StreamFormat, exact: bool = False,
               emit_int16: bool = True, long_only: bool = True):
    """Fused body for a steady premixed chunk, with the same entry fixups
    and carry layout as _pipeline_steady: exact=False the fused steady
    kernel (ops.fused_steady: matmul + OLA + int16, long-only chunks, int16
    out), exact=True the fused order-exact tail (ops.fused_steady_exact:
    any blksw, int16 or float out).

    Serves both premixed layouts: reducing mixes (freq path) and identity-
    mix passthrough (time path, fmt.identity_mix -- e.g. stereo->stereo),
    which differ only in the entry/exit delay fixups and in the blksw each
    plane takes (the freq path's planes share the first channel's, the
    passthrough planes keep their own; LFE is always long)."""
    nfo = fmt.nf_out
    passthrough = not (nfo < fmt.nfchans)         # identity premix
    out_dtype = torch.int16 if emit_int16 else torch.float32

    def plane_blksw(blksw):                       # [B, n, 5] -> [B, n, P]
        blk = blksw[:, :, :nfo] if passthrough else \
            blksw[:, :, :1].expand(-1, -1, nfo)
        if fmt.lfe_out:
            blk = torch.cat([blk, torch.zeros_like(blk[:, :, :1])], dim=2)
        return blk.contiguous()

    def run(carry, blocks):
        delay, downmixed = carry                  # [B,6,128], [B]
        blocks = _expand_compact(blocks)
        freq = blocks["freq"].contiguous()        # [B,n,P,256]; LFE last
        bias = blocks["bias"].contiguous()        # [B,n]
        if passthrough:
            # identity upmix: the time path's entry fixup is a no-op
            d0f = delay[:, :5]
        else:
            zero = torch.zeros((), dtype=delay.dtype, device=delay.device)
            # entry fixup: a carry from a time-path chunk holds per-channel
            # delays; downmix once (the block scan's first-step behaviour)
            d_mix = _lanes_first(downmix, delay[:, :5], fmt.acmod,
                                 fmt.output, zero, slev_zero=fmt.slev_zero)
            d0f = torch.where(downmixed[:, None, None], delay[:, :5], d_mix)
        parts = [d0f[:, :nfo]]
        if fmt.lfe_out:
            parts.append(delay[:, 5:6])
        d0 = torch.cat(parts, dim=1).contiguous()
        if exact:
            blk = None if long_only else plane_blksw(blocks["blksw"])
            pcm, dlast = fused_steady_exact(freq, blk, d0, bias, out_dtype)
        else:
            pcm, dlast = fused_steady(freq, d0, bias)
        if fmt.lfe_out:                           # pipeline emits LFE first
            pcm = torch.cat([pcm[:, :, nfo:], pcm[:, :, :nfo]], dim=2)
        new_delay = delay.clone()
        new_delay[:, :nfo] = dlast[:, :nfo]
        if passthrough:
            # unused planes get the zd of all-zero inputs, exactly 0
            new_delay[:, nfo:5] = 0.0
            flag = torch.zeros_like(downmixed)
        else:
            # planes nf_out..4 stay stale (post-fixup), like the block scan
            new_delay[:, nfo:5] = d0f[:, nfo:]
            flag = torch.ones_like(downmixed)
        if fmt.lfe_out:
            new_delay[:, 5] = dlast[:, nfo]
        return (new_delay, flag), pcm

    return run


def batched_pipeline(fmt: StreamFormat, mesh=None, emit_int16: bool = False,
                     steady: bool = False, long_only: bool = False,
                     premixed: bool = False, pallas: bool | None = None,
                     exact: bool | None = None, *,
                     fused: bool | None = None):
    """Returns fn: (carry, blocks) -> (carry, pcm).

    carry: (delay [B,6,128] f32, downmixed [B] bool) tensors.
    blocks: dict of tensors with leading [B, nblk, ...] axes, on the
    carry's device.
    pcm: [B, nblk, nch_out, 256] float32 (or int16 when emit_int16).

    steady=True selects the scan-free body (valid on chunks that pass
    models.decoder.steady_ok -- checked per call on the host);
    long_only=True additionally skips the short-block transform.
    steady=False selects the block scan (any chunk; full planes).

    exact (default: the package ACCURACY policy; an explicit pallas=True
    is a fast-mode request) selects the order-exact filterbank,
    bit-identical to the reference float build.

    pallas=None (default) sends every eligible chunk through a fused
    kernel: in reference mode every steady premixed chunk through the
    fused order-exact tail (B1F), in fast mode every steady + long_only +
    premixed + int16 chunk through the fused steady kernel (K1).
    pallas=False forces the plain steady body (A/B comparisons);
    pallas=True asks for K1 and asserts its eligibility (so it implies
    fast mode).  The slot is the JAX package's, whose fused kernel is a
    Pallas one; fused= is the port's keyword for the same choice, and
    giving both with different values raises ValueError.

    mesh (parallel.mesh.Mesh): fn splits the lanes of carry and blocks
    over its 'data' axis (operands already placed there stay), runs the
    function above once per data row on that row's device, and returns
    carry and pcm as parallel.mesh.Sharded, split the same way.
    """
    check_mesh(mesh)
    if pallas is not None and fused is not None and \
            bool(pallas) != bool(fused):
        raise ValueError(f"pallas={pallas} and fused={fused} ask for "
                         "different bodies; pass one of them")
    kernel = fused if pallas is None else pallas
    if exact is None:
        exact = False if kernel else default_exact()
    eligible = steady and long_only and premixed and emit_int16 and not exact
    if kernel:
        assert eligible, "the fused kernel requires steady+long_only+" \
                         "premixed+int16 in fast mode"
        run = _fused_run(fmt)
    elif kernel is None and (eligible or (exact and steady and premixed)):
        run = _fused_run(fmt, exact=exact, emit_int16=emit_int16,
                         long_only=long_only)
    else:
        assert steady or not premixed, "the block scan takes full planes"

        def run(carry, blocks):
            blocks = _expand_compact(blocks)
            if steady:
                carry, pcm = _pipeline_steady(fmt, carry, blocks,
                                              long_only=long_only,
                                              premixed=premixed, exact=exact)
            else:
                carry, pcm = _pipeline_body(fmt, carry, blocks, exact=exact)
            if emit_int16:
                pcm = convert_to_int16(pcm)
            return carry, pcm

    return run if mesh is None else over_data(mesh, run)


def raw_batched_pipeline(fmt: StreamFormat, mesh=None,
                         emit_int16: bool = False, steady: bool = False,
                         long_only: bool = False, cpl_fc: int = -1,
                         pallas: bool = False, exp_pts: int = 6,
                         alloc_pts: int = 6, exact: bool | None = None,
                         emax: int = 256):
    """Raw-H2D decode: fn (carry, frames_u8, meta, bias) -> (carry, pcm).

    The host ships raw AC-3 frame bytes [B, F, MB] plus per-block side
    info meta [B, 6F, ...] (tensors on the carry's device); the device
    unpacks exponents, re-runs the bit allocation and dequantizes the
    mantissas (ops.unpack_device.unpack_blocks), then decodes with the
    steady body (steady=True) or the block scan and, when asked, converts
    to int16.  carry = (unpack carry dict, (delay, downmixed)).

    cpl_fc / exp_pts / alloc_pts / emax select the unpack's RowPlan (see
    ops.unpack_device); exact (default: the package ACCURACY policy; an
    explicit pallas=True is a fast-mode request) selects the order-exact
    filterbank.

    A steady chunk of a premixable format (a reducing or an identity mix)
    can be premixed on the device (premix_blocks_device) and decoded by a
    fused tail: pallas=True takes the fused steady kernel (K1, fast mode,
    int16; it asserts steady, long_only, emit_int16, a premixable format
    and not exact), as the JAX package's raw pallas=True body does with
    its Pallas kernel.  Otherwise reference mode takes the fused
    order-exact tail (B1F) on such a chunk and fast mode the plain steady
    body.  mesh: as for batched_pipeline (the unpack carry too is split
    over 'data'); clock is for a one-device step only."""
    check_mesh(mesh)
    if exact is None:
        exact = False if pallas else default_exact()
    premixable = fmt.nf_out < fmt.nfchans or fmt.identity_mix
    tail = None
    if pallas:
        assert not exact, "the raw fused steady tail is a fast-mode body"
        assert steady and long_only and emit_int16 and premixable, \
            "the raw fused steady tail requires steady+long_only+int16 " \
            "and a premixable format"
        tail = _fused_run(fmt)
    elif exact and steady and premixable:
        tail = _fused_run(fmt, exact=True, emit_int16=emit_int16,
                          long_only=long_only)

    def run(carry, frames_u8, meta, bias, clock=None):
        ucarry, dcarry = carry
        ucarry, blocks = unpack_blocks(frames_u8, meta, ucarry, bias,
                                       nfch=fmt.nfchans, cpl_fc=cpl_fc,
                                       exp_pts=exp_pts, alloc_pts=alloc_pts,
                                       emax=emax)
        if clock is not None:
            clock.mark("device unpack")
            clock.kept["blocks"] = blocks
        with _stage("tail", clock, ("steady tail" if steady
                                    else "block scan") + " + int16"):
            if tail is not None:
                dcarry, pcm = tail(dcarry, premix_blocks_device(fmt, blocks))
            else:
                if steady:
                    dcarry, pcm = _pipeline_steady(fmt, dcarry, blocks,
                                                   long_only=long_only,
                                                   exact=exact)
                else:
                    dcarry, pcm = _pipeline_body(fmt, dcarry, blocks,
                                                 exact=exact)
                if emit_int16:
                    pcm = convert_to_int16(pcm)
        return (ucarry, dcarry), pcm

    if mesh is None:
        return run
    sharded = over_data(mesh, run)

    def run_mesh(carry, frames_u8, meta, bias, clock=None):
        if clock is not None:
            raise ValueError("a StageClock breaks down a one-device step; "
                             "pass no clock with a mesh")
        return sharded(carry, frames_u8, meta, bias)

    return run_mesh


class StageClock:
    """Breaks one raw-H2D step into stages (decode_available(clock=...)).

    mark(name) records, under `name`, the host-clock seconds since the
    previous mark, taken after the device has caught up; `kept` holds
    stage outputs for the caller's checks ("blocks": the dequantized
    blocks of unpack_blocks).  Synchronizing serializes the step, so this
    shows where a step's time goes; it does not time the path."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.seconds, self.kept = {}, {}
        self._sync()
        self._t = time.perf_counter()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def mark(self, name: str):
        self._sync()
        now = time.perf_counter()
        self.seconds[name] = now - self._t
        self._t = now


@contextlib.contextmanager
def _stage(name: str, clock: StageClock | None, stage: str):
    """span(name), then clock.mark(stage) when a clock is passed: one site
    for both, so the span and the stage end at the same boundary."""
    with span(name):
        yield
    if clock is not None:
        clock.mark(stage)


def init_batched_carry(batch: int, mesh=None, device=None):
    """Zero OLA delay and downmixed=True per lane: split over the 'data'
    axis of `mesh`, or on `device` (None: the CUDA card; raises without
    one).  The slots are the JAX package's (batch, mesh)."""
    if check_mesh(mesh) is not None:
        if device is not None:
            raise ValueError("pass a mesh or a device, not both")
        return stream_sharding(mesh).put(init_batched_carry(batch,
                                                            device="cpu"))
    device = resolve_device(device)
    delay = torch.zeros((batch, 6, 128), dtype=torch.float32, device=device)
    downmixed = torch.ones((batch,), dtype=torch.bool, device=device)
    return delay, downmixed


# ---------------------------------------------------------------------------
# Tensor-parallel filterbank step: the frequency contraction split over
# 'model', the partial products summed in model order (JAX's psum)
# ---------------------------------------------------------------------------

def tp_filterbank(mesh, coeffs, delay, blksw, bias):
    """The filterbank (ops.filterbank.filterbank) with coeffs [B, C, 256]
    split on the lane axis over 'data' and on the last axis over 'model':
    the device at (data i, model j) multiplies its 256/m frequency rows by
    the same rows of w_long / w_short into a partial [..., 384] product;
    the partials of a data row are summed on its model-0 device in model
    order (the psum); the window and OLA follow there.  delay [B, C, 128],
    blksw [B, C] bool, bias [B, C]: split over 'data'.

    -> (out [B, C, 256], new_delay [B, C, 128]) as parallel.mesh.Sharded.
    The contraction is summed in m pieces, so the result is within a few
    f32 ulps of the one-device filterbank's, not bitwise."""
    if not isinstance(mesh, Mesh):
        raise TypeError("tp_filterbank needs a parallel.mesh.Mesh")
    m = mesh.shape["model"]
    if 256 % m:
        raise ValueError(f"model={m} does not divide the 256 coefficients")
    rows = 256 // m
    c_s, d_s, b_s, bias_s = stream_sharding(mesh).put(
        (coeffs, delay, blksw, bias))
    outs, dnews = [], []
    for i, row in enumerate(mesh.grid):
        partial = []
        for j, dev in enumerate(row):
            w_long, w_short = mats_on(dev)[:2]
            c = c_s.parts[i][..., j * rows:(j + 1) * rows].to(
                dev, non_blocking=True)
            blk = b_s.parts[i].to(dev, non_blocking=True)[..., None]
            partial.append(
                torch.matmul(torch.where(blk, 0.0, c),
                             w_long[j * rows:(j + 1) * rows])
                + torch.matmul(torch.where(blk, c, 0.0),
                               w_short[j * rows:(j + 1) * rows]))
        home = row[0]
        zd = partial[0]
        for p in partial[1:]:
            zd = zd + p.to(home, non_blocking=True)
        _, _, win, win_r = mats_on(home)
        d = d_s.parts[i]
        dfold = torch.cat([d, d.flip(-1)], dim=-1)
        outs.append(zd[..., :256] * win + dfold * win_r
                    + bias_s.parts[i][..., None])
        dnews.append(zd[..., 256:])
    return Sharded(outs, mesh), Sharded(dnews, mesh)


# ---------------------------------------------------------------------------
# Host side: N stream parsers feeding the batched device pipeline
# ---------------------------------------------------------------------------

@dataclass
class StreamLane:
    # parser="python" | "raw_py": the lane's host.parse.A52Parser (None
    # for the native parsers)
    parser: A52Parser | None
    # the bytes fed and not yet dropped (a bytearray, whatever is passed);
    # the parsers read from pos.  feed drops the consumed prefix before it
    # appends, so the buffer holds only what was unconsumed when the lane
    # was last fed, plus that feed
    buf: bytes = b""
    pos: int = 0
    ok: bool = True          # the JAX package's lane-mask slot; unread
    # parsed-but-not-yet-emitted frames (uneven lane feeds leave a
    # remainder here; the next decode_available resumes with it):
    # parser="native" frame slices, "python" FrameData (None: a bad
    # frame), "raw_py" (bytes, recs, fmt) triples.  parser="raw" keeps its
    # remainder as arrays (_raw_chunk)
    pending: list = None

    def __post_init__(self):
        self.buf = bytearray(self.buf)
        if self.pending is None:
            self.pending = []


class BatchedDecoder:
    """N same-format streams -> batched PCM on the device.

    parser="native" (default): the host half is the native dense parser:
    one ctypes call parses every lane (C++ threads, GIL released) and
    emits device-ready planes -- dequantized frequency planes, premixed
    output planes when the chunk qualifies for the steady path.

    parser="raw": the host half is the native side-info parser (it skips
    the mantissas); the coded frame bytes and the per-block side info go
    to the device, which unpacks and dequantizes them itself
    (raw_batched_pipeline).  The lanes must share one format.

    parser="python" and "raw_py": the same two host halves with the Python
    parser (host.parse.A52Parser, one per lane; "raw_py" in its
    sideinfo_only form), frame by frame: the same planes and side info as
    the native parsers, so the same PCM, at the cost of Python per
    coefficient ("python") or per block ("raw_py") on the host.

    Either way the host arrays go to the device with
    torch.from_numpy(...).to(device); PCM comes back as a device tensor.
    With a mesh (parallel.mesh.make_mesh) the host half is still one
    parser over all lanes: its arrays are split over the mesh's 'data'
    axis, each shard's carry lives on its row's device, the device half
    runs once per shard (batched_pipeline(mesh=...)) and PCM comes back as
    a parallel.mesh.Sharded; each lane's PCM is the one-device decoder's.

    A bad frame marks the lane invalid for that frame (its PCM is zeroed)
    instead of failing the batch (a52dec.c:271-306).

    device: None -> the CUDA card (raises without one); "cpu" runs the
    plain PyTorch versions of every kernel; with a mesh, the mesh names
    the devices and device stays None.  fused: see batched_pipeline
    (parser="native" only).

    The positional order is the JAX package's, mesh included.  The
    default parser is "native", where the JAX
    package's is "python": the two parsers emit the same planes, and the
    native one is the throughput path.
    """

    def __init__(self, batch: int, flags: int, level: float = 1.0,
                 bias: float = 0.0, mesh=None, emit_int16: bool = False,
                 parser: str = "native", nthreads=None,
                 compact_h2d: bool = False, device=None,
                 fused: bool | None = None):
        if parser not in ("native", "raw", "python", "raw_py"):
            raise ValueError(f"parser={parser!r}: expected 'native', 'raw', "
                             "'python' or 'raw_py'")
        self.mesh = check_mesh(mesh)
        if mesh is None:
            self.device = resolve_device(device)
        elif device is not None:
            raise ValueError("pass a mesh or a device, not both")
        else:
            self.device = mesh.row_devices[0]
        py = parser in ("python", "raw_py")
        self.lanes = [StreamLane(A52Parser(sideinfo_only=parser == "raw_py")
                                 if py else None) for _ in range(batch)]
        self._parser_kind = parser
        self.flags = flags
        self.level = level
        self.bias = bias
        self.emit_int16 = emit_int16
        # block-float premixed planes over the link: int16 mantissa +
        # per-(block, plane, group) scale, ~2x fewer H2D bytes
        self.compact_h2d = compact_h2d
        self.fused = fused
        # decode_available calls so far: the step of the chunk that the
        # next call makes, which feed's bytes go into (utils.trace spans)
        self.step = 0
        self._fmt = None
        self._carry = init_batched_carry(
            batch, mesh, None if mesh is not None else self.device)
        self._pre_planes = None
        self._dense = self._sdense = None
        if parser == "native":
            self._dense = DenseBatchParser(batch, nthreads)
        elif parser == "raw":
            self._sdense = SideinfoBatchParser(batch, nthreads)
            # parsed-but-not-yet-emitted frames, per lane (see _raw_chunk)
            self._raw_pending = None
            self._raw_npend = np.zeros(batch, np.int64)
        if parser in ("raw", "raw_py"):
            self._raw_carry = self._place(init_unpack_carry(
                batch, "cpu" if mesh is not None else self.device))

    def feed(self, lane: int, data: bytes):
        """Appends data to the lane's stream.  It copies data and, when
        frames were consumed since the last feed, the unconsumed remainder
        that dropping them moves; never a consumed byte."""
        with span("feed", self.step) as on:
            ln = self.lanes[lane]
            moved = 0
            if ln.pos:
                moved = len(ln.buf) - ln.pos
                del ln.buf[:ln.pos]
                ln.pos = 0
            ln.buf += data
            if on is not None:
                count("feed_copied_bytes", len(data) + moved, self.step)

    def decode_available(self, max_frames: int = 8,
                         clock: StageClock | None = None):
        """Parse up to max_frames per lane, run the device pipeline once.

        Returns (pcm [B, nblk, nch, 256] device tensor, or Sharded with a
        mesh; valid [B, nframes] bool numpy) or None if no lane had a
        complete frame.

        clock (parser="raw" | "raw_py" only, no mesh): a StageClock that
        breaks the step into its stages.
        """
        if clock is not None and self.mesh is not None:
            raise ValueError("a StageClock breaks down a one-device step; "
                             "pass no clock with a mesh")
        set_step(self.step)
        self.step += 1
        if self._sdense is not None:
            return self._decode_available_raw_native(max_frames, clock)
        if self._parser_kind == "raw_py":
            return self._decode_available_raw_py(max_frames, clock)
        if clock is not None:
            raise ValueError("StageClock breaks down the raw-H2D step only")
        if self._dense is not None:
            return self._decode_available_native(max_frames)
        return self._decode_available_python(max_frames)

    # -- Python parser paths --------------------------------------------------

    def _next_frame(self, lane: StreamLane):
        """The lane's next whole frame (resyncing byte by byte past junk),
        or None when its buffer holds no complete frame yet."""
        buf, pos = lane.buf, lane.pos
        while pos + 7 <= len(buf):
            size = syncinfo(buf[pos:pos + 7])[0]
            if size == 0:
                pos += 1
                continue
            if pos + size > len(buf):
                break
            lane.pos = pos + size
            return bytes(buf[pos:pos + size])
        lane.pos = pos
        return None

    def _take_pending(self, max_frames: int, parse):
        """Fill each lane's pending list up to max_frames with parse(lane,
        frame) and take the frames every lane has -> per_lane lists, or
        None when some lane has none."""
        for lane in self.lanes:
            while len(lane.pending) < max_frames:
                fb = self._next_frame(lane)
                if fb is None:
                    break
                lane.pending.append(parse(lane, fb))
        nf = min((len(l.pending) for l in self.lanes), default=0)
        if nf == 0:
            return None
        per_lane = [lane.pending[:nf] for lane in self.lanes]
        for lane in self.lanes:
            del lane.pending[:nf]
        return per_lane

    def parser_decode(self, lane: StreamLane, frame: bytes):
        return lane.parser.decode_frame(frame, self.flags, self.level,
                                        self.bias)

    def _parse_python(self, lane: StreamLane, frame: bytes):
        """decode_frame of one lane's frame, or None for a frame the parser
        rejects: the lane-frame is masked (a52dec.c:271-306), the batch
        goes on."""
        try:
            return self.parser_decode(lane, frame)
        except Exception:               # any malformed frame: mask, go on
            log.debug("python parser rejected a frame", exc_info=True)
            return None

    def _empty_frame(self):
        """Silent stand-in for a rejected frame in a homogeneous chunk."""
        z = np.zeros((6, 256), np.float32)
        blk = BlockData(q=z, a=z, b=z, blksw=np.zeros(5, bool),
                        coeff=np.zeros(5, np.float32), chanbias=0,
                        remat_mask=np.zeros(256, bool),
                        lfe_scale=np.float32(0))
        s = self.lanes[0].parser.s
        return FrameData(acmod=s.acmod, lfeon=s.lfeon, output=s.output,
                         nfchans=int(T.NFCHANS[s.acmod]),
                         bias=np.float32(self.bias), slev=s.slev,
                         blocks=[blk] * 6)

    def _decode_available_python(self, max_frames: int):
        per_lane = self._take_pending(max_frames, self._parse_python)
        if per_lane is None:
            return None
        valid = np.array([[f is not None for f in row] for row in per_lane])
        if self._fmt is None and not valid.any():
            # no frame to take a format from yet: the parser state's
            s = self.lanes[0].parser.s
            self._fmt = StreamFormat(
                acmod=s.acmod, output=s.output,
                slev_zero=bool(s.slev == 0.0),
                chanbias=int(downmix_coeff(s.acmod, s.output, 1.0, s.clev,
                                           s.slev)[1]))
        # one format is one bucket; the bucket's padding lanes change no
        # other lane's PCM (every decode body works row by row), so a
        # python chunk equals the native parser's unpadded one bitwise
        return self._decode_heterogeneous(per_lane, valid)

    def _parse_raw(self, lane: StreamLane, frame: bytes):
        """Side-info-only parse of one frame -> (bytes, recs[6], fmt), or
        None for a malformed frame (masked lane-frame)."""
        p = lane.parser
        p.rec.clear()
        try:
            br, _ = p.frame(frame, self.flags, self.level, self.bias)
            for _ in range(T.NB_BLOCKS):
                p._block(br)
            recs = list(p.rec)
        except Exception:               # any malformed frame: mask, go on
            log.debug("python side-info parser rejected a frame",
                      exc_info=True)
            return None
        finally:
            p.rec.clear()
        r0 = recs[0]
        fmt = StreamFormat(acmod=int(r0["acmod"]), output=int(r0["output"]),
                           slev_zero=bool(r0["slev_zero"]),
                           chanbias=int(r0["chanbias"]))
        return frame, recs, fmt

    def _decode_available_raw_py(self, max_frames: int, clock=None):
        """Raw-H2D decode step with the Python side-info parser: the same
        frame bytes and meta as parser="raw" assembles, the same device
        half."""
        with _stage("sideinfo_parse", clock, "host side-info parse"):
            per_lane = self._take_pending(max_frames, self._parse_raw)
        if per_lane is None:
            return None
        with _stage("chunk_assembly", clock, "chunk assembly"):
            L, nf = len(self.lanes), len(per_lane[0])
            valid = np.array([[f is not None for f in row]
                              for row in per_lane])
            fmt = self._raw_pick_fmt({f[2] for row in per_lane for f in row
                                      if f is not None})
            mb = max((len(f[0]) for row in per_lane for f in row
                      if f is not None), default=128)
            mb = max(-(-mb // 128) * 128, 128)
            fu8 = np.zeros((L, nf, mb), np.uint8)
            null6 = [null_raw_rec()] * T.NB_BLOCKS
            metas = []
            for li, row in enumerate(per_lane):
                recs = []
                for fi, f in enumerate(row):
                    if f is None:
                        recs.extend(null6)
                    else:
                        fu8[li, fi, :len(f[0])] = np.frombuffer(f[0],
                                                                np.uint8)
                        recs.extend(f[1])
                metas.append(stack_raw_meta(recs))
            meta = {k: np.stack([m[k] for m in metas]) for k in metas[0]
                    if k != "raw_ok"}
        return self._raw_dispatch(fmt, fu8, meta, valid, clock)

    # -- raw-H2D path (device bitstream unpack) -----------------------------

    def _raw_pick_fmt(self, fmts: set):
        if len(fmts) > 1:
            raise ValueError(
                "raw-H2D mode requires a format-homogeneous batch; use "
                "parser='native' or 'python' for mixed-format lanes")
        if fmts:
            return fmts.pop()
        if self._fmt is not None:
            return self._fmt
        out = self.flags & T.A52_CHANNEL_MASK
        return StreamFormat(acmod=out, output=out, slev_zero=True,
                            chanbias=0)

    # the side-info parser's per-frame arrays, frame axis 1 ("recs" as
    # [L, F, 6] block records)
    _RAW_FRAME_KEYS = ("frames", "fsizes", "valid", "fmt", "recs")

    def _raw_chunk(self, max_frames: int, clock=None):
        """Host half of one raw-H2D step: parse up to max_frames per lane
        with the native side-info pool and assemble the chunk, all lanes
        at once, from each lane's pending frames (an uneven feed leaves
        some) followed by its new ones.

        Returns (fmt, frames_u8 [L, F, MB] uint8, meta {key: [L, 6F, ...]}
        in the wire dtypes, valid [L, F] bool) as numpy arrays, or None if
        no lane had a complete frame."""
        L = len(self.lanes)
        src, npend = self._raw_pending, self._raw_npend
        P = 0 if src is None else src["valid"].shape[1]
        need = max_frames - int(npend.min())
        total = npend
        if need > 0:
            with _stage("sideinfo_parse", clock, "host side-info parse"):
                r = self._sdense.parse([(l.buf, l.pos) for l in self.lanes],
                                       need, self.flags, self.level,
                                       self.bias)
                for i, lane in enumerate(self.lanes):
                    lane.pos += int(r["consumed"][i])
                new = {k: r[k] for k in self._RAW_FRAME_KEYS}
                new["recs"] = new["recs"].reshape(L, need, 6)
                src = new if src is None else {
                    k: np.concatenate([src[k], new[k]], axis=1)
                    for k in self._RAW_FRAME_KEYS}
                total = npend + r["nframes"]
        with _stage("chunk_assembly", clock, "chunk assembly"):
            # lane i's frame j: its pending frame j, else new frame
            # j - npend[i] (with nothing pending, every lane's frame j: a
            # plain slice)
            tmax, nf = int(total.max(initial=0)), int(total.min())
            if P == 0:
                pick = lambda a, lo, hi: a[:, lo:hi]
            else:
                j = np.arange(tmax)
                idx = np.minimum(np.where(j < npend[:, None], j,
                                          P + j - npend[:, None]),
                                 src["valid"].shape[1] - 1)
                lanes = np.arange(L)[:, None]
                pick = lambda a, lo, hi: a[lanes, idx[:, lo:hi]]
            self._raw_pending = None if tmax == nf else {
                k: pick(src[k], nf, tmax) for k in self._RAW_FRAME_KEYS}
            self._raw_npend = total - nf
            if nf == 0:
                return None
            fsizes, fvalid, ffmt, recs = (pick(src[k], 0, nf) for k in
                                          ("fsizes", "valid", "fmt", "recs"))
            ok = (fvalid != 0) & (ffmt[..., 3] != 0)
            fmts = {StreamFormat(acmod=int(a), output=int(o),
                                 slev_zero=bool(z), chanbias=int(c))
                    for a, o, z, c in np.unique(np.stack(
                        [ffmt[..., 0][ok], ffmt[..., 1][ok],
                         ffmt[..., 2][ok], recs[..., 0]["chanbias"][ok]],
                        axis=-1), axis=0)}
            mb = int(np.where(fvalid != 0, fsizes, 0).max(initial=0))
            mb = max(-(-mb // 128) * 128, 128)
            frames_u8 = pick(src["frames"][:, :, :mb], 0, nf)
            recs = recs.reshape(L, 6 * nf)
            meta = {k: np.ascontiguousarray(recs[k])
                    for k in recs.dtype.names}
        return self._raw_pick_fmt(fmts), frames_u8, meta, ok

    @staticmethod
    def _raw_plan(fmt, meta) -> dict:
        """raw_batched_pipeline's plan arguments for one chunk's (numpy,
        pruned) meta, each count the chunk's own."""
        steady = steady_ok(fmt, {"blksw": meta["blksw"].astype(bool),
                                 "coeff": meta["coeff"]})
        return dict(steady=steady,
                    long_only=steady and not meta["blksw"].any(),
                    cpl_fc=static_cpl_fc(meta),
                    exp_pts=static_exp_pts(meta),
                    alloc_pts=static_alloc_pts(meta),
                    emax=static_emax(meta))

    def _decode_available_raw_native(self, max_frames: int, clock=None):
        """Raw-H2D decode step: ship frame bytes + side-info meta, unpack
        and decode everything else on the device."""
        chunk = self._raw_chunk(max_frames, clock)
        if chunk is None:
            return None
        return self._raw_dispatch(*chunk, clock)

    def _raw_dispatch(self, fmt, fu8, meta, valid, clock=None):
        """The device half of a raw-H2D step, from the host's chunk: frame
        bytes fu8 [L, F, MB] uint8 and meta {key: [L, 6F, ...]} (numpy, in
        the wire dtypes)."""
        # drop meta for features absent from the whole chunk (delta bit
        # allocation, coupling, dither, LFE): the plan gets fewer rows, a
        # smaller lattice and no coupling/dither stages, and the dropped
        # arrays never cross the host link
        with _stage("prune_plan", clock, "prune + plan probes"):
            meta = prune_raw_meta(meta)
            fn = raw_batched_pipeline(fmt, self.mesh, self.emit_int16,
                                      **self._raw_plan(fmt, meta))
            L, nf = fu8.shape[:2]
            bias = np.full((L, T.NB_BLOCKS * nf), self.bias, np.float32)
        host = dict(meta, frames_u8=fu8, bias=bias)
        with _stage("h2d", clock, "H2D copy"):
            dev = {k: self._to_device(v) for k, v in host.items()}
        if clock is not None:
            clock.kept["h2d_bytes"] = sum(v.nbytes for v in host.values())
        self._fmt = fmt
        (self._raw_carry, self._carry), pcm = fn(
            (self._raw_carry, self._carry), dev.pop("frames_u8"), dev,
            dev.pop("bias"), clock=clock)
        return pcm, valid

    def _expected_pre_planes(self):
        """Output-plane count for the premixed steady path, derived from the
        next frame header + requested flags.  clev/slev only affect the
        STEREO<->DOLBY promotion, which has the same plane count, so zeros
        suffice for the negotiation here."""
        for lane in self.lanes:
            buf, pos = lane.buf, lane.pos
            while pos + 7 <= len(buf):
                size, sflags, _, _ = syncinfo(buf[pos:pos + 7])
                if size == 0:
                    pos += 1
                    continue
                acmod_in = sflags & T.A52_CHANNEL_MASK
                out, _ = downmix_init(acmod_in, self.flags, 1.0,
                                      np.float32(0.0), np.float32(0.0))
                if out < 0:
                    return 0
                outm = out & T.A52_CHANNEL_MASK
                nf_out = int(T.NFCHANS[outm])
                lfe = 1 if (sflags & T.A52_LFE) and (self.flags & T.A52_LFE) \
                    else 0
                if nf_out < int(T.NFCHANS[acmod_in]):
                    return nf_out + lfe      # reducing mix (freq path)
                if nf_out == int(T.NFCHANS[acmod_in]) and (
                        outm == acmod_in or
                        (acmod_in == T.A52_STEREO and outm == T.A52_DOLBY)):
                    # identity-mix passthrough (chanbias is always 0 for
                    # these pairs): premix = rematrix only
                    return nf_out + lfe
                return 0                     # upmix / non-identity: no premix
        return None                          # no header yet; retry later

    @staticmethod
    def _frame_slice(r, lane: int, f: int) -> dict:
        s = slice(f * 6, f * 6 + 6)
        return {
            "freq_full": r["freq_full"][lane, s],
            "freq_pre": None if r["freq_pre"] is None
            else r["freq_pre"][lane, s],
            "freq_man": None if r.get("freq_man") is None
            else r["freq_man"][lane, s],
            "freq_scale": None if r.get("freq_scale") is None
            else r["freq_scale"][lane, s],
            "blksw": r["blksw"][lane, s],
            "coeff": r["coeff"][lane, s],
            "remat": r["remat"][lane, s],
            "bias": r["bias"][lane, s],
            "valid": bool(r["valid"][lane, f]),
            "premix_ok": bool(r["premix_ok"][lane, f]),
            "meta": (r["meta"][lane, f].copy()
                     if r["meta"][lane, f, 6] else None),
        }

    def _fmt_from_meta(self, meta):
        if meta is not None:
            return StreamFormat(acmod=int(meta[0]), output=int(meta[2]),
                                slev_zero=bool(meta[5]),
                                chanbias=int(meta[4]))
        if self._fmt is not None:
            return self._fmt
        out = self.flags & T.A52_CHANNEL_MASK
        return StreamFormat(acmod=out, output=out, slev_zero=True, chanbias=0)

    @staticmethod
    def _fmt_of(obj):
        """StreamFormat of a pending frame: a native frame slice or a
        Python FrameData; None for an invalid frame."""
        if obj is None:
            return None
        if isinstance(obj, FrameData):
            return frame_format(obj)
        m = obj["meta"]
        if m is None:
            return None
        return StreamFormat(acmod=int(m[0]), output=int(m[2]),
                            slev_zero=bool(m[5]), chanbias=int(m[4]))

    def _place(self, tree):
        """Tensors on the decoder's device, or split over its mesh."""
        if self.mesh is not None:
            return stream_sharding(self.mesh).put(tree)
        return tree

    def _to_device(self, x):
        if self.mesh is not None:
            return stream_sharding(self.mesh).put(x)
        return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _run_native(self, fmt, valid, freq_pre, freq_full, blksw, coeff,
                    remat, bias, premix_all, freq_man=None, freq_scale=None):
        blksw = np.ascontiguousarray(blksw).astype(bool)
        if premix_all:
            if freq_man is not None:
                host = {"freq_man": freq_man, "freq_scale": freq_scale}
            else:
                host = {"freq": freq_pre}
            host.update(blksw=blksw, bias=bias)
            lo = not blksw.any()
            fn = batched_pipeline(fmt, self.mesh, self.emit_int16,
                                  steady=True, long_only=lo, premixed=True,
                                  fused=self.fused)
        else:
            host = {"freq": freq_full, "blksw": blksw, "coeff": coeff,
                    "remat": np.asarray(remat).astype(bool), "bias": bias}
            steady = steady_ok(fmt, host)
            lo = steady and not blksw.any()
            fn = batched_pipeline(fmt, self.mesh, self.emit_int16,
                                  steady=steady, long_only=lo,
                                  fused=self.fused)
        with span("h2d"):
            blocks = {k: self._to_device(v) for k, v in host.items()}
        self._fmt = fmt
        with span("tail"):
            self._carry, pcm = fn(self._carry, blocks)
        return pcm, valid

    def _decode_available_native(self, max_frames: int):
        if self._pre_planes is None:
            self._pre_planes = self._expected_pre_planes()
        pp = self._pre_planes or 0
        had_pending = any(l.pending for l in self.lanes)
        need = max_frames - min(len(l.pending) for l in self.lanes)
        r = None
        if need > 0:
            with span("dense_parse"):
                r = self._dense.parse([(l.buf, l.pos) for l in self.lanes],
                                      need, self.flags, self.level,
                                      self.bias, pp,
                                      compact=self.compact_h2d)
                for i, lane in enumerate(self.lanes):
                    lane.pos += int(r["consumed"][i])
        if r is not None and not had_pending:
            nfr = r["nframes"]
            nf = int(nfr.min())
            if nf > 0 and (nfr == nf).all():
                lane_fmts = {
                    self._fmt_from_meta(r["meta"][i, f])
                    for i in range(len(self.lanes)) for f in range(nf)
                    if r["meta"][i, f, 6]}
                if len(lane_fmts) > 1:
                    # formats differ across lanes or within a lane's
                    # frames: one bucketed call per distinct format
                    emit = [[self._frame_slice(r, i, f) for f in range(nf)]
                            for i in range(len(self.lanes))]
                    valid = r["valid"][:, :nf].astype(bool)
                    return self._decode_heterogeneous(emit, valid)
                # fast path: the parse output is already the batch
                rows = nf * 6
                fmt = (next(iter(lane_fmts)) if lane_fmts
                       else self._fmt_from_meta(None))
                valid = r["valid"][:, :nf].astype(bool)
                premix_all = (pp > 0
                              and (fmt.nf_out < fmt.nfchans
                                   or fmt.identity_mix)
                              and bool(r["premix_ok"][:, :nf].all()))
                compact = premix_all and r["freq_man"] is not None
                return self._run_native(
                    fmt, valid,
                    None if r["freq_pre"] is None else r["freq_pre"][:, :rows],
                    r["freq_full"][:, :rows], r["blksw"][:, :rows],
                    r["coeff"][:, :rows], r["remat"][:, :rows],
                    r["bias"][:, :rows], premix_all,
                    freq_man=r["freq_man"][:, :rows] if compact else None,
                    freq_scale=r["freq_scale"][:, :rows] if compact else None)
        if r is not None:
            for i, lane in enumerate(self.lanes):
                for f in range(int(r["nframes"][i])):
                    lane.pending.append(self._frame_slice(r, i, f))
        nf = min((len(l.pending) for l in self.lanes), default=0)
        if nf == 0:
            return None
        emit = [l.pending[:nf] for l in self.lanes]
        for lane in self.lanes:
            del lane.pending[:nf]
        valid = np.array([[fr["valid"] for fr in frames] for frames in emit])
        emit_fmts = {self._fmt_of(fr) for frames in emit for fr in frames
                     if fr["meta"] is not None}
        if len(emit_fmts) > 1:
            return self._decode_heterogeneous(emit, valid)
        meta = next((fr["meta"] for frames in emit for fr in frames
                     if fr["meta"] is not None), None)
        fmt = self._fmt_from_meta(meta)
        premix_all = (pp > 0
                      and (fmt.nf_out < fmt.nfchans or fmt.identity_mix)
                      and all(fr["premix_ok"] and fr["freq_pre"] is not None
                              for frames in emit for fr in frames))
        cat = lambda key: np.stack(
            [np.concatenate([fr[key] for fr in frames]) for frames in emit])
        compact = premix_all and all(
            fr.get("freq_man") is not None
            for frames in emit for fr in frames)
        return self._run_native(
            fmt, valid,
            cat("freq_pre") if premix_all and not compact else None,
            None if premix_all else cat("freq_full"),
            cat("blksw"), None if premix_all else cat("coeff"),
            None if premix_all else cat("remat"), cat("bias"), premix_all,
            freq_man=cat("freq_man") if compact else None,
            freq_scale=cat("freq_scale") if compact else None)

    # -- mixed-format batches ------------------------------------------------

    def _blank(self, nplanes: int, premixed: bool) -> dict:
        """Silent long blocks of one frame: a pad lane's (its coefficients
        count as coded: a zero coeff would fail steady_ok and send the
        whole bucket to the block scan), or a rejected frame's premixed
        planes."""
        blank = {"freq": np.zeros((6, nplanes, 256), np.float32),
                 "blksw": np.zeros((6, 5), bool),
                 "bias": np.full((6,), np.float32(self.bias))}
        if not premixed:
            blank.update(coeff=np.ones((6, 5), np.float32),
                         remat=np.zeros((6, 256), bool))
        return blank

    def _generic_blocks(self, obj):
        """Full-plane [6, ...] block arrays of one frame: a native frame
        slice, a Python FrameData, or None (a rejected frame: silence with
        zero coefficients, what the native parser writes for one)."""
        if obj is None:
            obj = self._empty_frame()
        if isinstance(obj, FrameData):
            return _stack_blocks([obj])
        return {"freq": obj["freq_full"], "blksw": obj["blksw"].astype(bool),
                "coeff": obj["coeff"], "remat": obj["remat"].astype(bool),
                "bias": obj["bias"]}

    def _premixed_frame(self, obj, fmt):
        """Premixed [6, nch_out, 256] block arrays of one frame, or None
        when the frame carries no premix for `fmt`: a Python FrameData
        (premixed per bucket, if steady, by premix_blocks), an ineligible
        native frame, or a plane count from another format.  A rejected
        frame (None) takes silent planes."""
        if obj is None:
            return self._blank(fmt.nch_out, premixed=True)
        if isinstance(obj, FrameData) or not obj.get("premix_ok"):
            return None
        fp = obj.get("freq_pre")
        if fp is None or fp.shape[-2] != fmt.nch_out:
            return None
        return {"freq": fp, "blksw": obj["blksw"].astype(bool),
                "bias": obj["bias"]}

    def _bucket_size(self, nsel: int) -> int:
        """A bucket's lane count: the next power of two, so that a mixed
        stream reuses a few batch shapes (and the allocator's blocks for
        them) instead of one per lane count; with a mesh, rounded up to a
        multiple of its device count so that every bucket splits evenly
        over 'data'."""
        b = 1 << max(nsel - 1, 0).bit_length()
        if self.mesh is not None:
            nd = self.mesh.size
            b = -(-max(b, nd) // nd) * nd
        return b

    def _decode_heterogeneous(self, per_lane, valid):
        """Decode frames whose formats differ across lanes or within a
        lane: per_lane[lane] = that lane's frame slices (one chunk).

        The chunk is cut into segments, maximal runs of frames in which
        every lane keeps its format (without a mid-stream change: one
        segment).  In each segment the lanes are gathered into one bucket
        per format, padded to _bucket_size, and each bucket takes the
        dispatch a homogeneous batch of its format would (premixed or full
        planes, steady or block scan).  The carries are gathered and
        scattered by lane index on the device, so a lane's OLA state
        survives a change of format as the reference's single a52_state_t
        does; PCM lands in one device buffer of the widest layout.  With a
        mesh (a bucket's lanes come from every shard) the carries and the
        PCM are gathered to the host for the chunk, as the JAX package
        keeps them there, each bucket runs split over 'data', and both are
        split over the mesh again at the end.
        -> (pcm [B, 6 * nf, nch_max, 256] device tensor or Sharded,
        valid)."""
        B = len(self.lanes)
        nf = len(per_lane[0])
        fmts = []
        for row in per_lane:
            lane_fmts, prev = [], self._fmt
            for f in row:
                cur = self._fmt_of(f)
                if cur is None:         # an invalid frame keeps the format
                    cur = prev or next(
                        self._fmt_of(g) for r2 in per_lane for g in r2
                        if self._fmt_of(g) is not None)
                lane_fmts.append(cur)
                prev = cur
            fmts.append(lane_fmts)
        nch_max = max(f.nch_out for row in fmts for f in row)
        dtype = torch.int16 if self.emit_int16 else torch.float32
        mesh = self.mesh
        home = self.device if mesh is None else torch.device("cpu")
        out = torch.zeros((B, nf * 6, nch_max, 256), dtype=dtype,
                          device=home)
        if mesh is None:
            d_all, m_all = (t.clone() for t in self._carry)
        else:
            d_all, m_all = stream_sharding(mesh).gather(self._carry, home)
        catframes = lambda frames: {k: np.concatenate([f[k] for f in frames])
                                    for k in frames[0]}
        seg0 = 0
        while seg0 < nf:
            key = [fmts[li][seg0] for li in range(B)]
            seg1 = seg0 + 1
            while seg1 < nf and all(fmts[li][seg1] == key[li]
                                    for li in range(B)):
                seg1 += 1
            frames = range(seg0, seg1)
            groups = {}
            for li in range(B):
                groups.setdefault(key[li], []).append(li)
            for fmt, sel in groups.items():
                pad = self._bucket_size(len(sel)) - len(sel)
                # premixed bucket: every frame carries a native premix for
                # this format (pad lanes: zero planes)
                pres = [[self._premixed_frame(per_lane[li][fi], fmt)
                         for fi in frames] for li in sel]
                premixed = ((fmt.nf_out < fmt.nfchans or fmt.identity_mix)
                            and all(p is not None for r2 in pres for p in r2))
                blank = self._blank(fmt.nch_out if premixed else 6, premixed)
                if premixed:
                    rows = [catframes(r2) for r2 in pres]
                else:
                    rows = [catframes([self._generic_blocks(per_lane[li][fi])
                                       for fi in frames]) for li in sel]
                rows += [catframes([blank] * len(frames))] * pad
                blocks = {k: np.stack([r2[k] for r2 in rows])
                          for k in rows[0]}
                lo = not blocks["blksw"].any()
                if premixed:
                    fn = batched_pipeline(fmt, mesh, self.emit_int16,
                                          steady=True, long_only=lo,
                                          premixed=True, fused=self.fused)
                elif steady_ok(fmt, blocks):
                    pre = fmt.nf_out < fmt.nfchans or fmt.identity_mix
                    if pre:
                        blocks = premix_blocks(fmt, blocks)
                        blocks = {k: blocks[k]
                                  for k in ("freq", "blksw", "bias")}
                    fn = batched_pipeline(fmt, mesh, self.emit_int16,
                                          steady=True, long_only=lo,
                                          premixed=pre, fused=self.fused)
                else:
                    fn = batched_pipeline(fmt, mesh, self.emit_int16,
                                          fused=self.fused)
                idx = torch.tensor(sel, device=home)
                dg, mg = d_all[idx], m_all[idx]
                if pad:
                    dg = torch.cat([dg, dg.new_zeros((pad, 6, 128))])
                    mg = torch.cat([mg, mg.new_ones((pad,))])
                (dg, mg), pcm = fn((dg, mg), {k: self._to_device(v)
                                              for k, v in blocks.items()})
                if mesh is not None:
                    dg, mg, pcm = stream_sharding(mesh).gather(
                        (dg, mg, pcm), home)
                d_all[idx] = dg[:len(sel)]
                m_all[idx] = mg[:len(sel)]
                out[idx, seg0 * 6:seg1 * 6, :fmt.nch_out] = \
                    pcm[:len(sel)].to(dtype)
                self._fmt = fmt
            seg0 = seg1
        self._carry = self._place((d_all, m_all))
        return self._place(out), valid
