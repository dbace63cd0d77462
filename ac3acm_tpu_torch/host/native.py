"""ctypes bindings for the native host pre-pass (native/ac3host.cpp).

The port keeps its own copy of the C++ host runtime and builds it at
first use (g++ -O3) into ``native/build/``, installs the generated tables
from this package's ``tables`` module, and exposes the two multi-lane
parse pools that feed ``parallel.pipeline.BatchedDecoder``: the dense
parser (``parser="native"``) and the side-info parser (``parser="raw"``).  ctypes
releases the GIL during calls, and the C++ side fans lanes out over its
own threads.  For one stream it has the per-stream parser
(``NativeParser``, the same ``decode_frame`` planes as host.parse.A52Parser)
and the full native CPU decoder (``NativeDecoder``: parse, the bit-exact
filterbank and the mixer, float for float the reference decoder), which
the a52 API decodes through; and the fixed-point and double sample types
(``SampleDecoder``), whose fixed device backend runs the native
parse-only pre-pass here and the filterbank on the card.
"""
from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess
import threading
import time

import numpy as np

from .. import tables as T
from ..utils.trace import count

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SOURCES = ("ac3host.cpp", "ac3sample.inc", "ac3fb.inc")
# -fno-gnu-unique: the function-local statics of the sample-type
# templates (TDec<...>::tables()) stay this library's own; as GNU unique
# symbols they would bind to another copy of the same C++ loaded in the
# process first (the JAX package's, in the tests), tables and all
_FLAGS = ["-O3", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17",
          "-pthread", "-fno-gnu-unique"]

_lock = threading.Lock()
_lib = None

# block-float scale groups per premixed plane (16 bins each); must match
# native/ac3host.cpp PRE_GROUPS
PRE_GROUPS = 16

# a52_dynrng user-callback signature: float fn(float range, void* data)
DYNRNG_CB = C.CFUNCTYPE(C.c_float, C.c_float, C.c_void_p)


class FrameOut(C.Structure):
    """native/ac3host.cpp FrameOut: one parsed frame's dense block arrays."""
    _fields_ = [
        ("q", C.c_float * 256 * 6 * 6),
        ("a", C.c_float * 256 * 6 * 6),
        ("b", C.c_float * 256 * 6 * 6),
        ("blksw", C.c_uint8 * 5 * 6),
        ("coeff", C.c_float * 5 * 6),
        ("remat", C.c_uint8 * 256 * 6),
        ("chanbias", C.c_int32),
        ("acmod", C.c_int32),
        ("lfeon", C.c_int32),
        ("output", C.c_int32),
        ("nfchans", C.c_int32),
        ("slev", C.c_float),
        ("bias", C.c_float),
    ]


def _build_dir() -> str:
    """Where the compiled library goes: ``native/build`` beside the sources
    when the package is writable (a source checkout), else a per-user
    cache (an install into read-only site-packages)."""
    if os.access(_NATIVE_DIR, os.W_OK):
        return os.path.join(_NATIVE_DIR, "build")
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "ac3acm_tpu_torch", "native-build")


def _src_digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_NATIVE_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def _build() -> str:
    """Compile the host library unless a build of these exact sources
    exists.  The file name carries the content hash, so a stale binary is
    never loaded; the compiler writes a private temporary name that is
    renamed into place, so concurrent first uses (test workers) are safe."""
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"libac3host-{_src_digest()[:16]}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *_FLAGS,
                        os.path.join(_NATIVE_DIR, "ac3host.cpp"), "-o", tmp],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, so)
    return so


def _i32(x):
    return np.ascontiguousarray(x, dtype=np.int32)


def get_lib():
    """The host library, built and loaded at the first call, whose seconds
    go to the counter lib_load_s (utils.trace)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        lib = C.CDLL(_build())
        lib.ac3h_new.restype = C.c_void_p
        lib.ac3h_free.argtypes = [C.c_void_p]

        f32 = lambda x: np.ascontiguousarray(x, dtype=np.float32)
        args = [
            _i32(T.LATAB), _i32(T.HTH), np.ascontiguousarray(T.BAPTAB, np.int8),
            _i32(T.BNDTAB), _i32(T.BNDSZ), _i32(T.MASKTAB),
            f32(T.SCALE_FACTOR), f32(T.Q_1_0), f32(T.Q_1_1), f32(T.Q_1_2),
            f32(T.Q_2_0), f32(T.Q_2_1), f32(T.Q_2_2), f32(T.Q_3),
            f32(T.Q_4_0), f32(T.Q_4_1), f32(T.Q_5),
            np.ascontiguousarray(T.dither_lut(), np.uint16),
            _i32(T.SDECAYTAB), _i32(T.FDECAYTAB), _i32(T.SGAINTAB),
            _i32(T.DBKNEETAB), _i32(T.FLOORTAB), _i32(T.FGAINTAB),
            np.ascontiguousarray(T.EXP_1, np.int8),
            np.ascontiguousarray(T.EXP_2, np.int8),
            np.ascontiguousarray(T.EXP_3, np.int8),
            _i32(T.CPL_BNDTAB), _i32(T.BAP_BITS),
        ]
        lib._table_refs = args                  # keep alive
        lib.ac3h_init.restype = None
        lib.ac3h_init.argtypes = [C.c_void_p] * len(args)
        lib.ac3h_init(*[a.ctypes.data for a in args])
        _bind_single(lib)
        _bind_sample(lib)
        _bind_dense(lib)
        _bind_sideinfo(lib)
        _lib = lib
        count("lib_load_s", time.perf_counter() - t0)
        return lib


# ---------------------------------------------------------------------------
# One stream: the native parser and the native CPU decoder
# ---------------------------------------------------------------------------

def _bind_single(lib):
    lib.ac3h_set_drc.restype = None
    lib.ac3h_set_drc.argtypes = [C.c_void_p, C.c_int]
    lib.ac3h_frames.restype = C.c_int
    lib.ac3h_frames.argtypes = [C.c_void_p, C.c_char_p, C.c_int64, C.c_int,
                                C.c_int, C.c_float, C.c_float,
                                C.POINTER(FrameOut), C.POINTER(C.c_int32)]
    lib.ac3h_dec_new.restype = C.c_void_p
    lib.ac3h_dec_free.restype = None
    lib.ac3h_dec_free.argtypes = [C.c_void_p]
    lib.ac3h_dec_set_drc.restype = None
    lib.ac3h_dec_set_drc.argtypes = [C.c_void_p, C.c_int]
    lib.ac3h_dec_set_dynrng_call.restype = None
    lib.ac3h_dec_set_dynrng_call.argtypes = [C.c_void_p, DYNRNG_CB,
                                             C.c_void_p]
    lib.ac3h_dec_frame.restype = C.c_int
    lib.ac3h_dec_frame.argtypes = [C.c_void_p, C.c_char_p, C.c_int,
                                   C.c_float, C.c_float,
                                   C.POINTER(C.c_float),
                                   C.POINTER(C.c_int32)]


class NativeParser:
    """Per-stream native parser: the same planes as host.parse.A52Parser's
    decode_frame (the two are held equal in the tests)."""

    def __init__(self):
        self.lib = get_lib()
        self._p = self.lib.ac3h_new()

    def __del__(self):
        if getattr(self, "_p", None):
            self.lib.ac3h_free(self._p)
            self._p = None

    def set_drc_enabled(self, enabled: bool):
        self.lib.ac3h_set_drc(self._p, int(enabled))

    def decode_frames_raw(self, buf: bytes, nframes: int, flags: int,
                          level: float = 1.0, bias: float = 0.0):
        """Parse up to nframes from buf.  Returns (n, FrameOut array)."""
        outs = (FrameOut * nframes)()
        sizes = (C.c_int32 * nframes)()
        n = self.lib.ac3h_frames(self._p, buf, len(buf), nframes, flags,
                                 level, bias, outs, sizes)
        return n, outs

    def decode_frames(self, buf: bytes, nframes: int, flags: int,
                      level: float = 1.0, bias: float = 0.0):
        """Parse and return stacked block arrays.

        Returns (blocks dict with [nblk, ...] arrays, meta dict of the last
        frame's format) or None when no frame parsed."""
        n, outs = self.decode_frames_raw(buf, nframes, flags, level, bias)
        if n == 0:
            return None
        view = np.ctypeslib.as_array(outs)[:n]      # structured array view
        # dequantized on the host: (q*a)*b in f32, the device's own product
        q = view["q"].reshape(n * 6, 6, 256)
        a = view["a"].reshape(n * 6, 6, 256)
        b = view["b"].reshape(n * 6, 6, 256)
        blocks = {
            "freq": (q * a) * b,
            "blksw": view["blksw"].reshape(n * 6, 5).astype(bool),
            "coeff": view["coeff"].reshape(n * 6, 5).copy(),
            "remat": view["remat"].reshape(n * 6, 256).astype(bool),
            "bias": np.repeat(view["bias"], 6).astype(np.float32),
        }
        meta = {
            "acmod": int(view["acmod"][-1]),
            "lfeon": int(view["lfeon"][-1]),
            "output": int(view["output"][-1]),
            "nfchans": int(view["nfchans"][-1]),
            "slev": float(view["slev"][-1]),
            "chanbias": int(view["chanbias"][-1]),
        }
        return blocks, meta


class NativeDecoder:
    """The full native CPU decode: parse, the bit-exact filterbank and the
    mixer, float for float the reference decoder (built with
    -ffp-contract=off, so every f32 product rounds as there).  The a52 API
    decodes through it, and the tests and chip_smoke.py hold the device
    decode to it."""

    def __init__(self):
        self.lib = get_lib()
        self._d = self.lib.ac3h_dec_new()
        self._dyncb = None

    def __del__(self):
        if getattr(self, "_d", None):
            self.lib.ac3h_dec_free(self._d)
            self._d = None

    def set_drc_enabled(self, enabled: bool):
        self.lib.ac3h_dec_set_drc(self._d, int(enabled))

    def set_dynrng_call(self, fn):
        """a52_dynrng callback (liba52 parse.c:207-216): fn(range) -> new
        range, applied before the level scale; None clears it.  The ctypes
        callback is kept on the object while the native side may call it."""
        if fn is None:
            self._dyncb = DYNRNG_CB()          # NULL function pointer
        else:
            self._dyncb = DYNRNG_CB(lambda r, _data: float(fn(r)))
        self.lib.ac3h_dec_set_dynrng_call(self._d, self._dyncb, None)

    def decode_stream(self, es: bytes, flags: int, level: float = 1.0,
                      bias: float = 0.0):
        """Returns float32 [nblk, nch_out, 256] planar PCM."""
        out_blocks = []
        pcm = np.zeros((6, 6, 256), np.float32)
        nch = C.c_int32(0)
        for frame in _frames(es):
            r = self.lib.ac3h_dec_frame(
                self._d, frame, flags, level, bias,
                pcm.ctypes.data_as(C.POINTER(C.c_float)), C.byref(nch))
            if r == 0:
                n = int(nch.value)
                out_blocks.append(
                    pcm.reshape(-1)[: 6 * n * 256].reshape(6, n, 256).copy())
        if not out_blocks:
            return np.zeros((0, 0, 256), np.float32)
        return np.concatenate(out_blocks, axis=0)


def _bind_sample(lib):
    lib.ac3h_sdec_new.restype = C.c_void_p
    lib.ac3h_sdec_new.argtypes = [C.c_int]
    lib.ac3h_sdec_free.restype = None
    lib.ac3h_sdec_free.argtypes = [C.c_void_p, C.c_int]
    lib.ac3h_sdec_set_drc.restype = None
    lib.ac3h_sdec_set_drc.argtypes = [C.c_void_p, C.c_int, C.c_int]
    for name, ct in (("ac3h_sdec_frame_fixed", C.c_int32),
                     ("ac3h_sdec_frame_double", C.c_double)):
        fn = getattr(lib, name)
        fn.restype = C.c_int
        fn.argtypes = [C.c_void_p, C.c_char_p, C.c_int, C.c_double,
                       C.c_double, C.POINTER(ct), C.POINTER(C.c_int32)]
    lib.ac3h_sdec_parse_fixed.restype = C.c_int
    lib.ac3h_sdec_parse_fixed.argtypes = [
        C.c_void_p, C.c_char_p, C.c_int, C.c_double,
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p]


class SampleDecoder:
    """The LIBA52_FIXED / LIBA52_DOUBLE sample types (include/a52.h:27-36).

    NativeDecoder is the float build; this decodes in the int32 Q30 fixed
    build or the double build (native/ac3sample.inc templates the C++ over
    the arithmetic traits the reference expresses as macros,
    a52_internal.h:124-163).

    backend="device" (the default; kind="fixed" only): the native
    parse-only pre-pass (ac3h_sdec_parse_fixed: dequantized Q30 planes,
    rematrixed) on the host, then models.decoder.fixed_block_pipeline on
    `device` a frame at a time (None: the CUDA card, raising without one,
    where each frame is one launch of kernel B1QS; "cpu" runs its plain
    PyTorch version), bit for bit the native fixed backend.
    backend="native": the whole decode in C++ on the host, either kind.
    The JAX package names its device backend "tpu"; here that name raises.
    kind="double" stays a host backend, as in the JAX package (no double
    arithmetic on the device path), so it needs backend="native".

    >>> d = SampleDecoder("fixed")                 # on the card
    >>> pcm = d.decode_stream(es, T.A52_STEREO)    # int32 Q30 planar
    """

    _KINDS = {"fixed": (0, np.int32), "double": (1, np.float64)}

    def __init__(self, kind: str, backend: str = "device", device=None):
        if kind not in self._KINDS:
            raise ValueError(f"kind must be fixed|double, got {kind!r}")
        if backend == "tpu":
            raise ValueError("backend 'tpu' is the JAX package's name; the "
                             "device backend here is backend='device'")
        if backend not in ("native", "device"):
            raise ValueError(f"backend must be native|device, got "
                             f"{backend!r}")
        if backend == "device" and kind != "fixed":
            raise ValueError("backend='device' supports kind='fixed' only; "
                             "the double build is a host backend: pass "
                             "backend='native'")
        from ..utils.device import resolve_device
        self.device = (resolve_device(device) if backend == "device"
                       else None)
        self.kind = kind
        self.backend = backend
        self._k, self._np = self._KINDS[kind]
        self.lib = get_lib()
        self._d = self.lib.ac3h_sdec_new(self._k)
        self._frame_fn = (self.lib.ac3h_sdec_frame_fixed if self._k == 0
                          else self.lib.ac3h_sdec_frame_double)
        self._ct = C.c_int32 if self._k == 0 else C.c_double
        self._dev_carry = None
        self._dev_buffers = None

    def __del__(self):
        if getattr(self, "_d", None):
            self.lib.ac3h_sdec_free(self._d, self._k)
            self._d = None

    def set_drc_enabled(self, enabled: bool):
        self.lib.ac3h_sdec_set_drc(self._d, self._k, int(enabled))

    def decode_stream(self, es: bytes, flags: int, level=None, bias=None):
        """-> planar [nblk, nch_out, 256] numpy in the kind's sample type
        (int32 Q30 or float64).

        The default level and bias follow the reference CLI's sinks: fixed
        1<<26 and 0 (audio_out_internal.h:30-32), double 1.0 and 0.0."""
        if level is None:
            level = float(1 << 26) if self._k == 0 else 1.0
        if bias is None:
            bias = 0.0
        if self.backend == "device":
            return self._decode_stream_device(es, flags, level)
        out_blocks = []
        pcm = np.zeros((6, 6, 256), self._np)
        nch = C.c_int32(0)
        for frame in _frames(es):
            r = self._frame_fn(self._d, frame, flags, level, bias,
                               pcm.ctypes.data_as(C.POINTER(self._ct)),
                               C.byref(nch))
            if r == 0:
                n = int(nch.value)
                out_blocks.append(
                    pcm.reshape(-1)[: 6 * n * 256].reshape(6, n, 256).copy())
        if not out_blocks:
            return np.zeros((0, 0, 256), self._np)
        return np.concatenate(out_blocks, axis=0)

    def _device_buffers(self):
        """The device path's buffers, made once a decoder: the parse's
        output arrays, tensor views of the three that go to the device
        each frame, and the constant remat and bias already there."""
        if self._dev_buffers is None:
            import torch
            dev = self.device
            arrays = {"freq": np.zeros((6, 6, 256), np.int32),
                      "blksw": np.zeros((6, 5), np.uint8),
                      "czero": np.zeros((6, 5), np.uint8),
                      "coeff": np.zeros((6, 5), np.float32),
                      "meta": np.zeros(6, np.int32)}
            views = {"freq": torch.from_numpy(arrays["freq"]),
                     "blksw": torch.from_numpy(arrays["blksw"]).view(
                         torch.bool),
                     "coeff": torch.from_numpy(arrays["coeff"])}
            const = {"remat": torch.zeros((6, 256), dtype=torch.bool,
                                          device=dev),
                     "bias": torch.zeros(6, dtype=torch.int32, device=dev)}
            args = [C.c_void_p(arrays[k].ctypes.data)
                    for k in ("freq", "blksw", "czero", "meta")]
            self._dev_buffers = arrays, views, const, args
        return self._dev_buffers

    def _decode_stream_device(self, es: bytes, flags: int, level: float):
        """LIBA52_FIXED on the device: the native parse-only pre-pass
        (dequantize to Q30, rematrix), then the int32 filterbank and
        downmix (models.decoder.fixed_block_pipeline: one B1QS launch a
        frame on the card) a frame at a time, as in the JAX package, the
        carry on the device between frames and calls; bit for bit the
        native fixed backend.  The host work a frame is the parse, one
        subtract into the coefficient flags and three copies straight to
        the device; the PCM comes back in one copy at the end."""
        import torch
        from ..models.decoder import (StreamFormat, fixed_block_pipeline,
                                      init_fixed_carry)
        dev = self.device
        arrays, views, const, args = self._device_buffers()
        czero, coeff, meta = arrays["czero"], arrays["coeff"], arrays["meta"]
        if self._dev_carry is None:
            self._dev_carry = init_fixed_carry(dev)
        outs = []
        for frame in _frames(es):
            if self.lib.ac3h_sdec_parse_fixed(self._d, frame, flags, level,
                                              *args) != 0:
                continue
            np.subtract(np.float32(1), czero, out=coeff)
            fmt = StreamFormat(acmod=int(meta[0]), output=int(meta[1]),
                               slev_zero=bool(meta[3]),
                               chanbias=int(meta[2]))
            # a CPU device shares the parser's buffers, which the next
            # parse rewrites only after this frame's (synchronous) decode
            blocks = {k: v.to(dev) for k, v in views.items()}
            self._dev_carry, pcm = fixed_block_pipeline(fmt)(
                self._dev_carry, {**blocks, **const})
            outs.append(pcm)
        if not outs:
            return np.zeros((0, 0, 256), self._np)
        return torch.cat(outs).cpu().numpy()


def _frames(es: bytes):
    """The frames of an elementary stream, resynced byte by byte; a frame
    cut short at the end is left out."""
    from .parse import syncinfo
    pos = 0
    while pos + 7 <= len(es):
        size = syncinfo(es[pos:pos + 7])[0]
        if size == 0:
            pos += 1
            continue
        if pos + size > len(es):
            return
        yield es[pos:pos + size]
        pos += size


# ---------------------------------------------------------------------------
# Dense multi-lane parse pool: the host half of the end-to-end pipeline
# ---------------------------------------------------------------------------

def _bind_dense(lib):
    lib.ac3h_parse_many.restype = None
    lib.ac3h_parse_many.argtypes = [
        C.POINTER(C.c_void_p), C.c_int,                    # parsers, nlanes
        C.POINTER(C.c_void_p), C.POINTER(C.c_int64),       # bufs, lens
        C.c_int, C.c_int, C.c_float, C.c_float, C.c_int,   # maxframes flags level bias pre_planes
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,    # freq_full freq_pre pre_man pre_scale
        C.c_void_p, C.c_void_p,                            # blksw coeff
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,    # remat biasv valid premix_ok
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_int,       # meta consumed nframes nthreads
    ]


class DenseBatchParser:
    """N independent native stream parsers -> one batched dense-tensor call.

    The whole batch is parsed in a single ctypes call (GIL released); the
    C++ side dequantizes ((q*a)*b in f32) and, when a frame qualifies for
    the steady frequency-domain path, premixes the output planes with the
    shared mixer byte-code.  Lanes fan out over native threads.

    parse() returns a dict of numpy arrays shaped [nlanes, maxframes*6, ...]
    plus per-lane frame counts and consumed byte counts.
    """

    def __init__(self, nlanes: int, nthreads: int | None = None):
        self.lib = get_lib()
        self._parsers = [self.lib.ac3h_new() for _ in range(nlanes)]
        self.nlanes = nlanes
        if nthreads is None:
            nthreads = min(nlanes, os.cpu_count() or 1)
        self.nthreads = nthreads

    def __del__(self):
        for p in getattr(self, "_parsers", []):
            self.lib.ac3h_free(p)
        self._parsers = []

    def parse(self, bufs, maxframes: int, flags: int, level: float = 1.0,
              bias: float = 0.0, pre_planes: int = 0,
              compact: bool = False):
        """bufs: list of (bytes-like, offset) or bytes-like per lane.

        compact=True additionally emits the premixed planes in block-float
        form -- int16 mantissas ("freq_man") + one f32 scale per
        (block, plane, 16-bin group) ("freq_scale"), freq = man * scale --
        halving the bytes the decode pipeline ships to the device."""
        L, R = self.nlanes, maxframes * 6
        assert len(bufs) == L
        freq_full = np.empty((L, R, 6, 256), np.float32)
        freq_pre = (np.empty((L, R, pre_planes, 256), np.float32)
                    if pre_planes else None)
        pre_man = (np.empty((L, R, pre_planes, 256), np.int16)
                   if pre_planes and compact else None)
        pre_scale = (np.empty((L, R, pre_planes, PRE_GROUPS), np.float32)
                     if pre_planes and compact else None)
        blksw = np.empty((L, R, 5), np.uint8)
        coeff = np.empty((L, R, 5), np.float32)
        remat = np.empty((L, R, 256), np.uint8)
        biasv = np.empty((L, R), np.float32)
        valid = np.empty((L, maxframes), np.uint8)
        premix_ok = np.empty((L, maxframes), np.uint8)
        meta = np.zeros((L, maxframes, 8), np.int32)   # per-frame format
        consumed = np.zeros(L, np.int64)
        nframes = np.zeros(L, np.int32)

        views = []                        # keep buffer views alive
        pbuf = (C.c_void_p * L)()
        plen = (C.c_int64 * L)()
        for i, b in enumerate(bufs):
            off = 0
            if isinstance(b, tuple):
                b, off = b
            v = np.frombuffer(b, np.uint8)
            views.append(v)
            pbuf[i] = C.c_void_p(v.ctypes.data + off)
            plen[i] = len(b) - off
        pp = (C.c_void_p * L)(*self._parsers)

        addr = lambda a: C.c_void_p(0 if a is None else a.ctypes.data)
        self.lib.ac3h_parse_many(
            pp, L, pbuf, plen, maxframes, flags, level, bias, pre_planes,
            addr(freq_full), addr(freq_pre), addr(pre_man),
            addr(pre_scale), addr(blksw), addr(coeff),
            addr(remat), addr(biasv), addr(valid), addr(premix_ok),
            addr(meta), addr(consumed), addr(nframes), self.nthreads)
        return {
            "freq_full": freq_full, "freq_pre": freq_pre,
            "freq_man": pre_man, "freq_scale": pre_scale,
            "blksw": blksw, "coeff": coeff, "remat": remat, "bias": biasv,
            "valid": valid, "premix_ok": premix_ok, "meta": meta,
            "consumed": consumed, "nframes": nframes,
        }


# ---------------------------------------------------------------------------
# Raw-H2D side-info parse pool: the host half of BatchedDecoder(parser="raw")
# -- frame bytes + per-block side-info records out, mantissa walk skipped
# (the device unpacks mantissas itself, ops.unpack_device).
# ---------------------------------------------------------------------------

# numpy mirror of native/ac3host.cpp RawRecWire (#pragma pack(1)); field
# names match ops.unpack_device's meta keys, each in its narrow wire dtype
RAW_REC_DTYPE = np.dtype([
    ("exp_off", "<i2", (7,)), ("expstr", "i1", (7,)), ("ngrps", "i1", (7,)),
    ("cplco_off", "<i2", (5,)), ("phs_off", "<i2"), ("man_off", "<i2"),
    ("endmant", "<i2", (5,)), ("chincpl", "i1"), ("phsflginu", "i1"),
    ("cplstrt", "<i2"), ("cplend", "<i2"), ("cplbndstrc", "<i4"),
    ("ncplbnd", "i1"), ("cplstrtbnd", "i1"), ("bai", "<i2"),
    ("csnroffst", "i1"), ("cplbai", "i1"), ("babai", "i1", (5,)),
    ("lfebai", "i1"), ("cplfleak", "i1"), ("cplsleak", "i1"),
    ("dith", "i1", (5,)), ("blksw", "i1", (5,)), ("coeff", "<f4", (5,)),
    ("chanbias", "i1"), ("rematflg", "i1"), ("lfe_scale", "<f4"),
    ("lfeon", "i1"), ("lfe_out", "i1"), ("fscod", "i1"), ("halfrate", "i1"),
    ("deltba", "i1", (7, 50)),
])


def _bind_sideinfo(lib):
    lib.ac3h_rawrec_size.restype = C.c_int
    if lib.ac3h_rawrec_size() != RAW_REC_DTYPE.itemsize:
        raise RuntimeError(
            f"RawRecWire is {lib.ac3h_rawrec_size()} bytes in the native "
            f"host but {RAW_REC_DTYPE.itemsize} in RAW_REC_DTYPE")
    lib.ac3h_parse_sideinfo_many.restype = None
    lib.ac3h_parse_sideinfo_many.argtypes = [
        C.POINTER(C.c_void_p), C.c_int,                  # parsers, nlanes
        C.POINTER(C.c_void_p), C.POINTER(C.c_int64),     # bufs, lens
        C.c_int, C.c_int, C.c_float, C.c_float,          # maxframes flags level bias
        C.c_void_p, C.c_int, C.c_void_p, C.c_void_p,     # frames mb fsizes recs
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_void_p,  # valid fmt consumed nframes
        C.c_int,                                         # nthreads
    ]


class SideinfoBatchParser:
    """N native stream parsers -> one batched side-info parse call.

    One ctypes call (GIL released, lanes fan out over C++ threads) per
    chunk: each lane's elementary stream is resynced, its frames copied
    into a dense [nlanes, maxframes, MB_MAX] staging buffer and their
    per-block RawRecWire side-info records filled; the mantissa field is
    skipped entirely (liba52 parse.c:336-556 -- the device performs that
    walk, ops.unpack_device)."""

    MB_MAX = 3840                      # largest legal AC-3 frame

    def __init__(self, nlanes: int, nthreads: int | None = None):
        self.lib = get_lib()
        self._parsers = [self.lib.ac3h_new() for _ in range(nlanes)]
        self.nlanes = nlanes
        if nthreads is None:
            nthreads = min(nlanes, os.cpu_count() or 1)
        self.nthreads = nthreads

    def __del__(self):
        for p in getattr(self, "_parsers", []):
            self.lib.ac3h_free(p)
        self._parsers = []

    def parse(self, bufs, maxframes: int, flags: int, level: float = 1.0,
              bias: float = 0.0):
        """bufs: list of (bytes-like, offset) or bytes-like per lane.

        Returns dict: frames [L, F, MB_MAX] u8, fsizes [L, F] i32,
        recs [L, F*6] RAW_REC_DTYPE, valid [L, F] u8,
        fmt [L, F, 4] i32 (acmod, output, slev_zero, have),
        consumed [L] i64, nframes [L] i32."""
        L, mb = self.nlanes, self.MB_MAX
        assert len(bufs) == L
        frames = np.zeros((L, maxframes, mb), np.uint8)
        fsizes = np.zeros((L, maxframes), np.int32)
        recs = np.zeros((L, maxframes * 6), RAW_REC_DTYPE)
        valid = np.zeros((L, maxframes), np.uint8)
        fmt = np.zeros((L, maxframes, 4), np.int32)
        consumed = np.zeros(L, np.int64)
        nframes = np.zeros(L, np.int32)

        views = []                        # keep buffer views alive
        pbuf = (C.c_void_p * L)()
        plen = (C.c_int64 * L)()
        for i, b in enumerate(bufs):
            off = 0
            if isinstance(b, tuple):
                b, off = b
            v = np.frombuffer(b, np.uint8)
            views.append(v)
            pbuf[i] = C.c_void_p(v.ctypes.data + off)
            plen[i] = len(b) - off
        pp = (C.c_void_p * L)(*self._parsers)
        addr = lambda a: C.c_void_p(a.ctypes.data)
        self.lib.ac3h_parse_sideinfo_many(
            pp, L, pbuf, plen, maxframes, flags, level, bias,
            addr(frames), mb, addr(fsizes), addr(recs), addr(valid),
            addr(fmt), addr(consumed), addr(nframes), self.nthreads)
        return {"frames": frames, "fsizes": fsizes, "recs": recs,
                "valid": valid, "fmt": fmt, "consumed": consumed,
                "nframes": nframes}
