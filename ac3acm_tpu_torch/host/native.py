"""ctypes bindings for the native host pre-pass (native/ac3host.cpp).

The port keeps its own copy of the C++ host runtime and builds it at
first use (g++ -O3) into ``native/build/``, installs the generated tables
from this package's ``tables`` module, and exposes the dense multi-lane
parse pool that feeds ``parallel.pipeline.BatchedDecoder``.  ctypes
releases the GIL during calls, and the C++ side fans lanes out over its
own threads.
"""
from __future__ import annotations

import ctypes as C
import hashlib
import os
import subprocess
import threading

import numpy as np

from .. import tables as T

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SOURCES = ("ac3host.cpp", "ac3sample.inc", "ac3fb.inc")
_FLAGS = ["-O3", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17",
          "-pthread"]

_lock = threading.Lock()
_lib = None

# block-float scale groups per premixed plane (16 bins each); must match
# native/ac3host.cpp PRE_GROUPS
PRE_GROUPS = 16


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
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
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
        _bind_dense(lib)
        _lib = lib
        return lib


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
