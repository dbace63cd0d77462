"""Build and load the port's CUDA kernels (nvcc -> C-ABI .so -> ctypes).

Each source under ``csrc/`` compiles on its own, at first use, into
``csrc/build/lib<name>-<hash>.so``; the hash covers the source and the
flags, so an edited kernel is never served from a stale build.  nvcc writes
a private temporary name that is renamed into place, so concurrent first
uses are safe.  Nothing here runs at import time: machines without nvcc
import the package freely.
"""
from __future__ import annotations

import ctypes as C
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..utils.trace import count

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs = {}
# per kernel: nvcc's resource report (registers, shared memory, spills)
ptxas_info = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    # the toolkit PyTorch itself would build against (CUDA_HOME et al.)
    from torch.utils.cpp_extension import CUDA_HOME
    path = os.path.join(CUDA_HOME or "", "bin", "nvcc")
    if not CUDA_HOME or not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _build_dir() -> str:
    """``csrc/build`` in a writable checkout, else a per-user cache."""
    if os.access(_CSRC, os.W_OK):
        return os.path.join(_CSRC, "build")
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "ac3acm_tpu_torch", "cuda-build")


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless this exact build exists; -> .so path."""
    src = os.path.join(_CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.tmp"
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, src, "-o", tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{r.stderr}")
        ptxas_info[name] = r.stderr.strip()
        os.replace(tmp, so)
    return so


def load(name: str, bind) -> C.CDLL:
    """The loaded library for csrc/<name>.cu; `bind(lib)` sets its argtypes.
    The first load of each adds its seconds, build included, to the
    counter lib_load_s (utils.trace)."""
    with _lock:
        if name not in _libs:
            t0 = time.perf_counter()
            lib = C.CDLL(build(name))
            bind(lib)
            _libs[name] = lib
            count("lib_load_s", time.perf_counter() - t0)
        return _libs[name]
