"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The kernels have a plain C interface and are bound with ctypes, like
mitsuba_customization_tpu/native.py binds native/. The library is built
with nvcc for sm_90a at first use into build/torch_kernels/<hash>/ under
the repository root, keyed by a hash of the sources alone; a later call
with the same sources loads the cached build. A missing nvcc or a failed
build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("merl_eval.cu", "cond_sample.cu")
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libmct_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# C entry point -> argument types (see csrc/*.cu); every one returns the
# cudaError_t of its launch as an int
_SIGNATURES = {
    "mct_merl_eval": [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I64, _P],
    "mct_cond_sample": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P, _P, _P, _I64, _P],
}

_lib = None
build_seconds = None  # wall time of the build this process ran (None: cached)


def _source_hash():
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path():
    """Path of the shared library for the current sources (built if absent)."""
    global build_seconds
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build to a private name, then rename: concurrent builders never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(str(CSRC / s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            "nvcc failed (%d):\n%s\n%s"
            % (proc.returncode, " ".join(cmd), proc.stderr[-8000:])
        )
    os.replace(tmp, lib)
    build_seconds = time.perf_counter() - t0
    return lib


def library():
    """The loaded kernel library, with argtypes declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(library_path()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err, what):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_of(t):
    """Current CUDA stream of tensor t's device, as a ctypes pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())
