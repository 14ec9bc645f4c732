"""Build and load the port's CUDA kernels (csrc/*.cu) as one shared library.

The kernels have a plain C interface and are bound with ctypes, like
mitsuba_customization_tpu/native.py binds native/. The library is built
with nvcc for sm_90a at first use into build/torch_kernels/<hash>/ under
the repository root, keyed by a hash of the sources and headers alone; a
later call with the same sources loads the cached build. Each source is
compiled by its own nvcc process, all started together, and the objects
are linked into one shared library. A missing nvcc or a failed build
raises: there is no fallback.
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
SOURCES = ("merl_eval.cu", "cond_sample.cu", "cluster_closest.cu",
           "cluster_shadow.cu")
HEADERS = ("cluster_common.cuh",)
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
LIB_NAME = "libmct_torch_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
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
    "mct_cluster_closest": [_P, _P, _P, _I64, _P, _P, _I, _P, _P, _I, _P,
                            _P, _P, _P, _P, _P],
    "mct_cluster_shadow": [_P, _P, _P, _I64, _P, _P, _I, _P, _P, _I, _P,
                           _P, _P],
}

_lib = None
build_seconds = None  # wall time of the build this process ran (None: cached)


def _source_hash():
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
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
    nvcc = _nvcc()
    # build to private names, then rename: concurrent builders never see
    # a half-written library
    tmp_dir = tempfile.mkdtemp(dir=out_dir)
    objs = [os.path.join(tmp_dir, s + ".o") for s in SOURCES]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)]
            for src, obj in zip(SOURCES, objs)]
    tmp = os.path.join(tmp_dir, LIB_NAME)
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for c in cmds]
        errs = [proc.communicate()[1] for proc in procs]  # wait for all
        for cmd, proc, err in zip(cmds, procs, errs):
            _raise_if_failed(proc.returncode, cmd, err)
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        _raise_if_failed(proc.returncode, link, proc.stderr)
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return lib


def _raise_if_failed(returncode, cmd, stderr):
    if returncode != 0:
        raise RuntimeError(
            "nvcc failed (%d):\n%s\n%s" % (returncode, " ".join(cmd), stderr[-8000:])
        )


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
