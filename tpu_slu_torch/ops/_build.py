"""Build ``tpu_slu_torch/csrc/*.cu`` with plain ``nvcc`` and load it with ctypes.

The library exposes plain ``extern "C"`` entry points, so the build needs no
PyTorch headers and takes seconds: one ``nvcc -c`` per source, all started
together, then one link. It runs at first use (the first CUDA call), never
at import, and is rebuilt whenever a hash of the sources changes: the hash
is part of the library's file name under ``build/``. Processes that start
together (the ranks of a data-parallel run) build once: the first takes a
lock file beside the library and compiles, the others wait on the lock and
load its library.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tpu_slu_torch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# The widest hidden size the card's recurrent kernels take: each holds its
# cluster's slice of a direction's W_hh (3H x H floats) in registers sized
# for H <= 128: the forward cluster recurrence of csrc/gru_cluster.cuh (K1,
# K2, K4f, K5f and K6) and the backward one of csrc/gru_cluster_bwd.cuh (the
# dh chain of K3, K4b and K5b). Only this register limit is left: no kernel
# holds a whole W_hh in one SM's shared memory any more. The JAX package
# takes any H; no config in experiments/ uses one past 128.
MAX_H = 128

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
# name -> (restype, argtypes); every pointer and the stream are c_void_p
_SIGNATURES = {
    "tsl_bigru_shared_fwd": (_I, [_P, _I, _P, _I] + [_P] * 8 + [_P] * 3 + [_I] * 5 + [_P]),
    "tsl_bigru_trainpool_fwd": (_I, [_P, _I, _P, _I] + [_P] * 8 + [_P] * 5 + [_I] * 4
                                + [_U, _U, _F, _P]),
    "tsl_bigru_shared_bwd": (_I, [_P, _I, _P, _I] + [_P] * 4 + [_P] * 8 + [_P] * 2 + [_P] * 8
                             + [_P] * 5 + [_I] * 5 + [_U, _U, _F, _P]),
    "tsl_bigru_shared_bwd_partial_floats": (ctypes.c_longlong, [_I] * 5),
    # the same entry points on bf16 streams (compute_dtype=bfloat16): the same arguments, and
    # K3's dX scratch `pair` after `partial`
    "tsl_bigru_shared_fwd_bf16": (_I, [_P, _I, _P, _I] + [_P] * 8 + [_P] * 3 + [_I] * 5 + [_P]),
    "tsl_bigru_trainpool_fwd_bf16": (_I, [_P, _I, _P, _I] + [_P] * 8 + [_P] * 5 + [_I] * 4
                                     + [_U, _U, _F, _P]),
    "tsl_bigru_shared_bwd_bf16": (_I, [_P, _I, _P, _I] + [_P] * 4 + [_P] * 8 + [_P] * 2 + [_P] * 8
                                  + [_P] * 6 + [_I] * 5 + [_U, _U, _F, _P]),
    "tsl_bigru_masked_fwd": (_I, [_P, _I, _P] + [_P] * 8 + [_P] * 2 + [_I] * 3 + [_P]),
    "tsl_bigru_masked_bwd": (_I, [_P, _I, _P, _P, _P] + [_P] * 8 + [_P] * 9 + [_P] * 5 + [_I] * 3
                             + [_P]),
    "tsl_gru1_fwd": (_I, [_P, _I, _P] + [_P] * 4 + [_P] * 2 + [_I] * 3 + [_P]),
    "tsl_gru1_cluster_size": (_I, [_I]),
    "tsl_gru1_bwd": (_I, [_P, _I, _P, _P, _P] + [_P] * 4 + [_P] * 5 + [_P] * 5 + [_I] * 3 + [_P]),
    "tsl_beam_decode": (_I, [_P] * 12 + [_I] * 9 + [_P]),
    "tsl_beam_cluster_size": (_I, [_I] * 9),
    "tsl_beam_decode_smem_bytes": (ctypes.c_longlong, [_I] * 7),
    "tsl_sinc_frontend_fwd": (_I, [_P] * 3 + [_I] * 13 + [_P]),
    "tsl_bigru_shared_cluster_size": (_I, [_I]),
    "tsl_bigru_shared_fwd_rs": (_I, [_P, _I, _P, _I] + [_P] * 8 + [_P] * 3 + [_I] * 5 + [_P]),
    # K6, K4f, K5f, K4b and K5b on bf16 streams: the f32 entries' arguments, and the
    # backward's bf16 scratch (hp16, dyx and, with two directions, pair) after `partial`
    "tsl_bigru_shared_fwd_rs_bf16": (_I, [_P, _I, _P, _I] + [_P] * 8 + [_P] * 3 + [_I] * 5 + [_P]),
    "tsl_bigru_masked_fwd_bf16": (_I, [_P, _I, _P] + [_P] * 8 + [_P] * 2 + [_I] * 3 + [_P]),
    "tsl_gru1_fwd_bf16": (_I, [_P, _I, _P] + [_P] * 4 + [_P] * 2 + [_I] * 3 + [_P]),
    "tsl_bigru_masked_bwd_bf16": (_I, [_P, _I, _P, _P, _P] + [_P] * 8 + [_P] * 9 + [_P] * 5 + [_P] * 3
                                  + [_I] * 3 + [_P]),
    "tsl_gru1_bwd_bf16": (_I, [_P, _I, _P, _P, _P] + [_P] * 4 + [_P] * 5 + [_P] * 5 + [_P] * 2 + [_I] * 3
                          + [_P]),
    "tsl_gemm_proj": (_I, [_P, _I, _P, _I, _P, _P, _P, _I, _I, _P]),
    "tsl_gemm_dx": (_I, [_P, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P]),
    "tsl_gemm_dw": (_I, [_P, _I, _P, _I, _P, _I, _P, _P, _P, _I, _P]),
    "tsl_gemm_proj_bf16": (_I, [_P, _I, _P, _I, _P, _P, _P, _I, _I, _P]),
    "tsl_gemm_proj_rs_bf16": (_I, [_P, _I, _P, _I] + [_P] * 7 + [_I] * 3 + [_P]),
    "tsl_gemm_dx_bf16": (_I, [_P, _I, _P, _P, _P, _I, _P, _I, _P, _I, _I, _P]),
    "tsl_error_string": (ctypes.c_char_p, [_I]),
}


def _sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    path = cand if os.path.isfile(cand) else shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return path


def source_hash() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> str:
    """Compile the sources into ``build/tpu_slu_torch/libkernels-<hash>.so``
    unless that file exists; returns its path. Raises with nvcc's stderr.
    The compile holds an exclusive ``fcntl`` lock on ``<library>.lock``: a
    process that finds it held waits, then takes the library the holder
    built."""
    out = os.path.join(BUILD_DIR, f"libkernels-{source_hash()}.so")
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(f"{out}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not os.path.isfile(out):
            _compile(out, verbose)
    return out


def _compile(out: str, verbose: bool) -> None:
    tmp = f"{out}.{os.getpid()}.tmp"
    nvcc = _nvcc()
    procs = []
    for src in (s for s in _sources() if s.endswith(".cu")):
        obj = f"{tmp}.{os.path.basename(src)}.o"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
               *(["-Xptxas", "-v"] if verbose else []), "-o", obj, src]
        procs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                 text=True)))
    results = [(cmd, obj, p, *p.communicate()) for cmd, obj, p in procs]
    try:
        for cmd, _, p, _, err in results:
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{err}")
            if verbose:
                print(err, end="")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp, *[obj for _, obj, *_ in results]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    finally:
        for _, obj, *_ in results:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)


def library():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (restype, argtypes) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = restype
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def partial_floats(d1: int, d2: int, H: int, M: int, ndir: int) -> int:
    """Floats of the dW workspace of K3 (``ndir`` 2, parts ``d1``, ``d2``), K4b
    (2, ``d2`` 0) and K5b (1, ``d2`` 0) over M = T*B rows on the current
    device: one slot for each row chunk of the reduction."""
    n = library().tsl_bigru_shared_bwd_partial_floats(d1, d2, H, M, ndir)
    if n < 0:
        raise RuntimeError("tsl_bigru_shared_bwd_partial_floats: CUDA error")
    return n


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = library().tsl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
