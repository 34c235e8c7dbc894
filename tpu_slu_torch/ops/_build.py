"""Build ``tpu_slu_torch/csrc/*.cu`` with plain ``nvcc`` and load it with ctypes.

The library exposes plain ``extern "C"`` entry points, so the build needs no
PyTorch headers and takes seconds. It runs at first use (the first CUDA
call), never at import, and is rebuilt whenever a hash of the sources
changes: the hash is part of the library's file name under ``build/``.
"""

from __future__ import annotations

import ctypes
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

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> (restype, argtypes); every pointer and the stream are c_void_p
_SIGNATURES = {
    "tsl_bigru_shared_fwd": (_I, [_P, _I, _P, _I] + [_P] * 8 + [_P] * 3 + [_I] * 5 + [_P]),
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
    unless that file exists; returns its path. Raises with nvcc's stderr."""
    out = os.path.join(BUILD_DIR, f"libkernels-{source_hash()}.so")
    if os.path.isfile(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           *(["-Xptxas", "-v"] if verbose else []), "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, out)
    return out


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


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if err != 0:
        msg = library().tsl_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
