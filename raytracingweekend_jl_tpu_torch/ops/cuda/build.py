"""Build and load the port's hand-written CUDA kernels.

All ``csrc/*.cu`` sources are compiled by ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``.
The library is built at first use into ``build/kernels/`` at the root of the
checkout, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads the cached library. Nothing is built
when the module is imported.

``--fmad=false`` keeps nvcc from contracting ``a*b+c`` into FMA, which eager
PyTorch does not do either: each kernel then agrees with its plain PyTorch
version almost bit for bit. No ``--use_fast_math``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import tempfile

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
#: C signatures of the exported launchers (each returns a cudaError_t).
_SIGNATURES = {
    # rays[6,R], spheres[N,4], R, N, tmin, t[R], idx[R], stream
    "rtw_sweep": [_P, _P, _I, _I, _F, _P, _P, _P],
    # fstate[12,R], istate[7,R], buf[3k,R], t[R], attrs[10,R], cam[21],
    # u9[9,R] or NULL, R, k, W, H, dpx, dpy, p_end, first_sample, max_depth,
    # seed, iteration, stream
    "rtw_shade_strided": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, _U, _U, _P],
}


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    """Path of the library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"librtw_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels unless the library for these sources exists;
    returns its path. The library is written under a temporary name and
    renamed, so concurrent builders never load a half-written file."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cus = [s for s in _sources() if s.endswith(".cu")]
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC_DIR, "-o", tmp, *cus]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stdout + proc.stderr, file=sys.stderr, flush=True)
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    """The loaded kernel library (built at first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rtw_error_string.argtypes = [ctypes.c_int]
        lib.rtw_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = load().rtw_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg}) at launch")
