"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all at once, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.
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
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]

_LIB = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
#: C signatures of the exported launchers (each returns a cudaError_t).
_SIGNATURES = {
    # rays[6,R], spheres[N,4], R, N, tmin, t[R], idx[R], parts, stream
    "rtw_sweep": [_P, _P, _I, _I, _F, _P, _P, _I, _P],
    # fstate[12,R], istate[7,R], buf[3k,R], t[R], idx[R], amat[N,10],
    # cam[21], u9[9,R] or NULL, R, k, W, H, dpx, dpy, p_end, first_sample,
    # max_depth, seed, iteration, stream
    "rtw_shade_strided": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _I, _I, _I, _I, _U, _U, _P],
    # fstate[12,R], istate[7,R], buf[3k,R], t[R], idx[R], amat[N,10],
    # cam[21], params[5], R, k, W, H, dpx, dpy, max_depth, pass, stream
    "rtw_shade_strided_pass": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _I, _I, _U, _P],
    # active[R], R, params[5], passes, flags[2], host_flags[2], stream
    "rtw_strided_chunk_end": [_P, _I, _P, _I, _P, _P, _P],
    # rays[6,R], times[R], spheres[N,8], R, N, tmin, t[R], idx[R], parts,
    # stream
    "rtw_sweep_motion": [_P, _P, _P, _I, _I, _F, _P, _P, _I, _P],
    # fstate[13,R], istate[7,R], buf[3k,R], t[R], idx[R], amat[N,13],
    # cam[21], u10[10,R] or NULL, R, k, W, H, dpx, dpy, p_end,
    # first_sample, max_depth, seed, iteration, stream
    "rtw_shade_strided_motion": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _I, _I, _I, _I, _U, _U, _P],
    # fstate[13,R], istate[7,R], buf[3k,R], t[R], idx[R], amat[N,13],
    # cam[21], params[5], R, k, W, H, dpx, dpy, max_depth, pass, stream
    "rtw_shade_strided_motion_pass": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _I, _U, _P],
    # rays[6,R], spheres[N,4], amat[N,10], R, N, tmin, t[R], idx[R],
    # attrs[10,R], parts, stream
    "rtw_sweep_fetch": [_P, _P, _P, _I, _I, _F, _P, _P, _P, _I, _P],
    # rays[6,R], spheres[N,4], amat[N,10], R, N, tmin, t[R], idx[R],
    # attrs[10,R], stream
    "rtw_sweep_fetch_one_thread": [_P, _P, _P, _I, _I, _F, _P, _P, _P, _P],
    # fstate[12,R], istate[3,R], t[R], attrs[10,R], u[R], v[R], cam[21],
    # u9[9,R] or NULL, R, last_sample, max_depth, seed, iteration, stream
    "rtw_shade_pinned": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _U,
                         _P],
    # fstate[12,R], istate[3,R], t[R], idx[R], amat[N,10], u[R], v[R],
    # cam[21], u9[9,R] or NULL, R, last_sample, max_depth, seed, iteration,
    # stream
    "rtw_shade_pinned_fetch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _U, _U, _P],
    # rays[6,W], alive[W], spheres[N,4], W, N, tmin, t[W], idx[W], parts,
    # stream
    "rtw_sweep_masked": [_P, _P, _P, _I, _I, _F, _P, _P, _I, _P],
    # kernel, N, &regs, &blocks_per_sm, &sm_count
    "rtw_sweep_occupancy": [_I, _I, _IP, _IP, _IP],
    # t[W], idx[W], amat[N,10], strips[6S,W], sf[9,W], si[3,W], rad[3S,W],
    # rec slot[n_rec,W], n_rec, u5[5,W] or NULL, W, S, max_depth, seed,
    # iteration, stream
    "rtw_persist_record": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P, _I, _I,
                           _I, _U, _U, _P],
    # cot[9,W], dep[6S,W], rec[K,21,W], gs[3S,W], dattr[K,9,W],
    # u5[K,5,W] or NULL, W, S, K, seed, i0, stream
    "rtw_persist_replay_fused": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _U, _U,
                                 _P],
    # cot[9,W], dep[6S,W], rec slot[11,W], idx[W], amat[N,10],
    # gs[3S,W], dattr[9,W], u5[5,W] or NULL, W, S, seed, iteration, stream
    "rtw_persist_replay_step": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _U,
                                _U, _P],
    # t[R], idx[R], amat[N,10], st[13,R], rec slot[21,R], u5[5,R] or NULL,
    # R, seed, bounce, stream
    "rtw_record_shade": [_P, _P, _P, _P, _P, _P, _I, _U, _U, _P],
    # rec[K,21,R], g3[3,R], cot[9,R], dattr[K,9,R], u5[K,5,R] or NULL, R, K,
    # seed, group, stream
    "rtw_replay_bwd_fused": [_P, _P, _P, _P, _P, _I, _I, _U, _I, _P],
    # group, &regs, &blocks_per_sm, &threads_per_block, &sm_count
    "rtw_replay_bwd_fused_occupancy": [_I, _IP, _IP, _IP, _IP],
    # rec slot[21,R], g3[3,R], cot[9,R], dattr[9,R], u5[5,R] or NULL, R,
    # seed, bounce, stream
    "rtw_replay_bwd_step": [_P, _P, _P, _P, _P, _I, _U, _U, _P],
    "rtw_replay_bwd_step_previous": [_P, _P, _P, _P, _P, _I, _U, _U, _P],
    # &regs, &blocks_per_sm, &threads_per_block
    "rtw_replay_bwd_step_occupancy": [_IP, _IP, _IP],
    # rays[6,R], spheres[11,N], rad[3,R], u5[depth,5,R] or NULL, the
    # zeroed lane counter next[1], R, N, max_depth, tmin, seed, stream
    "rtw_inline": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _U, _P],
    # N, &regs, &blocks_per_sm, &sm_count
    "rtw_inline_occupancy": [_I, _IP, _IP, _IP],
    # strips[6S,W], sf[9,W], si[3,W], rad[3S,W], rec slot[21,W], idx[W],
    # spheres[N,4], amat[N,10], N, tmin, u5[5,W] or NULL, W, S, max_depth,
    # seed, iteration, stream
    "rtw_persist_record_fused": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _P,
                                 _I, _I, _I, _U, _U, _P],
    # N, &regs, &blocks_per_sm, &sm_count
    "rtw_persist_record_fused_occupancy": [_I, _IP, _IP, _IP],
    # fstate[12,R], istate[3,R], spheres[N,4], amat[N,10], N, tmin, u[R],
    # v[R], cam[21], u9[9,R] or NULL, R, last_sample, max_depth, seed,
    # iteration, stream
    "rtw_mega": [_P, _P, _P, _P, _I, _F, _P, _P, _P, _P, _I, _I, _I, _U, _U,
                 _P],
    # N, &regs, &blocks_per_sm, &sm_count
    "rtw_mega_occupancy": [_I, _IP, _IP, _IP],
    # rays[6,R], sph[G+K*P,4], im[G+K*P], bnd[K,4], R, G, K, P, tmin, t[R],
    # idx[R], skips[ceil(R/32)], stream
    "rtw_grid_sweep": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P, _P, _P],
    "rtw_grid_sweep_all_roots": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P,
                                 _P, _P],
    # G, K, P, &regs, &blocks_per_sm, &sm_count
    "rtw_grid_sweep_occupancy": [_I, _I, _I, _IP, _IP, _IP],
    # start, n, out[n], stream
    "rtw_inv_length_bits": [_U, _I, _P, _P],
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
    returns its path. One ``nvcc`` per source runs at the same time; the
    library is linked under a temporary name and renamed, so concurrent
    builds never load a half-written file."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    work = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        cus = [s for s in _sources() if s.endswith(".cu")]
        objs = [os.path.join(work, os.path.basename(s) + ".o") for s in cus]
        extra = ["-Xptxas", "-v"] if verbose else []
        procs = [subprocess.Popen(
            [nvcc, *extra, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", o, s],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(cus, objs)]
        logs = [p.communicate()[0] for p in procs]
        for p, s, log in zip(procs, cus, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on {s}:\n"
                                   f"{log}")
        tmp = os.path.join(work, "lib.so")
        link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(link)}\n{proc.stdout}\n"
                               f"{proc.stderr}")
        if verbose:
            print("".join(logs), file=sys.stderr, flush=True)
        os.replace(tmp, path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
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


def check_arg(what: str, x, dtype, shape, device) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what a launcher takes."""
    if x.device != device:
        raise ValueError(f"{what}: tensor on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{what}: must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: must be {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
