"""K9 (``shade_pinned_fetch_kernel``) and K13 (``grid_sweep_kernel``)
beside the designs they were chosen over, on the card: what each change of
their redesign does alone, and why the shipped kernels are what they are.

The shipped sources (``csrc/shade_pinned.cu``, ``csrc/grid_sweep.cu``) are
built as they stand (``shipped``) and rewritten into variants, each built
by its own ``nvcc -Xptxas -v`` (all at once), with the launcher's C
signature unchanged:

- K9 ``previous``: the kept kernel before the redesign (the shipped
  library's ``shade_pinned_kernel``: one thread per lane over every lane,
  ten gathered attribute planes), timed alone and with the gather that
  feeds it. ``exit``: one thread per lane, an idle lane returning after
  its flag (no compaction); ``shipped_t64``, ``shipped_t256``: 64- and
  256-lane blocks, not 128.
- K13 ``previous``: the kept kernel before the redesign (the shipped
  library's ``grid_sweep_all_roots_kernel``: one 128-ray block per tile,
  both roots of every pair, the bound's root before its test).
  ``shipped_roots``: every pair's roots and the bound's root taken first
  (the shipped kernel without the change of the redesign); ``persistent``:
  as many 128-ray blocks as the card holds, each staging the tables once
  and looping over tiles; ``shipped_t256``, ``shipped_t512``: blocks of 256
  or 512 rays; ``shipped_ldg``: no staging, the tables read through the
  read-only path; ``split_q2``, ``split_q4``: each ray split over Q threads
  (``rtw_sweep_part``'s interleave, the parts' best t merged before each
  bound test, the 32-ray unit's vote across its Q warps with
  ``__syncthreads_or``), persistent blocks of 32 Q threads (one block per
  32-ray unit would stage the table 64 800 times a sweep).

It prints each build's registers, spills and shared memory. It holds every
build bit for bit: K9 (every state word) against K1, the gather and the
previous K9 at iterations 0, 8, 24 and 40 of the flagship film pinned
(2 073 600 lanes, spp 4), with injected and with Philox draws; K13 (t, idx
and skips) against the previous K13 on ``chip_smoke.py``'s eight cases of
the flagship's 2 073 600 rays (camera and bounce-1 rays, each row-major,
strided k = 64 and in 32x32 and 128x64 tiles). It times every build with
``chip_smoke.batch_ms`` (one CUDA event pair around N launches, and the
profiler's per-launch mean): K9 at the four iterations (each launch on its
own copy of the state), K13 on the eight cases. Five passes, every other
one in reverse order; each time is the median of the five. Then per
render: the flagship film pinned (``persistent_render_sum_fused``'s loop,
spp 4) with every K9 build and with K1 + gather + the previous K9, by the
host clock (medians, in turns) and by the profiler (the step's device time
per render), the images bitwise equal. The last lines give each change
alone against what it replaces, and the verdict: a change of K9 is kept
where it is at least 1% faster per pinned render and no slower at any
iteration, a change of K13 where it is at least 1% faster on every case.
One JSON object per line; a failed check raises.

    python3 scripts/torch_k9_k13_variants.py    # one CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import raytracingweekend_jl_tpu_torch as pt  # noqa: E402
import torch_k10_k12_variants as V  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops import integrator as I  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import build  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import (  # noqa: E402
    grid_kernel as K13, intersect_kernel as K1)
from raytracingweekend_jl_tpu_torch.ops.experimental import (  # noqa: E402
    grid as GR)
from raytracingweekend_jl_tpu_torch.ops.materials import (  # noqa: E402
    fetch_attr_planes)

W, H, SPP, DEPTH, TMIN = V.W, V.H, V.SPP, V.DEPTH, V.TMIN
_sub, _in = V._sub, V._in

# -- source rewrites ---------------------------------------------------------

K9_KERNEL = re.compile(r"__global__ void __launch_bounds__\("
                       r"RTW_PINNED_THREADS\)\n    shade_pinned_fetch_kernel"
                       r"\(.*?\n}\n", re.S)
K9_COMPACT = re.compile(r"  constexpr int NW = RTW_PINNED_THREADS / 32;\n"
                        r".*?  const int i = ids\[threadIdx.x\];\n", re.S)
K9_EXIT = """  const int i = blockIdx.x * RTW_PINNED_THREADS + threadIdx.x;
  if (i >= n || is[2 * n + i] == 0) return;  // an idle lane: nothing more
"""
K9_THREADS = "#define RTW_PINNED_THREADS 128\n"

K13_KERNEL = re.compile(r"__global__ void __launch_bounds__\("
                        r"RTW_GRID_THREADS\)\n    grid_sweep_kernel\(.*?\n}\n",
                        re.S)
K13_LAUNCH = re.compile(r'extern "C" int rtw_grid_sweep\(.*?\n}\n', re.S)
K13_THREADS = "#define RTW_GRID_THREADS 128\n"
K13_PAIR_GLOBAL = "    rtw_sweep_pair(s_sph[s], s,"
K13_PAIR_SLOT = "        rtw_sweep_pair(s_sph[base + j], base + j,"
K13_GATED = """    bool reach = false;
    if (valid && disc > 0.0f) {
      const float sq = sqrtf(disc);
      reach = -hb + sq >= tmin && -hb - sq < best_t;
    }
"""
K13_UNGATED = """    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const bool reach = valid && disc > 0.0f && -hb + sq >= tmin &&
                       -hb - sq < best_t;
"""
K13_STAGE = """  extern __shared__ float4 smem[];
  const int total = n_global + K * P;
  float4* s_sph = smem;
  float4* s_bnd = smem + total;
  for (int s = threadIdx.x; s < total; s += blockDim.x) s_sph[s] = sph[s];
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_bnd[k] = bnd[k];
  __syncthreads();
"""
K13_NO_STAGE = """  const float4* s_sph = sph;
  const float4* s_bnd = bnd;
"""
K13_SMEM = "  const size_t smem = rtw_grid_smem(n_global, K, P);\n"

#: K13 on persistent blocks: as many 128-ray blocks as the card holds, each
#: staging the tables once and looping over tiles b, b + gridDim.x, ...
PERSISTENT_K13 = """__global__ void __launch_bounds__(RTW_GRID_THREADS)
    grid_sweep_kernel(const float* __restrict__ rays,
                      const float4* __restrict__ sph,
                      const int* __restrict__ im,
                      const float4* __restrict__ bnd, int n_rays,
                      int n_global, int K, int P, float tmin,
                      float* __restrict__ t_out, int* __restrict__ idx_out,
                      int* __restrict__ skips) {
  extern __shared__ float4 smem[];
  const int total = n_global + K * P;
  float4* s_sph = smem;
  float4* s_bnd = smem + total;
  for (int s = threadIdx.x; s < total; s += blockDim.x) s_sph[s] = sph[s];
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_bnd[k] = bnd[k];
  __syncthreads();

  const size_t n = n_rays;
  const int n_tiles = (n_rays + RTW_GRID_THREADS - 1) / RTW_GRID_THREADS;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int i = tile * RTW_GRID_THREADS + threadIdx.x;
    const bool valid = i < n_rays;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
    if (valid) {
      ox = rays[i]; oy = rays[n + i]; oz = rays[2 * n + i];
      dx = rays[3 * n + i]; dy = rays[4 * n + i]; dz = rays[5 * n + i];
    }
    const float od = ox * dx + oy * dy + oz * dz;
    const float oo = ox * ox + oy * oy + oz * oz;

    float best_t = RTW_BIG;
    int best_s = 0;
    for (int s = 0; s < n_global; ++s)
      rtw_sweep_pair(s_sph[s], s, ox, oy, oz, dx, dy, dz, od, oo, tmin,
                     best_t, best_s);

    int culled = 0;
    for (int k = 0; k < K; ++k) {
      const float4 b = s_bnd[k];
      const float cd = b.x * dx + b.y * dy + b.z * dz;
      const float oc = b.x * ox + b.y * oy + b.z * oz;
      const float hb = od - cd;
      const float cq = oo - 2.0f * oc + b.w;
      const float disc = hb * hb - cq;
      bool reach = false;
      if (valid && disc > 0.0f) {
        const float sq = sqrtf(disc);
        reach = -hb + sq >= tmin && -hb - sq < best_t;
      }
      if (__any_sync(0xffffffffu, reach)) {
        const int base = n_global + k * P;
#pragma unroll 4
        for (int j = 0; j < P; ++j)
          rtw_sweep_pair(s_sph[base + j], base + j, ox, oy, oz, dx, dy, dz,
                         od, oo, tmin, best_t, best_s);
      } else {
        ++culled;
      }
    }
    if (valid) {
      t_out[i] = best_t;
      idx_out[i] = best_t < RTW_BIG ? __ldg(im + best_s) : 0;
      if ((threadIdx.x & 31) == 0) skips[i >> 5] = culled;
    }
  }
}

"""

#: Its launcher, with the shipped signature.
PERSISTENT_K13_LAUNCH = """extern "C" int rtw_grid_sweep(const float* rays, const float* sph,
                              const int* im, const float* bnd, int n_rays,
                              int n_global, int K, int P, float tmin,
                              float* t_out, int* idx_out, int* skips,
                              void* stream) {
  if (n_rays <= 0) return 0;
  const size_t smem = rtw_grid_smem(n_global, K, P);
  cudaError_t e = rtw_reserve_smem((const void*)grid_sweep_kernel, smem);
  int per_sm = 0, sms = 0, dev = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grid_sweep_kernel, RTW_GRID_THREADS, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int tiles = (n_rays + RTW_GRID_THREADS - 1) / RTW_GRID_THREADS;
  int blocks = per_sm * sms;
  if (blocks > tiles || blocks < 1) blocks = tiles;
  grid_sweep_kernel<<<blocks, RTW_GRID_THREADS, smem, (cudaStream_t)stream>>>(
      rays, reinterpret_cast<const float4*>(sph), im,
      reinterpret_cast<const float4*>(bnd), n_rays, n_global, K, P, tmin,
      t_out, idx_out, skips);
  return (int)cudaGetLastError();
}

"""

#: K13 with each ray split over RTW_GRID_Q threads of a 32 Q-thread block
#: (one 32-ray unit at a time, persistent over units).
SPLIT_K13 = """#define RTW_GRID_Q {q}

__global__ void __launch_bounds__(32 * RTW_GRID_Q)
    grid_sweep_kernel(const float* __restrict__ rays,
                      const float4* __restrict__ sph,
                      const int* __restrict__ im,
                      const float4* __restrict__ bnd, int n_rays,
                      int n_global, int K, int P, float tmin,
                      float* __restrict__ t_out, int* __restrict__ idx_out,
                      int* __restrict__ skips) {{
  constexpr int Q = RTW_GRID_Q;
  extern __shared__ float4 smem[];
  const int total = n_global + K * P;
  float4* s_sph = smem;
  float4* s_bnd = smem + total;
  for (int s = threadIdx.x; s < total; s += blockDim.x) s_sph[s] = sph[s];
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_bnd[k] = bnd[k];
  __syncthreads();

  const size_t n = n_rays;
  const int r = threadIdx.x / Q, q = threadIdx.x % Q;
  const int n_units = (n_rays + 31) / 32;
  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {{
    const int i = unit * 32 + r;
    const bool valid = i < n_rays;
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
    if (valid) {{
      ox = rays[i]; oy = rays[n + i]; oz = rays[2 * n + i];
      dx = rays[3 * n + i]; dy = rays[4 * n + i]; dz = rays[5 * n + i];
    }}
    const float od = ox * dx + oy * dy + oz * dz;
    const float oo = ox * ox + oy * oy + oz * oz;

    float best_t = RTW_BIG;
    int best_s = 0;
    for (int s = q; s < n_global; s += Q)
      rtw_sweep_pair(s_sph[s], s, ox, oy, oz, dx, dy, dz, od, oo, tmin,
                     best_t, best_s);

    int culled = 0;
    for (int k = 0; k < K; ++k) {{
      rtw_merge_closest(best_t, best_s, Q);  // the plain version's best t
      const float4 b = s_bnd[k];
      const float cd = b.x * dx + b.y * dy + b.z * dz;
      const float oc = b.x * ox + b.y * oy + b.z * oz;
      const float hb = od - cd;
      const float cq = oo - 2.0f * oc + b.w;
      const float disc = hb * hb - cq;
      bool reach = false;
      if (valid && disc > 0.0f) {{
        const float sq = sqrtf(disc);
        reach = -hb + sq >= tmin && -hb - sq < best_t;
      }}
      if (__syncthreads_or(reach)) {{
        const int base = n_global + k * P;
        for (int j = q; j < P; j += Q)
          rtw_sweep_pair(s_sph[base + j], base + j, ox, oy, oz, dx, dy, dz,
                         od, oo, tmin, best_t, best_s);
      }} else {{
        ++culled;
      }}
    }}
    rtw_merge_closest(best_t, best_s, Q);
    if (valid && q == 0) {{
      t_out[i] = best_t;
      idx_out[i] = best_t < RTW_BIG ? __ldg(im + best_s) : 0;
    }}
    if (threadIdx.x == 0) skips[unit] = culled;
  }}
}}
"""

SPLIT_K13_LAUNCH = """extern "C" int rtw_grid_sweep(const float* rays, const float* sph,
                              const int* im, const float* bnd, int n_rays,
                              int n_global, int K, int P, float tmin,
                              float* t_out, int* idx_out, int* skips,
                              void* stream) {
  if (n_rays <= 0) return 0;
  const size_t smem = rtw_grid_smem(n_global, K, P);
  cudaError_t e = rtw_reserve_smem((const void*)grid_sweep_kernel, smem);
  int per_sm = 0, sms = 0, dev = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, grid_sweep_kernel, 32 * RTW_GRID_Q, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int units = (n_rays + 31) / 32;
  int blocks = per_sm * sms;
  if (blocks > units || blocks < 1) blocks = units;
  grid_sweep_kernel<<<blocks, 32 * RTW_GRID_Q, smem, (cudaStream_t)stream>>>(
      rays, reinterpret_cast<const float4*>(sph), im,
      reinterpret_cast<const float4*>(bnd), n_rays, n_global, K, P, tmin,
      t_out, idx_out, skips);
  return (int)cudaGetLastError();
}
"""


def k9_source(src: str, name: str) -> str:
    """shade_pinned.cu of K9's variant ``name``."""
    if name == "shipped":
        return src
    if name == "exit":
        return _in(src, K9_KERNEL, (K9_COMPACT, K9_EXIT))
    if name.startswith("shipped_t"):
        return _sub(src, K9_THREADS, "#define RTW_PINNED_THREADS "
                    f"{int(name.removeprefix('shipped_t'))}\n")
    raise ValueError(name)


def k13_source(src: str, name: str) -> str:
    """grid_sweep.cu of K13's variant ``name``."""
    if name == "shipped":
        return src
    if name == "persistent":
        src = _sub(src, K13_KERNEL, PERSISTENT_K13)
        return _sub(src, K13_LAUNCH, PERSISTENT_K13_LAUNCH)
    if name.startswith("split_q"):
        q = int(name.removeprefix("split_q"))
        src = _sub(src, K13_KERNEL, SPLIT_K13.format(q=q))
        return _sub(src, K13_LAUNCH, SPLIT_K13_LAUNCH)
    change = name.removeprefix("shipped_")
    if change == "roots":
        return _in(src, K13_KERNEL,
                   (K13_PAIR_GLOBAL, "    rtw_sweep_one(s_sph[s], s,"),
                   (K13_PAIR_SLOT,
                    "        rtw_sweep_one(s_sph[base + j], base + j,"),
                   (K13_GATED, K13_UNGATED))
    if change == "ldg":
        src = _in(src, K13_KERNEL, (K13_STAGE, K13_NO_STAGE))
        return _in(src, K13_LAUNCH, (K13_SMEM, "  const size_t smem = 0;\n"))
    if change[0] == "t":
        return _sub(src, K13_THREADS,
                    f"#define RTW_GRID_THREADS {int(change[1:])}\n")
    raise ValueError(name)


#: Builds (``previous`` of each is the shipped library's kept kernel).
K9_BUILDS = ("shipped", "exit", "shipped_t64", "shipped_t256")
K13_BUILDS = ("shipped", "persistent", "shipped_roots", "shipped_t256",
              "shipped_t512", "shipped_ldg", "split_q2", "split_q4")

SOURCES = {"k9": "shade_pinned.cu", "k13": "grid_sweep.cu"}
KERNELS = {"k9": "shade_pinned_fetch_kernel", "k13": "grid_sweep_kernel"}
LAUNCHERS = {"k9": "rtw_shade_pinned_fetch", "k13": "rtw_grid_sweep"}
PTXAS = re.compile(r"Function properties for \w*?(shade_pinned_fetch_kernel|"
                   r"grid_sweep_kernel)\w*\s+(\d+) bytes stack frame, (\d+) "
                   r"bytes spill stores, (\d+) bytes spill loads\s+ptxas "
                   r"info\s*: Used (\d+) registers")
SMEM = re.compile(r"(\d+) bytes smem")


def build_variants(out: str, k9_builds=K9_BUILDS,
                   k13_builds=K13_BUILDS) -> tuple:
    """``({name: launcher} of K9's builds, of K13's, {kernel/name: ptxas
    report})``: the builds named compiled into ``out``, one nvcc each, all
    at once."""
    srcs = {}
    for kernel, f in SOURCES.items():
        with open(os.path.join(build.CSRC_DIR, f)) as fh:
            srcs[kernel] = fh.read()
    jobs = {("k9", n): k9_source(srcs["k9"], n) for n in k9_builds}
    jobs.update({("k13", n): k13_source(srcs["k13"], n) for n in k13_builds})
    procs = {}
    for (kernel, name), text in jobs.items():
        d = os.path.join(out, f"{kernel}_{name}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, SOURCES[kernel])
        with open(path, "w") as f:
            f.write(text)
        procs[(kernel, name)] = subprocess.Popen(
            [build._nvcc(), "-Xptxas", "-v", *build.NVCC_FLAGS, "-I", d,
             "-I", build.CSRC_DIR, "-shared", "-o",
             os.path.join(d, "lib.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"k9": {}, "k13": {}}
    report = {}
    for (kernel, name), p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {kernel} {name}:\n{log}")
        hits = [m for m in PTXAS.finditer(log)
                if m.group(1) == KERNELS[kernel]]
        if len(hits) != 1:
            raise RuntimeError(f"no single ptxas report for {kernel} "
                               f"{name}:\n{log}")
        stack, stores, loads, regs = map(int, hits[0].groups()[1:])
        smem = SMEM.search(log[hits[0].end():].split("\n")[0])
        lib = ctypes.CDLL(os.path.join(out, f"{kernel}_{name}", "lib.so"))
        fn = getattr(lib, LAUNCHERS[kernel])
        fn.argtypes = build._SIGNATURES[LAUNCHERS[kernel]]
        fn.restype = ctypes.c_int
        report[f"{kernel}/{name}"] = {
            "registers": regs, "stack_bytes": stack,
            "spill_store_bytes": stores, "spill_load_bytes": loads,
            "smem_bytes": int(smem.group(1)) if smem else 0}
        libs[kernel][name] = fn
    return libs["k9"], libs["k13"], report


# -- launches ----------------------------------------------------------------

def k9_launch(fn, st, fs, ist, t, idx, it: int, u9=None) -> None:
    """One launch of a K9 build (``fn``: its ``rtw_shade_pinned_fetch``) on
    ``fs``/``ist`` at iteration ``it`` of the film ``st``
    (``torch_k10_k12_variants.k12_states``), from the sweep's ``t``,
    ``idx``."""
    err = fn(fs.data_ptr(), ist.data_ptr(), t.data_ptr(), idx.data_ptr(),
             st["amat"].data_ptr(), st["u"].data_ptr(), st["v"].data_ptr(),
             st["cc"].data_ptr(), None if u9 is None else u9.data_ptr(),
             fs.shape[1], SPP - 1, DEPTH, st["seed"], it,
             torch.cuda.current_stream().cuda_stream)
    build.check(err, "K9 variant")


def previous_k9(st, fs, ist, t, attrs, it: int, u9=None) -> None:
    """One launch of the kept previous K9 (the library's
    ``rtw_shade_pinned``) from the gathered planes ``attrs``."""
    err = build.load().rtw_shade_pinned(
        fs.data_ptr(), ist.data_ptr(), t.data_ptr(), attrs.data_ptr(),
        st["u"].data_ptr(), st["v"].data_ptr(), st["cc"].data_ptr(),
        None if u9 is None else u9.data_ptr(), fs.shape[1], SPP - 1, DEPTH,
        st["seed"], it, torch.cuda.current_stream().cuda_stream)
    build.check(err, "previous K9")


def k13_launch(fn, rays, tabs, out) -> None:
    """One launch of a K13 build (``fn``: its ``rtw_grid_sweep``, or None
    for the kept previous kernel) into ``out`` = (t, idx, skips)."""
    lib = build.load()
    run = lib.rtw_grid_sweep_all_roots if fn is None else fn
    err = run(rays.data_ptr(), tabs.sph.data_ptr(), tabs.im.data_ptr(),
              tabs.bnd.data_ptr(), rays.shape[1], tabs.n_global, tabs.K,
              tabs.P, TMIN, *(x.data_ptr() for x in out),
              torch.cuda.current_stream().cuda_stream)
    build.check(err, "K13 variant")


def k13_outputs(rays) -> tuple:
    n, dev = rays.shape[1], rays.device
    return (torch.full((n,), 7.0, device=dev),
            torch.full((n,), 7, dtype=torch.int32, device=dev),
            torch.full((-(-n // K13.WARP),), 7, dtype=torch.int32,
                       device=dev))


# -- inputs --------------------------------------------------------------------

def k9_sweeps(st) -> dict:
    """K1's ``(t, idx)`` of the film's rays at each iteration of ``st``."""
    out = {}
    for it, (fs, _, _) in st["at"].items():
        out[it] = K1.sweep(fs[0:6].contiguous(), st["spheres"])
    return out


def k13_cases(dev) -> tuple:
    """``(tables, {case: rays [6, R]})``: the flagship's grid and
    ``chip_smoke.py``'s eight ray sets of 2 073 600 rays (camera rays and
    bounce-1 rays, each row-major, strided k = 64 and in 32x32 and 128x64
    tiles)."""
    flag = pt.scene_random_spheres(seed=1, device=dev)
    scene = pt.trim_scene(flag)
    cam = pt.t_cam1(device=dev)
    spheres = K1.sphere_consts(scene)
    tabs = GR.grid_tables(GR.build_grid(scene), dev)
    g = torch.Generator(device=dev).manual_seed(13)
    u, v = pt.pixel_coords(W, H, device=dev)
    o_c, d_c = I.pinned_start_rays(cam, u, v, 0, 0, float(W), float(H))
    R = W * H
    t0, i0 = K1.sweep(torch.cat([o_c.T, d_c.T]).contiguous(), spheres)
    hit0 = t0 < K1.BIG
    hitp = o_c + torch.where(hit0, t0, torch.ones_like(t0))[:, None] * d_c
    nrm = hitp - spheres[i0.long(), 0:3]
    nrm = nrm / nrm.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    d1 = nrm + pt.unit_sphere_directions((R,), generator=g, device=dev)
    d1 = d1 / d1.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    orders = {"row_major": None, "strided_k64": C._strided_perm(R, 64),
              "tile32": C._tile_perm(W, H, 32, 32),
              "tile128x64": C._tile_perm(W, H, 128, 64)}
    cases = {}
    for rs, (oo, dd) in (("camera", (o_c, d_c)), ("bounce1", (hitp, d1))):
        rays = torch.cat([oo.T, dd.T]).contiguous()
        for nm, perm in orders.items():
            cases[f"{rs}_{nm}"] = rays if perm is None else \
                rays[:, torch.from_numpy(perm).to(dev)].contiguous()
    return tabs, cases


# -- checks --------------------------------------------------------------------

def check_k9(k9_libs, st, sweeps) -> dict:
    """Every K9 build against K1 + gather + the previous K9, every state
    word bit for bit, at each iteration, with injected and Philox draws."""
    g = torch.Generator(device=st["u"].device).manual_seed(9)
    bad = {}
    for it, (fs, ist, _) in st["at"].items():
        n = fs.shape[1]
        t, idx = sweeps[it]
        for draws, u9 in (("injected", torch.rand((9, n), generator=g,
                                                   device=fs.device)),
                          ("philox", None)):
            ref = [fs.clone(), ist.clone()]
            V.pinned_iteration(st, *ref, it, u9)
            for name, fn in k9_libs.items():
                got = [fs.clone(), ist.clone()]
                k9_launch(fn, st, *got, t, idx, it, u9)
                torch.cuda.synchronize()
                bad[f"it{it}/{draws}/{name}"] = int(C._bitwise_lanes(
                    list(zip(got, ref)), n).sum())
                del got
    C.check(all(v == 0 for v in bad.values()),
            f"a K9 build differs from K1 + gather + the previous K9: "
            f"{ {k: v for k, v in bad.items() if v} }")
    return bad


def check_k13(k13_libs, tabs, cases) -> dict:
    """Every K13 build against the previous K13 on every case: t, idx and
    skips bit for bit."""
    bad = {}
    for case, rays in cases.items():
        ref = k13_outputs(rays)
        k13_launch(None, rays, tabs, ref)
        for name, fn in k13_libs.items():
            out = k13_outputs(rays)
            k13_launch(fn, rays, tabs, out)
            torch.cuda.synchronize()
            n = rays.shape[1]
            lanes = int(C._bitwise_lanes(list(zip(out[:2], ref[:2])), n).sum())
            bad[f"{case}/{name}"] = lanes + int((out[2] != ref[2]).sum())
    C.check(all(v == 0 for v in bad.values()),
            f"a K13 build differs from the previous K13: "
            f"{ {k: v for k, v in bad.items() if v} }")
    return bad


# -- times ---------------------------------------------------------------------

K9_RE = r"\bshade_pinned_fetch_kernel\b"
PREVIOUS_K9_RE = r"\bshade_pinned_kernel\b"
GATHER_RE = r"index_elementwise_kernel|direct_copy_kernel"
K13_RE = r"\bgrid_sweep_kernel\b"
PREVIOUS_K13_RE = r"\bgrid_sweep_all_roots_kernel\b"


def _timed_in_order(runs: dict, reverse: bool) -> dict:
    names = list(runs)[::-1] if reverse else list(runs)
    out = {name: C.batch_ms(*runs[name]) for name in names}
    return {name: out[name] for name in runs}


def k9_times(k9_libs, st, sweeps, reverse: bool, n: int = 20) -> dict:
    """Every K9 build at each iteration by ``batch_ms``, each launch on its
    own copy of the state, beside the previous K9 alone (on the gathered
    planes) and the gather with it."""
    out = {}
    for it, (fs, ist, n_act) in st["at"].items():
        t, idx = sweeps[it]
        attrs = fetch_attr_planes(idx, st["amat"])
        make = lambda: (fs.clone(), ist.clone())
        runs = {name: (lambda f, i, fn=fn: k9_launch(fn, st, f, i, t, idx,
                                                     it), make, n, K9_RE)
                for name, fn in k9_libs.items()}
        runs["previous"] = (lambda f, i: previous_k9(st, f, i, t, attrs, it),
                            make, n, PREVIOUS_K9_RE)
        runs["gather_previous"] = (
            lambda f, i: previous_k9(st, f, i, t, fetch_attr_planes(
                idx, st["amat"]), it), make, n,
            f"{PREVIOUS_K9_RE}|{GATHER_RE}")
        out[f"iteration{it}"] = {"active_lanes": n_act,
                                 **_timed_in_order(runs, reverse)}
        del attrs
        torch.cuda.empty_cache()
    return out


def k13_times(k13_libs, tabs, cases, reverse: bool, n: int = 20) -> dict:
    """Every K13 build and the previous K13 on every case by ``batch_ms``."""
    out = {}
    for case, rays in cases.items():
        o = k13_outputs(rays)
        runs = {"previous": (lambda: k13_launch(None, rays, tabs, o),
                             lambda: (), n, PREVIOUS_K13_RE)}
        for name, fn in k13_libs.items():
            runs[name] = (lambda fn=fn: k13_launch(fn, rays, tabs, o),
                          lambda: (), n, K13_RE)
        out[case] = _timed_in_order(runs, reverse)
    return out


# -- per render ----------------------------------------------------------------

def render_table(dev, k9_libs, repeats: int = 3) -> dict:
    """The flagship film pinned (``persistent_render_sum_fused``'s loop,
    spp 4) with every K9 build after K1, and with K1 + gather + the previous
    K9: wall seconds (host clock) and the step's device time per render
    (the profiler: K9, or the previous K9 and the gather), each the median
    of ``repeats`` renders in turns, the launches, the device's busy time
    and idle share, and every image bitwise the shipped one's."""
    scene, cam, _, _ = V.flagship(dev)
    u, v = pt.pixel_coords(W, H, device=dev)

    def loop(iteration):
        return lambda: I.pinned_render_loop(
            scene, cam, u, v, 7, SPP, 0, DEPTH, TMIN, float(W), float(H),
            None, None, None, iteration)

    def with_build(fn):
        def run(impl, tables, fs, ist, u_, v_, cc, seed32, it, last, md,
                tmin, u9):
            _, sph, amat = tables
            t, idx = K1.sweep(fs[0:6], sph, tmin)
            err = fn(fs.data_ptr(), ist.data_ptr(), t.data_ptr(),
                     idx.data_ptr(), amat.data_ptr(), u_.data_ptr(),
                     v_.data_ptr(), cc.data_ptr(),
                     None if u9 is None else u9.data_ptr(), fs.shape[1],
                     last, md, seed32 & 0xFFFFFFFF, it & 0xFFFFFFFF,
                     torch.cuda.current_stream().cuda_stream)
            build.check(err, "K9 variant")
        return loop(run)

    def three_launch(impl, tables, fs, ist, u_, v_, cc, seed32, it, last, md,
                     tmin, u9):
        _, sph, amat = tables
        t, idx = K1.sweep(fs[0:6], sph, tmin)
        err = build.load().rtw_shade_pinned(
            fs.data_ptr(), ist.data_ptr(), t.data_ptr(),
            fetch_attr_planes(idx, amat).data_ptr(), u_.data_ptr(),
            v_.data_ptr(), cc.data_ptr(),
            None if u9 is None else u9.data_ptr(), fs.shape[1], last, md,
            seed32 & 0xFFFFFFFF, it & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
        build.check(err, "previous K9")

    fns = {name: with_build(fn) for name, fn in k9_libs.items()}
    fns["shipped"] = lambda: I.persistent_render_sum_fused(
        scene, cam, u, v, 7, SPP, 0, DEPTH, TMIN, float(W), float(H))
    fns["gather_previous"] = loop(three_launch)
    pat = {name: K9_RE for name in fns}
    pat["gather_previous"] = f"{PREVIOUS_K9_RE}|{GATHER_RE}"
    ref = fns["shipped"]()  # warm-up
    same = {name: bool(torch.equal(C._bits(fn()), C._bits(ref)))
            for name, fn in fns.items() if name != "shipped"}
    C.check(all(same.values()), f"pinned renders differ: {same}")
    secs = {name: [] for name in fns}
    prof = {name: [] for name in fns}
    for r in range(repeats):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            secs[name].append(V._timed(fns[name])[0])
    for r in range(repeats):
        for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            p = C.profile_call(fns[name], {"step": pat[name],
                                           "sweep": r"\bsweep_kernel\b"})
            prof[name].append(p)
    row = {name: {"seconds_runs": secs[name],
                  "seconds_median": statistics.median(secs[name]),
                  "step_device_ms": statistics.median(
                      p["device_ms_by_match"]["step"]["device_ms"]
                      for p in prof[name]),
                  "step_launches": prof[name][0]["device_ms_by_match"][
                      "step"]["count"],
                  "sweep_device_ms": statistics.median(
                      p["device_ms_by_match"]["sweep"]["device_ms"]
                      for p in prof[name]),
                  "device_busy_s": statistics.median(
                      p["device_busy_s"] for p in prof[name]),
                  "device_idle_share": statistics.median(
                      p["device_idle_share"] for p in prof[name])}
           for name in fns}
    row["bitwise_equal_to_shipped"] = same
    return {"pinned_render": row}


# -- verdict -------------------------------------------------------------------

#: (change, against) of each change alone, per kernel
K9_ALONE = (("shipped", "gather_previous"), ("shipped", "previous"),
            ("exit", "gather_previous"), ("shipped", "exit"),
            ("shipped_t64", "shipped"), ("shipped_t256", "shipped"))
K13_ALONE = (("shipped", "previous"), ("shipped", "shipped_roots"),
             ("shipped_roots", "previous"), ("persistent", "shipped"),
             ("shipped_t256", "shipped"), ("shipped_t512", "shipped"),
             ("shipped_ldg", "shipped"), ("split_q2", "persistent"),
             ("split_q4", "persistent"))


def changes_alone(tabs: dict, renders: dict | None) -> dict:
    """Each change's ``event_ms`` over what it replaces, per shape (the
    pairs of variants that were timed); K9's also per pinned render (the
    step's device time per render)."""
    out = {kernel: [{"shape": shape, "change": c, "against": b,
                     "ratio": t[c]["event_ms"] / t[b]["event_ms"]}
                    for shape, t in tabs[kernel].items() for c, b in pairs
                    if c in t and b in t]
           for kernel, pairs in (("k9", K9_ALONE), ("k13", K13_ALONE))}
    if renders:
        r = renders["pinned_render"]
        out["k9"] += [{"shape": "pinned_render", "change": c, "against": b,
                       "ratio": r[c]["step_device_ms"]
                       / r[b]["step_device_ms"]} for c, b in K9_ALONE
                      if c in r and b in r]
    return out


def verdict(alone: dict) -> dict:
    """Which change is kept. K9: at least 1% faster (``V.KEEP_RATIO``) per
    pinned render, its main path, and no slower at any iteration. K13: at
    least 1% faster on every case."""
    def rows(kernel, c, b):
        return [r for r in alone[kernel]
                if (r["change"], r["against"]) == (c, b)]

    def kept9(c, b):
        rs = rows("k9", c, b)
        per_render = [r for r in rs if r["shape"] == "pinned_render"]
        return (bool(per_render)
                and all(r["ratio"] <= V.KEEP_RATIO for r in per_render)
                and all(r["ratio"] <= 1.0 for r in rs))

    def kept13(c, b):
        rs = rows("k13", c, b)
        return bool(rs) and all(r["ratio"] <= V.KEEP_RATIO for r in rs)

    return {"k9": {f"{c}_over_{b}": kept9(c, b) for c, b in K9_ALONE
                   if b != "previous"},  # the previous K9 needs the gather
            "k13": {f"{c}_over_{b}": kept13(c, b) for c, b in K13_ALONE},
            "shipped": {"k9": "128-lane blocks pack their active lanes "
                              "(idle blocks return at once) and shade them, "
                              "one thread each, the winner's row by index",
                        "k13": "one 128-ray block per tile staging the "
                               "tables, every pair's roots behind disc > 0"},
            "rule": "a change of K9 is kept where it is at least 1% faster "
                    "per pinned render and no slower at any iteration "
                    "(event_ms); a change of K13 where it is at least 1% "
                    "faster (event_ms) on every case"}


def run_pass_set(dev, passes: int, k9_builds=K9_BUILDS,
                 k13_builds=K13_BUILDS, renders: bool = True) -> dict:
    """Build, check and time the variants of the builds named (``passes``
    timing passes, then per render unless ``renders`` is false). The
    phases' JSON objects as a dict."""
    scene, cam, spheres, amat = V.flagship(dev)
    st = V.k12_states(dev, scene, cam, spheres, amat)
    sweeps = k9_sweeps(st)
    tabs, cases = k13_cases(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    k9_libs, k13_libs, report = build_variants(
        tempfile.mkdtemp(dir=os.path.join(ROOT, "build")), k9_builds,
        k13_builds)
    bad9 = check_k9(k9_libs, st, sweeps)
    bad13 = check_k13(k13_libs, tabs, cases)
    times = _median_tables([
        {"k9": k9_times(k9_libs, st, sweeps, bool(r % 2)),
         "k13": k13_times(k13_libs, tabs, cases, bool(r % 2))}
        for r in range(passes)])
    del st, sweeps, cases
    torch.cuda.empty_cache()
    rend = render_table(dev, k9_libs) if renders else None
    alone = changes_alone(times, rend)
    return {"ptxas": report,
            "occupancy": {"k13": K13.occupancy(tabs.n_global, tabs.K, tabs.P,
                                               dev)},
            "checks": {"k9_cases": len(bad9),
                       "k9_lanes_differing": sum(bad9.values()),
                       "k13_cases": len(bad13),
                       "k13_lanes_differing": sum(bad13.values()),
                       "tolerance": "K9's every state word bit for bit K1 + "
                                    "gather + the previous K9's; K13's t, "
                                    "idx and skips bit for bit the previous "
                                    "K13's"},
            "times": times, "renders": rend,
            "changes_alone": alone, "verdict": verdict(alone)}


_median_tables = V._median_tables


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = C.card_line()
    print(card, flush=True)
    build.load()
    t0 = time.perf_counter()
    out = run_pass_set(dev, 5)
    C.emit({"phase": "ptxas", **out["ptxas"], "occupancy": out["occupancy"]})
    C.emit({"phase": "variants_checks", **out["checks"]})
    C.emit({"phase": "variant_times", "card": card, "passes": 5,
            **out["times"],
            "note": "medians of 5 passes (every other one in reverse "
                    "order); event_ms: one event pair around the launches "
                    "(K9: each on its own copy of the state); profiler_ms: "
                    "the profiler's per-launch mean (gather_previous: the "
                    "gather, its cast and the previous K9 summed)"})
    C.emit({"phase": "renders", "card": card, **out["renders"]})
    C.emit({"phase": "changes_alone", **out["changes_alone"]})
    C.emit({"phase": "verdict", **out["verdict"],
            "seconds": time.perf_counter() - t0})
    print(C.card_line(), flush=True)
    C.emit({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
