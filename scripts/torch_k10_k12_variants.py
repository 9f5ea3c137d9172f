"""K10 (``sweep_fetch_kernel``) and K12 (``mega_kernel``) beside the designs
they were chosen over, on the card: what each change of their redesign does
alone, and why the shipped kernels are what they are.

The shipped sources (``csrc/sweep.cu``, ``csrc/mega.cu``) are built as they
stand (``shipped``) and rewritten into variants, each built by its own
``nvcc -Xptxas -v`` (all at once), with the launcher's C signature
unchanged:

- K10 ``previous``: the one-thread kernel that the shipped library keeps
  as the split loop's reference (``sweep_fetch_one_thread``: one thread per
  ray, the roots on every pair, both tables in shared memory).
  ``shipped_share``: the group's P threads share the ten plane writes
  (thread p writes planes p, p + P, ...) instead of the first writing all
  ten; ``shipped_smem``: the [N, 10] table staged in each block's shared
  memory, the row read from there.
- K12 ``previous``: the kernel before the redesign (one thread per lane
  over every lane, the one-thread loop, both tables staged in shared
  memory, 128-thread blocks). ``shipped_sweep_all``: no skip, every lane
  is swept and shaded (the step leaves an idle lane as it is);
  ``shipped_own``: each thread shades its own lane, not packed lane j;
  ``shipped_b1``, ``_b10``, ``_b16``: a launch bound of 1 (no register
  cap: the 64 registers the code takes), 10 or 16 blocks per SM, not 12
  (40 registers);
  ``shipped_t256_b1``: 256-lane blocks without a bound (this PR's first
  design), ``_t256_b5``: with 5 per SM; ``shipped_t64_b20``: 64-lane
  blocks, 20 per SM; ``shipped_p1``, ``_p4``, ``_p16``: P fixed for every
  block (the per-block rule replaced by a constant).

It prints each build's registers, spills and shared memory, and the
shipped K12's resident blocks. It holds every build bit for bit: K10 (t,
idx and the ten planes) against the one-thread kernel on four ray sets,
the K1 phase's 2^20 rays, bounces 0 (2 073 600 camera rays) and 3 of the
``fused_attrs`` render's first pass and the flagship's 32 400 mid-render
lanes, the shipped build at every P; K12 (every state word) against K1, the
gather and K9 at iterations 0, 8, 24 and 40 of the flagship film pinned
(2 073 600 lanes, spp 4), with injected and with Philox draws. It times
every build with ``chip_smoke.batch_ms`` (one CUDA event pair around N
launches, and the profiler's per-launch mean): K10 on the four sets, K12
at the four iterations (each launch on its own copy of the state). Five
passes, every other one in reverse order; each time is the median of the
five. Then per render: the megakernel render (64 launches) with every K12
variant, and the ``fused_attrs`` render (64 launches) with the one-thread
and the shipped K10, each by the host clock (medians, in turns) and by
the profiler (the kernel's device time per render), the images bitwise
equal. The last lines give each change alone against what it replaces,
and the verdict: a change of K10 is kept where it is at least 1% faster at
every shape it was timed at, a change of K12 where it is at least 1%
faster per megakernel render. One JSON object per line; a failed check
raises.

    python3 scripts/torch_k10_k12_variants.py    # one CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import importlib
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import raytracingweekend_jl_tpu_torch as pt  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops import integrator as I  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import build  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import (  # noqa: E402
    intersect_kernel as K1, mega_kernel as K12, shade_kernel as K2)
from raytracingweekend_jl_tpu_torch.ops.materials import (  # noqa: E402
    attr_mat, fetch_attr_planes)

MG = importlib.import_module("raytracingweekend_jl_tpu_torch.ops."
                             "experimental.mega")

W, H, SPP, DEPTH, TMIN = 1920, 1080, 4, 16, 1e-4

# -- source rewrites ---------------------------------------------------------

K10_KERNEL = re.compile(r"__global__ void __launch_bounds__\("
                        r"RTW_SWEEP_THREADS\)\n    sweep_fetch_kernel\(.*?\n}\n",
                        re.S)
K10_LAUNCH = re.compile(r'extern "C" int rtw_sweep_fetch\(.*?\n}\n', re.S)

K10_WRITES = """  if (i < n_rays && p == 0) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
    const bool hit = best_t < RTW_BIG;
    const float* row = amat + 10 * (size_t)best_i;
#pragma unroll
    for (int j = 0; j < 10; ++j)
      attrs_out[j * n + i] = hit ? __ldg(row + j) : 0.0f;
  }
"""
K10_SHARED_WRITES = """  if (i < n_rays) {
    if (p == 0) {
      t_out[i] = best_t;
      idx_out[i] = best_i;
    }
    const bool hit = best_t < RTW_BIG;
    const float* row = amat + 10 * (size_t)best_i;
    for (int j = p; j < 10; j += 1 << log2p)
      attrs_out[j * n + i] = hit ? __ldg(row + j) : 0.0f;
  }
"""
# The attribute table is staged before rtw_split_sweep, whose barrier after
# the sphere table's staging covers both.
K10_STAGE = "  long long i;\n"
K10_STAGE_TABLE = """  float* sattr = reinterpret_cast<float*>(sph + n_spheres);
  for (int j = threadIdx.x; j < 10 * n_spheres; j += blockDim.x)
    sattr[j] = amat[j];
  long long i;
"""
K10_ROW = "    const float* row = amat + 10 * (size_t)best_i;\n"
K10_TABLE_ROW = "    const float* row = sattr + 10 * best_i;\n"
K10_LDG = "hit ? __ldg(row + j) : 0.0f;"
K10_LDS = "hit ? row[j] : 0.0f;"
K10_SMEM = """  if (e != cudaSuccess) return (int)e;
  sweep_fetch_kernel<<<"""
K10_SMEM_TABLE = """  if (e != cudaSuccess) return (int)e;
  smem += (size_t)n_spheres * 10 * sizeof(float);
  e = rtw_reserve_smem((const void*)sweep_fetch_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sweep_fetch_kernel<<<"""

K12_KERNEL = re.compile(r"__global__ void __launch_bounds__\(RTW_MEGA_THREADS, "
                        r"RTW_MEGA_MIN_BLOCKS\)\n    mega_kernel\(.*?\n}\n",
                        re.S)
K12_LAUNCH = re.compile(r'extern "C" int rtw_mega\(.*?\n}\n', re.S)

#: The earlier K12: one thread per lane over every lane, the one-thread
#: loop, the sphere and attribute tables staged per block.
PREVIOUS_K12 = """__global__ void mega_kernel(float* __restrict__ fs, int* __restrict__ is,
                            const float4* __restrict__ spheres,
                            const float* __restrict__ amat, int n_spheres,
                            float tmin, const float* __restrict__ fu,
                            const float* __restrict__ fv,
                            const float* __restrict__ cam,
                            const float* __restrict__ u9, int n,
                            int last_sample, int max_depth, uint32_t seed,
                            uint32_t iteration) {
  extern __shared__ float4 sph[];
  float* sattr = reinterpret_cast<float*>(sph + n_spheres);
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) sph[s] = spheres[s];
  for (int j = threadIdx.x; j < 10 * n_spheres; j += blockDim.x)
    sattr[j] = amat[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t;
  int best_i;
  rtw_sweep_closest(sph, n_spheres, fs[0 * n + i], fs[1 * n + i],
                    fs[2 * n + i], fs[3 * n + i], fs[4 * n + i],
                    fs[5 * n + i], tmin, best_t, best_i);
  const bool hit = best_t < RTW_BIG;
  const float* row = sattr + 10 * best_i;
  float a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = hit ? row[j] : 0.0f;

  float u[9];
  if (u9) {
#pragma unroll
    for (int j = 0; j < 9; ++j) u[j] = u9[j * n + i];
  } else {
    rtw_uniforms<9>(seed, iteration, (uint32_t)i, u);
  }
  rtw_pinned_step(i, n, fs, is, best_t, a, u, fu[i], fv[i], cam, last_sample,
                  max_depth);
}
"""

#: Its launcher, with the shipped signature.
PREVIOUS_K12_LAUNCH = """extern "C" int rtw_mega(float* fstate, int* istate, const float* spheres,
                        const float* amat, int n_spheres, float tmin,
                        const float* fu, const float* fv, const float* cam,
                        const float* u9, int n, int last_sample, int max_depth,
                        unsigned int seed, unsigned int iteration,
                        void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)n_spheres * (sizeof(float4) + 10 * sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mega_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      fstate, istate, reinterpret_cast<const float4*>(spheres), amat,
      n_spheres, tmin, fu, fv, cam, u9, n, last_sample, max_depth, seed,
      iteration);
  return (int)cudaGetLastError();
}
"""

K12_ACTIVE = "  const bool act = i0 < n && is[2 * n + i0] != 0;\n"
K12_EVERY = "  const bool act = i0 < n;\n"
K12_PACKED_SHADE = """  if (threadIdx.x >= n_act) return;
  const int i = ids[threadIdx.x];
  const float t = win_t[threadIdx.x];
  const bool hit = t < RTW_BIG;
  const float* row = amat + 10 * (size_t)win_i[threadIdx.x];
"""
K12_OWN_SHADE = """  if (!act) return;
  const int jj = base[warp] + __popc(m & ((1u << lane) - 1u));
  const int i = i0;
  const float t = win_t[jj];
  const bool hit = t < RTW_BIG;
  const float* row = amat + 10 * (size_t)win_i[jj];
"""
K12_RULE = """  int P = p_cap < 16 ? p_cap : 16;
  while (P > 1 && n_act * P > 4 * RTW_MEGA_THREADS) P >>= 1;
"""
K12_BOUND = "#define RTW_MEGA_MIN_BLOCKS 12\n"
K12_THREADS = "#define RTW_MEGA_THREADS 128\n"


def _sub(src: str, old, new: str) -> str:
    """``src`` with the one occurrence of ``old`` (a string or a compiled
    pattern) replaced by ``new``; raises unless there is exactly one."""
    if isinstance(old, re.Pattern):
        n = len(old.findall(src))
        out = old.sub(lambda m: new, src)
    else:
        n = src.count(old)
        out = src.replace(old, new)
    if n != 1:
        raise RuntimeError(f"rewrite target found {n} times: {old!r:.80}")
    return out


def _in(src: str, pattern: re.Pattern, *edits) -> str:
    """``src`` with the edits ``(old, new), ...`` made inside the one
    function that ``pattern`` matches."""
    m = pattern.findall(src)
    if len(m) != 1:
        raise RuntimeError(f"function found {len(m)} times: {pattern!r:.80}")
    body = m[0]
    for old, new in edits:
        body = _sub(body, old, new)
    return _sub(src, pattern, body)


def k10_source(src: str, name: str) -> str:
    """sweep.cu of K10's variant ``name``."""
    if name == "shipped":
        return src
    if name == "shipped_share":
        return _in(src, K10_KERNEL, (K10_WRITES, K10_SHARED_WRITES))
    if name == "shipped_smem":
        src = _in(src, K10_KERNEL, (K10_STAGE, K10_STAGE_TABLE),
                  (K10_ROW, K10_TABLE_ROW), (K10_LDG, K10_LDS))
        return _in(src, K10_LAUNCH, (K10_SMEM, K10_SMEM_TABLE))
    raise ValueError(name)


def k12_source(src: str, name: str) -> str:
    """mega.cu of K12's variant ``name``."""
    if name == "previous":
        src = _sub(src, K12_KERNEL, PREVIOUS_K12)
        return _sub(src, K12_LAUNCH, PREVIOUS_K12_LAUNCH)
    if name == "shipped":
        return src
    change = name.removeprefix("shipped_")
    if change == "sweep_all":
        return _sub(src, K12_ACTIVE, K12_EVERY)
    if change == "own":
        return _sub(src, K12_PACKED_SHADE, K12_OWN_SHADE)
    for part in change.split("_"):
        if part[0] == "b":  # a launch bound of that many blocks per SM
            src = _sub(src, K12_BOUND,
                       f"#define RTW_MEGA_MIN_BLOCKS {int(part[1:])}\n")
        elif part[0] == "t":  # lanes (threads) per block
            src = _sub(src, K12_THREADS,
                       f"#define RTW_MEGA_THREADS {int(part[1:])}\n")
        elif part[0] == "p":  # P for every block
            src = _sub(src, K12_RULE, f"  const int P = {int(part[1:])};\n")
        else:
            raise ValueError(name)
    return src


#: Builds (``previous`` of K10 is the shipped library's reference kernel).
K10_BUILDS = ("shipped", "shipped_share", "shipped_smem")
K12_BUILDS = ("shipped", "previous", "shipped_sweep_all", "shipped_own",
              "shipped_b1", "shipped_b10", "shipped_b16", "shipped_t256_b1",
              "shipped_t256_b5", "shipped_t64_b20", "shipped_p1",
              "shipped_p4", "shipped_p16")

SOURCES = {"k10": "sweep.cu", "k12": "mega.cu"}
KERNELS = {"k10": "sweep_fetch_kernel", "k12": "mega_kernel"}
LAUNCHERS = {"k10": "rtw_sweep_fetch", "k12": "rtw_mega"}
PTXAS = re.compile(r"Function properties for \w*?(sweep_fetch_kernel|"
                   r"mega_kernel)\w*\s+(\d+) bytes stack frame, (\d+) bytes "
                   r"spill stores, (\d+) bytes spill loads\s+ptxas info\s*: "
                   r"Used (\d+) registers")
SMEM = re.compile(r"(\d+) bytes smem")


def build_variants(out: str, k10_builds=K10_BUILDS,
                   k12_builds=K12_BUILDS) -> tuple:
    """``({name: launcher} of K10's builds, of K12's, {kernel/name: ptxas
    report})``: the builds named compiled into ``out``, one nvcc each, all
    at once."""
    srcs = {}
    for kernel, f in SOURCES.items():
        with open(os.path.join(build.CSRC_DIR, f)) as fh:
            srcs[kernel] = fh.read()
    jobs = {("k10", n): k10_source(srcs["k10"], n) for n in k10_builds}
    jobs.update({("k12", n): k12_source(srcs["k12"], n) for n in k12_builds})
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
    libs = {"k10": {}, "k12": {}}
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
    return libs["k10"], libs["k12"], report


# -- launches ----------------------------------------------------------------

def k10_launch(fn, rays, spheres, amat, out, parts: int) -> None:
    """One launch of a K10 build (``fn``: its ``rtw_sweep_fetch``, or None
    for the one-thread reference) into ``out`` = (t, idx, attrs)."""
    stream = torch.cuda.current_stream().cuda_stream
    args = (rays.data_ptr(), spheres.data_ptr(), amat.data_ptr(),
            rays.shape[1], spheres.shape[0], TMIN, *(x.data_ptr() for x in out))
    if fn is None:
        err = build.load().rtw_sweep_fetch_one_thread(*args, stream)
    else:
        err = fn(*args, parts, stream)
    build.check(err, "K10 variant")


def k10_outputs(rays) -> tuple:
    n, dev = rays.shape[1], rays.device
    return (torch.full((n,), 7.0, device=dev),
            torch.full((n,), 7, dtype=torch.int32, device=dev),
            torch.full((10, n), 7.0, device=dev))


def k12_launch(fn, st, fs, ist, it: int, u9=None) -> None:
    """One launch of a K12 build on ``fs``/``ist`` at iteration ``it`` of
    the film ``st`` (:func:`k12_states`)."""
    sph, amat = st["spheres"], st["amat"]
    err = fn(fs.data_ptr(), ist.data_ptr(), sph.data_ptr(), amat.data_ptr(),
             sph.shape[0], TMIN, st["u"].data_ptr(), st["v"].data_ptr(),
             st["cc"].data_ptr(), None if u9 is None else u9.data_ptr(),
             fs.shape[1], SPP - 1, DEPTH, st["seed"], it,
             torch.cuda.current_stream().cuda_stream)
    build.check(err, "K12 variant")


def pinned_iteration(st, fs, ist, it: int, u9=None) -> None:
    """The pinned iteration before K9 took the fetch: K1, the gather, the
    previous K9 (``shade_and_regen``, kept on no route)."""
    t, idx = K1.sweep(fs[0:6], st["spheres"])
    K2.shade_and_regen(fs, ist, t, fetch_attr_planes(idx, st["amat"]),
                       st["u"], st["v"], st["cc"], st["seed"], it, SPP - 1,
                       DEPTH, u9)


# -- inputs --------------------------------------------------------------------

K12_ITERATIONS = (0, 8, 24, 40)


def flagship(dev) -> tuple:
    """The flagship scene (trimmed, on ``dev``), its camera, sphere table
    and attribute table."""
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    return scene, pt.t_cam1(device=dev), K1.sphere_consts(scene), \
        attr_mat(scene)


def fused_attrs_rays(dev, bounces=(0, 3)) -> dict:
    """The rays K10 sweeps at ``bounces`` of the first pass of the
    ``fused_attrs`` render (1920x1080, spp 4), captured at its launches."""
    calls, seen = {}, [0]
    real = K1.sweep_fetch

    def capture(rays, *a, **kw):
        if seen[0] in bounces:
            calls[seen[0]] = rays.clone()
        seen[0] += 1
        return real(rays, *a, **kw)

    K1.sweep_fetch = capture
    try:
        pt.render(pt.scene_random_spheres(seed=1), pt.t_cam1(), W, SPP,
                  device=dev, fused_attrs=True)
    finally:
        K1.sweep_fetch = real
    C.check(sorted(calls) == sorted(bounces), f"captured {sorted(calls)}")
    return calls


def k10_sets(dev, scene, cam, spheres) -> dict:
    """K10's four ray sets: the K1 phase's 2^20 rays, bounces 0 and 3 of
    the ``fused_attrs`` render, the flagship's 32 400 mid-render lanes."""
    rays = fused_attrs_rays(dev)
    st, _, _, _ = C.mid_render_state(scene, cam, W, H, SPP)
    return {"rays_2p20": C.k1_phase_rays(dev, cam, spheres),
            "camera_2073600": rays[0], "bounce3_2073600": rays[3],
            "mid_render_32400": st.fstate[0:6].contiguous()}


def k12_states(dev, scene, cam, spheres, amat) -> dict:
    """The flagship film pinned (2 073 600 lanes, spp 4) before iterations
    0, 8, 24 and 40, advanced by the pinned route; with the film
    coordinates, camera constants and seed of the ``k12`` phase."""
    u, v = pt.pixel_coords(W, H, device=dev)
    n = u.shape[0]
    org, d = I.pinned_start_rays(cam, u, v, 0, 0, float(W), float(H))
    fs = torch.zeros((12, n), device=dev)
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=torch.int32, device=dev)
    ist[2] = 1
    st = {"u": u, "v": v, "cc": K2.pack_camera_consts(cam, W, H),
          "seed": 0x9E3779B9, "spheres": spheres, "amat": amat, "at": {}}
    for it in range(max(K12_ITERATIONS) + 1):
        if it in K12_ITERATIONS:
            st["at"][it] = (fs.clone(), ist.clone(),
                            int((ist[2] != 0).sum()))
        pinned_iteration(st, fs, ist, it)
    torch.cuda.synchronize()
    return st


# -- checks --------------------------------------------------------------------

def check_k10(k10_libs, sets, spheres, amat) -> dict:
    """Every K10 build (the wrapper's P), and the shipped build at every
    P, bit for bit against the one-thread kernel on every set: the lanes
    that differ by case (all 0, or it raises)."""
    bad = {}
    for set_name, r in sets.items():
        ref = k10_outputs(r)
        k10_launch(None, r, spheres, amat, ref, 0)
        auto = K1.sweep_parts(r.shape[1], spheres.shape[0],
                              K1._resident_threads(r.device, spheres.shape[0],
                                                   "sweep_fetch"))
        runs = [(name, auto) for name in k10_libs]
        runs += [("shipped", p) for p in (1, 2, 4, 8, 16, 32) if p != auto]
        for name, p in runs:
            out = k10_outputs(r)
            k10_launch(k10_libs[name], r, spheres, amat, out, p)
            torch.cuda.synchronize()
            bad[f"{set_name}/{name}/p{p}"] = int(C._bitwise_lanes(
                list(zip(out, ref)), r.shape[1]).sum())
    C.check(all(v == 0 for v in bad.values()),
            f"a K10 build differs from the one-thread kernel: "
            f"{ {k: v for k, v in bad.items() if v} }")
    return bad


def check_k12(k12_libs, st) -> dict:
    """Every K12 variant against K1 + gather + K9, every state word bit for
    bit, at each iteration, with injected and Philox draws."""
    g = torch.Generator(device=st["u"].device).manual_seed(12)
    bad = {}
    for it, (fs, ist, _) in st["at"].items():
        n = fs.shape[1]
        for draws, u9 in (("injected", torch.rand((9, n), generator=g,
                                                   device=fs.device)),
                          ("philox", None)):
            ref = [fs.clone(), ist.clone()]
            pinned_iteration(st, *ref, it, u9)
            for name, fn in k12_libs.items():
                got = [fs.clone(), ist.clone()]
                k12_launch(fn, st, *got, it, u9)
                torch.cuda.synchronize()
                bad[f"it{it}/{draws}/{name}"] = int(C._bitwise_lanes(
                    list(zip(got, ref)), n).sum())
                del got
    C.check(all(v == 0 for v in bad.values()),
            f"a K12 build differs from K1 + gather + K9: "
            f"{ {k: v for k, v in bad.items() if v} }")
    return bad


# -- times ---------------------------------------------------------------------

K10_RE = r"\bsweep_fetch_kernel\b"
ONE_THREAD_RE = r"\bsweep_fetch_one_thread_kernel\b"
K12_RE = r"\bmega_kernel\b"


def _timed_in_order(runs: dict, reverse: bool) -> dict:
    names = list(runs)[::-1] if reverse else list(runs)
    out = {name: C.batch_ms(*runs[name]) for name in names}
    return {name: out[name] for name in runs}


def k10_times(k10_libs, sets, spheres, amat, reverse: bool,
              n: int = 20) -> dict:
    """Every K10 variant on every set by ``batch_ms`` (the wrapper's P)."""
    out = {}
    for set_name, r in sets.items():
        o = k10_outputs(r)
        auto = K1.sweep_parts(r.shape[1], spheres.shape[0],
                              K1._resident_threads(r.device, spheres.shape[0],
                                                   "sweep_fetch"))
        runs = {"previous": (lambda: k10_launch(None, r, spheres, amat, o, 0),
                             lambda: (), n, ONE_THREAD_RE)}
        for name in k10_libs:
            runs[name] = (lambda fn=k10_libs[name]: k10_launch(
                fn, r, spheres, amat, o, auto), lambda: (), n, K10_RE)
        out[set_name] = {"rays": r.shape[1], "parts": auto,
                         **_timed_in_order(runs, reverse)}
    return out


def k12_times(k12_libs, st, reverse: bool, n: int = 20) -> dict:
    """Every K12 variant at each iteration by ``batch_ms``, each launch on
    its own copy of the state, with K1 + gather + K9 beside them."""
    out = {}
    for it, (fs, ist, n_act) in st["at"].items():
        make = lambda: (fs.clone(), ist.clone())
        runs = {name: (lambda f, i, fn=fn: k12_launch(fn, st, f, i, it),
                       make, n, K12_RE)
                for name, fn in k12_libs.items()}
        runs["k1_gather_k9"] = (lambda f, i: pinned_iteration(st, f, i, it),
                                make, n, r"\bsweep_kernel\b|"
                                r"\bshade_pinned_kernel\b|"
                                r"index_elementwise_kernel|"
                                r"direct_copy_kernel")
        out[f"iteration{it}"] = {"active_lanes": n_act,
                                 **_timed_in_order(runs, reverse)}
        torch.cuda.empty_cache()
    return out


def _median_tables(passes: list) -> dict:
    """The median ``event_ms`` and ``profiler_ms`` of each timed entry (of
    the passes whose profiler kept the launches' records)."""
    def walk(xs):
        if isinstance(xs[0], dict) and "event_ms" in xs[0]:
            return {k: statistics.median(v) if (v := [
                x[k] for x in xs if x[k] is not None]) else None
                for k in ("event_ms", "profiler_ms")}
        if isinstance(xs[0], dict):
            return {k: walk([x[k] for x in xs]) for k in xs[0]}
        return xs[0]
    return walk(passes)


# -- per render ----------------------------------------------------------------

def _timed(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def render_tables(dev, k12_libs, repeats: int = 3) -> dict:
    """The megakernel render with every K12 variant (the shipped one
    through the route, ``ops/experimental/mega.py``), and the
    ``fused_attrs`` render with the one-thread and the shipped K10: wall
    seconds (host clock) and the kernel's device time per render (the
    profiler), each the median of ``repeats`` renders in turns, the
    kernel's launches, the device's busy time and idle share, and every
    image bitwise the shipped one's (the megakernel's also the pinned
    route's)."""
    scene, cam, _, _ = flagship(dev)
    u, v = pt.pixel_coords(W, H, device=dev)

    def iteration(fn):
        def run(impl, tables, fs, ist, u_, v_, cc, seed32, it, last, md,
                tmin, u9):
            _, sph, amat = tables
            err = fn(fs.data_ptr(), ist.data_ptr(), sph.data_ptr(),
                     amat.data_ptr(), sph.shape[0], tmin, u_.data_ptr(),
                     v_.data_ptr(), cc.data_ptr(),
                     None if u9 is None else u9.data_ptr(), fs.shape[1],
                     last, md, seed32 & 0xFFFFFFFF, it & 0xFFFFFFFF,
                     torch.cuda.current_stream().cuda_stream)
            build.check(err, "K12 variant")
        return lambda: I.pinned_render_loop(
            scene, cam, u, v, 7, SPP, 0, DEPTH, TMIN, float(W), float(H),
            None, None, None, run)

    mega = {name: iteration(fn) for name, fn in k12_libs.items()}
    mega["shipped"] = lambda: MG.persistent_render_sum_mega(
        scene, cam, u, v, 7, SPP, 0, DEPTH, TMIN, float(W), float(H))
    flag_scene, flag_cam = pt.scene_random_spheres(seed=1), pt.t_cam1()
    real = K1.sweep_fetch

    def fused(one_thread: bool):
        K1.sweep_fetch = (lambda r, s, a, tmin=TMIN:
                          K1.sweep_fetch_one_thread(r, s, a, tmin)) \
            if one_thread else real
        try:
            return pt.render(flag_scene, flag_cam, W, SPP, device=dev,
                             fused_attrs=True)
        finally:
            K1.sweep_fetch = real

    trace = {"previous": lambda: fused(True), "shipped": lambda: fused(False)}
    out = {}
    for route, fns, pat in (
            ("mega_render", mega, {name: K12_RE for name in mega}),
            ("fused_attrs_render", trace, {"previous": ONE_THREAD_RE,
                                           "shipped": K10_RE})):
        ref = fns["shipped"]()  # warm-up
        same = {name: bool(torch.equal(C._bits(fn()), C._bits(ref)))
                for name, fn in fns.items() if name != "shipped"}
        C.check(all(same.values()), f"{route}: images differ: {same}")
        secs = {name: [] for name in fns}
        for r in range(repeats):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                secs[name].append(_timed(fns[name])[0])
        prof = {name: [] for name in fns}
        for r in range(repeats):
            for name in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                p = C.profile_call(fns[name], {"kernel": pat[name]})
                prof[name].append((p["device_ms_by_match"]["kernel"],
                                   p["device_busy_s"],
                                   p["device_idle_share"]))
        row = {name: {"seconds_runs": secs[name],
                      "seconds_median": statistics.median(secs[name]),
                      "kernel_device_ms_runs": [k["device_ms"]
                                                for k, _, _ in prof[name]],
                      "kernel_device_ms": statistics.median(
                          k["device_ms"] for k, _, _ in prof[name]),
                      "kernel_launches": prof[name][0][0]["count"],
                      "device_busy_s": statistics.median(
                          b for _, b, _ in prof[name]),
                      "device_idle_share": statistics.median(
                          i for _, _, i in prof[name])}
               for name in fns}
        row["bitwise_equal_to_shipped"] = same
        if route == "mega_render":
            pinned = I.persistent_render_sum_fused(
                scene, cam, u, v, 7, SPP, 0, DEPTH, TMIN, float(W), float(H))
            row["bitwise_equal_to_pinned"] = bool(torch.equal(
                C._bits(ref), C._bits(pinned)))
            C.check(row["bitwise_equal_to_pinned"],
                    "the megakernel image differs from the pinned route's")
            del pinned
        out[route] = row
        del ref
    return out


# -- verdict -------------------------------------------------------------------

#: (change, against) of each change alone, per kernel
K10_ALONE = (("shipped", "previous"), ("shipped_share", "shipped"),
             ("shipped_smem", "shipped"))
K12_ALONE = (("shipped", "previous"), ("shipped", "shipped_sweep_all"),
             ("shipped_sweep_all", "previous"), ("shipped_own", "shipped"),
             ("shipped_b1", "shipped"), ("shipped_b10", "shipped"),
             ("shipped_b16", "shipped"),
             ("shipped_t256_b1", "shipped"), ("shipped_t256_b5", "shipped"),
             ("shipped_t64_b20", "shipped"), ("shipped_p1", "shipped"),
             ("shipped_p4", "shipped"), ("shipped_p16", "shipped"))


def changes_alone(tabs: dict, renders: dict) -> dict:
    """Each change's ``event_ms`` over what it replaces, per shape (the
    pairs of variants that were timed); K12's also per megakernel render
    (the kernel's device time per render), and the shipped K12 over K1 +
    gather + K9 per iteration."""
    out = {kernel: [{"shape": shape, "change": c, "against": b,
                     "ratio": t[c]["event_ms"] / t[b]["event_ms"]}
                    for shape, t in tabs[kernel].items() for c, b in pairs
                    if c in t and b in t]
           for kernel, pairs in (("k10", K10_ALONE), ("k12", K12_ALONE))}
    out["k12"] += [{"shape": shape, "change": "shipped",
                    "against": "k1_gather_k9",
                    "ratio": t["shipped"]["event_ms"]
                    / t["k1_gather_k9"]["event_ms"]}
                   for shape, t in tabs["k12"].items()]
    r = renders["mega_render"]
    out["k12"] += [{"shape": "mega_render", "change": c, "against": b,
                    "ratio": r[c]["kernel_device_ms"]
                    / r[b]["kernel_device_ms"]} for c, b in K12_ALONE
                   if c in r and b in r]
    return out


#: A change is kept where it takes at most this share of what it replaces
#: at every shape: repeated medians of one build move by up to ~1%.
KEEP_RATIO = 0.99


def verdict(alone: dict) -> dict:
    """Which change is kept. K10: at least 1% faster at every shape
    against what it replaces. K12: at least 1% faster per megakernel render
    (its main path, whose 64 launches span every active share; its
    per-iteration ratios are in ``changes_alone``)."""
    def kept(kernel, c, b):
        rows = [r for r in alone[kernel] if (r["change"], r["against"])
                == (c, b)]
        per_render = [r for r in rows if r["shape"] == "mega_render"]
        return all(r["ratio"] <= KEEP_RATIO for r in per_render or rows)

    def timed(kernel, pairs):  # the pairs that were timed
        done = {(r["change"], r["against"]) for r in alone[kernel]}
        return [(c, b) for c, b in pairs if (c, b) in done]
    return {"k10": {"redesign": kept("k10", "shipped", "previous"),
                    **{c.removeprefix("shipped_"): kept("k10", c, b)
                       for c, b in timed("k10", K10_ALONE[1:])}},
            "k12": {"redesign": kept("k12", "shipped", "previous"),
                    **{("skip_idle" if b == "shipped_sweep_all"
                        else c.removeprefix("shipped_")): kept("k12", c, b)
                       for c, b in timed("k12", K12_ALONE[1:2]
                                         + K12_ALONE[3:])}},
            "shipped": {"k10": "K1's launch (256 threads, the sphere table "
                               "in shared memory, P threads per ray by the "
                               "wrapper's rule), then the group's first "
                               "thread writes (t, idx) and the winner's row "
                               "by index through the read-only path",
                        "k12": "128-lane blocks, at least 12 per SM, "
                               "pack their active lanes (idle blocks return "
                               "at once), sweep them with P per block (K3's "
                               "rule) and shade the packed lanes, one "
                               "thread each, the row by index"},
            "rule": "a change is kept where it is at least 1% faster "
                    "(event_ms) at every shape timed against what it "
                    "replaces (K10), per megakernel render (K12)"}


def run_pass_set(dev, passes: int, sets: dict | None = None,
                 k10_builds=K10_BUILDS, k12_builds=K12_BUILDS,
                 render_repeats: int = 3) -> dict:
    """Build, check and time the variants of the builds named (``passes``
    timing passes, then per render, ``render_repeats`` renders each);
    ``sets``: K10's ray sets (by default :func:`k10_sets`). The phases'
    JSON objects as a dict."""
    scene, cam, spheres, amat = flagship(dev)
    if sets is None:
        sets = k10_sets(dev, scene, cam, spheres)
    st = k12_states(dev, scene, cam, spheres, amat)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    k10_libs, k12_libs, report = build_variants(
        tempfile.mkdtemp(dir=os.path.join(ROOT, "build")), k10_builds,
        k12_builds)
    bad10 = check_k10(k10_libs, sets, spheres, amat)
    bad12 = check_k12(k12_libs, st)
    tabs = _median_tables([
        {"k10": k10_times(k10_libs, sets, spheres, amat, bool(r % 2)),
         "k12": k12_times(k12_libs, st, bool(r % 2))}
        for r in range(passes)])
    rend = render_tables(dev, k12_libs, render_repeats)
    alone = changes_alone(tabs, rend)
    return {"ptxas": report,
            "occupancy": {"k12": K12.occupancy(spheres.shape[0], dev),
                          **{k: K1.occupancy(k, spheres.shape[0], dev)
                             for k in ("sweep_fetch",
                                       "sweep_fetch_one_thread")}},
            "checks": {"k10_cases": len(bad10),
                       "k10_lanes_differing": sum(bad10.values()),
                       "k12_cases": len(bad12),
                       "k12_lanes_differing": sum(bad12.values()),
                       "k12_active_lanes": {it: a for it, (_, _, a)
                                            in st["at"].items()},
                       "tolerance": "K10's t, idx and ten planes bit for "
                                    "bit the one-thread kernel's; K12's "
                                    "every state word bit for bit K1 + "
                                    "gather + K9's"},
            "times": tabs,
            "renders": rend,
            "changes_alone": alone, "verdict": verdict(alone)}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = C.card_line()
    print(card, flush=True)
    build.load()
    out = run_pass_set(dev, 5)
    C.emit({"phase": "ptxas", **out["ptxas"], "occupancy": out["occupancy"]})
    C.emit({"phase": "variants_checks", **out["checks"]})
    C.emit({"phase": "variant_times", "card": card, "passes": 5,
            **out["times"],
            "note": "medians of 5 passes (every other one in reverse "
                    "order); event_ms: one event pair around the launches "
                    "(K12: each on its own copy of the state); "
                    "profiler_ms: the profiler's per-launch mean "
                    "(k1_gather_k9: the sweep, gather, cast and K9 "
                    "summed)"})
    C.emit({"phase": "renders", "card": card, **out["renders"]})
    C.emit({"phase": "changes_alone", **out["changes_alone"]})
    C.emit({"phase": "verdict", **out["verdict"]})
    print(C.card_line(), flush=True)
    C.emit({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
