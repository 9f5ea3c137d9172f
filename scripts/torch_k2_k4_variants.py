"""K2 (``shade_strided_kernel``) and K4 (``persist_record_kernel``) beside
the designs they were chosen over, on the card: what each change of their
redesign does alone, and why the shipped kernels are what they are.

The shipped sources (``csrc/shade_strided.cu``, ``csrc/persist_record.cu``)
are built as they stand (``shipped``) and rewritten into variants, each
built by its own ``nvcc -Xptxas -v`` (all at once), with the launcher's C
signature unchanged:

- ``previous``: the kernel before the fetch went inside. It reads the ten
  attribute planes that a gather wrote (the ``amat`` argument then holds
  those [10, n] planes); K4 also stores its record with the default
  policy. This is the earlier kernel's code but for an unused argument. It
  is timed alone and after its gather and cast (``gather+previous``, what
  the loops ran before).
- ``smem``: the [N, 10] table copied into each block's shared memory.
- K2 ``split_P2``, ``split_P4``, ``split_P8``: a lane's three Philox
  blocks, two Box-Muller branches and lens disk (moved out of the
  sample-start branch, since the whole group computes it) spread over P
  threads of a warp and exchanged with ``__shfl_sync``.
- K4 ``ldg``: the row fetch without the evict-first hint;
  ``previous_stcs``: the hint alone; ``previous_compact`` and
  ``shipped_compact``: each block's live lanes packed onto its first
  threads (a ballot, a scan of the 8 warp counts, 256-lane blocks), the
  draws still keyed by the lane.

K2's rewrites act on its lane, ``rtw_shade_strided_lane``, which the moving
scene's step (K2m, its ``kMoving`` instantiation) shares; only K2 is
checked and timed here.

It prints each build's registers, stack and spills. On the flagship
render's state at iteration 24 (32 400 lanes, ``mid_render_32400``) and at
its tail (the first multiple of 8 iterations after which under 10% of the
lanes are active), and on the flagship step's record states at iterations
20 and 40 (262 144 lanes), it holds every variant bit for bit against the
plain version (the gather, then the attribute-level step; injected and
Philox draws, K4 at both record widths) and times it with
``chip_smoke.batch_ms`` (one CUDA event pair around N launches, each on its
own copy of the state, and the profiler's per-launch mean), in three
passes, the second in reverse order; each time is the median of the three.
``gather+previous`` and ``shipped`` are also timed with an event pair
around each launch (``chip_smoke.device_ms``, the earlier method), and K3
with ``gather+previous``, ``ldg`` or ``shipped`` over 8 consecutive record
iterations from iteration 20 (median of 3), where the evict-first hint can
keep the state in L2 between launches. The last
lines give each change alone against what it replaces, and what ships: a
change is kept where it is faster at every shape it was timed at. One JSON
object per line; a failed check raises.

    python3 scripts/torch_k2_k4_variants.py     # one CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import raytracingweekend_jl_tpu_torch as pt  # noqa: E402
from raytracingweekend_jl_tpu_torch import rng  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops import integrator as I  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import build  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import (  # noqa: E402
    intersect_kernel as K1, persist_grad_kernel as PK, shade_kernel as K2)
from raytracingweekend_jl_tpu_torch.ops.materials import (  # noqa: E402
    attr_mat, fetch_attr_planes)

# -- source rewrites ---------------------------------------------------------

FETCH_ROW = "  rtw_fetch_row(idx, amat, i, a);\n"
K2_START = ("  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "  if (i >= n) return;\n")
K4_START = ("  const int i = blockIdx.x * blockDim.x + threadIdx.x;\n"
            "  if (i >= n_lanes) return;\n")
K4_DEAD = K4_START + """  const size_t n = n_lanes;
  if (si[2 * n + i] == 0) {
    rtw_zero_record<true>(i, n, rec, n_rec);
    return;
  }
"""

PLANES = ("#pragma unroll\n"
          "  for (int j = 0; j < 10; ++j) a[j] = amat[j * n + i];\n")

SMEM_STAGE = """  extern __shared__ float stab[];  // the [N, 10] table
  for (int j = threadIdx.x; j < 10 * RTW_N_SPHERES; j += blockDim.x)
    stab[j] = amat[j];
  __syncthreads();
"""
SMEM_ROW = """  {
    const float* row = stab + 10 * __ldg(idx + i);
#pragma unroll
    for (int j = 0; j < 10; ++j) a[j] = row[j];
  }
"""

COMPACT = """  constexpr int NW = 256 / 32;
  __shared__ int ids[256];
  __shared__ int base[NW + 1];  // per-warp offsets; base[NW] = total
  const size_t n = n_lanes;
  const int i0 = blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // The dead lanes' pass: zero records. Each warp counts its live lanes.
  const bool in = i0 < n_lanes;
  const bool live = in && si[2 * n + i0] != 0;
  if (in && !live) rtw_zero_record<true>(i0, n, rec, n_rec);
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (lane == 0) base[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the NW per-warp counts
    const int v = lane < NW ? base[lane] : 0;
    int incl = v;
    for (int off = 1; off < NW; off <<= 1) {
      const int w = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += w;
    }
    if (lane < NW) base[lane] = incl - v;
    if (lane == NW - 1) base[NW] = incl;
  }
  __syncthreads();
  // Pack the live lane ids in lane order; thread j serves the j-th.
  if (live) ids[base[warp] + __popc(m & ((1u << lane) - 1u))] = i0;
  __syncthreads();
  if ((int)threadIdx.x >= base[NW]) return;
  const int i = ids[threadIdx.x];  // draws keyed by the lane, not the thread
"""

SPLIT_HELPERS = """
#define RTW_P {P}

// Thread `src` (0..P-1) of the calling thread's group of P.
__device__ __forceinline__ int rtw_group_lane(int src) {{
  return ((int)(threadIdx.x & 31) & ~(RTW_P - 1)) | src;
}}

// A word that thread `src` of the group holds, on every thread of it.
template <typename T>
__device__ __forceinline__ T rtw_from(T v, int src) {{
  return RTW_P == 1 ? v : __shfl_sync(0xffffffffu, v, rtw_group_lane(src));
}}

// The lane's 9 uniforms (rtw_uniforms<9>): Philox block b is computed by
// thread b % P of the group, in round b / P; every thread gets all 9.
__device__ __forceinline__ void rtw_uniforms9_split(uint32_t seed,
                                                    uint32_t iteration,
                                                    uint32_t lane, int q,
                                                    float* u) {{
  constexpr int R = (3 + RTW_P - 1) / RTW_P;
  uint32_t w[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {{  // a thread past block 2 draws unused words
    const RtwU4 c = {{lane, (uint32_t)(q + r * RTW_P), 0u, 0u}};
    const RtwU4 o = rtw_philox4x32_10(c, seed, iteration);
    w[r][0] = o.x; w[r][1] = o.y; w[r][2] = o.z; w[r][3] = o.w;
  }}
#pragma unroll
  for (int j = 0; j < 9; ++j) {{
    const int b = j / 4;
    u[j] = rtw_u01(rtw_from(w[b / RTW_P][j % 4], b % RTW_P));
  }}
}}

// The polar pieces r * (cos a, sin a): pieces 0 and 1 are the Box-Muller
// branches of rtw_gauss3 (g0, g1, g2), piece 2 the lens disk point (da,
// db); piece c is computed by thread c % P of the group in round c / P,
// with the expressions of rtw_gauss3 and of the disk map.
__device__ __forceinline__ void rtw_polar_split(const float* u, int q,
                                                float& g0, float& g1,
                                                float& g2, float& da,
                                                float& db) {{
  constexpr int R = (3 + RTW_P - 1) / RTW_P;
  float pc[R], ps[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {{
    const int c = q + r * RTW_P;
    float rad, ang;
    if (c < 2) {{  // Box-Muller
      const float ua = c == 0 ? u[0] : u[2];
      const float ub = c == 0 ? u[1] : u[3];
      rad = sqrtf(-2.0f * logf(fmaxf(ua, 1e-12f)));
      ang = 6.283185307179586f * ub;
    }} else {{  // concentric square -> disk map (idle threads past piece 2)
      const float ca = 2.0f * u[7] - 1.0f, cb = 2.0f * u[8] - 1.0f;
      const bool use_a = fabsf(ca) > fabsf(cb);
      const float qp = 0.7853981633974483f, hp = 1.5707963267948966f;
      const float safe_a = ca == 0.0f ? 1.0f : ca;
      const float safe_b = cb == 0.0f ? 1.0f : cb;
      rad = use_a ? ca : cb;
      ang = use_a ? qp * (cb / safe_a) : hp - qp * (ca / safe_b);
      if (ca == 0.0f && cb == 0.0f) ang = 0.0f;
    }}
    pc[r] = rad * cosf(ang);
    ps[r] = rad * sinf(ang);
  }}
  g0 = rtw_from(pc[0], 0);
  g1 = rtw_from(ps[0], 0);
  g2 = rtw_from(pc[1 / RTW_P], 1 % RTW_P);
  da = rtw_from(pc[2 / RTW_P], 2 % RTW_P);
  db = rtw_from(ps[2 / RTW_P], 2 % RTW_P);
}}
"""
SPLIT_START = """  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lane = g / RTW_P;
  const int q = (int)(g % RTW_P);
  // Past the last lane a thread of a group shadows lane n - 1 (every
  // thread of a warp takes part in the shuffles) and stores nothing.
  const bool store = lane < n && q == 0;
  const int i = lane < n ? (int)lane : n - 1;
"""
DISK = ("    float da, db;\n"
        "    rtw_lens_disk(u[7], u[8], da, db);\n")
GAUSS = ("  float g0, g1, g2;\n"
         "  rtw_gauss3(u[0], u[1], u[2], u[3], g0, g1, g2);\n")


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


def _smem(src: str, start: str, kernel: str, n_spheres: int) -> str:
    src = f"#define RTW_N_SPHERES {n_spheres}\n" + src
    src = _sub(src, start, SMEM_STAGE + start)
    src = _sub(src, FETCH_ROW, SMEM_ROW)
    return _sub(src, f"  {kernel}<<<blocks, threads, 0,",
                f"  cudaFuncSetAttribute({kernel}, "
                "cudaFuncAttributeMaxDynamicSharedMemorySize, "
                f"40 * RTW_N_SPHERES);\n"
                f"  {kernel}<<<blocks, threads, 40 * RTW_N_SPHERES,")


def _default_stores(src: str) -> str:
    src = _sub(src, "rtw_zero_record<true>(", "rtw_zero_record<false>(")
    return _sub(src, "rtw_record_advance<true>(", "rtw_record_advance<false>(")


def k2_source(src: str, core: str, name: str, n_spheres: int) -> tuple:
    """``(shade_strided.cu, shade_core.cuh)`` of K2's variant ``name``."""
    if name == "previous":
        src = _sub(src, FETCH_ROW, PLANES)
    elif name == "smem":
        src = _smem(src, K2_START, "shade_strided_kernel", n_spheres)
    elif name.startswith("split_P"):
        P = int(name[len("split_P"):])
        src = _sub(src, '#include "shade_core.cuh"\n',
                   '#include "shade_core.cuh"\n'
                   + SPLIT_HELPERS.format(P=P))
        src = _sub(src, K2_START, SPLIT_START)
        src = _sub(src, "  float u[NU];\n",
                   "  float u[12];  // the 9 uniforms, then g0, g1, g2\n")
        src = _sub(src, "    rtw_uniforms<NU>(seed, iteration, (uint32_t)i, u);\n",
                   "    rtw_uniforms9_split(seed, iteration, (uint32_t)i, q, "
                   "u);\n")
        src = _sub(src, "  const float t = t_in[i];\n",
                   "  float da, db;\n"
                   "  rtw_polar_split(u, q, u[9], u[10], u[11], da, db);\n"
                   "  const float t = t_in[i];\n")
        src = _sub(src, "    if (strip < k) {\n", "    if (store && strip < k) {\n")
        src = _sub(src, DISK, "")
        src = _sub(src, "  active = (active && !need) || start;\n",
                   "  active = (active && !need) || start;\n"
                   "  if (!store) return;\n")
        src = _sub(src, "  const int blocks = (n + threads - 1) / threads;\n",
                   "  const int blocks = (int)(((long long)n * RTW_P + threads"
                   " - 1) / threads);\n")
        core = _sub(core, GAUSS, "  const float g0 = u[9], g1 = u[10], "
                                 "g2 = u[11];  // drawn by the group\n")
    elif name != "shipped":
        raise ValueError(name)
    return src, core


def k4_source(src: str, name: str, n_spheres: int) -> str:
    """persist_record.cu of K4's variant ``name``."""
    parts = set(name.split("_"))
    if "compact" in parts:
        src = _sub(src, K4_DEAD, COMPACT)
        src = _sub(src, "  const int threads = 128;\n  const int blocks = "
                        "(n_lanes + threads - 1) / threads;\n"
                        "  persist_record_kernel<<<",
                   "  const int threads = 256;\n  const int blocks = "
                   "(n_lanes + threads - 1) / threads;\n"
                   "  persist_record_kernel<<<")
    if "previous" in parts:
        src = _sub(src, FETCH_ROW, PLANES)
        if "stcs" not in parts:
            src = _default_stores(src)
    if "smem" in parts:
        src = _default_stores(_smem(src, K4_START, "persist_record_kernel",
                                    n_spheres))
    if "ldg" in parts:
        src = _default_stores(src)
    return src


K2_VARIANTS = ("shipped", "previous", "smem", "split_P2", "split_P4",
               "split_P8")
K4_VARIANTS = ("shipped", "previous", "previous_stcs", "previous_compact",
               "ldg", "smem", "shipped_compact")
#: variants that read the gathered planes in place of the table
PLANES_INPUT = ("previous", "previous_stcs", "previous_compact")

PTXAS = re.compile(r"Function properties for \w*(shade_strided_kernel|"
                   r"persist_record_kernel)\w*\s+(\d+) bytes stack frame, "
                   r"(\d+) bytes spill stores, (\d+) bytes spill loads\s+"
                   r"ptxas info\s*: Used (\d+) registers")


def build_variants(out: str, n_spheres: int) -> tuple:
    """``({name: ctypes library} of K2's, of K4's, {kernel/name: ptxas
    report})``: every variant of both kernels compiled into ``out``, one
    nvcc each, all at once."""
    def read(name):
        with open(os.path.join(build.CSRC_DIR, name)) as f:
            return f.read()
    k2_src, core, k4_src = (read("shade_strided.cu"), read("shade_core.cuh"),
                            read("persist_record.cu"))
    jobs = {}
    for name in K2_VARIANTS:
        src, core_v = k2_source(k2_src, core, name, n_spheres)
        jobs[("shade_strided", name)] = {"shade_strided.cu": src,
                                         "shade_core.cuh": core_v}
    for name in K4_VARIANTS:
        jobs[("persist_record", name)] = {
            "persist_record.cu": k4_source(k4_src, name, n_spheres)}
    procs = {}
    for (kernel, name), files in jobs.items():
        d = os.path.join(out, f"{kernel}_{name}")
        os.makedirs(d, exist_ok=True)
        for fname, text in files.items():
            with open(os.path.join(d, fname), "w") as f:
                f.write(text)
        procs[(kernel, name)] = subprocess.Popen(
            [build._nvcc(), "-Xptxas", "-v", *build.NVCC_FLAGS, "-I", d,
             "-I", build.CSRC_DIR, "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, f"{kernel}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"shade_strided": {}, "persist_record": {}}
    report = {}
    for (kernel, name), p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {kernel} {name}:\n{log}")
        hits = [m for m in PTXAS.finditer(log) if m.group(1) == f"{kernel}"
                "_kernel"]
        if len(hits) != 1:
            raise RuntimeError(f"no single ptxas report for {kernel} "
                               f"{name}:\n{log}")
        stack, stores, loads, regs = map(int, hits[0].groups()[1:])
        report[f"{kernel}/{name}"] = {
            "registers": regs, "stack_bytes": stack,
            "spill_store_bytes": stores, "spill_load_bytes": loads}
        lib = ctypes.CDLL(os.path.join(out, f"{kernel}_{name}", "lib.so"))
        fn = getattr(lib, f"rtw_{kernel}")
        fn.argtypes = build._SIGNATURES[f"rtw_{kernel}"]
        fn.restype = ctypes.c_int
        libs[kernel][name] = fn
    return libs["shade_strided"], libs["persist_record"], report


# -- launches ----------------------------------------------------------------

def k2_launch(fn, fs, is_, buf, t, idx, table, cc, geom, seed: int, it: int,
              u9=None) -> None:
    """One launch of a K2 build (``table``: the [N, 10] table, or the
    gathered [10, n] planes for ``previous``); first sample 0, depth 16."""
    n, k = t.shape[0], buf.shape[0] // 3
    W, H, dpx, dpy, p_end = (int(g) for g in geom)
    err = fn(fs.data_ptr(), is_.data_ptr(), buf.data_ptr(), t.data_ptr(),
             idx.data_ptr(), table.data_ptr(), cc.data_ptr(),
             None if u9 is None else u9.data_ptr(), n, k, W, H, dpx, dpy,
             p_end, 0, 16, seed & 0xFFFFFFFF, it & 0xFFFFFFFF,
             torch.cuda.current_stream().cuda_stream)
    build.check(err, "K2 variant")


def k4_launch(fn, t, idx, table, strips, sf, si, rad, slot, seed: int,
              it: int, depth: int, u5=None) -> None:
    """One launch of a K4 build (``table`` as :func:`k2_launch`)."""
    err = fn(t.data_ptr(), idx.data_ptr(), table.data_ptr(),
             strips.data_ptr(), sf.data_ptr(), si.data_ptr(), rad.data_ptr(),
             slot.data_ptr(), slot.shape[0],
             None if u5 is None else u5.data_ptr(), t.shape[0],
             strips.shape[0] // 6, depth, seed & 0xFFFFFFFF,
             it & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
    build.check(err, "K4 variant")


# -- states ------------------------------------------------------------------

def states(dev):
    """The flagship render's state at iteration 24 and the flagship step's
    record states at iterations 20 and 40, as ``chip_smoke``'s phases build
    them: ``(fwd, snap)`` for :func:`variant_tables`."""
    W, H, SPP, k = 1920, 1080, 4, 64
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    cam = pt.t_cam1(device=dev)
    spheres, amat = K1.sphere_consts(scene), attr_mat(scene)
    st = I.init_strided_state(cam, W * H, W, H, 5, SPP, 0, 16, k, device=dev)
    cc = K2.pack_camera_consts(cam, W, H)
    seed32 = rng.persistent_seed(5, 0)
    for it in range(24):
        I.strided_step((scene, spheres, amat), st, cc, seed32, it, 0, 16,
                       1e-4, "kernels")
    rays = st.fstate[0:6].contiguous()
    t, idx = K1.sweep(rays, spheres)
    fwd = dict(state=[st.fstate, st.istate, st.buf], t=t, idx=idx, amat=amat,
               cc=cc, geom=st.geom, seed=seed32, rays=rays, spheres=spheres,
               cam=cam)

    S, DEPTH, SEED = 8, 16, 0x5EED
    g = torch.Generator(device=dev).manual_seed(7)
    u_px, v_px = pt.pixel_coords(W, H, device=dev)
    o, d = pt.get_rays(cam, u_px, v_px, generator=g)
    strips, sf, si, rad = PG.start_planes(o, d, S)
    lanes = sf.shape[1]
    slot = torch.empty((PK.N_REC, lanes), device=dev)
    k4_states, k4_hits = {}, {}
    for i in range(41):
        t, idx = K1.sweep_masked(sf[0:6], si[2], spheres)
        if i in (20, 40):
            k4_states[i] = (sf.clone(), si.clone(), rad.clone())
            k4_hits[i] = (t, idx)
        PK.persist_record_step(t, idx, amat, strips, sf, si, rad, slot, SEED,
                               i, DEPTH)
    snap = dict(strips=strips, seed=SEED, depth=DEPTH, k4_states=k4_states,
                k4_hits=k4_hits)
    return fwd, snap


def k2_shapes(dev, fwd) -> dict:
    """``{shape: (state, t, idx, iteration)}``: the flagship render's state
    at iteration 24 (``mid_render_32400``) and at its tail (the first
    multiple of 8 iterations, from 32 on, after which under 10% of the
    lanes are active), each before its K2 launch."""
    amat, cc, geom, seed = fwd["amat"], fwd["cc"], fwd["geom"], fwd["seed"]
    spheres = fwd["spheres"]
    W_, H_ = geom[0], geom[1]
    st = I.init_strided_state(fwd["cam"], W_ * H_, W_, H_, 5, 4, 0, 16, 64,
                              device=dev)
    it = 0
    while it < st.iter_limit and (it % 8 or it < 32 or float(
            (st.istate[5] != 0).float().mean()) >= 0.1):
        I.strided_step((None, spheres, amat), st, cc, seed, it, 0, 16, 1e-4,
                       "kernels")
        it += 1
    t_tail, i_tail = K1.sweep(st.fstate[0:6].contiguous(), spheres)
    return {"mid_render_32400": (fwd["state"], fwd["t"], fwd["idx"], 24),
            "tail": ([st.fstate, st.istate, st.buf], t_tail, i_tail, it)}


# -- checks and tables ---------------------------------------------------------

def check_variants(dev, k2_libs, k4_libs, fwd, snap, shapes) -> dict:
    """Every build of both kernels against the plain version, bit for bit:
    K2 on both render shapes, K4 at iterations 20 and 40 at both record
    widths, each with injected and with Philox draws. Returns the lanes
    that differ by case (all 0, or it raises)."""
    amat, cc, geom, seed = fwd["amat"], fwd["cc"], fwd["geom"], fwd["seed"]
    g = torch.Generator(device=dev).manual_seed(11)
    bad = {}
    for shape, (state, t, idx, it) in shapes.items():
        n = t.shape[0]
        planes = fetch_attr_planes(idx, amat)
        u9 = torch.rand((9, n), generator=g, device=dev)
        for draws, u in (("injected", u9), ("philox", None)):
            ref = [x.clone() for x in state]
            K2.shade_strided_fetch_ref(*ref, t, idx, amat, cc, geom, seed,
                                       it, 0, 16, u)
            for name, fn in k2_libs.items():
                got = [x.clone() for x in state]
                k2_launch(fn, *got, t, idx,
                          planes if name == "previous" else amat, cc, geom,
                          seed, it, u)
                torch.cuda.synchronize()
                bad[f"k2/{shape}/{draws}/{name}"] = int(C._bitwise_lanes(
                    list(zip(got, ref)), n).sum())
    strips, SEED, DEPTH = snap["strips"], snap["seed"], snap["depth"]
    for it, state in snap["k4_states"].items():
        t, idx = snap["k4_hits"][it]
        n = t.shape[0]
        planes = fetch_attr_planes(idx, amat)
        u5 = torch.rand((5, n), generator=g, device=dev)
        for n_rec in (PK.N_REC, PK.N_REC_LEAN):
            for draws, u in (("injected", u5), ("philox", None)):
                def run(step):
                    sf, si, rad = (x.clone() for x in state)
                    slot = torch.full((n_rec, n), 7.0, device=dev)
                    step(sf, si, rad, slot)
                    torch.cuda.synchronize()
                    return sf, si, rad, slot
                ref = run(lambda *a: PK.persist_record_fetch_ref(
                    t, idx, amat, strips, *a, SEED, it, DEPTH, u))
                for name, fn in k4_libs.items():
                    table = planes if name in PLANES_INPUT else amat
                    got = run(lambda *a: k4_launch(
                        fn, t, idx, table, strips, *a, SEED, it, DEPTH, u))
                    bad[f"k4/it{it}/{n_rec}/{draws}/{name}"] = int(
                        C._bitwise_lanes(list(zip(got, ref)), n).sum())
    C.check(all(v == 0 for v in bad.values()),
            f"a K2 or K4 build differs from its plain version: "
            f"{ {k: v for k, v in bad.items() if v} }")
    return bad


def _timed_in_order(runs: dict, reverse: bool) -> dict:
    """``{name: chip_smoke.batch_ms(*args)}`` of ``runs`` (``{name:
    args}``), run in order or in reverse order."""
    names = list(runs)[::-1] if reverse else list(runs)
    out = {name: C.batch_ms(*runs[name]) for name in names}
    return {name: out[name] for name in runs}


K2_RE = r"\bshade_strided_kernel\b"
K4_RE = r"\bpersist_record_kernel\b"
GATHER_RE = "|index_elementwise_kernel|direct_copy_kernel"


def variant_tables(dev, k2_libs, k4_libs, fwd, snap, shapes, n2: int = 50,
                   n4: int = 20, reverse: bool = False) -> dict:
    """Every build of K2 on each render shape and of K4 at iterations 20
    and 40, and ``gather+previous`` (the gather, the cast and the previous
    kernel, as the loops ran them), by ``chip_smoke.batch_ms``, in order or
    in reverse order."""
    amat, cc, geom, seed = fwd["amat"], fwd["cc"], fwd["geom"], fwd["seed"]
    k2 = {}
    for shape, (state, t, idx, it) in shapes.items():
        make = lambda state=state: [x.clone() for x in state]
        planes = fetch_attr_planes(idx, amat)
        runs = {"gather+previous": (
            lambda fs, is_, buf, t=t, idx=idx, it=it: k2_launch(
                k2_libs["previous"], fs, is_, buf, t, idx,
                fetch_attr_planes(idx, amat), cc, geom, seed, it),
            make, n2, K2_RE + GATHER_RE)}
        for name, fn in k2_libs.items():
            table = planes if name == "previous" else amat
            runs[name] = (lambda fs, is_, buf, fn=fn, table=table, t=t,
                          idx=idx, it=it: k2_launch(
                              fn, fs, is_, buf, t, idx, table, cc, geom,
                              seed, it), make, n2, K2_RE)
        k2[shape] = {"iteration": it,
                     "active_share": (state[1][5] != 0).float().mean().item(),
                     **_timed_in_order(runs, reverse)}
    strips, SEED, DEPTH = snap["strips"], snap["seed"], snap["depth"]
    lanes = strips.shape[1]
    k4 = {}
    for it, state in snap["k4_states"].items():
        t, idx = snap["k4_hits"][it]
        planes = fetch_attr_planes(idx, amat)
        make = lambda state=state: [x.clone() for x in state] + [
            torch.empty((PK.N_REC, lanes), device=dev)]
        runs = {"gather+previous": (
            lambda sf, si, rad, slot, t=t, idx=idx, it=it: k4_launch(
                k4_libs["previous"], t, idx, fetch_attr_planes(idx, amat),
                strips, sf, si, rad, slot, SEED, it, DEPTH),
            make, n4, K4_RE + GATHER_RE)}
        for name, fn in k4_libs.items():
            table = planes if name in PLANES_INPUT else amat
            runs[name] = (lambda sf, si, rad, slot, fn=fn, table=table, t=t,
                          idx=idx, it=it: k4_launch(
                              fn, t, idx, table, strips, sf, si, rad, slot,
                              SEED, it, DEPTH), make, n4, K4_RE)
        k4[f"it{it}"] = {"live_share": (state[1][2] != 0).float().mean().item(),
                         **_timed_in_order(runs, reverse)}
    return {"k2": k2, "k4": k4}


def record_loop_ms(dev, k4_libs, fwd, snap, iters: int = 8,
                   reps: int = 10) -> dict:
    """K3 and K4 over ``iters`` consecutive record iterations from the
    flagship step's iteration 20, as the record loop runs them (each K4
    launch reads the state the last one wrote, and K3 sweeps it), for
    ``gather+previous``, ``ldg`` and ``shipped``: ``chip_smoke.batch_ms``
    per run of the ``iters`` iterations, each run on its own copy of the
    state. The evict-first hint is meant to keep the state in L2 between
    the launches of the loop, which the single-launch tables cannot show."""
    amat, spheres = fwd["amat"], fwd["spheres"]
    strips, SEED, DEPTH = snap["strips"], snap["seed"], snap["depth"]
    st20 = snap["k4_states"][20]
    lanes = strips.shape[1]
    make = lambda: [x.clone() for x in st20] + [
        torch.empty((iters, PK.N_REC, lanes), device=dev)]
    out = {}
    for name in ("gather+previous", "ldg", "shipped"):
        fn = k4_libs["previous" if name == "gather+previous" else name]

        def run(sf, si, rad, rec, fn=fn, gather=name == "gather+previous"):
            for s in range(iters):
                t, idx = K1.sweep_masked(sf[0:6], si[2], spheres)
                table = fetch_attr_planes(idx, amat) if gather else amat
                k4_launch(fn, t, idx, table, strips, sf, si, rad, rec[s],
                          SEED, 20 + s, DEPTH)
        out[name] = C.batch_ms(run, make, reps, K4_RE)
    return out


def pair_tables(dev, k2_libs, k4_libs, fwd, snap) -> dict:
    """``gather+previous`` and ``shipped`` of K2 (mid-render) and K4
    (iteration 20) by the earlier method: an event pair around each launch
    (``chip_smoke.device_ms``), the state restored between launches."""
    amat, cc, geom, seed = fwd["amat"], fwd["cc"], fwd["geom"], fwd["seed"]
    t, idx = fwd["t"], fwd["idx"]
    live = [x.clone() for x in fwd["state"]]
    reset = lambda: [x.copy_(y) for x, y in zip(live, fwd["state"])]
    out = {"k2": {
        "gather+previous": C.device_ms(lambda: k2_launch(
            k2_libs["previous"], *live, t, idx, fetch_attr_planes(idx, amat),
            cc, geom, seed, 24), 50, setup=reset),
        "shipped": C.device_ms(lambda: k2_launch(
            k2_libs["shipped"], *live, t, idx, amat, cc, geom, seed, 24), 50,
            setup=reset)}}
    strips, SEED, DEPTH = snap["strips"], snap["seed"], snap["depth"]
    st20 = snap["k4_states"][20]
    t4, i4 = snap["k4_hits"][20]
    live4 = [x.clone() for x in st20]
    slot = torch.empty((PK.N_REC, strips.shape[1]), device=dev)
    reset4 = lambda: [x.copy_(y) for x, y in zip(live4, st20)]
    out["k4"] = {
        "gather+previous": C.device_ms(lambda: k4_launch(
            k4_libs["previous"], t4, i4, fetch_attr_planes(i4, amat), strips,
            *live4, slot, SEED, 20, DEPTH), 20, setup=reset4),
        "shipped": C.device_ms(lambda: k4_launch(
            k4_libs["shipped"], t4, i4, amat, strips, *live4, slot, SEED, 20,
            DEPTH), 20, setup=reset4)}
    return out


def _median_tables(passes: list) -> dict:
    """The median ``event_ms`` and ``profiler_ms`` of each timed entry (of
    the passes whose profiler kept the launches' records)."""
    def walk(xs):
        if "event_ms" in xs[0]:
            return {k: statistics.median(v) if (v := [
                x[k] for x in xs if x[k] is not None]) else None
                for k in ("event_ms", "profiler_ms")}
        return {k: walk([x[k] for x in xs]) if isinstance(xs[0][k], dict)
                else xs[0][k] for k in xs[0]}
    return walk(passes)


#: (change, against) of each change alone, per kernel
K2_ALONE = (("shipped", "gather+previous"), ("smem", "gather+previous"),
            ("shipped", "previous"), ("smem", "shipped"),
            ("split_P2", "shipped"), ("split_P4", "shipped"),
            ("split_P8", "shipped"))
K4_ALONE = (("ldg", "gather+previous"), ("smem", "gather+previous"),
            ("ldg", "previous"), ("smem", "ldg"),
            ("previous_stcs", "previous"), ("shipped", "ldg"),
            ("previous_compact", "previous"), ("shipped_compact", "shipped"),
            ("shipped", "gather+previous"))


def changes_alone(tabs: dict) -> dict:
    """Each change's ``event_ms`` over what it replaces, per shape."""
    out = {}
    for kernel, pairs in (("k2", K2_ALONE), ("k4", K4_ALONE)):
        out[kernel] = [
            {"shape": shape, "change": c, "against": b,
             "ratio": t[c]["event_ms"] / t[b]["event_ms"]}
            for shape, t in tabs[kernel].items() for c, b in pairs]
    return out


def verdict(alone: dict, loop: dict) -> dict:
    """Which change is kept, by the rule below; K4's evict-first hint also
    by the record loop (:func:`record_loop_ms`)."""
    def kept(kernel, change, base):
        return all(r["ratio"] < 1 for r in alone[kernel]
                   if r["change"] == change and r["against"] == base)
    return {"k2": {"fetch_inside_ldg": kept("k2", "shipped",
                                            "gather+previous"),
                   "smem_over_ldg": kept("k2", "smem", "shipped"),
                   **{f"split_P{p}": kept("k2", f"split_P{p}", "shipped")
                      for p in (2, 4, 8)}},
            "k4": {"fetch_inside_ldg": kept("k4", "ldg", "gather+previous"),
                   "smem_over_ldg": kept("k4", "smem", "ldg"),
                   "stcs": kept("k4", "shipped", "ldg"),
                   "stcs_in_record_loop": loop["shipped"]["event_ms"]
                   < loop["ldg"]["event_ms"],
                   "compact": kept("k4", "shipped_compact", "shipped")},
            "shipped": {"k2": "one thread per lane, the row through the "
                              "read-only path",
                        "k4": "one thread per lane, the row through the "
                              "read-only path, evict-first record stores"},
            "rule": "a change is kept where it is faster (event_ms) at "
                    "every shape timed"}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = C.card_line()
    print(card, flush=True)
    build.load()
    fwd, snap = states(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    k2_libs, k4_libs, report = build_variants(
        tempfile.mkdtemp(dir=os.path.join(ROOT, "build")),
        fwd["spheres"].shape[0])
    C.emit({"phase": "ptxas", **report})
    shapes = k2_shapes(dev, fwd)
    bad = check_variants(dev, k2_libs, k4_libs, fwd, snap, shapes)
    C.emit({"phase": "variants_vs_plain", "cases": len(bad),
            "lanes_differing": sum(bad.values()),
            "tolerance": "every word of the state, strip buffers, radiance "
                         "and record bit for bit"})
    passes = [variant_tables(dev, k2_libs, k4_libs, fwd, snap, shapes,
                             reverse=(r == 1)) for r in range(3)]
    tabs = _median_tables(passes)
    loops = [record_loop_ms(dev, k4_libs, fwd, snap) for _ in range(3)]
    loop = {k: {"event_ms": statistics.median(x[k]["event_ms"]
                                              for x in loops)}
            for k in loops[0]}
    C.emit({"phase": "variant_times", "card": card, "passes": 3, **tabs,
            "record_loop_8_iterations": loop,
            "device_ms_pair_per_launch": pair_tables(dev, k2_libs, k4_libs,
                                                     fwd, snap),
            "note": "medians of 3 passes (the second in reverse order); "
                    "event_ms: one event pair around the launches, each on "
                    "its own copy of the state; profiler_ms: the profiler's "
                    "per-launch mean (gather+previous: gather, cast and "
                    "kernel); device_ms_pair_per_launch: an event pair "
                    "around each launch"})
    alone = changes_alone(tabs)
    C.emit({"phase": "changes_alone", **alone})
    C.emit({"phase": "verdict", **verdict(alone, loop)})
    print(C.card_line(), flush=True)
    C.emit({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
