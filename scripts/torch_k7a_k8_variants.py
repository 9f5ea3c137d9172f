"""K7a (``record_shade_kernel``) and K8 (``inline_kernel``) beside the designs
they were chosen over, on the card: what each change of their redesign does
alone, and why the shipped kernels are what they are.

The shipped sources (``csrc/record_shade.cu``, ``csrc/inline.cu``) are built
as they stand (``shipped``) and rewritten into variants, each built by its
own ``nvcc -Xptxas -v`` (all at once), with the launcher's C signature
unchanged:

- K7a ``previous``: the kernel before the winner fetch went inside. It
  reads the ten attribute planes that a gather wrote (the ``amat`` argument
  then holds those [10, n] planes). It is timed alone and after its gather
  and cast (``gather+previous``, what the record loop ran before).
- K7a ``shipped_nohint``: the record stored with the default policy, not
  evict-first (``__stcs``, as K4 stores its record);
  ``shipped_t32``, ``_t64``, ``_t256``: other block sizes (at 22 400
  lanes, 128 threads make 175 blocks on 132 SMs); ``shipped_smem``: the
  [N, 10] table copied into each block's shared memory (N compiled in);
  ``shipped_draws``: the Philox draws issued before the state loads.
- K8 ``previous``: one thread per lane, the whole bounce loop in the
  kernel, a running select of the winner's ten attributes in the sweep.
  ``previous_index``: the index sweep alone (the winner's attributes read
  from shared memory after the loop); ``queue_running``: the lane work
  queue alone; ``shipped``: both. ``shipped_half``: a warp refills only when
  half its lanes are idle, not when any is; ``shipped_t64``, ``_t256``:
  other block sizes; ``shipped_w8`` ... ``_w36``: at most 8 ... 36 resident
  warps per SM, not 16 (36: every slot the occupancy API allows at 128
  threads); ``shipped_t256_w8``, ``_w24``: both changes.

It prints each build's registers, spills, shared memory and (K8) resident
blocks per SM. It holds every build bit for bit against ``previous``: K7a
(state and all 21 record planes) at every bounce 0-15 of the inverse demo's
first pass (200x112, 22 400 lanes, the fit's start scene); K8 (radiance) on
the demo's 179 200 lanes (spp 8), on the hollow glass scene at 64x36 and on
a 64-sphere table at 200x112 (the inline route's largest), each with
injected and with Philox draws. It reads the live share of K8's warps:
the one-thread loop's (lane-bounces over the slots its warps issue) and the
queue's, from the plain mirror of its schedule over the shipped build's
resident warps. It times every build with ``chip_smoke.batch_ms`` (one CUDA
event pair around N launches, each on its own copy of the state, and the
profiler's per-launch mean): K7a at bounces 0, 2 and 8, with
``gather+previous`` beside it, and the whole 16-bounce record of the pass
(K3, then the gather and the previous kernel or the shipped kernel); K8 on
the demo. ``gather+previous`` and ``shipped`` of K7a at bounce 2, and
``previous`` and ``shipped`` of K8, are also timed with an event pair
around each launch (``chip_smoke.device_ms``). Five passes, every other one
in reverse order; each time is the median of the five. The last lines give
each change alone against what it replaces, and the verdict: a change is
kept where it is at least 1% faster at every shape it was timed at. One
JSON object per line; a failed check raises.

    python3 scripts/torch_k7a_k8_variants.py     # one CUDA card and nvcc
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
from raytracingweekend_jl_tpu_torch.camera import (  # noqa: E402
    sample_pass_rays)
from raytracingweekend_jl_tpu_torch.ops import fused_grad as FG  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import build  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import (  # noqa: E402
    grad_kernel as GK, inline_kernel as K8, intersect_kernel as K1)
from raytracingweekend_jl_tpu_torch.ops.materials import (  # noqa: E402
    attr_mat, fetch_attr_planes)

# -- source rewrites ---------------------------------------------------------

K7A_KERNEL = re.compile(r"__global__ void __launch_bounds__\(RTW_K7A_THREADS\) "
                        r"record_shade_kernel\(.*?\n}\n", re.S)

#: The earlier K7a: the winner's attributes from ten gathered planes
#: (``attrs``, passed where the shipped kernel takes the table), default
#: stores, no launch bound; ``idx`` is unused.
PREVIOUS_K7A = """__global__ void record_shade_kernel(const float* __restrict__ t_in,
                                    const int* __restrict__ idx,
                                    const float* __restrict__ attrs,
                                    float* __restrict__ st,
                                    float* __restrict__ rec,
                                    const float* __restrict__ u5, int n_lanes,
                                    uint32_t seed, uint32_t bounce) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  if (__float_as_int(st[12 * n + i]) == 0) {
#pragma unroll
    for (int p = 0; p < 21; ++p) rec[p * n + i] = 0.0f;
    return;
  }

  float ox = st[0 * n + i], oy = st[1 * n + i], oz = st[2 * n + i];
  float dx = st[3 * n + i], dy = st[4 * n + i], dz = st[5 * n + i];
  float tx = st[6 * n + i], ty = st[7 * n + i], tz = st[8 * n + i];
  float rx = st[9 * n + i], ry = st[10 * n + i], rz = st[11 * n + i];

  float u[5];
  if (u5) {
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = u5[j * n + i];
  } else {
    rtw_uniforms<5>(seed, bounce, (uint32_t)i, u);
  }
  const float t = t_in[i];
  float a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = attrs[j * n + i];

  // Residual record: this bounce's inputs.
  rec[0 * n + i] = ox; rec[1 * n + i] = oy; rec[2 * n + i] = oz;
  rec[3 * n + i] = dx; rec[4 * n + i] = dy; rec[5 * n + i] = dz;
  rec[6 * n + i] = tx; rec[7 * n + i] = ty; rec[8 * n + i] = tz;
  rec[9 * n + i] = t;
  rec[10 * n + i] = __int_as_float(1);
#pragma unroll
  for (int j = 0; j < 10; ++j) rec[(11 + j) * n + i] = a[j];

  const RtwShade s = rtw_shade_core(u, t, a, ox, oy, oz, dx, dy, dz, tx, ty,
                                    tz, true, rx, ry, rz);
  if (s.hitm) {
    ox = s.px; oy = s.py; oz = s.pz;
    dx = s.ndx; dy = s.ndy; dz = s.ndz;
    tx = tx * a[4]; ty = ty * a[5]; tz = tz * a[6];
  }
  st[0 * n + i] = ox; st[1 * n + i] = oy; st[2 * n + i] = oz;
  st[3 * n + i] = dx; st[4 * n + i] = dy; st[5 * n + i] = dz;
  st[6 * n + i] = tx; st[7 * n + i] = ty; st[8 * n + i] = tz;
  st[9 * n + i] = rx; st[10 * n + i] = ry; st[11 * n + i] = rz;
  st[12 * n + i] = __int_as_float(s.hitm ? 1 : 0);
}
"""

K7A_STORE_HINT = "  __stcs(p, v);\n"
K7A_STORE = "  *p = v;\n"
K7A_DRAWS = ("  float u[5];\n"
             "  if (u5) {\n"
             "#pragma unroll\n"
             "    for (int j = 0; j < 5; ++j) u[j] = u5[j * n + i];\n"
             "  } else {\n"
             "    rtw_uniforms<5>(seed, bounce, (uint32_t)i, u);\n"
             "  }\n")
K7A_LOADS = "  float ox = st[0 * n + i]"
K7A_START = "    uint32_t seed, uint32_t bounce) {\n"
K7A_TABLE = ("  __shared__ float tab[RTW_K7A_N * 10];\n"
             "  for (int k = threadIdx.x; k < RTW_K7A_N * 10; k += blockDim.x)\n"
             "    tab[k] = amat[k];\n"
             "  __syncthreads();\n")
K7A_FETCH = "  rtw_fetch_row(idx, amat, i, a);\n"
K7A_TABLE_ROW = ("  {\n"
                 "    const float* row = tab + 10 * __ldg(idx + i);\n"
                 "#pragma unroll\n"
                 "    for (int j = 0; j < 10; ++j) a[j] = row[j];\n"
                 "  }\n")

K8_KERNEL = re.compile(r"__global__ void __launch_bounds__\(RTW_K8_THREADS\) "
                       r"inline_kernel\(.*?\n}\n", re.S)
K8_SWEEP = re.compile(r"__device__ __forceinline__ void rtw_inline_sweep\(.*?"
                      r"\n}\n", re.S)

#: The earlier K8: one thread per lane, the bounce loop in the kernel, one
#: block per 128 lanes (``next`` is unused).
PREVIOUS_K8 = """__global__ void inline_kernel(
    const float* __restrict__ rays, const float* __restrict__ spheres,
    float* __restrict__ rad_out, const float* __restrict__ u5,
    int* __restrict__ next, int n_lanes, int n_spheres, int max_depth,
    float tmin, uint32_t seed) {
  extern __shared__ float sph[];  // [11, n_spheres]
  for (int k = threadIdx.x; k < RTW_INLINE_PLANES * n_spheres;
       k += blockDim.x)
    sph[k] = spheres[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  float dx = rays[3 * n + i], dy = rays[4 * n + i], dz = rays[5 * n + i];
  float tx = 1.0f, ty = 1.0f, tz = 1.0f;
  float rx = 0.0f, ry = 0.0f, rz = 0.0f;

  for (int b = 0; b < max_depth; ++b) {
    float bt, a[10];
    rtw_inline_sweep(sph, n_spheres, tmin, ox, oy, oz, dx, dy, dz, bt, a);
    float u[5];
    if (u5) {
      const float* us = u5 + (size_t)b * 5 * n;
#pragma unroll
      for (int j = 0; j < 5; ++j) u[j] = us[j * n + i];
    } else {
      rtw_uniforms<5>(seed, (uint32_t)b, (uint32_t)i, u);
    }
    const RtwShade sh = rtw_shade_core(u, bt, a, ox, oy, oz, dx, dy, dz, tx,
                                       ty, tz, true, rx, ry, rz);
    if (!sh.hitm) break;  // banked the sky: nothing more changes
    ox = sh.px; oy = sh.py; oz = sh.pz;
    dx = sh.ndx; dy = sh.ndy; dz = sh.ndz;
    tx = tx * a[4]; ty = ty * a[5]; tz = tz * a[6];
  }
  rad_out[i] = rx;
  rad_out[n + i] = ry;
  rad_out[2 * n + i] = rz;
}
"""

#: The earlier sweep: a running select of the winner's ten attributes.
RUNNING_SWEEP = """__device__ __forceinline__ void rtw_inline_sweep(
    const float* sph, int n_spheres, float tmin, float ox, float oy,
    float oz, float dx, float dy, float dz, float& bt, float* a) {
  const float* scx = sph;
  const float* scy = sph + n_spheres;
  const float* scz = sph + 2 * n_spheres;
  const float* sck = sph + 3 * n_spheres;
  const float* sattr = sph + 4 * n_spheres;  // r, ar, ag, ab, fz, ir, mt
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;
  bt = RTW_BIG;
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = 0.0f;
  for (int s = 0; s < n_spheres; ++s) {
    const float cx = scx[s], cy = scy[s], cz = scz[s];
    const float cd = cx * dx + cy * dy + cz * dz;
    const float oc = cx * ox + cy * oy + cz * oz;
    const float hb = od - cd;
    const float c = oo - 2.0f * oc + sck[s];
    const float disc = hb * hb - c;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float r1 = -hb - sq;
    const float t = r1 >= tmin ? r1 : -hb + sq;
    if (disc > 0.0f && t >= tmin && t < bt) {
      bt = t;
      a[0] = cx;
      a[1] = cy;
      a[2] = cz;
#pragma unroll
      for (int j = 0; j < 7; ++j) a[3 + j] = sattr[j * n_spheres + s];
    }
  }
}
"""
K8_GRID = ("  const int blocks = per_sm * sms < need ? per_sm * sms : need;\n",
           "  const int blocks = need;\n")



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


def _threads(src: str, kernel: str, threads: int) -> str:
    return _sub(src, f"#define RTW_{kernel}_THREADS 128\n",
                f"#define RTW_{kernel}_THREADS {threads}\n")


def k7a_source(src: str, name: str, n_spheres: int) -> str:
    """record_shade.cu of K7a's variant ``name`` (``n_spheres``: the table
    the shared-memory variant is compiled for)."""
    if name == "previous":
        return _sub(src, K7A_KERNEL, PREVIOUS_K7A)
    if name == "shipped":
        return src
    change = name.removeprefix("shipped_")
    if change in ("t32", "t64", "t256"):
        return _threads(src, "K7A", int(change[1:]))
    if change == "nohint":
        return _sub(src, K7A_STORE_HINT, K7A_STORE)
    if change == "draws":
        src = _sub(src, K7A_DRAWS, "")
        return _sub(src, K7A_LOADS, K7A_DRAWS + K7A_LOADS)
    if change == "smem":
        src = _sub(src, "#define RTW_K7A_THREADS 128\n",
                   f"#define RTW_K7A_THREADS 128\n#define RTW_K7A_N "
                   f"{n_spheres}\n")
        src = _sub(src, K7A_START, K7A_START + K7A_TABLE)
        return _sub(src, K7A_FETCH, K7A_TABLE_ROW)
    raise ValueError(name)


def k8_source(src: str, name: str) -> str:
    """inline.cu of K8's variant ``name``: ``previous``,
    ``previous_index``, ``queue_running``, or ``shipped`` with changes
    ``_t<threads>``, ``_w<resident warps per SM>`` and ``_half``."""
    base, _, x = name.partition("_")
    if name in ("previous", "previous_index"):
        src = _sub(src, K8_KERNEL, PREVIOUS_K8)
        src = _sub(src, *K8_GRID)
    if name in ("previous", "queue_running"):
        src = _sub(src, K8_SWEEP, RUNNING_SWEEP)
    if base != "shipped":
        if name not in ("previous", "previous_index", "queue_running"):
            raise ValueError(name)
        return src
    for part in x.split("_") if x else ():
        if part == "half":
            src = _sub(src, "#define RTW_K8_REFILL 1\n",
                       "#define RTW_K8_REFILL 16\n")
        elif part[0] == "t":
            src = _threads(src, "K8", int(part[1:]))
        elif part[0] == "w":
            src = _sub(src, "#define RTW_K8_WARPS_PER_SM 16\n",
                       f"#define RTW_K8_WARPS_PER_SM {int(part[1:])}\n")
        else:
            raise ValueError(name)
    return src


K7A_VARIANTS = ("shipped", "previous", "shipped_nohint", "shipped_t32",
                "shipped_t64", "shipped_t256", "shipped_smem",
                "shipped_draws")
K8_VARIANTS = ("shipped", "previous", "previous_index", "queue_running",
               "shipped_half", "shipped_t64", "shipped_t256", "shipped_w8",
               "shipped_w12", "shipped_w20", "shipped_w24", "shipped_w36",
               "shipped_t256_w8", "shipped_t256_w24")

SOURCES = {"k7a": "record_shade.cu", "k8": "inline.cu"}
KERNELS = {"k7a": "record_shade_kernel", "k8": "inline_kernel"}
LAUNCHERS = {"k7a": "rtw_record_shade", "k8": "rtw_inline"}
PTXAS = re.compile(r"Function properties for \w*?(record_shade_kernel|"
                   r"inline_kernel)\w*\s+(\d+) bytes stack frame, (\d+) bytes "
                   r"spill stores, (\d+) bytes spill loads\s+ptxas info\s*: "
                   r"Used (\d+) registers")
SMEM = re.compile(r"(\d+) bytes smem")


def build_variants(out: str, n_spheres: int) -> tuple:
    """``({name: launcher} of K7a's, of K8's, {kernel/name: ptxas
    report})``: every variant compiled into ``out``, one nvcc each, all at
    once. K8's launchers carry their build's ``occupancy(n)``."""
    srcs = {}
    for kernel, f in SOURCES.items():
        with open(os.path.join(build.CSRC_DIR, f)) as fh:
            srcs[kernel] = fh.read()
    jobs = {("k7a", n): k7a_source(srcs["k7a"], n, n_spheres)
            for n in K7A_VARIANTS}
    jobs.update({("k8", n): k8_source(srcs["k8"], n) for n in K8_VARIANTS})
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
    libs = {"k7a": {}, "k8": {}}
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
        row = {"registers": regs, "stack_bytes": stack,
               "spill_store_bytes": stores, "spill_load_bytes": loads,
               "smem_bytes": int(smem.group(1)) if smem else 0}
        if kernel == "k8":
            occ = lib.rtw_inline_occupancy
            occ.argtypes = build._SIGNATURES["rtw_inline_occupancy"]
            fn.occupancy = _occupancy(occ)
            row.update(fn.occupancy(n_spheres))
        report[f"{kernel}/{name}"] = row
        libs[kernel][name] = fn
    return libs["k7a"], libs["k8"], report


def _occupancy(occ):
    def run(n_spheres: int) -> dict:
        regs, per_sm, sms = (ctypes.c_int() for _ in range(3))
        build.check(occ(n_spheres, ctypes.byref(regs), ctypes.byref(per_sm),
                        ctypes.byref(sms)), "K8 variant occupancy")
        return {"blocks_per_sm": per_sm.value, "sms": sms.value}
    return run


# -- launches ----------------------------------------------------------------

#: The fit's record draws (chip_smoke's ``fit_slice_phases``) and the demo
#: render's scatter draws.
SEED = rng.purpose_seed(0, rng.SCATTER_DIR, 0) & 0xFFFFFFFF
SEED8 = rng.persistent_seed(0, 0)
DEPTH = 16
TMIN = 1e-4


def k7a_launch(fn, t, idx, table, st, slot, bounce: int, u5=None) -> None:
    """One launch of a K7a build (``table``: the [N, 10] table, or the
    gathered [10, n] planes for ``previous``)."""
    err = fn(t.data_ptr(), idx.data_ptr(), table.data_ptr(), st.data_ptr(),
             slot.data_ptr(), None if u5 is None else u5.data_ptr(),
             t.shape[0], SEED, bounce, torch.cuda.current_stream().cuda_stream)
    build.check(err, "K7a variant")


def k8_launch(fn, shape, rad, head, u5=None) -> None:
    """One launch of a K8 build over ``shape``'s rays into ``rad`` [3, R]
    (``head``: the zeroed lane counter)."""
    rays, planes = shape["rays"], shape["planes"]
    err = fn(rays.data_ptr(), planes.data_ptr(), rad.data_ptr(),
             None if u5 is None else u5.data_ptr(), head.data_ptr(),
             rays.shape[1], planes.shape[1], DEPTH, TMIN, shape["seed"],
             torch.cuda.current_stream().cuda_stream)
    build.check(err, "K8 variant")


def _k8_run(fn, shape, u5=None):
    R = shape["rays"].shape[1]
    rad = torch.full((3, R), 7.0, device=shape["rays"].device)
    k8_launch(fn, shape, rad, torch.zeros(1, dtype=torch.int32,
                                          device=rad.device), u5)
    torch.cuda.synchronize()
    return rad


# -- states --------------------------------------------------------------------

def k7a_states(dev, W: int = 200, H: int = 112) -> dict:
    """The inverse demo's first record pass (the fit's start scene, 200x112
    camera rays, one sample): before each of the 16 bounces, the state and
    the masked sweep's ``t`` and ``idx``; plus the table and spheres."""
    _, scene0, cam, _, _ = C.inverse_demo()
    sc = pt.trim_scene(scene0.to(dev))
    u, v = pt.pixel_coords(W, H, device=dev)
    o, d = sample_pass_rays(cam.to(dev), u, v, 0, 0, 1, float(W), float(H))
    spheres, amat = K1.sphere_consts(sc), attr_mat(sc)
    st = FG.start_state(o, d)
    slot = torch.empty((GK.N_REC, st.shape[1]), device=dev)
    bounces = []
    for b in range(DEPTH):
        t, idx = K1.sweep_masked(st[0:6], st[12].view(torch.int32), spheres)
        bounces.append({"st": st.clone(), "t": t, "idx": idx,
                        "live": int((st[12].view(torch.int32) != 0).sum())})
        GK.record_shade_step(t, idx, amat, st, slot, SEED, b)
    torch.cuda.synchronize()
    return {"bounces": bounces, "amat": amat, "spheres": spheres,
            "start": FG.start_state(o, d)}


def _shape(scene, cam, W, H, spp, seed) -> dict:
    dev = scene.device
    u, v = pt.pixel_coords(W, H, device=dev)
    o, d = sample_pass_rays(cam, u, v, 0, 0, spp, float(W), float(H))
    return {"rays": torch.cat([o.T, d.T]).contiguous(),
            "planes": K8.sphere_planes(scene), "seed": seed, "scene": scene,
            "o": o, "d": d, "size": [W, H, spp]}


def k8_shapes(dev) -> dict:
    """K8's inputs: the inverse demo's forward render (the fit's start
    scene, 200x112 at spp 8: 179 200 lanes), the hollow glass scene at
    64x36 and the first 64 spheres of the flagship scene at 200x112."""
    _, scene0, cam, _, _ = C.inverse_demo()
    glass = pt.trim_scene(pt.scene_diel_spheres_hollow(device=dev))
    big = pt.scene_random_spheres(seed=1, device=dev)
    big = pt.trim_scene(big._replace(**{f: getattr(big, f)[:64]
                                        for f in big._fields}))
    return {"demo": _shape(pt.trim_scene(scene0.to(dev)), cam.to(dev), 200,
                           112, 8, SEED8),
            "glass_64x36": _shape(glass, pt.hollow_glass_cam(device=dev), 64,
                                  36, 1, SEED8),
            "spheres64": _shape(big, pt.t_cam1(device=dev), 200, 112, 1,
                                SEED8)}


def k8_schedule(name: str, occupancy, n_spheres: int, lanes: int) -> dict:
    """The warps a queue build of K8 launches on ``lanes`` lanes and its
    refill threshold: its threads per block times its resident blocks per
    SM (``occupancy``: the build's own, within its warp cap), at most the
    blocks the lanes need."""
    parts = name.split("_")[1:]
    threads = next((int(p[1:]) for p in parts if p[0] == "t"), K8.THREADS)
    occ = occupancy(n_spheres)
    blocks = min(occ["blocks_per_sm"] * occ["sms"], -(-lanes // threads))
    return {"warps": blocks * threads // 32,
            "refill": 16 if "half" in parts else 1}


def live_shares(shape, k8_libs) -> dict:
    """K8's live share on ``shape``: the one-thread loop's (a warp issues
    as many bounces as its longest lane) and each queue build's, by the
    plain mirror of its schedule over the warps that build launches (each
    checked bit for bit against ``trace_inline_ref``)."""
    stats = {}
    ref = K8.trace_inline_ref(shape["scene"], shape["o"], shape["d"],
                              shape["seed"], DEPTH, TMIN, stats=stats)
    out = {"loop": K8.warp_live_share(stats["bounces"]),
           "live_by_bounce": stats["live"]}
    n_sph, lanes = shape["planes"].shape[1], shape["rays"].shape[1]
    done = {}
    for name, fn in k8_libs.items():
        if name.startswith("previous"):
            continue
        sched = k8_schedule(name, fn.occupancy, n_sph, lanes)
        key = (sched["warps"], sched["refill"])
        if key not in done:
            q = {}
            got = K8.trace_inline_queue_ref(
                shape["scene"], shape["o"], shape["d"], shape["seed"], DEPTH,
                TMIN, n_warps=sched["warps"], refill=sched["refill"], stats=q)
            C.check(torch.equal(got.view(torch.int32), ref.view(torch.int32)),
                    f"the queue mirror ({name}) differs from trace_inline_ref")
            done[key] = q
        out[name] = {**sched, **done[key]}
    return out


# -- checks and tables ---------------------------------------------------------

def _k7a_run(fn, bx, table, b, u5=None):
    st = bx["st"].clone()
    slot = torch.full((GK.N_REC, st.shape[1]), 7.0, device=st.device)
    k7a_launch(fn, bx["t"], bx["idx"], table, st, slot, b, u5)
    torch.cuda.synchronize()
    return st, slot


def check_variants(dev, k7a_libs, k8_libs, states, shapes) -> dict:
    """Every build against ``previous``, bit for bit: K7a's state and
    record slot at every bounce of the pass, K8's radiance on every shape,
    each with injected and with Philox draws. Returns the lanes that differ
    by case (all 0, or it raises)."""
    g = torch.Generator(device=dev).manual_seed(11)
    amat = states["amat"]
    bad = {}
    for b, bx in enumerate(states["bounces"]):
        R = bx["t"].shape[0]
        planes = fetch_attr_planes(bx["idx"], amat)
        for draws, u5 in (("injected", torch.rand((5, R), generator=g,
                                                   device=dev)),
                          ("philox", None)):
            ref = _k7a_run(k7a_libs["previous"], bx, planes, b, u5)
            for name, fn in k7a_libs.items():
                got = _k7a_run(fn, bx, planes if name == "previous" else amat,
                               b, u5)
                bad[f"k7a/bounce{b}/{draws}/{name}"] = int(C._bitwise_lanes(
                    list(zip(got, ref)), R).sum())
    for shape_name, shape in shapes.items():
        R = shape["rays"].shape[1]
        for draws, u5 in (("injected", torch.rand((DEPTH, 5, R), generator=g,
                                                   device=dev)),
                          ("philox", None)):
            ref = _k8_run(k8_libs["previous"], shape, u5)
            for name, fn in k8_libs.items():
                bad[f"k8/{shape_name}/{draws}/{name}"] = int(C._bitwise_lanes(
                    [(_k8_run(fn, shape, u5), ref)], R).sum())
    C.check(all(v == 0 for v in bad.values()),
            f"a K7a or K8 build differs from the previous kernel: "
            f"{ {k: v for k, v in bad.items() if v} }")
    return bad


def _timed_in_order(runs: dict, reverse: bool) -> dict:
    names = list(runs)[::-1] if reverse else list(runs)
    out = {name: C.batch_ms(*runs[name]) for name in names}
    return {name: out[name] for name in runs}


K7A_RE = r"\brecord_shade_kernel\b"
K8_RE = r"\binline_kernel\b"
GATHER_RE = "|index_elementwise_kernel|direct_copy_kernel"
K3_RE = r"|\bsweep_masked_kernel\b"
K7A_BOUNCES = (0, 2, 8)


def _k7a_runs(k7a_libs, states, b: int, n: int) -> dict:
    bx, amat = states["bounces"][b], states["amat"]
    R = bx["t"].shape[0]
    planes = fetch_attr_planes(bx["idx"], amat)
    make = lambda: (bx["st"].clone(), torch.empty((GK.N_REC, R),
                                                  device=amat.device))
    runs = {"gather+previous": (
        lambda st, slot: k7a_launch(
            k7a_libs["previous"], bx["t"], bx["idx"],
            fetch_attr_planes(bx["idx"], amat), st, slot, b), make, n,
        K7A_RE + GATHER_RE)}
    for name, fn in k7a_libs.items():
        table = planes if name == "previous" else amat
        runs[name] = (lambda st, slot, fn=fn, table=table: k7a_launch(
            fn, bx["t"], bx["idx"], table, st, slot, b), make, n, K7A_RE)
    return runs


def record_pass_runs(k7a_libs, states, n: int = 10) -> dict:
    """The whole record of the pass (16 bounces of K3, then the gather and
    the previous K7a, or the shipped K7a) as ``batch_ms`` runs."""
    amat, spheres = states["amat"], states["spheres"]
    start = states["start"]
    R = start.shape[1]
    make = lambda: (start.clone(), torch.empty((DEPTH, GK.N_REC, R),
                                               device=amat.device))

    def run(st, rec, gather: bool):
        for b in range(DEPTH):
            t, idx = K1.sweep_masked(st[0:6], st[12].view(torch.int32),
                                     spheres)
            if gather:
                k7a_launch(k7a_libs["previous"], t, idx,
                           fetch_attr_planes(idx, amat), st, rec[b], b)
            else:
                k7a_launch(k7a_libs["shipped"], t, idx, amat, st, rec[b], b)

    return {"gather+previous": (lambda st, rec: run(st, rec, True), make, n,
                                K7A_RE + K3_RE + GATHER_RE),
            "shipped": (lambda st, rec: run(st, rec, False), make, n,
                        K7A_RE + K3_RE)}


def _k8_runs(k8_libs, shape, n: int) -> dict:
    R = shape["rays"].shape[1]
    dev = shape["rays"].device
    make = lambda: (torch.empty((3, R), device=dev),
                    torch.zeros(1, dtype=torch.int32, device=dev))
    return {name: (lambda rad, head, fn=fn: k8_launch(fn, shape, rad, head),
                   make, n, K8_RE)
            for name, fn in k8_libs.items()}


def variant_tables(k7a_libs, k8_libs, states, shapes, n7: int = 50,
                   n8: int = 20, reverse: bool = False) -> dict:
    """Every build of K7a at bounces 0, 2 and 8 (and ``gather+previous``),
    the whole record pass, and every build of K8 on the demo, by
    ``chip_smoke.batch_ms``, in order or in reverse order."""
    k7a = {f"bounce{b}": {"live_lanes": states["bounces"][b]["live"],
                          **_timed_in_order(_k7a_runs(k7a_libs, states, b,
                                                      n7), reverse)}
           for b in K7A_BOUNCES}
    k7a["record_pass"] = _timed_in_order(record_pass_runs(k7a_libs, states),
                                         reverse)
    k8 = {"demo": _timed_in_order(_k8_runs(k8_libs, shapes["demo"], n8),
                                  reverse)}
    return {"k7a": k7a, "k8": k8}


def pair_tables(k7a_libs, k8_libs, states, shapes) -> dict:
    """``gather+previous`` and ``shipped`` of K7a at bounce 2, ``previous``
    and ``shipped`` of K8 on the demo, by an event pair around each launch
    (``chip_smoke.device_ms``), the state restored between launches."""
    bx, amat = states["bounces"][2], states["amat"]
    st = bx["st"].clone()
    slot = torch.empty((GK.N_REC, st.shape[1]), device=st.device)
    reset = lambda: st.copy_(bx["st"])
    k7a = {"gather+previous": C.device_ms(lambda: k7a_launch(
        k7a_libs["previous"], bx["t"], bx["idx"],
        fetch_attr_planes(bx["idx"], amat), st, slot, 2), 50, setup=reset),
        "shipped": C.device_ms(lambda: k7a_launch(
            k7a_libs["shipped"], bx["t"], bx["idx"], amat, st, slot, 2), 50,
            setup=reset)}
    demo = shapes["demo"]
    rad = torch.empty((3, demo["rays"].shape[1]), device=amat.device)
    head = torch.zeros(1, dtype=torch.int32, device=amat.device)
    k8 = {name: C.device_ms(lambda fn=k8_libs[name]: k8_launch(
        fn, demo, rad, head), 20, setup=head.zero_)
        for name in ("previous", "shipped")}
    return {"k7a_bounce2": k7a, "k8_demo": k8}


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


#: (change, against) of each change alone, per kernel
K7A_ALONE = (("shipped", "gather+previous"), ("shipped", "previous"),
             ("shipped", "shipped_nohint"), ("shipped_t32", "shipped"),
             ("shipped_t64", "shipped"), ("shipped_t256", "shipped"),
             ("shipped_smem", "shipped"), ("shipped_draws", "shipped"))
K8_ALONE = (("previous_index", "previous"), ("queue_running", "previous"),
            ("shipped", "previous"), ("shipped", "queue_running"),
            ("shipped", "previous_index"), ("shipped_half", "shipped"),
            ("shipped_t64", "shipped"), ("shipped_t256", "shipped"),
            ("shipped_w8", "shipped"), ("shipped_w12", "shipped"),
            ("shipped_w20", "shipped"), ("shipped_w24", "shipped"),
            ("shipped_w36", "shipped"), ("shipped_t256_w8", "shipped"),
            ("shipped_t256_w24", "shipped"))


def changes_alone(tabs: dict) -> dict:
    """Each change's ``event_ms`` over what it replaces, per shape."""
    out = {}
    for kernel, pairs in (("k7a", K7A_ALONE), ("k8", K8_ALONE)):
        out[kernel] = [
            {"shape": shape, "change": c, "against": b,
             "ratio": t[c]["event_ms"] / t[b]["event_ms"]}
            for shape, t in tabs[kernel].items() if shape != "record_pass"
            for c, b in pairs]
    return out


#: A change is kept where it takes at most this share of what it replaces
#: at every shape: repeated medians of one build move by up to ~1%.
KEEP_RATIO = 0.99


def verdict(alone: dict) -> dict:
    """Which change is kept: at least 1% faster at every shape against
    what it replaces, in each pairing it was timed in."""
    def kept(kernel, *pairs):
        return all(r["ratio"] <= KEEP_RATIO for r in alone[kernel]
                   if (r["change"], r["against"]) in pairs)
    return {"k7a": {"fetch_inside": kept("k7a", ("shipped",
                                                 "gather+previous")),
                    "hint": kept("k7a", ("shipped", "shipped_nohint")),
                    **{c.removeprefix("shipped_"): kept("k7a", (c, "shipped"))
                       for c, b in K7A_ALONE[3:]}},
            "k8": {"index": kept("k8", ("previous_index", "previous"),
                                 ("shipped", "queue_running")),
                   "queue": kept("k8", ("queue_running", "previous"),
                                 ("shipped", "previous_index")),
                   **{c.removeprefix("shipped_"): kept("k8", (c, "shipped"))
                      for c, b in K8_ALONE[5:]}},
            "shipped": {"k7a": "one thread per lane, 128-thread blocks, the "
                               "winner's row by index through the read-only "
                               "path, the record stored evict-first",
                        "k8": "persistent: at most 16 resident warps per "
                              "SM, a lane work queue refilled when any lane "
                              "of a warp is idle, the winner by index, "
                              "128-thread blocks"},
            "rule": "a change is kept where it is at least 1% faster "
                    "(event_ms) at every shape timed against what it "
                    "replaces; the ptxas report gives each build's "
                    "spills"}


def run_pass_set(dev, passes: int) -> dict:
    """Build, check and time every variant (``passes`` timing passes);
    the phases' JSON objects as a dict."""
    states, shapes = k7a_states(dev), k8_shapes(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    k7a_libs, k8_libs, report = build_variants(
        tempfile.mkdtemp(dir=os.path.join(ROOT, "build")),
        states["amat"].shape[0])
    bad = check_variants(dev, k7a_libs, k8_libs, states, shapes)
    shares = {"demo": live_shares(shapes["demo"], k8_libs)}
    tabs = _median_tables([variant_tables(k7a_libs, k8_libs, states, shapes,
                                          reverse=bool(r % 2))
                           for r in range(passes)])
    alone = changes_alone(tabs)
    return {"ptxas": report,
            "vs_previous": {"cases": len(bad),
                            "lanes_differing": sum(bad.values()),
                            "k7a_live_lanes_by_bounce": [
                                bx["live"] for bx in states["bounces"]],
                            "k8_shapes": {k: v["size"] + [
                                v["planes"].shape[1]]
                                for k, v in shapes.items()},
                            "tolerance": "K7a state and record, K8 "
                                         "radiance, bit for bit against "
                                         "the previous kernel"},
            "live_shares": shares, "times": tabs,
            "pairs": pair_tables(k7a_libs, k8_libs, states, shapes),
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
    C.emit({"phase": "ptxas", **out["ptxas"]})
    C.emit({"phase": "variants_vs_previous", **out["vs_previous"]})
    C.emit({"phase": "k8_live_shares", "card": card, **out["live_shares"]})
    C.emit({"phase": "variant_times", "card": card, "passes": 5,
            **out["times"], "device_ms_pair_per_launch": out["pairs"],
            "note": "medians of 5 passes (every other one in reverse "
                    "order); event_ms: one event pair around the launches, "
                    "each on its own copy of the state; profiler_ms: the "
                    "profiler's per-launch mean (gather+previous: gather, "
                    "cast and kernel; record_pass: 16 x (K3 [+ gather] + "
                    "K7a)); device_ms_pair_per_launch: an event pair around "
                    "each launch"})
    C.emit({"phase": "changes_alone", **out["changes_alone"]})
    C.emit({"phase": "verdict", **out["verdict"]})
    print(C.card_line(), flush=True)
    C.emit({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
