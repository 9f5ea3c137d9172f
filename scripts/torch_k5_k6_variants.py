"""K5 (``persist_replay_fused_kernel``) and K6 (``persist_replay_step_kernel``)
beside the designs they were chosen over, on the card: what each change of
their redesign does alone, and why the shipped kernels are what they are.

The shipped source (``csrc/persist_replay.cu``) is built as it stands
(``shipped``) and rewritten into variants, each built by its own ``nvcc
-Xptxas -v`` (all at once):

- ``previous``: the earlier kernels. K5 loads each slot's words after its
  flags; K6 reads ten attribute planes that a gather wrote (its ``amat``
  argument then holds those [10, n] planes; ``gather+previous`` times the
  gather, the cast and the kernel, as the lean loop ran them).
- K5 (a) staging: ``cp.async`` copies a later slot's words into shared
  memory while the current slot's adjoint runs. ``shipped_ahead1_nohint``
  adds it alone to the previous kernel (one slot ahead); the shipped
  kernel stages three slots ahead (``shipped_ahead1``, ``shipped_ahead2``:
  one and two), in four buffers, 46 KB, which hold the SM to 4 resident
  blocks (``shipped_ahead1_bufs4``: one slot ahead in the same four
  buffers, so the same residency).
- K5 (b) ``previous_row``: a hit lane reads its winner's row of the
  [N, 10] table by index (``rtw_fetch_row``) in place of the record's 10
  attribute planes, a miss lane still reads the planes (its attribute
  cotangent rows are zeros whose signs follow the attributes). This
  build's launcher also takes the winner indices and the table.
- K5 (c), K6 (b) the hints: flags and record loads evict-first, attribute
  rows stored streaming (``__ldcs``, ``__stcs``): shipped in K5
  (``_nohint`` without them), ``previous_hint`` on the previous kernels,
  ``shipped_hint`` on K6.
- K5 (d), K6 (c): 256-thread blocks (``_t256``), or a launch bound of 7
  (K5) or 8 (K6) resident 128-thread blocks per SM (``_lb7``, ``_lb8``);
  on the previous K5, as the shipped one's shared memory already bounds
  its residency (and 256 of its threads would need 92 KB).
- K6 (a), the shipped kernel: the row fetched by index inside.
- Two readings of K5 that are not kernels (no bitwise check):
  ``probe_memory`` moves what the previous kernel moves with the adjoint
  left out, ``probe_compute`` runs its adjoint over the real flags with
  every other word read from, and written to, slot 0 (cache-resident).

It prints each build's registers, spills, shared memory and SASS
instruction count, and each phase's lane and warp live shares (a warp
issues a slot's adjoint while any of its lanes lives). On the flagship
gradient step's own record phases (1920x1080, spp 1, 8 strips, tail
compaction (44, 16): phase 1 at 262 144 lanes, phase 2 at 16 384) and on a
phase 1 recorded by K11 (whose miss lanes hold zero attributes), it holds
every build bit for bit against ``previous`` (cot, dep and dattr; injected
and Philox draws; K6 over every slot of both phases of the lean record) and
times it with ``chip_smoke.batch_ms`` (one CUDA event pair around N
launches, each on its own copy of the carry, and the profiler's per-launch
mean), in five passes, every other one in reverse order; each time is the
median of the five. K5 is timed over phase 1 and phase 2, K6 at phase 1's
slots 10 and 40, beside the pair method (``chip_smoke.device_ms``) for
``previous`` and ``shipped`` and the whole lean replay of both phases with
and without the gather. The last lines give each change alone against what
it replaces, and what ships: a change is kept where it is faster at every
shape it was timed at. One JSON object per line; a failed check raises.

    python3 scripts/torch_k5_k6_variants.py     # one CUDA card and nvcc
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
from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import build  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import (  # noqa: E402
    intersect_kernel as K1, persist_grad_kernel as PK)
from raytracingweekend_jl_tpu_torch.ops.intersect import (  # noqa: E402
    DEFAULT_TMIN)
from raytracingweekend_jl_tpu_torch.ops.cuda.grad_kernel import (  # noqa: E402
    base_seed)
from raytracingweekend_jl_tpu_torch.ops.materials import (  # noqa: E402
    attr_mat, fetch_attr_planes)

# -- source rewrites ---------------------------------------------------------

K5_KERNEL = re.compile(r"__global__ void __launch_bounds__\(RTW_K5_THREADS\) "
                       r"persist_replay_fused_kernel\(.*?\n}\n", re.S)

#: The earlier K5: each slot's words loaded after its flags, one slot at a
#: time. ``{params}`` and ``{attrs}`` take the row variant's rewrites.
UNSTAGED_K5 = """__global__ void persist_replay_fused_kernel(
    float* __restrict__ cot_io, float* __restrict__ dep,
    const float* __restrict__ rec, {params}const float* __restrict__ gs,
    float* __restrict__ dattr, const float* __restrict__ u5, int n_lanes,
    int S, int n_slots, uint32_t seed, uint32_t i0) {{
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  float cot[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];

  for (int slot = n_slots - 1; slot >= 0; --slot) {{
    const float* rs = rec + (size_t)slot * 21 * n;
    float* da = dattr + (size_t)slot * 9 * n;
    const int flags = __float_as_int(rs[10 * n + i]);
    if (!(flags & RTW_F_ACT)) {{
#pragma unroll
      for (int j = 0; j < 9; ++j) da[j * n + i] = 0.0f;
      continue;
    }}
    float u[5];
    if (u5) {{
      const float* us = u5 + (size_t)slot * 5 * n;
#pragma unroll
      for (int j = 0; j < 5; ++j) u[j] = us[j * n + i];
    }} else {{
      rtw_uniforms<5>(seed, i0 + (uint32_t)slot, (uint32_t)i, u);
    }}
    float r[10], a[10], g[3], d9[9];
#pragma unroll
    for (int j = 0; j < 10; ++j) r[j] = rs[j * n + i];
{attrs}    rtw_strip_cot(gs, flags, n, i, g);
    rtw_replay_iter(u, r, a, g, flags, cot, dep, n, i, S, d9);
#pragma unroll
    for (int j = 0; j < 9; ++j) da[j * n + i] = d9[j];
  }}
#pragma unroll
  for (int j = 0; j < 9; ++j) cot_io[j * n + i] = cot[j];
}}
"""
PLANES_K5 = ("#pragma unroll\n"
             "    for (int j = 0; j < 10; ++j) a[j] = rs[(11 + j) * n + i];\n")
ROW_K5 = ("    if (flags & RTW_F_HIT) {{\n"
          "      rtw_fetch_row(rec_idx + (size_t)slot * n, amat, i, a);\n"
          "    }} else {{\n"
          "#pragma unroll\n"
          "      for (int j = 0; j < 10; ++j) a[j] = rs[(11 + j) * n + i];\n"
          "    }}\n")
ROW_PARAMS = "const int* __restrict__ rec_idx,\n    const float* __restrict__ amat, "
ROW_LAUNCHER = (
    ("                                        const float* rec, const float* gs,\n",
     "                                        const float* rec, const int* rec_idx,\n"
     "                                        const float* amat, const float* gs,\n"),
    ("      cot, dep, rec, gs, dattr, u5, n_lanes, S, n_slots, seed, i0);\n",
     "      cot, dep, rec, rec_idx, amat, gs, dattr, u5, n_lanes, S, n_slots,\n"
     "      seed, i0);\n"))

#: (target, replacement) of the evict-first loads and streaming stores
HINT_UNSTAGED = (
    ("__float_as_int(rs[10 * n + i])", "__float_as_int(__ldcs(rs + 10 * n + i))"),
    ("r[j] = rs[j * n + i];", "r[j] = __ldcs(rs + j * n + i);"),
    ("a[j] = rs[(11 + j) * n + i];", "a[j] = __ldcs(rs + (11 + j) * n + i);"),
    ("da[j * n + i] = 0.0f;", "__stcs(da + j * n + i, 0.0f);"),
    ("da[j * n + i] = d9[j];", "__stcs(da + j * n + i, d9[j]);"))
NO_HINT_STAGED = (
    ("__float_as_int(__ldcs(rec + ((size_t)s * 21 + 10) * n + i))",
     "__float_as_int(rec[((size_t)s * 21 + 10) * n + i])"),
    ("__stcs(da + j * n, 0.0f);", "da[j * n] = 0.0f;"),
    ("__stcs(da + j * n, d9[j]);", "da[j * n] = d9[j];"))
HINT_K6 = (
    ("__float_as_int(rec[10 * n + i])", "__float_as_int(__ldcs(rec + 10 * n + i))"),
    ("r[j] = rec[j * n + i];", "r[j] = __ldcs(rec + j * n + i);"),
    ("dattr[j * n + i] = 0.0f;", "__stcs(dattr + j * n + i, 0.0f);"),
    ("dattr[j * n + i] = d9[j];", "__stcs(dattr + j * n + i, d9[j]);"))

PROBE_MEMORY = ("    rtw_replay_iter(u, r, a, g, flags, cot, dep, n, i, S, d9);\n",
                "#pragma unroll\n"
                "    for (int j = 0; j < 9; ++j)\n"
                "      d9[j] = r[j] + a[j] + (j < 3 ? g[j] : 0.0f);\n")
PROBE_COMPUTE = (("r[j] = rs[j * n + i];", "r[j] = rec[j * n + i];"),
                 ("a[j] = rs[(11 + j) * n + i];", "a[j] = rec[(11 + j) * n + i];"),
                 ("    float* da = dattr + (size_t)slot * 9 * n;\n",
                  "    float* da = dattr;\n"))

K6_FETCH = "  rtw_fetch_row(idx, amat, i, a);\n"
K6_PLANES = ("#pragma unroll\n"
             "  for (int j = 0; j < 10; ++j) a[j] = amat[j * n + i];\n")


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


def _subs(src: str, pairs) -> str:
    for old, new in pairs:
        src = _sub(src, old, new)
    return src


def _threads(src: str, kernel: str, threads: int) -> str:
    return _sub(src, f"#define RTW_{kernel}_THREADS 128\n",
                f"#define RTW_{kernel}_THREADS {threads}\n")


def _bound(src: str, kernel: str, blocks: int) -> str:
    """The kernel's launch bound with ``blocks`` resident blocks per SM."""
    return _sub(src, f"__launch_bounds__(RTW_{kernel}_THREADS) ",
                f"__launch_bounds__(RTW_{kernel}_THREADS, {blocks}) ")


def k5_source(src: str, name: str) -> str:
    """persist_replay.cu of K5's variant ``name``."""
    base, _, x = name.partition("_")
    if base in ("previous", "probe"):
        row = x == "row"
        src = _sub(src, K5_KERNEL, UNSTAGED_K5.format(
            params=ROW_PARAMS if row else "",
            attrs=ROW_K5.format() if row else PLANES_K5))
        if row:
            src = _subs(src, ROW_LAUNCHER)
        if x == "hint":
            src = _subs(src, HINT_UNSTAGED)
        if name == "probe_memory":
            src = _sub(src, *PROBE_MEMORY)
        if name == "probe_compute":
            src = _subs(src, PROBE_COMPUTE)
        if x == "t256":
            src = _threads(src, "K5", 256)
        if x == "lb7":  # the earlier kernel had no launch bound
            src = _sub(src, "__global__ void persist_replay_fused_kernel(",
                       "__global__ void __launch_bounds__(RTW_K5_THREADS, 7) "
                       "persist_replay_fused_kernel(")
        return src
    if base != "shipped":
        raise ValueError(name)
    for part in x.split("_") if x else ():
        if part.startswith("ahead"):
            src = _sub(src, "#define RTW_K5_AHEAD 3\n",
                       f"#define RTW_K5_AHEAD {int(part[5:])}\n")
        elif part == "bufs4":  # the shared memory, and so the residency, of
            src = _sub(src, "#define RTW_K5_BUFS (RTW_K5_AHEAD + 1)\n",
                       "#define RTW_K5_BUFS 4\n")  # three slots ahead
        elif part == "nohint":
            src = _subs(src, NO_HINT_STAGED)
        else:
            raise ValueError(name)
    return src


def k6_source(src: str, name: str) -> str:
    """persist_replay.cu of K6's variant ``name``."""
    base, _, x = name.partition("_")
    if base == "previous":  # the planes of a gather, no launch bound
        src = _sub(src, K6_FETCH, K6_PLANES)
        src = _sub(src, "__launch_bounds__(RTW_K6_THREADS) ", "")
    if x == "hint":
        src = _subs(src, HINT_K6)
    elif x == "t256":
        src = _threads(src, "K6", 256)
    elif x == "lb8":
        src = _bound(src, "K6", 8)
    elif x:
        raise ValueError(name)
    return src


K5_VARIANTS = ("shipped", "previous", "shipped_nohint", "shipped_ahead1",
               "shipped_ahead2", "shipped_ahead1_bufs4", "shipped_ahead1_nohint",
               "previous_row", "previous_hint", "previous_t256",
               "previous_lb7", "probe_memory", "probe_compute")
K6_VARIANTS = ("shipped", "previous", "previous_hint", "shipped_hint",
               "shipped_t256", "shipped_lb8")
#: K5's readings that are not kernels (no bitwise check), and its build
#: whose launcher takes the winner indices and the table
PROBES = ("probe_memory", "probe_compute")
ROW = "previous_row"
#: K6's variants that read the gathered planes in place of the table
PLANES_INPUT = ("previous", "previous_hint")

PTXAS = re.compile(r"Function properties for \w*(persist_replay_fused_kernel|"
                   r"persist_replay_step_kernel)\w*\s+(\d+) bytes stack "
                   r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                   r"loads\s+ptxas info\s*: Used (\d+) registers")
SMEM = re.compile(r"(\d+) bytes smem")

KERNELS = {"k5": "persist_replay_fused", "k6": "persist_replay_step"}


def _sass_counts(lib: str) -> dict:
    """SASS instructions of each kernel in ``lib`` (``cuobjdump -sass``),
    or ``{}`` where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True).stdout
    counts = {}
    for part in out.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        for k in KERNELS.values():
            if f"{k}_kernel" in name:
                counts[k] = len(re.findall(r"/\*[0-9a-f]{4}\*/", part))
    return counts


def build_variants(out: str) -> tuple:
    """``({name: launcher} of K5's, of K6's, {kernel/name: ptxas report
    and SASS count})``: every variant compiled into ``out``, one nvcc
    each, all at once."""
    with open(os.path.join(build.CSRC_DIR, "persist_replay.cu")) as f:
        src = f.read()
    jobs = {("k5", n): k5_source(src, n) for n in K5_VARIANTS}
    jobs.update({("k6", n): k6_source(src, n) for n in K6_VARIANTS})
    procs = {}
    for (kernel, name), text in jobs.items():
        d = os.path.join(out, f"{kernel}_{name}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "persist_replay.cu"), "w") as f:
            f.write(text)
        procs[(kernel, name)] = subprocess.Popen(
            [build._nvcc(), "-Xptxas", "-v", *build.NVCC_FLAGS, "-I", d,
             "-I", build.CSRC_DIR, "-shared", "-o",
             os.path.join(d, "lib.so"), os.path.join(d, "persist_replay.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"k5": {}, "k6": {}}
    report = {}
    for (kernel, name), p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {kernel} {name}:\n{log}")
        want = f"{KERNELS[kernel]}_kernel"
        hits = [m for m in PTXAS.finditer(log) if m.group(1) == want]
        if len(hits) != 1:
            raise RuntimeError(f"no single ptxas report for {kernel} "
                               f"{name}:\n{log}")
        stack, stores, loads, regs = map(int, hits[0].groups()[1:])
        smem = SMEM.search(log[hits[0].end():].split("\n")[0])
        path = os.path.join(out, f"{kernel}_{name}", "lib.so")
        report[f"{kernel}/{name}"] = {
            "registers": regs, "stack_bytes": stack,
            "spill_store_bytes": stores, "spill_load_bytes": loads,
            "smem_bytes": int(smem.group(1)) if smem else 0,
            "sass_instructions": _sass_counts(path).get(KERNELS[kernel])}
        fn = getattr(ctypes.CDLL(path), f"rtw_{KERNELS[kernel]}")
        sig = list(build._SIGNATURES[f"rtw_{KERNELS[kernel]}"])
        if (kernel, name) == ("k5", ROW):  # + rec_idx, amat after rec
            sig[3:3] = [ctypes.c_void_p, ctypes.c_void_p]
        fn.argtypes = sig
        fn.restype = ctypes.c_int
        libs[kernel][name] = fn
    return libs["k5"], libs["k6"], report


# -- launches ----------------------------------------------------------------

def k5_launch(fn, cot, dep, rec, gs, dattr, i0: int, seed: int, u5_all=None,
              row=None) -> None:
    """One launch of a K5 build over the phase ``rec`` (``row``: the winner
    indices and the table, for the row variant)."""
    extra = () if row is None else tuple(x.data_ptr() for x in row)
    err = fn(cot.data_ptr(), dep.data_ptr(), rec.data_ptr(), *extra,
             gs.data_ptr(), dattr.data_ptr(),
             None if u5_all is None else u5_all.data_ptr(), cot.shape[1],
             gs.shape[0] // 3, rec.shape[0], seed & 0xFFFFFFFF,
             i0 & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
    build.check(err, "K5 variant")


def k6_launch(fn, cot, dep, slot, idx, table, gs, out, seed: int, it: int,
              u5=None) -> None:
    """One launch of a K6 build over one slot (``table``: the [N, 10]
    table, or the gathered [10, n] planes for the previous kernel)."""
    err = fn(cot.data_ptr(), dep.data_ptr(), slot.data_ptr(), idx.data_ptr(),
             table.data_ptr(), gs.data_ptr(), out.data_ptr(),
             None if u5 is None else u5.data_ptr(), cot.shape[1],
             gs.shape[0] // 3, seed & 0xFFFFFFFF, it & 0xFFFFFFFF,
             torch.cuda.current_stream().cuda_stream)
    build.check(err, "K6 variant")


# -- states ------------------------------------------------------------------

#: The step's seed, and the replay's: the record phases draw with
#: ``base_seed`` of the step's seed, and so does the walk.
STEP_SEED = 0x5EED
SEED = base_seed(STEP_SEED)


def phases(dev, W: int = 1920, H: int = 1080) -> dict:
    """The flagship gradient step's record phases (``render_grads``'
    default route: 1920x1080, spp 1, 8 strips, tail compaction (44, 16),
    strict), and phase 1 again recorded by K11: ``{name: dict(rec,
    rec_idx, i0, gs, cot, dep)}`` with each phase cut to its realized
    slots, a random radiance cotangent in the strip layout and a random
    carry on the lanes the walk reaches; plus ``amat``."""
    S = 8
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    cam = pt.t_cam1(device=dev)
    g = torch.Generator(device=dev).manual_seed(7)
    u_px, v_px = pt.pixel_coords(W, H, device=dev)
    o, d = pt.get_rays(cam, u_px, v_px, generator=g)
    cfg = PG._config(STEP_SEED, 16, DEFAULT_TMIN, S, None, False, (44, 16),
                     True, True, None, None, None, dev)
    _, (ph1, ph2, sel, _), dropped = PG._record_forward(scene, o, d, cfg)
    C.check(int(dropped) == 0, f"{int(dropped)} paths dropped")
    amat = attr_mat(scene)
    spheres = K1.sphere_consts(scene)
    gs1 = PG.grad_strip_planes(
        torch.rand((W * H, 3), generator=g, device=dev) * 2 - 1, S,
        ph1.rec.shape[2])

    def cut(ph, gs):
        n = int((ph.counts > 0).sum())
        rec, rec_idx = ph.rec[:n], ph.rec_idx[:n]
        lanes = rec.shape[2]
        reach = ((rec[:, 10].view(torch.int32) & PK.F_ACT) != 0).any(0)
        cot = torch.randn((9, lanes), generator=g, device=dev) * reach
        return dict(rec=rec, rec_idx=rec_idx, i0=ph.i0, gs=gs, cot=cot,
                    dep=torch.zeros((6 * S, lanes), device=dev))

    out = {"phase1": cut(ph1, gs1),
           "phase2": cut(ph2, gs1[:, sel].contiguous())}
    # Phase 1 through K11: zero attributes on miss lanes.
    strips, sf, si, rad = PG.start_planes(o, d, S)
    n1 = out["phase1"]["rec"].shape[0]
    lanes = sf.shape[1]
    rec = torch.empty((n1, PK.N_REC, lanes), device=dev)
    rec_idx = torch.empty((n1, lanes), dtype=torch.int32, device=dev)
    for s in range(n1):
        PK.persist_record_fused_step(strips, sf, si, rad, rec[s], rec_idx[s],
                                     spheres, amat, SEED, s, 16,
                                     DEFAULT_TMIN)
    out["phase1_k11"] = dict(out["phase1"], rec=rec, rec_idx=rec_idx)
    out["amat"] = amat
    return out


def live_shares(rec) -> dict:
    """The share of (lane, slot) pairs that are live, and of (warp, slot)
    pairs with a live lane: a warp issues a slot's adjoint for all its 32
    lanes while any of them lives."""
    live = (rec[:, 10].view(torch.int32) & PK.F_ACT) != 0
    warps = live.reshape(live.shape[0], live.shape[1] // 32, 32).any(2)
    return {"lanes": live.float().mean().item(),
            "warps": warps.float().mean().item()}


# -- checks and tables ---------------------------------------------------------

def _k5_args(name, ph, amat):
    return {"row": (ph["rec_idx"], amat)} if name == ROW else {}


def _k5_run(fn, ph, amat, u5_all=None, row=None):
    cot, dep = ph["cot"].clone(), ph["dep"].clone()
    rec = ph["rec"]
    dattr = torch.full((rec.shape[0], 9, rec.shape[2]), 7.0,
                       device=rec.device)
    k5_launch(fn, cot, dep, rec, ph["gs"], dattr, ph["i0"], SEED, u5_all, row)
    torch.cuda.synchronize()
    return cot, dep, dattr


def _k6_walk(fn, ph, amat, planes: bool, u5_all=None):
    """The lean replay of a whole phase through one K6 build, newest slot
    first (``planes``: the build reads gathered planes)."""
    cot, dep = ph["cot"].clone(), ph["dep"].clone()
    rec, rec_idx = ph["rec"], ph["rec_idx"]
    dattr = torch.full((rec.shape[0], 9, rec.shape[2]), 7.0,
                       device=rec.device)
    for s in reversed(range(rec.shape[0])):
        table = fetch_attr_planes(rec_idx[s], amat) if planes else amat
        k6_launch(fn, cot, dep, rec[s, :PK.N_REC_LEAN], rec_idx[s], table,
                  ph["gs"], dattr[s], SEED, ph["i0"] + s,
                  None if u5_all is None else u5_all[s])
    torch.cuda.synchronize()
    return cot, dep, dattr


def _differing(a, b) -> int:
    """Lanes on which any word of ``(cot, dep, dattr)`` differs in a bit."""
    return int(C._bitwise_lanes(list(zip(a, b)), a[0].shape[1]).sum())


def check_variants(dev, k5_libs, k6_libs, ph) -> dict:
    """Every build against ``previous``, bit for bit (cot, dep, dattr):
    K5 over both phases and over phase 1 as K11 records it, K6 over every
    slot of both phases of the lean record, each with injected and with
    Philox draws; and the shipped K6 against the shipped K5 on phase 1.
    Returns the lanes that differ by case (all 0, or it raises)."""
    amat = ph["amat"]
    g = torch.Generator(device=dev).manual_seed(11)
    bad = {}
    for shape in ("phase1", "phase2", "phase1_k11"):
        p = ph[shape]
        u5 = torch.rand((p["rec"].shape[0], 5, p["rec"].shape[2]),
                        generator=g, device=dev)
        for draws, u in (("injected", u5), ("philox", None)):
            ref = _k5_run(k5_libs["previous"], p, amat, u)
            for name, fn in k5_libs.items():
                if name not in PROBES:
                    bad[f"k5/{shape}/{draws}/{name}"] = _differing(
                        _k5_run(fn, p, amat, u, **_k5_args(name, p, amat)),
                        ref)
            if shape == "phase1_k11":
                continue
            ref6 = _k6_walk(k6_libs["previous"], p, amat, True, u)
            for name, fn in k6_libs.items():
                bad[f"k6/{shape}/{draws}/{name}"] = _differing(
                    _k6_walk(fn, p, amat, name in PLANES_INPUT, u), ref6)
            if draws == "philox":
                bad[f"k6_shipped_vs_k5_shipped/{shape}"] = _differing(
                    _k6_walk(k6_libs["shipped"], p, amat, False),
                    _k5_run(k5_libs["shipped"], p, amat))
        del u5
    C.check(all(v == 0 for v in bad.values()),
            f"a K5 or K6 build differs from the previous kernel: "
            f"{ {k: v for k, v in bad.items() if v} }")
    return bad


def _timed_in_order(runs: dict, reverse: bool) -> dict:
    names = list(runs)[::-1] if reverse else list(runs)
    out = {name: C.batch_ms(*runs[name]) for name in names}
    return {name: out[name] for name in runs}


K5_RE = r"\bpersist_replay_fused_kernel\b"
K6_RE = r"\bpersist_replay_step_kernel\b"
GATHER_RE = "|index_elementwise_kernel|direct_copy_kernel"
K6_SLOTS = (10, 40)


def _k6_slot(ph, s: int) -> dict:
    p = ph["phase1"]
    return dict(p, slot=p["rec"][s, :PK.N_REC_LEAN], idx=p["rec_idx"][s],
                it=p["i0"] + s)


def variant_tables(dev, k5_libs, k6_libs, ph, n5: int = 10, n6: int = 50,
                   reverse: bool = False) -> dict:
    """Every build of K5 over phases 1 and 2 and of K6 at phase 1's slots
    10 and 40, and K6's ``gather+previous``, by ``chip_smoke.batch_ms``,
    in order or in reverse order."""
    amat = ph["amat"]
    k5 = {}
    for shape in ("phase1", "phase2"):
        p = ph[shape]
        rec = p["rec"]
        make = lambda p=p, rec=rec: (
            p["cot"].clone(), p["dep"].clone(),
            torch.empty((rec.shape[0], 9, rec.shape[2]), device=dev))
        runs = {name: (lambda cot, dep, dattr, fn=fn, p=p, kw=_k5_args(
            name, p, amat): k5_launch(fn, cot, dep, p["rec"], p["gs"], dattr,
                                      p["i0"], SEED, **kw),
            make, n5 if shape == "phase1" else 2 * n5, K5_RE)
            for name, fn in k5_libs.items()}
        k5[shape] = {"lanes": rec.shape[2], "slots": rec.shape[0],
                     "live_share": live_shares(rec),
                     **_timed_in_order(runs, reverse)}
    k6 = {}
    for s in K6_SLOTS:
        q = _k6_slot(ph, s)
        lanes = q["cot"].shape[1]
        planes = fetch_attr_planes(q["idx"], amat)
        make = lambda q=q: (q["cot"].clone(), q["dep"].clone(),
                            torch.empty((9, lanes), device=dev))
        runs = {"gather+previous": (
            lambda cot, dep, out, q=q: k6_launch(
                k6_libs["previous"], cot, dep, q["slot"], q["idx"],
                fetch_attr_planes(q["idx"], amat), q["gs"], out, SEED,
                q["it"]), make, n6, K6_RE + GATHER_RE)}
        for name, fn in k6_libs.items():
            table = planes if name in PLANES_INPUT else amat
            runs[name] = (lambda cot, dep, out, fn=fn, q=q, table=table:
                          k6_launch(fn, cot, dep, q["slot"], q["idx"], table,
                                    q["gs"], out, SEED, q["it"]), make, n6,
                          K6_RE)
        k6[f"slot{s}"] = {"live_share": live_shares(q["slot"][None]),
                          **_timed_in_order(runs, reverse)}
    return {"k5": k5, "k6": k6}


def lean_walk_ms(dev, k6_libs, ph, reps: int = 5) -> dict:
    """The lean replay of both phases (every slot, newest first, as
    ``persist_grad._replay_phase`` walks them) by ``chip_smoke.batch_ms``:
    the gather and the previous kernel per slot, against the shipped
    kernel, which fetches the row itself."""
    amat = ph["amat"]
    shapes = ("phase2", "phase1")
    out = {}
    for name in ("gather+previous", "shipped"):
        fn = k6_libs["previous" if name == "gather+previous" else name]
        gather = name == "gather+previous"

        def make():
            return tuple(x for sh in shapes
                         for x in (ph[sh]["cot"].clone(),
                                   ph[sh]["dep"].clone(),
                                   torch.empty((ph[sh]["rec"].shape[0], 9,
                                                ph[sh]["rec"].shape[2]),
                                               device=dev)))

        def run(*carry, fn=fn, gather=gather):
            for k, sh in enumerate(shapes):
                p = ph[sh]
                cot, dep, dattr = carry[3 * k:3 * k + 3]
                for s in reversed(range(p["rec"].shape[0])):
                    idx = p["rec_idx"][s]
                    k6_launch(fn, cot, dep, p["rec"][s, :PK.N_REC_LEAN], idx,
                              fetch_attr_planes(idx, amat) if gather
                              else amat, p["gs"], dattr[s], SEED,
                              p["i0"] + s)
        out[name] = C.batch_ms(run, make, reps,
                               K6_RE + (GATHER_RE if gather else ""))
    out["launches"] = sum(ph[sh]["rec"].shape[0] for sh in shapes)
    return out


def pair_tables(dev, k5_libs, k6_libs, ph) -> dict:
    """``previous`` and ``shipped`` of K5 (phase 1) and K6's ``gather+
    previous`` and ``shipped`` (slot 10) by the earlier method: an event
    pair around each launch (``chip_smoke.device_ms``), the carry restored
    between launches."""
    amat = ph["amat"]
    p = ph["phase1"]
    carry = [p["cot"].clone(), p["dep"].clone()]
    reset = lambda: [x.copy_(y) for x, y in zip(carry, (p["cot"], p["dep"]))]
    dattr = torch.empty((p["rec"].shape[0], 9, p["rec"].shape[2]), device=dev)
    out = {"k5": {name: C.device_ms(lambda fn=k5_libs[name]: k5_launch(
        fn, *carry, p["rec"], p["gs"], dattr, p["i0"], SEED), 10,
        setup=reset) for name in ("previous", "shipped")}}
    q = _k6_slot(ph, 10)
    o6 = torch.empty((9, q["cot"].shape[1]), device=dev)
    out["k6"] = {
        "gather+previous": C.device_ms(lambda: k6_launch(
            k6_libs["previous"], *carry, q["slot"], q["idx"],
            fetch_attr_planes(q["idx"], amat), q["gs"], o6, SEED, q["it"]),
            50, setup=reset),
        "shipped": C.device_ms(lambda: k6_launch(
            k6_libs["shipped"], *carry, q["slot"], q["idx"], amat, q["gs"],
            o6, SEED, q["it"]), 50, setup=reset)}
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
                and k != "live_share" else xs[0][k] for k in xs[0]}
    return walk(passes)


#: (change, against) of each change alone, per kernel
K5_ALONE = (("shipped_nohint", "previous"),
            ("shipped_ahead1_nohint", "previous"),
            ("shipped_ahead2", "shipped_ahead1"), ("shipped", "shipped_ahead1"),
            ("shipped", "shipped_ahead2"),
            ("shipped_ahead1_bufs4", "shipped_ahead1"),
            ("shipped", "shipped_ahead1_bufs4"),
            ("previous_row", "previous"), ("previous_hint", "previous"),
            ("shipped_ahead1", "shipped_ahead1_nohint"),
            ("shipped", "shipped_nohint"), ("previous_t256", "previous"),
            ("previous_lb7", "previous"), ("shipped", "previous"),
            ("probe_memory", "previous"), ("probe_compute", "previous"))
K6_ALONE = (("shipped", "gather+previous"), ("shipped", "previous"),
            ("previous_hint", "previous"), ("shipped_hint", "shipped"),
            ("shipped_t256", "shipped"), ("shipped_lb8", "shipped"))


def changes_alone(tabs: dict) -> dict:
    """Each change's ``event_ms`` over what it replaces, per shape."""
    out = {}
    for kernel, pairs in (("k5", K5_ALONE), ("k6", K6_ALONE)):
        out[kernel] = [
            {"shape": shape, "change": c, "against": b,
             "ratio": t[c]["event_ms"] / t[b]["event_ms"]}
            for shape, t in tabs[kernel].items() for c, b in pairs]
    return out


def verdict(alone: dict, report: dict) -> dict:
    """Which change is kept: faster at every shape against what it
    replaces, in each pairing it was timed in, and built without a
    spill."""
    def kept(kernel, *pairs):
        spill = any(report[f"{kernel}/{c}"]["spill_store_bytes"]
                    for c, _ in pairs)
        return not spill and all(
            r["ratio"] < 1 for r in alone[kernel]
            if (r["change"], r["against"]) in pairs)
    return {"k5": {"stage": kept("k5", ("shipped_nohint", "previous")),
                   "three_ahead": kept("k5", ("shipped", "shipped_ahead1"),
                                       ("shipped", "shipped_ahead2")),
                   "row": kept("k5", ("previous_row", "previous")),
                   "hint": kept("k5", ("shipped", "shipped_nohint"),
                                ("shipped_ahead1", "shipped_ahead1_nohint")),
                   "t256": kept("k5", ("previous_t256", "previous")),
                   "lb7": kept("k5", ("previous_lb7", "previous"))},
            "k6": {"fetch_inside": kept("k6", ("shipped", "gather+previous"),
                                        ("shipped", "previous")),
                   "hint": kept("k6", ("previous_hint", "previous"),
                                ("shipped_hint", "shipped")),
                   "t256": kept("k6", ("shipped_t256", "shipped")),
                   "lb8": kept("k6", ("shipped_lb8", "shipped"))},
            "shipped": {"k5": "one thread per lane, the next three slots' "
                              "words staged by cp.async into shared "
                              "memory, evict-first flags, streaming rows",
                        "k6": "one thread per lane, the winner's row by "
                              "index through the read-only path"},
            "rule": "a change is kept where it is faster (event_ms) at "
                    "every shape timed against what it replaces, and "
                    "builds without a spill"}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = C.card_line()
    print(card, flush=True)
    build.load()
    ph = phases(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    k5_libs, k6_libs, report = build_variants(
        tempfile.mkdtemp(dir=os.path.join(ROOT, "build")))
    C.emit({"phase": "ptxas", **report})
    bad = check_variants(dev, k5_libs, k6_libs, ph)
    C.emit({"phase": "variants_vs_previous", "cases": len(bad),
            "lanes_differing": sum(bad.values()),
            "shapes": {k: list(v["rec"].shape) for k, v in ph.items()
                       if k != "amat"},
            "tolerance": "cot, dep and dattr bit for bit against the "
                         "previous kernel"})
    passes = [variant_tables(dev, k5_libs, k6_libs, ph, reverse=bool(r % 2))
              for r in range(5)]
    tabs = _median_tables(passes)
    walks = [lean_walk_ms(dev, k6_libs, ph) for _ in range(3)]
    walk = {k: ({"event_ms": statistics.median(x[k]["event_ms"]
                                               for x in walks)}
                if isinstance(walks[0][k], dict) else walks[0][k])
            for k in walks[0]}
    C.emit({"phase": "variant_times", "card": card, "passes": 5, **tabs,
            "lean_walk_both_phases": walk,
            "device_ms_pair_per_launch": pair_tables(dev, k5_libs, k6_libs,
                                                     ph),
            "note": "medians of 5 passes (every other one in reverse "
                    "order); event_ms: one event pair around the launches, "
                    "each on its own copy of the carry; profiler_ms: the "
                    "profiler's per-launch mean (gather+previous: gather, "
                    "cast and kernel); lean_walk_both_phases: event_ms of "
                    "one whole lean replay (median of 3); "
                    "device_ms_pair_per_launch: an event pair around each "
                    "launch"})
    alone = changes_alone(tabs)
    C.emit({"phase": "changes_alone", **alone})
    C.emit({"phase": "verdict", **verdict(alone, report)})
    print(C.card_line(), flush=True)
    C.emit({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
