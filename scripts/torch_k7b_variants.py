"""K7b (``replay_bwd_step_kernel``) beside the designs it was chosen over,
on the card: what each change of its redesign does alone, and why the
shipped kernel is what it is.

The shipped source (``csrc/replay_bwd.cu``) is built as it stands
(``shipped``: every load of a lane issued at once, its alive flag with
them, as volatile loads; a dead lane then writing its zero rows and
stopping; 64-thread blocks) and rewritten into variants, each built by its
own ``nvcc -Xptxas -v`` (all at once), with the launcher's C signature
unchanged:

- ``previous``: the kernel before the redesign, kept in the shipped
  library (``replay_bwd_step_previous_kernel``: the carry and radiance
  cotangent loaded with the flag, the record after it, 128-thread blocks);
- ``flag_first``: the flag read first, a dead lane stopping at once, a
  live lane's loads issued together behind it (two round trips; the
  redesign's first form); ``flag_first_t128``: the same at 128-thread
  blocks (the flag-first change alone);
- ``shipped_t32``, ``shipped_t128``, ``shipped_t256``: other block sizes;
- ``compact``: K12's and K9's compaction behind the flag, a block's live
  lanes packed into its first warps before they load anything;
- ``pair``: K7c's lane pair (G = 2) behind the flag: the pair's second
  thread loads the record, draws and runs the adjoint's forward half into
  shared memory while the first loads the carry, then the first
  transposes.

Every build (and the previous kernel) carries an empty kernel for the
launch floor. It prints each build's registers and spills. It holds every
build bit for bit against the previous kernel: cot after every bounce and
every dattr row, over the whole reverse walk of the inverse demo's first
pass (``scene_4_spheres``' start scene, 200x112, 22 400 lanes, 16 bounces,
the record by K3 + K7a), with injected and with Philox draws. It times
every build by one CUDA event pair around N back-to-back launches (each
on its own carry): one launch at bounces 0, 4, 8 and 15 of
that walk, and the 256 launches of two unfused-replay fit steps (the walks
of the step's 8 passes, twice); and the empty kernel over 256 launches.
Five passes, every other one in reverse order; each time is the median of
the five. The last lines give each change alone against what it replaces,
and the verdict: a change is kept where it is at least 1% faster per two
steps. One JSON object per line; a failed check raises.

    python3 scripts/torch_k7b_variants.py    # one CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import itertools
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
from raytracingweekend_jl_tpu_torch.camera import sample_pass_rays  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops import fused_grad as FG  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import build  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import (  # noqa: E402
    grad_kernel as GK, intersect_kernel as K1)
from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat  # noqa: E402

W, H, SPP, DEPTH = 200, 112, 8, 16

# -- source rewrites ---------------------------------------------------------

THREADS = "#define RTW_K7B_THREADS 64\n"
KERNEL = re.compile(r"template <bool INJ>\n__global__ void __launch_bounds__"
                    r"\(RTW_K7B_THREADS\)\n    replay_bwd_step_kernel\(.*?"
                    r"\n}\n", re.S)
BLOCKS = ("  const int blocks = (n_lanes + RTW_K7B_THREADS - 1) / "
          "RTW_K7B_THREADS;\n")
BLOCKS_PAIR = ("  const int blocks = (2 * n_lanes + RTW_K7B_THREADS - 1) / "
               "RTW_K7B_THREADS;\n")

SIGNATURE = """template <bool INJ>
__global__ void __launch_bounds__(RTW_K7B_THREADS)
    replay_bwd_step_kernel(const float* __restrict__ rec,
                           const float* __restrict__ g3,
                           float* __restrict__ cot_io,
                           float* __restrict__ dattr,
                           const float* __restrict__ u5, int n_lanes,
                           uint32_t seed, uint32_t bounce) {
"""

#: The live lane's loads, draws, adjoint and stores (lane i, size_t n).
LIVE = """  float r[10], a[10], cot[9], g[3], u[5], d9[9];
#pragma unroll
  for (int j = 0; j < 10; ++j) r[j] = rec[j * n + i];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = rec[(11 + j) * n + i];
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = g3[j * n + i];
  if (INJ) {
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = u5[j * n + i];
  } else {
    rtw_uniforms<5>(seed, bounce, (uint32_t)i, u);
  }
  rtw_fixed_replay(u, r, a, g, cot, d9);
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    cot_io[j * n + i] = cot[j];
    dattr[j * n + i] = d9[j];
  }
}
"""

#: The flag first: a dead lane stops, a live lane's loads go out behind it.
FLAG_FIRST = SIGNATURE + """  const int i = blockIdx.x * RTW_K7B_THREADS + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  if (__float_as_int(rec[10 * n + i]) == 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) dattr[j * n + i] = 0.0f;
    return;
  }
""" + LIVE

COMPACT = SIGNATURE + """  constexpr int NW = RTW_K7B_THREADS / 32;
  __shared__ int ids[RTW_K7B_THREADS];
  __shared__ int base[NW + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t n = n_lanes;
  const int i0 = blockIdx.x * RTW_K7B_THREADS + threadIdx.x;
  const bool in = i0 < n_lanes;
  const bool live = in && __float_as_int(rec[10 * n + i0]) != 0;
  if (in && !live) {
#pragma unroll
    for (int j = 0; j < 9; ++j) dattr[j * n + i0] = 0.0f;
  }
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (lane == 0) base[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {
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
  const int n_live = base[NW];
  if (live) ids[base[warp] + __popc(m & ((1u << lane) - 1u))] = i0;
  __syncthreads();
  if (threadIdx.x >= n_live) return;
  const int i = ids[threadIdx.x];
""" + LIVE

PAIR = SIGNATURE + """  __shared__ RtwK7cStage stage[RTW_K7B_THREADS / 2];
  const int l = threadIdx.x >> 1, k = threadIdx.x & 1;
  const int i = blockIdx.x * (RTW_K7B_THREADS / 2) + l;
  const size_t n = n_lanes;
  const bool live = i < n_lanes && __float_as_int(rec[10 * n + i]) != 0;
  float cot[9], g[3];
  if (i < n_lanes && !live && k == 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) dattr[j * n + i] = 0.0f;
  }
  if (live && k == 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];
#pragma unroll
    for (int j = 0; j < 3; ++j) g[j] = g3[j * n + i];
  }
  if (live && k == 1) {
    float r[10], a[10], u[5];
#pragma unroll
    for (int j = 0; j < 10; ++j) r[j] = rec[j * n + i];
#pragma unroll
    for (int j = 0; j < 10; ++j) a[j] = rec[(11 + j) * n + i];
    if (INJ) {
#pragma unroll
      for (int j = 0; j < 5; ++j) u[j] = u5[j * n + i];
    } else {
      rtw_uniforms<5>(seed, bounce, (uint32_t)i, u);
    }
    RtwK7cStage& st = stage[l];
    const bool hit = r[9] < RTW_BIG;
    st.f = rtw_adjoint_forward(u, r, a, hit);
#pragma unroll
    for (int j = 0; j < 6; ++j) st.r[j] = r[3 + j];
#pragma unroll
    for (int j = 0; j < 7; ++j) st.a[j] = a[j];
    st.hit = hit;
  }
  __syncwarp();
  if (live && k == 0) {
    float d9[9];
    rtw_fixed_transpose(stage[l], g, cot, d9);
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      cot_io[j * n + i] = cot[j];
      dattr[j * n + i] = d9[j];
    }
  }
}
"""

#: An empty kernel and its launcher, appended to every build: the launch
#: floor.
EMPTY = """
__global__ void rtw_empty_kernel() {}

extern "C" int rtw_empty_launch(int blocks, void* stream) {
  rtw_empty_kernel<<<blocks, 64, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""

BUILDS = ("shipped", "flag_first", "flag_first_t128", "shipped_t32",
          "shipped_t128", "shipped_t256", "compact", "pair")


def k7b_source(src: str, name: str) -> str:
    """replay_bwd.cu of K7b's variant ``name``."""
    if name == "shipped":
        return src
    if "_t" in name:
        base, threads = name.rsplit("_t", 1)
        return _sub(k7b_source(src, base), THREADS,
                    f"#define RTW_K7B_THREADS {int(threads)}\n")
    if name == "flag_first":
        return _sub(src, KERNEL, FLAG_FIRST)
    if name == "compact":
        return _sub(src, KERNEL, COMPACT)
    if name == "pair":
        return _sub(_sub(src, KERNEL, PAIR), BLOCKS, BLOCKS_PAIR)
    raise ValueError(name)


def _sub(src: str, old, new: str) -> str:
    """``src`` with the one occurrence of ``old`` (a string or a compiled
    pattern) replaced by ``new``; raises unless there is exactly one (edit
    the patterns with the kernel)."""
    if isinstance(old, re.Pattern):
        n = len(old.findall(src))
        out = old.sub(lambda m: new, src)
    else:
        n = src.count(old)
        out = src.replace(old, new)
    if n != 1:
        raise RuntimeError(f"rewrite target found {n} times: {old!r:.80}")
    return out


PTXAS = re.compile(r"Function properties for (\w+)\s+(\d+) bytes stack "
                   r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                   r"loads\s+ptxas info\s*: Used (\d+) registers")
_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                                ctypes.c_void_p]


def build_variants(out: str, builds=BUILDS) -> tuple:
    """``({name: launcher}, {name: ptxas report of K7b}, empty-kernel
    launcher)``: the builds named compiled into ``out``, one nvcc each, all
    at once; ``previous`` is the shipped library's kept kernel."""
    with open(os.path.join(build.CSRC_DIR, "replay_bwd.cu")) as fh:
        src = fh.read()
    procs = {}
    for name in builds:
        d = os.path.join(out, name)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "replay_bwd.cu")
        with open(path, "w") as f:
            f.write(k7b_source(src, name) + EMPTY)
        procs[name] = subprocess.Popen(
            [build._nvcc(), "-Xptxas", "-v", *build.NVCC_FLAGS, "-I", d,
             "-I", build.CSRC_DIR, "-shared", "-o",
             os.path.join(d, "lib.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, report, empty = {}, {}, None
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        regs = {m.group(1): {"registers": int(m.group(5)),
                             "spill_store_bytes": int(m.group(3)),
                             "spill_load_bytes": int(m.group(4))}
                for m in PTXAS.finditer(log)
                if "replay_bwd_step" in m.group(1)}
        if not regs:
            raise RuntimeError(f"no ptxas report for {name}:\n{log}")
        report[name] = regs
        lib = ctypes.CDLL(os.path.join(out, name, "lib.so"))
        fn = lib.rtw_replay_bwd_step
        fn.argtypes, fn.restype = _SIG, ctypes.c_int
        libs[name] = fn
        if empty is None:
            empty = lib.rtw_empty_launch
            empty.argtypes = [ctypes.c_int, ctypes.c_void_p]
            empty.restype = ctypes.c_int
    libs["previous"] = build.load().rtw_replay_bwd_step_previous
    return libs, report, empty


# -- launches and inputs -------------------------------------------------------

def launch(fn, slot, g3, cot, out, seed: int, bounce: int, u5=None) -> None:
    """One launch of a K7b build on record slot ``slot`` [21, R]."""
    err = fn(slot.data_ptr(), g3.data_ptr(), cot.data_ptr(), out.data_ptr(),
             None if u5 is None else u5.data_ptr(), slot.shape[1], seed,
             bounce, torch.cuda.current_stream().cuda_stream)
    build.check(err, "K7b variant")


def walk(fn, rec, g3, cot, dattr, seed: int, u5=None) -> None:
    """The reverse walk of ``rec`` [16, 21, R] by a K7b build: one launch
    per bounce, newest first, the carry in ``cot``."""
    for b in reversed(range(rec.shape[0])):
        launch(fn, rec[b], g3, cot, dattr[b], seed, b,
               None if u5 is None else u5[b])


def demo_records(dev, passes: int = SPP) -> list:
    """``[(rec [16, 21, R], seed)]`` of the inverse demo's start scene, one
    per sample pass of a fit step (200x112, 22 400 lanes; K3 + K7a with
    Philox draws, each pass's seed as the pass loop keys it)."""
    _, scene0, cam, _, _ = C.inverse_demo()
    scene0, cam = pt.trim_scene(scene0.to(dev)), cam.to(dev)
    spheres, amat = K1.sphere_consts(scene0), attr_mat(scene0)
    u, v = pt.pixel_coords(W, H, device=dev)
    out = []
    for s0 in range(passes):
        seed = rng.purpose_seed(0, rng.SCATTER_DIR, s0) & 0xFFFFFFFF
        o, d = sample_pass_rays(cam, u, v, 0, s0, 1, float(W), float(H))
        st = FG.start_state(o, d)
        rec = torch.empty((DEPTH, GK.N_REC, W * H), device=dev)
        for b in range(DEPTH):
            t, idx = K1.sweep_masked(st[0:6], st[12].view(torch.int32),
                                     spheres)
            GK.record_shade_step(t, idx, amat, st, rec[b], seed, b)
        out.append((rec, seed))
    return out


def check(libs, rec, seed: int) -> dict:
    """Every build's walk against the previous kernel's: cot after every
    bounce and every dattr row bit for bit (rows start as NaN, so a row no
    one writes shows), injected and Philox draws; lanes differing by case
    (all 0, or it raises)."""
    K, _, R = rec.shape
    dev = rec.device
    g = torch.Generator(device=dev).manual_seed(5)
    g3 = torch.rand((3, R), generator=g, device=dev) * 2 - 1
    bad = {}
    for draws, u5 in (("injected", torch.rand((K, 5, R), generator=g,
                                              device=dev)),
                      ("philox", None)):
        outs = {}
        for name, fn in libs.items():
            cot = torch.zeros((9, R), device=dev)
            dattr = torch.full((K, 9, R), float("nan"), device=dev)
            cots = []
            for b in reversed(range(K)):
                launch(fn, rec[b], g3, cot, dattr[b], seed, b,
                       None if u5 is None else u5[b])
                cots.append(cot.clone())
            torch.cuda.synchronize()
            outs[name] = (torch.stack(cots), dattr)
        ref = outs["previous"]
        for name, got in outs.items():
            bad[f"{draws}/{name}"] = int(C._bitwise_lanes(
                [(got[0], ref[0]), (got[1], ref[1])], R).sum())
    C.check(all(v == 0 for v in bad.values()),
            f"a K7b build differs from the previous kernel: "
            f"{ {k: v for k, v in bad.items() if v} }")
    return bad


# -- times ---------------------------------------------------------------------

BOUNCES = (0, 4, 8, 15)


def event_ms(fn, make_args, n: int, sleep_cycles: int = 50_000_000) -> float:
    """Device milliseconds per call of ``fn(*args)`` over ``n`` calls, each
    on its own arguments from ``make_args()`` (prepared before the run):
    one CUDA event pair around the whole run, behind a spin kernel that
    keeps the card busy while the host enqueues, so the launches run back
    to back (``chip_smoke.batch_ms``'s first method)."""
    fn(*make_args())  # warm-up
    args = [make_args() for _ in range(n)]
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for x in args:
        fn(*x)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def times(libs, records, empty, reverse: bool, n: int = 50) -> dict:
    """Every build by :func:`event_ms`: one launch at each of
    :data:`BOUNCES` of the first pass's walk (each launch on its own zeroed
    carry; the bounce's slot as the walk meets it, Philox draws), and the
    walks of the 8 passes twice (256 launches, two unfused steps: ms per
    walk, and ``per_two_steps_ms`` their sum); the empty kernel over 256
    launches."""
    rec0, seed0 = records[0]
    R = rec0.shape[2]
    dev = rec0.device
    g3 = torch.rand((3, R), generator=torch.Generator(device=dev)
                    .manual_seed(9), device=dev) * 2 - 1
    names = list(libs)[::-1] if reverse else list(libs)
    out = {f"bounce{b}": {} for b in BOUNCES}
    out["two_steps"] = {}
    make = lambda: (torch.zeros((9, R), device=dev),
                    torch.empty((9, R), device=dev))
    for name in names:
        fn = libs[name]
        for b in BOUNCES:
            out[f"bounce{b}"][name] = {"event_ms": event_ms(
                lambda c, o, fn=fn, b=b: launch(fn, rec0[b], g3, c, o,
                                                seed0, b), make, n)}
        walks = itertools.cycle(records)

        def make_walk():
            rec, seed = next(walks)
            return (rec, torch.zeros((9, R), device=dev),
                    torch.empty((DEPTH, 9, R), device=dev), seed)
        ms = event_ms(lambda r, c, d, s, fn=fn: walk(fn, r, g3, c, d, s),
                      make_walk, 2 * len(records))
        out["two_steps"][name] = {"event_ms": ms,
                                  "per_two_steps_ms": ms * 2 * len(records)}
    stream = torch.cuda.current_stream().cuda_stream
    out["empty_kernel"] = {"event_ms": event_ms(
        lambda: build.check(empty(1, stream), "empty kernel"), lambda: (),
        256)}
    return out


def _median(passes: list) -> dict:
    def med(xs):
        if isinstance(xs[0], dict) and "event_ms" in xs[0]:
            return {k: statistics.median(x[k] for x in xs) for k in xs[0]}
        return {k: med([x[k] for x in xs]) for k in xs[0]}
    return med(passes)


#: (change, against): each change of the redesign alone.
ALONE = (("shipped", "previous"), ("shipped_t128", "previous"),
         ("shipped", "shipped_t128"), ("shipped", "flag_first"),
         ("flag_first_t128", "previous"), ("shipped_t32", "shipped"),
         ("shipped_t256", "shipped"), ("compact", "flag_first"),
         ("pair", "flag_first"))

#: A change is kept where it takes at most this share of what it replaces
#: per two steps.
KEEP_RATIO = 0.99


def changes_alone(tab: dict) -> list:
    """Each change's ``event_ms`` over what it replaces, at every bounce
    and per two steps."""
    rows = []
    for c, b in ALONE:
        rows.append({"change": c, "against": b, **{
            shape: tab[shape][c]["event_ms"] / tab[shape][b]["event_ms"]
            for shape in tab if shape != "empty_kernel"}})
    return rows


def verdict(alone: list) -> dict:
    out = {f"{r['change']} over {r['against']}": bool(
        r["two_steps"] <= KEEP_RATIO) for r in alone}
    out["rule"] = ("a change is kept where it is at least 1% faster per two "
                   "unfused steps (event_ms, the 256 launches of the "
                   "route) against what it replaces; the ratios at each "
                   "bounce are reported beside it")
    return out


def run(dev, passes: int) -> dict:
    """Build, check and time every build (``passes`` timing passes). The
    phases' JSON objects as a dict."""
    records = demo_records(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    libs, report, empty = build_variants(
        tempfile.mkdtemp(dir=os.path.join(ROOT, "build")))
    bad = check(libs, *records[0])
    rec0 = records[0][0]
    live = (rec0[:, 10].view(torch.int32) != 0).sum(1).tolist()
    tab = _median([times(libs, records, empty, bool(r % 2))
                   for r in range(passes)])
    alone = changes_alone(tab)
    return {"ptxas": report,
            "occupancy": GK.replay_bwd_step_occupancy(dev),
            "checks": {"cases": len(bad), "lanes_differing": sum(bad.values()),
                       "lanes": rec0.shape[2], "live_lanes_by_bounce": live,
                       "tolerance": "cot after every bounce and every dattr "
                                    "row of the 16-bounce walk bit for bit "
                                    "the previous K7b's, injected and "
                                    "Philox"},
            "times": tab, "changes_alone": alone, "verdict": verdict(alone)}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = C.card_line()
    print(card, flush=True)
    build.load()
    out = run(dev, 5)
    C.emit({"phase": "ptxas", **out["ptxas"], "occupancy": out["occupancy"]})
    C.emit({"phase": "variants_checks", **out["checks"]})
    C.emit({"phase": "variant_times", "card": card, "passes": 5,
            **out["times"],
            "note": "medians of 5 passes (every other one in reverse "
                    "order); event_ms: one event pair around n back-to-back "
                    "launches (per launch at a bounce, per walk of 16 "
                    "launches for two_steps, per launch of the empty "
                    "kernel)"})
    C.emit({"phase": "changes_alone", "rows": out["changes_alone"]})
    C.emit({"phase": "verdict", **out["verdict"]})
    print(C.card_line(), flush=True)
    C.emit({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
