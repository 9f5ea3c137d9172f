"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``raytracingweekend_jl_tpu_torch/csrc``,
checks each against its plain PyTorch version on the card, and drives the
port's main paths through their public entry points on the card: the
flagship forward render (``render(..., persistent=True)``), the flagship
gradient step (``render_grads``), the inverse-rendering fit at the
configuration of the JAX package's inverse demo (``fit_scene``, with its
small-image gradient step and forward render), then the default ``render``
through the fixed-depth wavefront, a non-contiguous tile through the
pixel-pinned route, the remat gradient step and the twin-AD canary, and
last the flagship gradient step through the fused record step
(``trace_recorded_persist(fused_step=True)``), the flagship render through
the megakernel (``persistent_render_sum_mega``) and the cluster sweep
(``intersect_spheres_grid``) on the flagship's rays in five lane orders.
K1 and K3 split each ray's sweep over a group of threads and are held bit
for bit against the kept one-thread kernel (the previous K10,
``sweep_fetch_one_thread``) at every split (``k1_vs_plain``,
``k3_vs_plain``, ``sweep_redesign``), and ``sweep_redesign`` times them at
the main paths' widths. K2 and K4 fetch the sweep winner's attributes
themselves: they are held bit for bit
against their plain versions (the gather, then the attribute-level step;
``k2_vs_plain``, ``k2_loop_vs_plain`` over the render's first 32
iterations, ``k4_vs_plain`` at the step's iterations 20 and 40), the
launch counters show no gather in either loop, ``shade_variants`` builds,
checks and times the designs they were chosen over
(``scripts/torch_k2_k4_variants.py``), and ``shade_redesign`` times K1, K2
and K4 by one event pair around many launches, by an event pair around
each and by the profiler, with the flagship render and step profiled. K6
fetches the winner's row itself and K5 stages the next three slots'
record words while it replays one: both are held against their plain
versions (``k5_vs_plain``, ``k6_vs_plain``, with injected and Philox
draws; K6's walk bit for bit K5's), the lean flagship step launches no
gather, and ``replay_redesign`` builds, checks bit for bit and times the
designs they were chosen over (``scripts/torch_k5_k6_variants.py``), then
times K5 and K6 by both methods and profiles the default and lean
flagship steps. K7a fetches the winner's row itself and K8 runs a lane
work queue over at most 16 resident warps per SM: both are held bit for
bit against their plain versions (``k7a_vs_plain`` at every bounce of the
demo's first pass, ``k8_vs_plain`` on the demo and a 64-sphere table), the
fit and the small-image step launch no gather, and ``fit_redesign`` builds,
checks bit for bit and times the designs they were chosen over
(``scripts/torch_k7a_k8_variants.py``), then times K7a, K7b, K7c and K8 by
both methods and profiles one fit step. K10 sweeps with K1's split loop
and reads the winner's row by index, and K12 sweeps and shades only its
active lanes: ``k10_k12_redesign`` holds K10 bit for bit against the
one-thread kernel on four ray sets at every split, K12 against K1, the
gather and K9 at four iterations of the flagship film, and times the
previous and the shipped designs in turns and per render
(``scripts/torch_k10_k12_variants.py``, which alone also builds and
times the designs they were chosen over). ``remat_passes_step`` takes
the flagship step at spp 4 with a 2 GiB record budget, which recomputes
each pass in the backward, bit for bit the same chunks with every record
kept, beside their peak memory. K7c stages a lane's next live slots'
forward halves on two threads (the one-thread walk where the lanes fill
the card) and K11 sweeps each block's packed live lanes with the split
loop: ``k7c_k11_variants`` and ``k7c_k11_redesign`` hold them bit for bit
against K7b's walk, K3 + K4 and their plain versions, time them beside
the previous kernels (``scripts/torch_k7c_k11_variants.py``) and rerun
the fit with the previous K7c, its losses bit for bit. K9 fetches the
winner's row itself and touches only the active lanes, so the pinned
route launches K1 and K9 and no gather, and K13 takes every pair's roots
behind ``disc > 0``: ``k9_k13_redesign`` holds
them bit for bit against the kept previous kernels (K9 against K1, the
gather and the previous K9 at four iterations of the flagship film and at
every iteration of the even-row tile, whose image is bitwise the
three-launch route's; K13 on the eight cases of ``grid_sweep``), times
them beside those kernels, and ``k9_k13_variants`` runs one pass of
``scripts/torch_k9_k13_variants.py``. K7b issues every load of a lane at
once, its alive flag with them: ``k7b_variants`` runs one pass of
``scripts/torch_k7b_variants.py`` (every design bit for bit the previous
K7b over the demo's 16-bounce walk, timed per launch at four bounces and
per two unfused steps beside the empty-kernel launch floor) and
``k7b_redesign`` holds K7b bit for bit the kept previous kernel through
the wrappers and two unfused fit steps' losses with either. The edge
(silhouette) estimator and ``fit_scene_scan``: ``edge_primal`` (the
primal bit for bit the keyed trace on the card), ``edge_flagship_fit``
(two steps of the JAX package's flagship joint fit, 960x540, spp 8, with
their seconds and peak memory), ``edge_fd`` (a center's edge gradient
against finite differences) and ``fit_scan`` (``fit_scene_scan`` beside
``fit_scene`` on both geoms, with host syncs per step). Last, ``cli``:
the command line (``raytracingweekend_jl_tpu_torch.cli``) in a
temporary directory at the flagship film, spp 8 in two chunks of 4 against
4 samples checkpointed and resumed to 8 (the sums bit for bit; K1 and K2
launched; the written PNG read back), beside a run of the module in a
subprocess, ``--stats``, the reference scene, float64 on the fixed-depth
route, the refused ``--mesh-tiles 2`` and ``scripts/torch_inverse_render.py``.
It times the kernels, the renders,
the steps and the fit against the plain path. Each phase prints one JSON
line; a failed check raises and the script exits non-zero without printing
a result. The line before the card line lists every kernel with its
launches on its main path, its error against its plain version, its time,
the plain version's time and its bound (the least time the card could take
for the same work).
The last line is ``{"ok": true, "device": {...}}``. It needs a CUDA device
and exits non-zero without one. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Prints ``obj`` as one JSON line; a phase's line gets the seconds
    since the script started (``elapsed_s``)."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - _T0}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


#: Published peaks of one NVIDIA H100 SXM (data sheet, at its 700 W limit):
#: device-memory bytes per second, float32 operations per second outside
#: the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

#: Float operations counted per unit of work, from the kernels' code (the
#: Philox integer arithmetic and the compares and selects are not counted,
#: so each bound is a lower bound):
SWEEP_RAY_OPS = 10       # o.d and o.o, once per ray
SWEEP_SPHERE_OPS = 20    # the half-b quadratic and its roots, per sphere
SHADE_OPS = 150          # shade core: sky, normal, Box-Muller, 3 materials
ADVANCE_OPS = 3          # T *= albedo on a hit
ADJOINT_OPS = 400        # bounce adjoint: forward recomputed, then reversed


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time the card could take to move ``n_bytes`` (each input
    read once, each output written once) and do ``n_ops`` float32
    operations: the larger of the two times at the published peaks, and
    which one it is."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_F32_OPS_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes": n_bytes, "bound_ops": n_ops}


def _counted_modules() -> tuple:
    from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
    from raytracingweekend_jl_tpu_torch.ops.cuda import grid_kernel as K13
    from raytracingweekend_jl_tpu_torch.ops.cuda import inline_kernel as K8
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.cuda import mega_kernel as K12
    from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
    from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
    return K1, K2, PK, GK, K8, K12, K13


def reset_counts() -> None:
    """Sets every kernel wrapper's launch count to 0, and the count of
    winner-attribute gathers."""
    from raytracingweekend_jl_tpu_torch.ops import materials
    materials.fetch_calls = 0
    K1, K2, PK, GK, K8, K12, K13 = _counted_modules()
    K1.launches = K2.launches = K1.masked_launches = 0
    K1.fetch_launches = K2.pinned_launches = 0
    PK.record_launches = PK.replay_fused_launches = 0
    PK.replay_step_launches = PK.record_fused_launches = 0
    GK.record_launches = GK.replay_step_launches = 0
    GK.replay_fused_launches = K8.launches = 0
    K12.launches = K13.launches = 0


def counts() -> dict:
    """Every kernel's launch count, by its name in the ``kernels`` line, and
    the winner-attribute gathers (``gather``: each a cast and a gather
    launch on the card)."""
    from raytracingweekend_jl_tpu_torch.ops import materials
    K1, K2, PK, GK, K8, K12, K13 = _counted_modules()
    return {"gather": materials.fetch_calls,
            "sweep": K1.launches, "shade_strided": K2.launches,
            "sweep_masked": K1.masked_launches,
            "persist_record": PK.record_launches,
            "persist_replay_fused": PK.replay_fused_launches,
            "persist_replay_step": PK.replay_step_launches,
            "record_shade": GK.record_launches,
            "replay_bwd_step": GK.replay_step_launches,
            "replay_bwd_fused": GK.replay_fused_launches,
            "inline": K8.launches, "sweep_fetch": K1.fetch_launches,
            "shade_pinned": K2.pinned_launches,
            "persist_record_fused": PK.record_fused_launches,
            "mega": K12.launches, "grid_sweep": K13.launches}


def call_ms(fn, n: int, setup=None) -> float:
    """Mean milliseconds per call of ``fn()`` as a caller sees it: CUDA
    events around each call, synchronised after each, so the host's enqueue
    time counts (``setup()`` runs untimed before each call)."""
    import torch
    total = 0.0
    for _ in range(n):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / n


def device_ms(fn, n: int, setup=None, sleep_cycles: int = 100_000_000) -> float:
    """Mean device milliseconds per call of ``fn()``: a spin kernel keeps the
    card busy while the host enqueues all ``n`` calls between CUDA events,
    so no host time falls between an event pair."""
    import torch
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    pairs = []
    for _ in range(n):
        if setup is not None:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / n


def batch_ms(fn, make_args, n: int, kernel: str,
             sleep_cycles: int = 200_000_000) -> dict:
    """Device milliseconds per call of ``fn(*args)`` over ``n`` calls, each
    on its own arguments from ``make_args()`` (a fresh copy of the state,
    prepared before the run), by two methods: one CUDA event pair around
    the whole run, behind a spin kernel that keeps the card busy while the
    host enqueues (``event_ms``), and the profiler's mean device time per
    launch of each kernel whose name matches the regular expression
    ``kernel``, summed over those kernels (``profiler_ms``: e.g. a gather,
    a cast and a shade step per call), from a second run under
    torch.profiler without the spin kernel. After earlier profiler
    sessions in the same process the profiler may keep only some of these
    launches' records, or none (``profiler_launches`` counts those it
    kept; ``profiler_ms`` is then the mean of those, or None)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run(args, spin):
        torch.cuda.synchronize()
        if spin:
            torch.cuda._sleep(sleep_cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for x in args:
            fn(*x)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / n

    fn(*make_args())  # warm-up
    event = run([make_args() for _ in range(n)], True)
    args = [make_args() for _ in range(n)]  # copies outside the profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(args, False)
    pat = re.compile(kernel)
    rows = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and pat.search(e.key) and e.count]
    return {"event_ms": event,
            "profiler_ms": (sum(us / c for us, c in rows) / 1e3 if rows
                            else None),
            "profiler_launches": sum(c for _, c in rows)}


def profile_call(fn, sums: dict | None = None) -> dict:
    """Device time by kernel and the device's busy share over one call of
    ``fn()``, from torch.profiler (CUPTI). ``sums`` maps a label to a
    regular expression: the device time and count of every kernel whose
    name it matches are summed under that label."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Only events that ran on the card (kernels, copies): the host-side
    # aten:: rows repeat their kernels' device time.
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_s = sum(r[1] for r in rows) / 1e6
    # Host side: operators by their own CPU time (a synchronising operator
    # counts the time it waits for the card).
    host = sorted(((e.key, e.self_cpu_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.self_cpu_time_total > 0), key=lambda r: -r[1])
    by_match = {label: {"device_ms": sum(r[1] for r in rows
                                         if re.search(pat, r[0])) / 1e3,
                        "count": sum(r[2] for r in rows
                                     if re.search(pat, r[0]))}
                for label, pat in (sums or {}).items()}
    launch = [(e.count, e.self_cpu_time_total) for e in prof.key_averages()
              if e.key == "cudaLaunchKernel"]
    return {"wall_s_profiled": wall, "device_busy_s": busy_s,
            "device_idle_share": (1 - busy_s / wall) if rows else None,
            "device_events": sum(r[2] for r in rows),
            "cuda_launch_kernel": {"count": sum(c for c, _ in launch),
                                   "self_cpu_ms": sum(
                                       us for _, us in launch) / 1e3},
            **({"device_ms_by_match": by_match} if sums else {}),
            "top_kernels": [{"name": k[:80], "device_ms": us / 1e3,
                             "count": c} for k, us, c in rows[:12]],
            "top_host_ops": [{"name": k[:60], "self_cpu_ms": us / 1e3,
                              "count": c} for k, us, c in host[:12]]}


def lanes_outside(close_pairs, rel: float, exact_pairs=()) -> tuple:
    """``(lanes, max_abs_err)``: the number of lanes (last axis) on which a
    float pair differs by more than ``rel * max(1, |plain|)`` or an exact
    pair differs at all, and the largest float difference. Each pair is
    ``(kernel, plain)``."""
    ok, err = None, 0.0
    for a, b in close_pairs:
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        diff = (a - b).abs()
        o = (diff <= rel * b.abs().clamp(min=1)).all(0)
        ok = o if ok is None else ok & o
        err = max(err, diff.max().item())
    for a, b in exact_pairs:
        ok &= (a.reshape(-1, a.shape[-1]) == b.reshape(-1, b.shape[-1])).all(0)
    return int((~ok).sum().item()), err


#: K1's and K3's P in the bitwise checks: the one the wrapper picks
#: (``None``: K1's rule, K3's per-block choice), then each forced P.
SPLIT_PARTS = (None, 1, 2, 4, 8, 16, 32)


def split_vs_one_thread(rays, spheres, amat, alive=None) -> dict:
    """The lanes on which K1 (with ``alive``: K3, dead lanes held to
    ``(BIG, 0)``) differs in any bit of t or idx from the kept one-thread
    kernel (``sweep_fetch_one_thread``, the previous K10), for each P of
    :data:`SPLIT_PARTS` (``"auto"`` for the wrapper's pick): the split
    schedule against the one-thread loop in one call."""
    import torch
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    n = rays.shape[1]
    t10, i10, _ = K1.sweep_fetch_one_thread(rays, spheres, amat)
    runs = {}
    if alive is None:
        for P in SPLIT_PARTS:
            runs["auto" if P is None else str(P)] = K1.sweep(rays, spheres,
                                                             parts=P)
    else:
        live = alive != 0
        t10 = torch.where(live, t10, torch.full_like(t10, K1.BIG))
        i10 = torch.where(live, i10, torch.zeros_like(i10))
        for P in SPLIT_PARTS:
            runs["auto" if P is None else str(P)] = K1.sweep_masked(
                rays, alive, spheres, parts=P or 0)
    torch.cuda.synchronize()
    return {k: int(_bitwise_lanes([(t, t10), (i, i10)], n).sum())
            for k, (t, i) in runs.items()}


def grad_kernel_phases(dev, card, scene, cam, W: int, H: int) -> tuple:
    """K3-K6 against their plain versions at the flagship's gradient shapes
    (spp 1, 8 strips, 262 144 lanes, a recorded 44-slot phase), and their
    times. Returns their rows of the ``kernels`` line (launches unset),
    their ``device_ms`` and ``call_ms`` entries, and the record phase's
    state before iteration 20 (for K11's checks)."""
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch import rng
    from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
    from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat

    S, DEPTH, B1, SEED = 8, 16, 44, 0x5EED
    spheres, amat = K1.sphere_consts(scene), attr_mat(scene)
    g = torch.Generator(device=dev).manual_seed(7)
    u_px, v_px = pt.pixel_coords(W, H, device=dev)
    o, d = pt.get_rays(cam, u_px, v_px, generator=g)
    strips, sf, si, rad = PG.start_planes(o, d, S)
    lanes = sf.shape[1]
    check(lanes == 262144, f"flagship gradient lanes {lanes}")
    # Record one 44-slot phase through K3 + K4 (Philox draws).
    rec = torch.empty((B1, PK.N_REC, lanes), device=dev)
    rec_idx = torch.empty((B1, lanes), dtype=torch.int32, device=dev)
    for i in range(B1):
        if i == 20:  # a mid-phase state for the K3 and K4 checks
            sf20, si20, rad20 = sf.clone(), si.clone(), rad.clone()
        if i == 40:  # a late state, few lanes live (K3's and K4's checks)
            sf40, si40, rad40 = sf.clone(), si.clone(), rad.clone()
        t, idx = K1.sweep_masked(sf[0:6], si[2], spheres)
        rec_idx[i] = idx
        PK.persist_record_step(t, idx, amat, strips, sf, si, rad, rec[i],
                               SEED, i, DEPTH)
    torch.cuda.synchronize()

    # -- K3 against sweep_masked_ref ----------------------------------------
    live = si20[2] != 0
    t3, i3 = K1.sweep_masked(sf20[0:6], si20[2], spheres)
    torch.cuda.synchronize()
    t3r, i3r = K1.sweep_masked_ref(sf20[0:6], si20[2], spheres)
    idx_same = bool(torch.equal(i3, i3r))
    t_bit = (t3 == t3r)[live].float().mean().item()
    dead_ok = bool(((t3[~live] == K1.BIG) & (i3[~live] == 0)).all())
    k3_err = (t3 - t3r).abs().max().item()
    k3_states = {20: (sf20[0:6], si20[2]), 40: (sf40[0:6], si40[2])}
    vs_one = {it: split_vs_one_thread(r, spheres, amat, a)
              for it, (r, a) in k3_states.items()}
    emit({"phase": "k3_vs_plain", "lanes": lanes, "spheres": scene.n_spheres,
          "iteration": 20, "live_share": live.float().mean().item(),
          "idx_identical": idx_same, "t_bit_equal_share_live": t_bit,
          "dead_lanes_big_0": dead_ok, "t_max_abs_err": k3_err,
          "live_share_by_iteration": {
              it: (a != 0).float().mean().item()
              for it, (_, a) in k3_states.items()},
          "lanes_differing_from_one_thread_by_iteration_and_p": vs_one,
          "tolerance": "idx identical; t bit-equal on >= 99.99% of live "
                       "lanes; dead lanes exactly (BIG, 0); against the "
                       "one-thread kernel, at iterations 20 and 40 and "
                       "every P: 0 lanes differ in any bit"})
    check(idx_same, "K3 idx differs from sweep_masked_ref")
    check(t_bit >= 0.9999, f"K3 t bit-equal on only {t_bit} of live lanes")
    check(dead_ok, "K3 dead lanes are not (BIG, 0)")
    check(all(v == 0 for d in vs_one.values() for v in d.values()),
          f"K3 differs from the one-thread kernel: {vs_one}")

    # -- K4 against its plain version (the gather, then
    # persist_record_step_ref) at iterations 20 and 40, both record widths,
    # injected and Philox draws: every word bit for bit ----------------------
    k4_states = {20: (sf20, si20, rad20), 40: (sf40, si40, rad40)}
    k4_hits = {20: (t3, i3), 40: K1.sweep_masked(sf40[0:6], si40[2], spheres)}

    def k4_run(it, n_rec, u5, step):
        sf_, si_, rad_ = (x.clone() for x in k4_states[it])
        slot = torch.full((n_rec, lanes), 7.0, device=dev)
        t_, i_ = k4_hits[it]
        step(t_, i_, amat, strips, sf_, si_, rad_, slot, SEED, it, DEPTH, u5)
        torch.cuda.synchronize()
        return sf_, si_, rad_, slot

    u5 = torch.rand((5, lanes), generator=g, device=dev)
    k4_bad = {}
    for it in k4_states:
        for n_rec in (PK.N_REC, PK.N_REC_LEAN):
            for draws, u in (("injected", u5), ("philox", None)):
                ref = k4_run(it, n_rec, u, PK.persist_record_fetch_ref)
                got = k4_run(it, n_rec, u, PK.persist_record_step)
                k4_bad[f"it{it}/{n_rec}/{draws}"] = int(
                    _bitwise_lanes(list(zip(got, ref)), lanes).sum())
    emit({"phase": "k4_vs_plain", "lanes": lanes, "strips": S,
          "iterations": sorted(k4_states),
          "live_share_by_iteration": {
              it: (st_[1][2] != 0).float().mean().item()
              for it, st_ in k4_states.items()},
          "lanes_differing_by_case": k4_bad,
          "tolerance": "sf, si, rad and the record slot (21 and 11 planes) "
                       "bit for bit on every lane"})
    check(all(v == 0 for v in k4_bad.values()),
          f"K4 differs from its plain version: {k4_bad}")
    k4_err = 0.0  # every word equal (checked above)

    # -- K5 and K6 against their plain versions over the recorded phase ------
    g_rad = torch.rand((W * H, 3), generator=g, device=dev) * 2 - 1
    gstrips = PG.grad_strip_planes(g_rad, S, lanes)
    cot0 = torch.randn((9, lanes), generator=g, device=dev) * si[2]
    dep0 = torch.zeros((6 * S, lanes), device=dev)

    def k5_run(fused, u5_all=None):
        cot, dep = cot0.clone(), dep0.clone()
        dattr = fused(cot, dep, rec, gstrips, 0, SEED, u5_all)
        torch.cuda.synchronize()
        return cot, dep, dattr

    def k6_run(step, u5_all=None):  # the lean 11-plane record
        cot, dep = cot0.clone(), dep0.clone()
        dattr = torch.empty((B1, 9, lanes), device=dev)
        for s in reversed(range(B1)):
            step(cot, dep, rec[s, :PK.N_REC_LEAN], rec_idx[s], amat, gstrips,
                 SEED, s, None if u5_all is None else u5_all[s], out=dattr[s])
        torch.cuda.synchronize()
        return cot, dep, dattr

    u5_all = torch.stack([rng.philox_uniforms(SEED, i, lanes, 5, device=dev)
                          for i in range(B1)])
    u5_rand = torch.rand((B1, 5, lanes), generator=g, device=dev)
    k5 = k5_run(PK.persist_replay_fused)
    bad5, k5_err = lanes_outside(
        list(zip(k5, k5_run(PK.persist_replay_fused_ref))), 1e-5)
    bad5i, k5i_err = lanes_outside(
        list(zip(k5_run(PK.persist_replay_fused, u5_rand),
                 k5_run(PK.persist_replay_fused_ref, u5_rand))), 1e-5)
    philox_bitwise = all(torch.equal(a, b) for a, b in
                         zip(k5, k5_run(PK.persist_replay_fused, u5_all)))
    k6 = k6_run(PK.persist_replay_step)
    bad6, k6_err = lanes_outside(
        list(zip(k6, k6_run(PK.persist_replay_step_fetch_ref))), 1e-5)
    bad6i, k6i_err = lanes_outside(
        list(zip(k6_run(PK.persist_replay_step, u5_rand),
                 k6_run(PK.persist_replay_step_fetch_ref, u5_rand))), 1e-5)
    k6_philox_bitwise = all(torch.equal(a, b) for a, b in
                            zip(k6, k6_run(PK.persist_replay_step, u5_all)))
    k6_is_k5 = all(torch.equal(_bits(a), _bits(b)) for a, b in zip(k6, k5))
    del u5_all, u5_rand
    k5_err, k6_err = max(k5_err, k5i_err), max(k6_err, k6i_err)
    tol = "cot, dep, dattr within 1e-5*max(1,|x|) on >= 99.9% of lanes"
    emit({"phase": "k5_vs_plain", "lanes": lanes, "slots": B1,
          "lanes_outside": {"philox": bad5, "injected": bad5i},
          "max_abs_err": k5_err,
          "philox_vs_injected_bitwise": philox_bitwise, "tolerance": tol
          + "; own Philox draws bitwise equal to injected philox_uniforms"})
    emit({"phase": "k6_vs_plain", "lanes": lanes, "slots": B1,
          "record": "lean (11 planes, winner rows fetched in the kernel)",
          "lanes_outside": {"philox": bad6, "injected": bad6i},
          "max_abs_err": k6_err, "philox_vs_injected_bitwise":
          k6_philox_bitwise, "bitwise_equal_to_k5": k6_is_k5,
          "tolerance": tol + "; K6's walk bit for bit K5's"})
    limit = int(1e-3 * lanes)
    check(bad5 <= limit and bad5i <= limit, f"K5: {bad5}, {bad5i} lanes "
          "outside")
    check(philox_bitwise, "K5 Philox draws differ from philox_uniforms")
    check(bad6 <= limit and bad6i <= limit, f"K6: {bad6}, {bad6i} lanes "
          "outside")
    check(k6_philox_bitwise, "K6 Philox draws differ from philox_uniforms")
    check(k6_is_k5, "K6's walk differs from K5's")

    # -- times at these shapes (CUDA events) --------------------------------
    live4 = [sf20.clone(), si20.clone(), rad20.clone()]
    slot4 = torch.empty((PK.N_REC, lanes), device=dev)
    carry = [cot0.clone(), dep0.clone()]
    lean10 = rec[10, :PK.N_REC_LEAN]
    out6 = torch.empty((9, lanes), device=dev)
    fns = {
        "sweep_masked": lambda: K1.sweep_masked(sf20[0:6], si20[2], spheres),
        "sweep_masked_plain": lambda: K1.sweep_masked_ref(
            sf20[0:6], si20[2], spheres),
        "persist_record": lambda: PK.persist_record_step(
            t3, i3, amat, strips, *live4, slot4, SEED, 20, DEPTH),
        "persist_record_plain": lambda: PK.persist_record_fetch_ref(
            t3, i3, amat, strips, *live4, slot4, SEED, 20, DEPTH),
        "persist_replay_fused": lambda: PK.persist_replay_fused(
            *carry, rec, gstrips, 0, SEED),
        "persist_replay_fused_plain": lambda: PK.persist_replay_fused_ref(
            *carry, rec, gstrips, 0, SEED),
        "persist_replay_step": lambda: PK.persist_replay_step(
            *carry, lean10, rec_idx[10], amat, gstrips, SEED, 10, out=out6),
        "persist_replay_step_plain": lambda: PK.persist_replay_step_fetch_ref(
            *carry, lean10, rec_idx[10], amat, gstrips, SEED, 10, out=out6),
    }
    setups = {"persist_record": lambda: [x.copy_(y) for x, y in
                                         zip(live4, (sf20, si20, rad20))],
              "persist_replay": lambda: [x.copy_(y) for x, y in
                                         zip(carry, (cot0, dep0))]}
    dev_ms, call = {}, {}
    for name, fn in fns.items():
        plain = name.endswith("_plain")
        setup = next((v for k, v in setups.items() if name.startswith(k)),
                     None)
        n = 3 if plain else 20
        dev_ms[name] = device_ms(fn, n, setup=setup, sleep_cycles=(
            3_000_000_000 if plain else 100_000_000))
        call[name] = call_ms(fn, n, setup=setup)

    # -- bounds at these shapes, counted from this run's flags: a live lane
    # or slot moves all its words; a dead one reads its flag and writes what
    # the kernel writes for it (K3: t and idx; K4: a zero slot; K5, K6: 9
    # zero rows). A miss banks 3 radiance words, a regeneration reads 6
    # strip words (K4) or deposits 6 cotangent words (K5, K6). ------------
    def flag_counts(fl):
        act = (fl & PK.F_ACT) != 0
        return (act, int(act.sum()),
                int((act & ((fl & PK.F_HIT) == 0)).sum()),
                int(((fl & PK.F_REGEN) != 0).sum()))

    n_live = int(live.sum())
    n_sph = spheres.shape[0]
    _, live4, miss4, regen4 = flag_counts(PK.flags_of(rec[20]))
    check(live4 == n_live, f"slot 20 holds {live4} live lanes, not {n_live}")
    fl5 = rec[:, 10].view(torch.int32)
    act5, live_slots5, _, regen5 = flag_counts(fl5)
    # the (lane, strip) radiance cotangents the walk needs, each read once
    strips5 = sum(int((act5 & ((fl5 >> PK.F_STRIP_SHIFT) == s)).any(0).sum())
                  for s in range(S))
    lanes5 = int(act5.any(0).sum())
    _, live6, _, regen6 = flag_counts(PK.flags_of(rec[10]))
    bounds = {
        # every lane: alive in, t and idx out; live lanes: the 6 ray words
        # in; the table once; the sweep of live lanes.
        "sweep_masked": bound(lanes * (4 + 8) + n_live * 24 + 16 * n_sph,
                              n_live * (SWEEP_RAY_OPS
                                        + SWEEP_SPHERE_OPS * n_sph)),
        # every lane: its flag in; dead: a zero slot out; live: t, idx, 9
        # ray-state and 2 int words in, the 21-word slot and the state out;
        # the attribute table once.
        "persist_record": bound(
            lanes * 4 + (lanes - n_live) * PK.N_REC * 4
            + n_live * ((1 + 1 + 9 + 2) + (PK.N_REC + 9 + 3)) * 4
            + miss4 * 3 * 4 + regen4 * 6 * 4 + n_sph * 40,
            n_live * (SHADE_OPS + ADVANCE_OPS)),
        # lanes with work: the carry in and out; every slot's flag; live
        # slots: 20 more record words in, 9 rows out; dead slots: 9 zero
        # rows out; each needed strip cotangent in once.
        "persist_replay_fused": bound(
            lanes5 * 2 * 9 * 4 + B1 * lanes * 4
            + (B1 * lanes - live_slots5) * 9 * 4
            + live_slots5 * (20 + 9) * 4 + strips5 * 3 * 4
            + regen5 * 6 * 4, live_slots5 * ADJOINT_OPS),
        # every lane's flag; live: 10 record words, the winner index, 3
        # strip cotangents and the carry in, the carry and 9 rows out; dead:
        # 9 zero rows out; the attribute table once.
        "persist_replay_step": bound(
            lanes * 4 + (lanes - live6) * 9 * 4
            + live6 * ((10 + 1 + 3 + 9) + (9 + 9)) * 4 + regen6 * 6 * 4
            + n_sph * 40, live6 * ADJOINT_OPS),
    }
    emit({"phase": "grad_kernel_bounds", "bounds": bounds,
          "live_lanes_k3_k4": n_live, "lanes": lanes, "misses_k4": miss4,
          "regens_k4": regen4, "live_slots_k5": live_slots5,
          "slots_k5": B1 * lanes, "live_lanes_k6": live6})

    pkg, tpu = "raytracingweekend_jl_tpu_torch/csrc", \
        "raytracingweekend_jl_tpu/ops/pallas"
    rows = [("sweep_masked", "sweep.cu", "intersect_kernel.py:115", k3_err),
            ("persist_record", "persist_record.cu",
             "persist_grad_kernel.py:239", k4_err),
            ("persist_replay_fused", "persist_replay.cu",
             "persist_grad_kernel.py:665", k5_err),
            ("persist_replay_step", "persist_replay.cu",
             "persist_grad_kernel.py:542", k6_err)]
    snap = dict(strips=strips, sf=sf20, si=si20, rad=rad20, seed=SEED,
                spheres=spheres, amat=amat, depth=DEPTH, iteration=20,
                k3_states=k3_states, k4_states=k4_states, k4_hits=k4_hits)
    return [kernel_row(nm, f"{pkg}/{src}", f"{tpu}/{tpu_at}", err,
                       dev_ms[nm], dev_ms[nm + "_plain"], bounds[nm])
            for nm, src, tpu_at, err in rows], dev_ms, call, snap


def kernel_row(name, source, replaces, err, ms, plain_ms, bnd) -> dict:
    """One entry of the ``kernels`` line (launches filled in later). No
    single PyTorch call computes any of the port's kernels (a sphere sweep,
    a shade or record step, a bounce adjoint walk, a whole render), so
    ``library_ms`` is null."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
            "bound_by": bnd["bound_by"], "library_ms": None}


def grad_entry_phases(dev, card, W: int = 1920, w2: int = 480) -> dict:
    """The gradient slice through the public ``render_grads``: the flagship
    step (default route, then the lean-record route), the kernels against
    the plain versions at 480x270, and a finite-difference check. Returns
    the launches of K3-K6 on the main-path runs."""
    import torch
    import raytracingweekend_jl_tpu_torch as pt

    def same(a, b):
        return bool(torch.equal(a[0], b[0])) and all(
            torch.equal(x, y) for x, y in zip(a[1], b[1]))

    H, h2, SPP = pt.image_height_for(W), pt.image_height_for(w2), 1
    scene, cam = pt.scene_random_spheres(seed=1), pt.t_cam1()
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.8, 0, 1))
    target = pt.render_radiance(scene, cam, W, SPP, seed=123, device=dev,
                                persistent=True)

    def step(**kw):
        out = pt.render_grads(bad, cam, target, W, SPP, device=dev, **kw)
        torch.cuda.synchronize()
        return out

    # -- the flagship step, default route (K3, K4, K5) ----------------------
    step()  # warm-up
    stats = {}
    reset_counts()
    first = step(stats=stats)
    launches = counts()
    bitwise = same(first, step())
    pt.check_grads_sane(first[1], first[0])
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        secs.append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    step()
    peak = torch.cuda.max_memory_allocated()
    sec = sorted(secs)[len(secs) // 2]
    n1, n2 = stats["phase1_counts"][0], stats["phase2_counts"][0]
    lanes = stats["lanes"][0]
    emit({"phase": "grad_step", "card": card, "size": [W, H], "spp": SPP,
          "route": "persistent record, 8 strips, tail compaction (44, 16), "
                   "strict, fused replay",
          "launches": launches, "dropped": stats["dropped"],
          "lanes": lanes, "boundary_active": stats["boundary_active"][0],
          "occupancy_at_44": stats["boundary_active"][0] / lanes,
          "phase1_iterations": sum(c > 0 for c in n1),
          "phase2_iterations": sum(c > 0 for c in n2),
          "phase2_counts": [c for c in n2 if c > 0],
          "loss": float(first[0]), "bitwise_repeat": bitwise,
          "seconds_runs": secs, "seconds_median": sec,
          "mpaths_per_s": W * H * SPP / sec / 1e6,
          "peak_allocated_bytes": peak,
          "grad_sums": {f: float(getattr(first[1], f).sum())
                        for f in pt.DIFF_FIELDS}})
    check(all(launches[k] > 0 for k in
              ("sweep_masked", "persist_record", "persist_replay_fused")),
          f"gradient step launched {launches}")
    check(stats["dropped"] == 0, f"{stats['dropped']} paths dropped")
    check(launches["gather"] == 0, f"the record loop gathered: {launches}")
    check(bitwise, "two gradient steps differ")
    emit({"phase": "grad_profile", "card": card, **profile_call(step)})

    # -- the lean-record route of the same step (K3, K4, K6) ----------------
    lean_kw = dict(recorded_persist=(8, None, (44, 16), False),
                   persist_strict=True)
    reset_counts()
    lean = step(**lean_kw)
    lean_launches = counts()
    t0 = time.perf_counter()
    step(**lean_kw)
    lean_sec = time.perf_counter() - t0
    lean_same = same(lean, first)
    emit({"phase": "grad_step_lean", "card": card, "size": [W, H],
          "spp": SPP, "launches": lean_launches, "seconds": lean_sec,
          "mpaths_per_s": W * H * SPP / lean_sec / 1e6,
          "bitwise_equal_to_default": lean_same})
    check(all(lean_launches[k] > 0 for k in
              ("sweep_masked", "persist_record", "persist_replay_step")),
          f"lean gradient step launched {lean_launches}")
    check(lean_launches["gather"] == 0,
          f"the lean record or replay loop gathered: {lean_launches}")
    check(lean_same, "lean-record gradients differ from the default's")

    # -- kernels against the plain versions at 480x270, the persistent pair
    # pinned (below 2^17 pixels the default is the fixed-depth pair) -------
    target2 = pt.render_radiance(scene, cam, w2, 1, seed=123, device=dev,
                                 persistent=True)
    persist = dict(recorded_persist=(8, None, (44, 16)), persist_strict=True)

    def step2(**kw):
        t0 = time.perf_counter()
        out = pt.render_grads(bad, cam, target2, w2, 1, device=dev, seed=9,
                              **persist, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    sec_k = min(step2()[0], step2()[0])
    _, (loss_k, g_k) = step2()
    sec_p, (loss_p, g_p) = step2(impl="plain")
    rel_loss = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    fields = {}
    for f in pt.DIFF_FIELDS:
        a = getattr(g_k, f).double().ravel()
        b = getattr(g_p, f).double().ravel()
        na, nb = a.norm().item(), b.norm().item()
        cos = 1.0 if na == nb == 0 else (a @ b).item() / max(na * nb, 1e-300)
        fields[f] = {"cosine": cos,
                     "norm_ratio": 1.0 if na == nb == 0 else na / nb}
    emit({"phase": "grad_vs_plain", "card": card, "size": [w2, h2],
          "spp": 1, "loss_kernels": float(loss_k), "loss_plain": float(loss_p),
          "loss_rel_diff": rel_loss, "fields": fields,
          "seconds_kernels": sec_k, "seconds_plain": sec_p,
          "tolerance": "loss within 1e-5 relative; per field cosine >= "
                       "0.999 and norm ratio within 1%"})
    check(rel_loss <= 1e-5, f"loss differs by {rel_loss} relative")
    for f, v in fields.items():
        check(v["cosine"] >= 0.999 and abs(v["norm_ratio"] - 1) <= 0.01,
              f"grad[{f}] kernels vs plain: {v}")

    # -- finite differences in the largest Lambertian sphere's albedo -------
    lf = lambda img, tgt: ((img.double() - tgt.double()) ** 2).mean()
    _, g_fd = pt.render_grads(bad, cam, target2, w2, 1, device=dev, seed=9,
                              loss_fn=lf, **persist)
    k = int(torch.where(bad.mat == 0, bad.radius, -1.0).argmax())
    eps, rows = 1e-3, []
    for c in range(3):
        losses = []
        for sgn in (1.0, -1.0):
            alb = bad.albedo.clone()
            alb[k, c] += sgn * eps
            with torch.no_grad():
                losses.append(float(pt.render_loss(
                    bad._replace(albedo=alb), cam, target2, w2, 1,
                    device=dev, seed=9, loss_fn=lf, **persist)))
        fd = (losses[0] - losses[1]) / (2 * eps)
        an = float(g_fd.albedo[k, c])
        rows.append({"channel": c, "fd": fd, "kernel_grad": an,
                     "rel_err": abs(fd - an) / max(abs(an), 1e-30)})
    emit({"phase": "grad_fd", "card": card, "size": [w2, h2], "spp": 1,
          "sphere": k, "radius": float(bad.radius[k]), "eps": eps,
          "channels": rows, "tolerance": "within 1e-2 relative"})
    for r in rows:
        check(r["rel_err"] <= 1e-2, f"FD check failed: {r}")

    return {**{k: launches[k] for k in
               ("sweep_masked", "persist_record", "persist_replay_fused")},
            "persist_replay_step": lean_launches["persist_replay_step"]}


def inverse_demo() -> tuple:
    """The inverse demo's scenes on the CPU: ``(truth, start, camera,
    movable, scored)``. The start perturbs the truth as the JAX script
    does, drawn from numpy: centers +-0.12 on the movable spheres, albedo
    0.55 a + 0.15 on the movable non-glass ones (``scored``)."""
    import numpy as np
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    scene_true, cam = pt.scene_4_spheres(), pt.t_default_cam()
    movable = pt.movable_mask(scene_true)
    scored = movable & (scene_true.mat.numpy() != pt.DIELECTRIC)
    gen = np.random.default_rng(7)
    jit = gen.uniform(-0.12, 0.12, tuple(scene_true.center.shape))
    jit[~movable] = 0.0
    alb = scene_true.albedo.numpy().copy()
    alb[scored] = np.clip(alb[scored] * 0.55 + 0.15, 0, 1)
    scene0 = scene_true._replace(
        center=scene_true.center + torch.from_numpy(jit.astype(np.float32)),
        albedo=torch.from_numpy(alb))
    return scene_true, scene0, cam, movable, scored


def fit_slice_phases(dev, card, W: int = 200, H: int = 112, SPP: int = 8,
                     STEPS: int = 120) -> tuple:
    """The inverse-rendering slice at the JAX package's inverse demo
    (``scripts/inverse_render.py`` defaults: ``scene_4_spheres``,
    ``t_default_cam``, 200x112, spp 8, depth 16, 120 Adam steps, SPSA with
    2 probe pairs): K7a, K7b, K7c and K8 against their plain versions at the
    demo's shapes, the small-image gradient step, the forward render, the
    fit itself against its plain path, and the kernels' times (an event
    pair per launch). Returns the four kernel rows with their launches on the
    fit's main path, their ``device_ms`` and ``call_ms`` entries, and the
    inputs :func:`fit_redesign_phases` times them on."""
    import numpy as np
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch import rng
    from raytracingweekend_jl_tpu_torch.camera import sample_pass_rays
    from raytracingweekend_jl_tpu_torch.ops import fused_grad as FG
    from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
    from raytracingweekend_jl_tpu_torch.ops.cuda import inline_kernel as K8
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat

    DEPTH = 16
    R, fw, fh = W * H, float(W), float(H)
    scene_true, scene0, cam, movable, scored = inverse_demo()
    # The target: a forward pass of the fixed-depth pair, as the demo's.
    target = pt.render_radiance(scene_true, cam, W, SPP, image_height=H,
                                seed=0, persistent=False, recorded_fused=True)

    # -- K7a, K7b, K7c against their plain versions: the demo's first pass,
    # 22 400 lanes; K7a at every bounce -----------------------------------
    sc0 = pt.trim_scene(scene0.to(dev))
    cam_d = cam.to(dev)
    u_px, v_px = pt.pixel_coords(W, H, device=dev)
    seed32 = rng.purpose_seed(0, rng.SCATTER_DIR, 0) & 0xFFFFFFFF
    o1, d1 = sample_pass_rays(cam_d, u_px, v_px, 0, 0, 1, fw, fh)
    spheres, amat = K1.sphere_consts(sc0), attr_mat(sc0)
    st = FG.start_state(o1, d1)
    rec = torch.empty((DEPTH, GK.N_REC, R), device=dev)
    before = []  # (state, t, idx) before each bounce
    for b in range(DEPTH):
        t, idx = K1.sweep_masked(st[0:6], st[12].view(torch.int32), spheres)
        before.append((st.clone(), t, idx))
        GK.record_shade_step(t, idx, amat, st, rec[b], seed32, b)
    st2, t2, idx2 = before[2]
    torch.cuda.synchronize()
    g = torch.Generator(device=dev).manual_seed(11)
    limit = int(1e-4 * R)

    def k7a_run(step, b, u5):
        st_b, t_b, idx_b = before[b]
        st_, slot = st_b.clone(), torch.full((GK.N_REC, R), 7.0, device=dev)
        step(t_b, idx_b, amat, st_, slot, seed32, b, u5)
        torch.cuda.synchronize()
        return st_, slot

    def k7a_compare(u5_fn):
        """(lanes differing in any word at any bounce, max |difference|)."""
        bad, err = 0, 0.0
        for b in range(DEPTH):
            u5 = u5_fn()
            got = k7a_run(GK.record_shade_step, b, u5)
            ref = k7a_run(GK.record_shade_fetch_ref, b, u5)
            bad += int(_bitwise_lanes(list(zip(got, ref)), R).sum())
            err = max(err, max((x - y).abs().max().item()
                               for x, y in zip(got, ref)))
        return bad, err

    bad_a_inj, err_a_inj = k7a_compare(
        lambda: torch.rand((5, R), generator=g, device=dev))
    bad_a_ph, err_a_ph = k7a_compare(lambda: None)
    live2 = int((st2[12].view(torch.int32) != 0).sum())
    emit({"phase": "k7a_vs_plain", "card": card, "lanes": R,
          "bounces": DEPTH, "live_lanes_by_bounce": [
              int((x[0][12].view(torch.int32) != 0).sum()) for x in before],
          "lanes_differing_injected_u5": bad_a_inj,
          "max_abs_err_injected": err_a_inj,
          "lanes_differing_philox": bad_a_ph, "max_abs_err_philox": err_a_ph,
          "tolerance": "K7a (the winner's row fetched inside) against the "
                       "gather plus record_shade_step_ref: state and all 21 "
                       "record planes bit for bit on every lane, at every "
                       "bounce"})
    check(bad_a_inj == 0 and bad_a_ph == 0,
          f"K7a: {bad_a_inj} / {bad_a_ph} lane-bounces differ")
    tol = ("alive flags identical; float planes within 1e-6*max(1,|x|) on "
           ">= 99.99% of lanes")

    g3 = torch.rand((3, R), generator=g, device=dev) * 2 - 1
    cot2 = torch.randn((9, R), generator=g, device=dev)

    def k7b_compare(u5):
        outs = []
        for step in (GK.replay_bwd_step, GK.replay_bwd_step_ref):
            cot = cot2.clone()
            outs.append((step(rec[2], g3, cot, seed32, 2, u5), cot))
            torch.cuda.synchronize()
        return lanes_outside(list(zip(*outs)), 1e-6)

    bad_b_inj, err_b_inj = k7b_compare(torch.rand((5, R), generator=g,
                                                  device=dev))
    bad_b_ph, err_b_ph = k7b_compare(None)
    emit({"phase": "k7b_vs_plain", "card": card, "lanes": R, "slot": 2,
          "lanes_outside_injected_u5": bad_b_inj,
          "max_abs_err_injected": err_b_inj,
          "lanes_outside_philox": bad_b_ph, "max_abs_err_philox": err_b_ph,
          "tolerance": tol.replace("alive flags identical; float", "carry "
                                   "and attribute")})
    check(bad_b_inj <= limit and bad_b_ph <= limit,
          f"K7b: {bad_b_inj} / {bad_b_ph} lanes outside")

    def k7c_compare(u5_all):
        outs = []
        for fused in (GK.replay_bwd_fused, GK.replay_bwd_fused_ref):
            cot = torch.zeros((9, R), device=dev)
            outs.append((fused(rec, g3, cot, seed32, u5_all), cot))
            torch.cuda.synchronize()
        return lanes_outside(list(zip(*outs)), 1e-6), outs[0]

    (bad_c_inj, err_c_inj), _ = k7c_compare(
        torch.rand((DEPTH, 5, R), generator=g, device=dev))
    (bad_c_ph, err_c_ph), k7c_out = k7c_compare(None)
    cot_s = torch.zeros((9, R), device=dev)
    d_s = torch.empty((DEPTH, 9, R), device=dev)
    for b in reversed(range(DEPTH)):
        GK.replay_bwd_step(rec[b], g3, cot_s, seed32, b, out=d_s[b])
    step_is_fused = bool(torch.equal(d_s, k7c_out[0])
                         and torch.equal(cot_s, k7c_out[1]))
    emit({"phase": "k7c_vs_plain", "card": card, "lanes": R,
          "slots": DEPTH, "lanes_outside_injected_u5": bad_c_inj,
          "max_abs_err_injected": err_c_inj,
          "lanes_outside_philox": bad_c_ph, "max_abs_err_philox": err_c_ph,
          "k7b_walk_bitwise_equal": step_is_fused,
          "tolerance": "carry and attribute rows over the whole 16-slot "
                       "walk within 1e-6*max(1,|x|) on >= 99.99% of lanes"})
    check(bad_c_inj <= limit and bad_c_ph <= limit,
          f"K7c: {bad_c_inj} / {bad_c_ph} lanes outside")

    # -- K8 against its plain version: the demo at spp 8, 179 200 lanes, and
    # the first 64 spheres of the flagship scene (the inline route's largest
    # table) at 200x112 ------------------------------------------------------
    o8, d8 = sample_pass_rays(cam_d, u_px, v_px, 0, 0, SPP, fw, fh)
    L8 = o8.shape[0]
    seed8 = rng.persistent_seed(0, 0)
    big = pt.scene_random_spheres(seed=1, device=dev)
    big = pt.trim_scene(big._replace(**{f: getattr(big, f)[:64]
                                        for f in big._fields}))
    o64, d64 = sample_pass_rays(pt.t_cam1(device=dev), u_px, v_px, 0, 0, 1,
                                fw, fh)

    def k8_compare(scene, o, d, u5):
        a = K8.trace_inline(scene, o, d, seed8, DEPTH, 1e-4, u5)
        torch.cuda.synchronize()
        b = K8.trace_inline_ref(scene, o, d, seed8, DEPTH, 1e-4, u5)
        return (int(_bitwise_lanes([(a.T, b.T)], o.shape[0]).sum()),
                (a - b).abs().max().item())

    k8_cases = {}
    for name, scene, o, d in (("demo", sc0, o8, d8),
                              ("spheres64", big, o64, d64)):
        n = o.shape[0]
        k8_cases[name] = {
            "lanes": n, "spheres": scene.n_spheres,
            "injected_u5": k8_compare(scene, o, d, torch.rand(
                (DEPTH, 5, n), generator=g, device=dev)),
            "philox": k8_compare(scene, o, d, None)}
    (bad8_inj, err8_inj), (bad8_ph, err8_ph) = (
        k8_cases["demo"]["injected_u5"], k8_cases["demo"]["philox"])
    emit({"phase": "k8_vs_plain", "card": card, "lanes": L8,
          "spheres": sc0.n_spheres,
          "lanes_differing_and_max_abs_err": k8_cases,
          "occupancy": K8.occupancy(sc0.n_spheres, dev),
          "tolerance": "radiance bit for bit on every lane"})
    check(all(c[k][0] == 0 for c in k8_cases.values()
              for k in ("injected_u5", "philox")),
          f"K8 differs from its plain version: {k8_cases}")

    # -- the small-image gradient step through render_grads -----------------
    def grad_step(**kw):
        out = pt.render_grads(scene0, cam, target, W, SPP, seed=0, **kw)
        torch.cuda.synchronize()
        return out

    def same(a, b):
        return bool(torch.equal(a[0], b[0])) and all(
            torch.equal(x, y) for x, y in zip(a[1], b[1]))

    grad_step()  # warm-up
    reset_counts()
    first = grad_step()
    step_launches = counts()
    bitwise = same(first, grad_step())
    pt.check_grads_sane(first[1], first[0])
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        grad_step()
        secs.append(time.perf_counter() - t0)
    reset_counts()
    stepwise = grad_step(replay_fused=False)
    step_route = counts()
    max_rel = max(((x - y).abs() / y.abs().clamp(min=1)).max().item()
                  for x, y in zip(stepwise[1], first[1]))
    max_rel = max(max_rel, abs(float(stepwise[0]) - float(first[0]))
                  / abs(float(first[0])))
    plain = grad_step(impl="plain")
    rel_loss = abs(float(first[0]) - float(plain[0])) / abs(float(plain[0]))
    fields = field_stats(first[1], plain[1])
    lf = lambda img, tgt: ((img.double() - tgt.double()) ** 2).mean()
    _, g_fd = grad_step(loss_fn=lf)
    eps, fd_rows = 1e-3, []
    for c in range(3):
        losses = []
        for sgn in (1.0, -1.0):
            alb_ = scene0.albedo.clone()
            alb_[0, c] += sgn * eps
            with torch.no_grad():
                losses.append(float(pt.render_loss(
                    scene0._replace(albedo=alb_), cam, target, W, SPP,
                    seed=0, loss_fn=lf)))
        fd = (losses[0] - losses[1]) / (2 * eps)
        an = float(g_fd.albedo[0, c])
        fd_rows.append({"channel": c, "fd": fd, "kernel_grad": an,
                        "rel_err": abs(fd - an) / max(abs(an), 1e-30)})
    sec = sorted(secs)[len(secs) // 2]
    emit({"phase": "fused_grad_step", "card": card, "size": [W, H],
          "spp": SPP, "route": "fixed-depth pair (default below 2^17 "
                               "pixels), fused replay",
          "launches": step_launches, "loss": float(first[0]),
          "bitwise_repeat": bitwise, "seconds_runs": secs,
          "seconds_median": sec, "mpaths_per_s": R * SPP / sec / 1e6,
          "replay_step_route_launches": step_route,
          "replay_step_max_rel_diff": max_rel,
          "plain_loss_rel_diff": rel_loss, "plain_fields": fields,
          "fd_sphere": 0, "fd_eps": eps, "fd_channels": fd_rows,
          "tolerance": "K7b route within 1e-6; plain: loss 1e-5 relative, "
                       "per field cosine >= 0.999 and norm ratio within 1%; "
                       "FD within 1e-2 relative"})
    check(all(step_launches[k] > 0 for k in
              ("sweep_masked", "record_shade", "replay_bwd_fused")),
          f"small-image step launched {step_launches}")
    check(step_launches["gather"] == 0 and step_route["gather"] == 0,
          f"the small-image step gathered: {step_launches}, {step_route}")
    check(step_launches["persist_record"] == 0
          and step_launches["persist_replay_fused"] == 0,
          f"small-image step took the persistent pair: {step_launches}")
    check(step_route["replay_bwd_step"] > 0
          and step_route["replay_bwd_fused"] == 0,
          f"replay_fused=False launched {step_route}")
    check(bitwise, "two small-image steps differ")
    check(max_rel <= 1e-6, f"K7b route differs by {max_rel}")
    check(rel_loss <= 1e-5, f"plain loss differs by {rel_loss}")
    for f, v in fields.items():
        check(v["cosine"] >= 0.999 and abs(v["norm_ratio"] - 1) <= 0.01,
              f"grad[{f}] kernels vs plain: {v}")
    for r in fd_rows:
        check(r["rel_err"] <= 1e-2, f"FD check failed: {r}")

    # -- the demo's forward render through the entry point (K8) -------------
    def fwd(**kw):
        t0 = time.perf_counter()
        out = pt.render_radiance(scene_true, cam, W, SPP, image_height=H,
                                 seed=0, persistent=True, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    fwd()  # warm-up
    reset_counts()
    _, img = fwd()
    fwd_launches = counts()
    fwd_secs = [fwd()[0] for _ in range(5)]
    _, img_plain = fwd(impl="plain")
    _, img_strided = fwd(inline=False)
    m = img.mean((0, 1))
    rel_plain = ((m - img_plain.mean((0, 1))).abs()
                 / img_plain.mean((0, 1))).max().item()
    rel_strided = ((m - img_strided.mean((0, 1))).abs()
                   / img_strided.mean((0, 1))).max().item()
    fwd_sec = sorted(fwd_secs)[2]
    emit({"phase": "inline_render", "card": card, "size": [W, H],
          "spp": SPP, "launches": fwd_launches, "seconds_runs": fwd_secs,
          "seconds_median": fwd_sec,
          "mpaths_per_s": R * SPP / fwd_sec / 1e6,
          "means": m.tolist(), "max_rel_diff_plain": rel_plain,
          "max_rel_diff_strided": rel_strided,
          "tolerance": "each channel mean within 1% of the plain path's and "
                       "of the strided route's"})
    check(fwd_launches["inline"] == 1 and fwd_launches["sweep"] == 0
          and fwd_launches["shade_strided"] == 0,
          f"demo forward launched {fwd_launches}")
    check(bool(torch.isfinite(img).all()), "non-finite demo image")
    check(rel_plain <= 0.01 and rel_strided <= 0.01,
          f"demo means differ: {rel_plain}, {rel_strided}")

    # -- the fit: 120 steps of fit_scene on the card ------------------------
    def err(a, b, mask):
        return float((a.cpu() - b.cpu()).abs().numpy()[mask].max())

    reset_counts()
    t0 = time.perf_counter()
    res = pt.fit_scene(scene0, cam, target, W, SPP, steps=STEPS)
    fit_wall = time.perf_counter() - t0
    fit_launches = counts()
    losses = res.losses
    step_sec = sorted(res.step_seconds)[len(res.step_seconds) // 2]
    a0, a1 = (err(scene0.albedo, scene_true.albedo, scored),
              err(res.scene.albedo, scene_true.albedo, scored))
    c0, c1 = (err(scene0.center, scene_true.center, movable),
              err(res.scene.center, scene_true.center, movable))
    emit({"phase": "fit", "card": card, "size": [W, H], "spp": SPP,
          "steps": STEPS, "loss_first": losses[0], "loss_last": losses[-1],
          "loss_min": min(losses), "loss_step10": losses[10],
          "step_seconds_median": step_sec,
          "step_seconds_first": res.step_seconds[0], "wall_s": fit_wall,
          "mpaths_per_s": R * SPP / step_sec / 1e6,
          "albedo_err": [a0, a1], "center_err": [c0, c1],
          "launches": fit_launches,
          "launches_per_step": {k: v / STEPS
                                for k, v in fit_launches.items()},
          "checks": "losses finite; step 10 < 0.75 x step 0; albedo error "
                    "shrinks; center error < 1.3 x its start"})
    check(bool(np.isfinite(losses).all()), "non-finite fit loss")
    check(losses[10] < 0.75 * losses[0], f"fit loss {losses[:11]}")
    check(a1 < a0, f"albedo error {a0} -> {a1}")
    check(c1 < 1.3 * c0, f"center error {c0} -> {c1}")
    check(all(fit_launches[k] > 0 for k in
              ("sweep_masked", "record_shade", "replay_bwd_fused", "inline")),
          f"fit launched {fit_launches}")
    check(fit_launches["gather"] == 0, f"the fit gathered: {fit_launches}")
    rep = [pt.fit_scene(scene0, cam, target, W, SPP, steps=3).losses
           for _ in range(2)]
    check(rep[0] == rep[1], f"two 3-step fits differ: {rep}")

    # -- the fit's per-bounce replay route (K7b) ----------------------------
    reset_counts()
    res_b = pt.fit_scene(scene0, cam, target, W, SPP, steps=2,
                         render_kwargs={"replay_fused": False})
    b_launches = counts()
    emit({"phase": "fit_replay_step", "card": card, "steps": 2,
          "launches": b_launches, "losses": res_b.losses,
          "losses_default_route": rep[0][:2], "repeat_fits_bitwise": True})
    check(b_launches["replay_bwd_step"] > 0
          and b_launches["replay_bwd_fused"] == 0,
          f"replay_fused=False fit launched {b_launches}")

    # -- kernels against plain through the fit, 64x36 spp 2 ----------------
    w3, h3 = 64, 36
    target3 = pt.render_radiance(scene_true, cam, w3, 2, image_height=h3,
                                 seed=0, persistent=False,
                                 recorded_fused=True)
    t0 = time.perf_counter()
    fk = pt.fit_scene(scene0, cam, target3, w3, 2, steps=3).losses
    sec_k = time.perf_counter() - t0
    t0 = time.perf_counter()
    fp = pt.fit_scene(scene0, cam, target3, w3, 2, steps=3,
                      render_kwargs={"impl": "plain"}).losses
    sec_p = time.perf_counter() - t0
    rel_fit = max(abs(a - b) / abs(b) for a, b in zip(fk, fp))
    emit({"phase": "fit_vs_plain", "card": card, "size": [w3, h3], "spp": 2,
          "steps": 3, "losses_kernels": fk, "losses_plain": fp,
          "max_rel_diff": rel_fit, "seconds_kernels": sec_k,
          "seconds_plain": sec_p, "tolerance": "each loss within 1e-4 "
                                               "relative"})
    check(rel_fit <= 1e-4, f"fit losses differ by {rel_fit}")

    # -- times at the demo's shapes (CUDA events) and bounds ----------------
    live_st, slot_t = [st2.clone()], torch.empty((GK.N_REC, R), device=dev)
    carry = [cot2.clone()]
    out9 = torch.empty((9, R), device=dev)
    zero9 = [torch.zeros((9, R), device=dev)]
    fns = {
        "record_shade": lambda: GK.record_shade_step(
            t2, idx2, amat, live_st[0], slot_t, seed32, 2),
        "record_shade_plain": lambda: GK.record_shade_fetch_ref(
            t2, idx2, amat, live_st[0], slot_t, seed32, 2),
        "replay_bwd_step": lambda: GK.replay_bwd_step(
            rec[2], g3, carry[0], seed32, 2, out=out9),
        "replay_bwd_step_plain": lambda: GK.replay_bwd_step_ref(
            rec[2], g3, carry[0], seed32, 2, out=out9),
        "replay_bwd_fused": lambda: GK.replay_bwd_fused(rec, g3, zero9[0],
                                                        seed32),
        "replay_bwd_fused_plain": lambda: GK.replay_bwd_fused_ref(
            rec, g3, zero9[0], seed32),
        "inline": lambda: K8.trace_inline(sc0, o8, d8, seed8, DEPTH),
        "inline_plain": lambda: K8.trace_inline_ref(sc0, o8, d8, seed8,
                                                    DEPTH),
    }
    setups = {"record_shade": lambda: live_st[0].copy_(st2),
              "replay_bwd_step": lambda: carry[0].copy_(cot2),
              "replay_bwd_fused": lambda: zero9[0].zero_()}
    dev_ms, call = {}, {}
    for name, fn in fns.items():
        plain_fn = name.endswith("_plain")
        setup = setups.get(name.removesuffix("_plain"))
        n = 5 if plain_fn else 50
        dev_ms[name] = device_ms(fn, n, setup=setup, sleep_cycles=(
            3_000_000_000 if plain_fn else 100_000_000))
        call[name] = call_ms(fn, n, setup=setup)
    stats = {}
    K8.trace_inline_ref(sc0, o8, d8, seed8, DEPTH, stats=stats)
    lane_bounces = sum(stats["live"])
    n_sph = sc0.n_spheres
    # Bytes counted from this run's alive flags: a live lane or slot moves
    # all its words; a dead one reads its flag and writes what the kernel
    # writes for it (K7a: a zero 21-word slot; K7b, K7c: 9 zero rows).
    live_rec = rec[:, 10].view(torch.int32) != 0
    live_slot2 = int(live_rec[2].sum())
    live_slots = int(live_rec.sum())
    lanes_c = int(live_rec.any(0).sum())
    bounds = {
        # every lane's flag; live: 12 state words, t and the winner's index
        # in, the 21-word slot and 13 state words out; dead: the zero slot
        # out; the [N, 10] table once.
        "record_shade": bound(
            R * 4 + (R - live2) * GK.N_REC * 4
            + live2 * ((12 + 1 + 1) + (GK.N_REC + 13)) * 4
            + amat.numel() * 4,
            live2 * (SHADE_OPS + ADVANCE_OPS)),
        # every lane's flag; live: 20 more slot words, 3 radiance
        # cotangents and the carry in, the carry and 9 rows out; dead: 9
        # zero rows out.
        "replay_bwd_step": bound(
            R * 4 + (R - live_slot2) * 9 * 4
            + live_slot2 * ((20 + 3 + 9) + (9 + 9)) * 4,
            live_slot2 * ADJOINT_OPS),
        # lanes with a live slot: 3 radiance cotangents and the carry in,
        # the carry out; every slot's flag; live slots: 20 more words in,
        # 9 rows out; dead slots: 9 zero rows out.
        "replay_bwd_fused": bound(
            lanes_c * (3 + 9 + 9) * 4 + DEPTH * R * 4
            + (DEPTH * R - live_slots) * 9 * 4
            + live_slots * (20 + 9) * 4,
            live_slots * ADJOINT_OPS),
        # rays in, radiance out, the sphere table once; the sweep and shade
        # of every bounce a lane runs.
        "inline": bound(L8 * (6 + 3) * 4 + 11 * n_sph * 4,
                        lane_bounces * (SWEEP_RAY_OPS
                                        + SWEEP_SPHERE_OPS * n_sph
                                        + SHADE_OPS + ADVANCE_OPS)),
    }
    emit({"phase": "fit_kernel_times", "card": card, "device_ms": dev_ms,
          "call_ms": call, "bounds": bounds,
          "shapes": "record_shade: bounce 2 of the demo's first pass "
                    "(22 400 lanes); replay_bwd_step: slot 2; "
                    "replay_bwd_fused: the whole 16-slot walk; inline: the "
                    "demo at spp 8 (179 200 lanes, 8 spheres)",
          "inline_lane_bounces": lane_bounces,
          "inline_one_thread_loop_live_share": K8.warp_live_share(
              stats["bounces"])})

    pkg, tpu = "raytracingweekend_jl_tpu_torch/csrc", \
        "raytracingweekend_jl_tpu/ops/pallas"
    rows = [("record_shade", "record_shade.cu", "grad_kernel.py:73",
             max(err_a_inj, err_a_ph), fit_launches),
            ("replay_bwd_step", "replay_bwd.cu", "grad_kernel.py:411",
             max(err_b_inj, err_b_ph), b_launches),
            ("replay_bwd_fused", "replay_bwd.cu", "grad_kernel.py:520",
             max(err_c_inj, err_c_ph), fit_launches),
            ("inline", "inline.cu", "inline_kernel.py:94",
             max(err8_inj, err8_ph), fit_launches)]
    out = []
    for nm, src, tpu_at, e, launched in rows:
        row = kernel_row(nm, f"{pkg}/{src}", f"{tpu}/{tpu_at}", e,
                         dev_ms[nm], dev_ms[nm + "_plain"], bounds[nm])
        row["launches"] = launched[nm]
        out.append(row)
    inputs = dict(R=R, st2=st2, t2=t2, idx2=idx2, amat=amat, rec=rec, g3=g3,
                  cot2=cot2, seed32=seed32, sc0=sc0, o8=o8, d8=d8,
                  seed8=seed8, scene0=scene0, cam=cam, target=target, W=W,
                  H=H, SPP=SPP, pair_ms=dev_ms, losses=losses)
    return out, dev_ms, call, inputs


#: Float operations of a lane that starts its pixel's next sample in K9
#: (jitter, the concentric map, the thin-lens ray and its normalisation).
REGEN_OPS = 40


def mega_bound(fs, ist, spheres) -> dict:
    """K12's bound on the pinned state ``fs``/``ist``: per active lane, 15
    state words in and out and the film coordinates in; per idle lane, its
    flag read; the two tables and the camera once. Active lanes: the
    sweep, the shade and the regeneration (an upper count); their hits:
    the advance."""
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    n, n_sph = fs.shape[1], spheres.shape[0]
    active = ist[2] != 0
    n_active = int(active.sum())
    t, _ = K1.sweep(fs[0:6].contiguous(), spheres)
    hit_live = int((active & (t < K1.BIG)).sum())
    return bound(n_active * (15 * 4 * 2 + 8) + (n - n_active) * 4
                 + n_sph * (16 + 40) + 21 * 4,
                 n_active * (SWEEP_RAY_OPS + SWEEP_SPHERE_OPS * n_sph
                             + SHADE_OPS + REGEN_OPS)
                 + hit_live * ADVANCE_OPS)


def pinned_fetch_bound(ist, t, n_sph: int) -> dict:
    """K9's bound on the pinned state ``ist`` with the sweep's ``t``: per
    active lane, 15 state words in and out, t, the winner's index, the film
    coordinates and the winner's 40-byte row in (176 B); per idle lane, its
    flag read (its state does not change); the attribute table and the
    camera once. Shade operations of the active lanes, the regeneration of
    every active lane (an upper count: only finished rays regenerate), the
    advance of the active hits."""
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    n = t.shape[0]
    active = ist[2] != 0
    n_active = int(active.sum())
    hit_live = int((active & (t < K1.BIG)).sum())
    return bound(n_active * (15 * 4 * 2 + 4 + 4 + 8 + 40)
                 + (n - n_active) * 4 + n_sph * 40 + 21 * 4,
                 n_active * (SHADE_OPS + REGEN_OPS) + hit_live * ADVANCE_OPS)


def grid_bound(n_rays: int, tabs, reach_pairs: int) -> dict:
    """K13's bound: rays in, t and idx out, each warp's count out, the
    tables once; every ray against the global spheres and every bound, and
    each ray against the slots of the clusters its own bound test reaches
    (a lane its warp carries through a cluster it cannot reach changes
    nothing of the result)."""
    n_warps = -(-n_rays // 32)
    return bound(
        n_rays * (24 + 8) + n_warps * 4
        + (tabs.n_global + tabs.K * tabs.P) * (16 + 4) + tabs.K * 16,
        n_rays * (SWEEP_RAY_OPS + SWEEP_SPHERE_OPS * (tabs.n_global + tabs.K))
        + SWEEP_SPHERE_OPS * tabs.P * reach_pairs)


def sweep_fetch_bound(n_rays: int, n_sph: int) -> dict:
    """K10's bound: rays in (24 B), t, idx and 10 attributes out (48 B), the
    two tables once; every ray against every sphere."""
    return bound(n_rays * (24 + 48) + n_sph * (16 + 40),
                 n_rays * (SWEEP_RAY_OPS + SWEEP_SPHERE_OPS * n_sph))


def field_stats(ga, gb) -> dict:
    """Per field of two ``SceneGrads``: cosine and norm ratio (1.0 each
    when both are zero)."""
    import raytracingweekend_jl_tpu_torch as pt
    out = {}
    for f in pt.DIFF_FIELDS:
        a = getattr(ga, f).double().ravel().cpu()
        b = getattr(gb, f).double().ravel().cpu()
        na, nb = a.norm().item(), b.norm().item()
        cos = 1.0 if na == nb == 0 else (a @ b).item() / max(na * nb, 1e-300)
        out[f] = {"cosine": cos,
                  "norm_ratio": 1.0 if na == nb == 0 else na / max(nb, 1e-300)}
    return out


def trace_slice_phases(dev, card, scene, cam, rays, lin_strided,
                       W: int = 1920, H: int = 1080, SPP: int = 4) -> list:
    """The fixed-depth wavefront and the pixel-pinned route at the flagship
    configuration: K10 and K9 against their plain versions, the backward of
    K1 and K10 on the card against the CPU, the default ``render`` through
    ``trace`` (K1, then K10 with ``fused_attrs``), a non-contiguous tile
    through K9, the remat gradient step and the twin-AD canary. Returns the
    K10 and K9 rows of the ``kernels`` line with their main-path launches:
    the ``fused_attrs`` render for K10, the even-rows tile for K9."""
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch import grad as G
    from raytracingweekend_jl_tpu_torch.ops import integrator as I
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
    from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat

    spheres, amat = K1.sphere_consts(scene), attr_mat(scene)
    n_sph = spheres.shape[0]
    g = torch.Generator(device=dev).manual_seed(4)
    long_sleep = 3_000_000_000

    # -- K10 against sweep_fetch_ref: the K1 phase's 2^20 rays --------------
    t10, i10, a10 = K1.sweep_fetch(rays, spheres, amat)
    torch.cuda.synchronize()
    t10r, i10r, a10r = K1.sweep_fetch_ref(rays, spheres, amat)
    t1, _ = K1.sweep(rays, spheres)
    idx_same = bool(torch.equal(i10, i10r))
    t_is_k1 = bool(torch.equal(t10, t1))
    attrs_same = bool(torch.equal(a10, a10r))
    k10_err = max((t10 - t10r).abs().max().item(),
                  (a10 - a10r).abs().max().item())
    emit({"phase": "k10_vs_plain", "card": card, "rays": rays.shape[1],
          "spheres": n_sph, "idx_identical": idx_same,
          "t_bitwise_k1": t_is_k1, "attrs_identical": attrs_same,
          "t_bit_equal_share_plain": (t10 == t10r).float().mean().item(),
          "max_abs_err": k10_err,
          "tolerance": "idx identical to the plain version; t bitwise "
                       "K1's; attribute planes equal"})
    check(idx_same and t_is_k1 and attrs_same, "K10 differs")
    k10_ms = device_ms(lambda: K1.sweep_fetch(rays, spheres, amat), 20)
    k10_plain_ms = device_ms(lambda: K1.sweep_fetch_ref(rays, spheres, amat),
                             3, sleep_cycles=long_sleep)
    k10_bound = sweep_fetch_bound(rays.shape[1], n_sph)

    # -- K9 against shade_and_regen_fetch_ref: the whole flagship film
    # pinned, 2 073 600 lanes, after 24 iterations ------------------------
    u_px, v_px = pt.pixel_coords(W, H, device=dev)
    n = u_px.shape[0]
    org, d = I.pinned_start_rays(cam, u_px, v_px, 0, 0, float(W), float(H))
    fs = torch.zeros((12, n), device=dev)
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=torch.int32, device=dev)
    ist[2] = 1
    cc = K2.pack_camera_consts(cam, W, H)
    seed32, last = 0x9E3779B9, SPP - 1
    for it in range(24):
        tt, ti = K1.sweep(fs[0:6], spheres)
        K2.shade_and_regen_fetch(fs, ist, tt, ti, amat, u_px, v_px, cc,
                                 seed32, it, last, 16)
    tt, ti = K1.sweep(fs[0:6], spheres)
    torch.cuda.synchronize()

    def k9_compare(u9):
        a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
        K2.shade_and_regen_fetch(*a, tt, ti, amat, u_px, v_px, cc, seed32, 24,
                                 last, 16, u9)
        torch.cuda.synchronize()
        K2.shade_and_regen_fetch_ref(*b, tt, ti, amat, u_px, v_px, cc, seed32,
                                     24, last, 16, u9)
        return lanes_outside([(a[0], b[0])], 1e-6, [(a[1], b[1])])

    bad9_inj, err9_inj = k9_compare(torch.rand((9, n), generator=g,
                                               device=dev))
    bad9_ph, err9_ph = k9_compare(None)
    n_active = int((ist[2] != 0).sum())
    emit({"phase": "k9_vs_plain", "card": card, "lanes": n,
          "iteration": 24, "active_lanes": n_active,
          "lanes_outside_injected_u9": bad9_inj,
          "max_abs_err_injected": err9_inj, "lanes_outside_philox": bad9_ph,
          "max_abs_err_philox": err9_ph,
          "tolerance": "int planes identical, float planes within "
                       "1e-6*max(1,|x|), on >= 99.99% of lanes"})
    limit = int(1e-4 * n)
    check(bad9_inj <= limit and bad9_ph <= limit,
          f"K9: {bad9_inj} / {bad9_ph} lanes outside")
    live = [fs.clone(), ist.clone()]

    def restore():
        live[0].copy_(fs)
        live[1].copy_(ist)

    k9_ms = device_ms(lambda: K2.shade_and_regen_fetch(
        *live, tt, ti, amat, u_px, v_px, cc, seed32, 24, last, 16), 20,
        setup=restore)
    k9_plain_ms = device_ms(lambda: K2.shade_and_regen_fetch_ref(
        *live, tt, ti, amat, u_px, v_px, cc, seed32, 24, last, 16), 3,
        setup=restore, sleep_cycles=long_sleep)
    k9_bound = pinned_fetch_bound(ist, tt, n_sph)
    del live
    emit({"phase": "k9_k10_times", "card": card,
          "device_ms": {"sweep_fetch": k10_ms, "sweep_fetch_plain":
                        k10_plain_ms, "shade_pinned": k9_ms,
                        "shade_pinned_plain": k9_plain_ms},
          "bounds": {"sweep_fetch": k10_bound, "shade_pinned": k9_bound},
          "shapes": "sweep_fetch: the K1 phase's 2^20 rays, 488 spheres; "
                    "shade_pinned: 2 073 600 pinned lanes at iteration 24 "
                    f"({n_active} active), Philox draws"})

    # -- the backward of K1 and K10 on the card against the CPU -----------
    n_v = min(1 << 16, rays.shape[1])
    o_v, d_v = rays[0:3, :n_v].T.contiguous(), rays[3:6, :n_v].T.contiguous()
    g_t = torch.randn(n_v, generator=g, device=dev)
    g_a = torch.randn((n_v, 10), generator=g, device=dev)

    def vjp(device, fused):
        sc = scene.to(device)
        leaves = [o_v.to(device).requires_grad_(),
                  d_v.to(device).requires_grad_()] + [
            getattr(sc, f).clone().requires_grad_() for f in pt.DIFF_FIELDS]
        s2 = sc._replace(**dict(zip(pt.DIFF_FIELDS, leaves[2:])))
        if fused:
            h, attrs = K1.intersect_fetch_kernel(leaves[0], leaves[1], s2)
            outs = [h.t] + list(attrs[:5])
            cots = [g_t] + [g_a[:, 0:3], g_a[:, 3], g_a[:, 4:7], g_a[:, 7],
                            g_a[:, 8]]
        else:
            h = K1.intersect_spheres_kernel(leaves[0], leaves[1], s2)
            outs, cots = [h.t], [g_t]
        used = leaves if fused else leaves[:4]
        out = torch.autograd.grad(outs, used, [c.to(device) for c in cots])
        return [x.double().cpu() for x in out]

    vjp_rows = {}
    for fused in (False, True):
        card_a, card_b = vjp(dev, fused), vjp(dev, fused)
        cpu = vjp(torch.device("cpu"), fused)
        names = ("origin", "direction") + (pt.DIFF_FIELDS if fused
                                           else ("center", "radius"))
        cos = {}
        for nm, a, b in zip(names, card_a, cpu):
            na, nb = a.norm().item(), b.norm().item()
            cos[nm] = 1.0 if na == nb == 0 else \
                (a.ravel() @ b.ravel()).item() / max(na * nb, 1e-300)
        rep = all(torch.equal(x, y) for x, y in zip(card_a, card_b))
        vjp_rows["k10" if fused else "k1"] = {"cosines": cos,
                                              "bitwise_repeat": rep}
        check(rep, f"{'K10' if fused else 'K1'} backward not repeatable")
        check(all(abs(c - 1) <= 1e-6 for c in cos.values()),
              f"{'K10' if fused else 'K1'} backward card vs CPU: {cos}")
    emit({"phase": "sweep_vjp", "card": card, "rays": n_v, **vjp_rows,
          "tolerance": "card against CPU: field cosines 1.0 within 1e-6; "
                       "two card calls bitwise equal"})

    # -- the default render through trace: K1, then K10 ---------------------
    flag_scene, flag_cam = pt.scene_random_spheres(seed=1), pt.t_cam1()

    def trace_render(**kw):
        t0 = time.perf_counter()
        out = pt.render(flag_scene, flag_cam, W, SPP, device="cuda", **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    route = {}
    for fa in (False, True):
        trace_render(fused_attrs=fa)  # warm-up
        reset_counts()
        sec0, img = trace_render(fused_attrs=fa)
        launches = counts()
        secs = sorted([sec0] + [trace_render(fused_attrs=fa)[0]
                                for _ in range(4)])
        lin = (img * img).mean((0, 1))
        rel = ((lin - lin_strided) / lin_strided).abs().max().item()
        route["fused_attrs" if fa else "k1"] = {
            "launches": launches, "seconds_runs": secs,
            "seconds_median": secs[2], "mpaths_per_s": W * H * SPP
            / secs[2] / 1e6, "means": lin.tolist(),
            "max_rel_diff_strided": rel}
        check(tuple(img.shape) == (H, W, 3)
              and bool(torch.isfinite(img).all()), "bad trace image")
        check(rel <= 0.01, f"trace means differ from strided by {rel}")
        want = ("sweep_fetch", "sweep") if fa else ("sweep", "sweep_fetch")
        check(launches[want[0]] == 16 * SPP and launches[want[1]] == 0,
              f"trace (fused_attrs={fa}) launched {launches}")
    k10_launches = route["fused_attrs"]["launches"]["sweep_fetch"]
    sec_plain, img_plain = trace_render(impl="plain")
    lin_p = (img_plain * img_plain).mean((0, 1))
    rel_p = ((lin_p - lin_strided) / lin_strided).abs().max().item()
    emit({"phase": "trace_render", "card": card, "size": [W, H], "spp": SPP,
          "route": "fixed-depth wavefront (the default persistent=False), "
                   "one pass per sample, 16 bounces per pass",
          **route, "seconds_plain": sec_plain,
          "mpaths_per_s_plain": W * H * SPP / sec_plain / 1e6,
          "max_rel_diff_plain_strided": rel_p,
          "tolerance": "each channel mean within 1% of the strided route's; "
                       "16 sweeps per pass"})
    check(rel_p <= 0.01, f"plain trace means differ by {rel_p}")
    emit({"phase": "trace_profile", "card": card, **profile_call(
        lambda: pt.render(flag_scene, flag_cam, W, SPP, device="cuda"))})

    # -- a non-contiguous tile through K9: the even rows --------------------
    rows = torch.arange(W * H, device=dev).reshape(H, W)[::2].reshape(-1)
    tu, tv = u_px[rows].contiguous(), v_px[rows].contiguous()
    sc_d = pt.trim_scene(flag_scene.to(dev))
    cam_d = flag_cam.to(dev)

    def tile(**kw):
        t0 = time.perf_counter()
        out = pt.render_tile_sum(sc_d, cam_d, rows.numel(), 7, SPP, 0, 16,
                                 1e-4, float(W), float(H), persistent=True,
                                 u=tu, v=tv, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out / SPP

    tile()  # warm-up
    reset_counts()
    sec_t, tile_img = tile()
    tile_launches = counts()
    secs_t = sorted([sec_t] + [tile()[0] for _ in range(2)])
    strided_rows = pt.render_radiance(
        flag_scene, flag_cam, W, SPP, seed=8, device="cuda",
        persistent=True).reshape(-1, 3)[rows]
    m_t, m_s = tile_img.mean(0), strided_rows.mean(0)
    rel_t = ((m_t - m_s) / m_s).abs().max().item()
    emit({"phase": "pinned_render", "card": card, "size": [W, H],
          "tile": "even rows", "pixels": rows.numel(), "spp": SPP,
          "launches": tile_launches, "seconds_runs": secs_t,
          "seconds_median": secs_t[1],
          "mpaths_per_s": rows.numel() * SPP / secs_t[1] / 1e6,
          "means": m_t.tolist(), "means_strided_rows": m_s.tolist(),
          "max_rel_diff": rel_t,
          "tolerance": "each channel mean within 1% of the strided "
                       "route's on the same rows"})
    check(tile_launches["shade_pinned"] > 0 and tile_launches["sweep"] > 0
          and tile_launches["gather"] == 0,
          f"pinned tile launched {tile_launches}")
    check(bool(torch.isfinite(tile_img).all()) and rel_t <= 0.01,
          f"pinned tile means differ by {rel_t}")
    k9_launches = tile_launches["shade_pinned"]

    # -- the remat gradient step (grad_bench's remat_chunk512k and
    # fusedattrs_remat_chunk512k rows) -------------------------------------
    scene_b = pt.scene_random_spheres(seed=1)
    bad = scene_b._replace(albedo=torch.clamp(scene_b.albedo * 0.8, 0, 1))
    target = pt.render_radiance(scene_b, flag_cam, W, 1, seed=123,
                                device=dev, persistent=True)
    remat = dict(recorded=False, remat=True, pixel_chunk=1 << 19)

    def step(**kw):
        out = pt.render_grads(bad, flag_cam, target, W, 1, device=dev, **kw)
        torch.cuda.synchronize()
        return out

    default = step()
    # Two default steps on other draws: how far two independent estimates of
    # each field lie apart at spp 1.
    default_spread = field_stats(step(seed=1)[1], default[1])
    steps, grads = {}, {}
    for fa in (False, True):
        step(fused_attrs=fa, **remat)  # warm-up
        reset_counts()
        first = step(fused_attrs=fa, **remat)
        launches = counts()
        again = step(fused_attrs=fa, **remat)
        bitwise = bool(torch.equal(first[0], again[0])) and all(
            torch.equal(x, y) for x, y in zip(first[1], again[1]))
        pt.check_grads_sane(first[1], first[0])
        grads[fa] = first[1]
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            step(fused_attrs=fa, **remat)
            secs.append(time.perf_counter() - t0)
        torch.cuda.reset_peak_memory_stats()
        step(fused_attrs=fa, **remat)
        peak = torch.cuda.max_memory_allocated()
        vs_default = field_stats(first[1], default[1])
        sec = sorted(secs)[2]
        steps["fused_attrs" if fa else "k1"] = {
            "launches": launches, "loss": float(first[0]),
            "bitwise_repeat": bitwise, "seconds_runs": secs,
            "seconds_median": sec, "mpaths_per_s": W * H / sec / 1e6,
            "peak_allocated_bytes": peak, "vs_default_step": vs_default}
        check(bitwise, f"two remat steps differ (fused_attrs={fa})")
        alb = vs_default["albedo"]
        check(0.25 < alb["norm_ratio"] < 4 and alb["cosine"] > 0.5,
              f"remat step against the default step: {vs_default}")
    fa_vs_k1 = field_stats(grads[True], grads[False])
    emit({"phase": "remat_grad_step", "card": card, "size": [W, H],
          "spp": 1, "pixel_chunk": 1 << 19, "route": "recorded=False, "
          "remat=True: autograd through trace, each bounce recomputed",
          **steps, "fused_attrs_vs_k1": fa_vs_k1,
          "loss_default_step": float(default[0]),
          "default_vs_default_other_seed": default_spread,
          "tolerance": "two steps bitwise equal; against the default "
                       "persistent-record step (other draws) the albedo "
                       "gradient's norm ratio within 0.25-4 and cosine "
                       "> 0.5; the other fields are reported beside the "
                       "spread of two default steps on other draws"})
    emit({"phase": "remat_profile", "card": card, **profile_call(
        lambda: step(**remat))})

    # -- finite differences of the remat route in sphere 0's albedo, 480x270
    w2 = 480
    target2 = pt.render_radiance(scene_b, flag_cam, w2, 1, seed=123,
                                 device=dev, persistent=True)
    lf = lambda img, tgt: ((img.double() - tgt.double()) ** 2).mean()
    kw2 = dict(device=dev, seed=9, loss_fn=lf, recorded=False, remat=True)
    _, g_fd = pt.render_grads(bad, flag_cam, target2, w2, 1, **kw2)
    eps, fd_rows = 1e-3, []
    for c in range(3):
        losses = []
        for sgn in (1.0, -1.0):
            alb = bad.albedo.clone()
            alb[0, c] += sgn * eps
            with torch.no_grad():
                losses.append(float(pt.render_loss(
                    bad._replace(albedo=alb), flag_cam, target2, w2, 1,
                    **kw2)))
        fd = (losses[0] - losses[1]) / (2 * eps)
        an = float(g_fd.albedo[0, c])
        fd_rows.append({"channel": c, "fd": fd, "grad": an,
                        "rel_err": abs(fd - an) / max(abs(an), 1e-30)})
    emit({"phase": "remat_grad_fd", "card": card, "size": [w2, w2 * 9 // 16],
          "sphere": 0, "eps": eps, "channels": fd_rows,
          "tolerance": "within 1e-2 relative"})
    for r in fd_rows:
        check(r["rel_err"] <= 1e-2, f"remat FD check failed: {r}")

    # -- the twin-AD canary: the kernel pair against the remat twin, on the
    # scene of the JAX package's own canary test, at 256 wide and spp 64.
    # The center, radius and fuzz gradients are heavy-tailed: one path with
    # a grazing hit (1 / (p . d)), a fuzz-0 mirror or glass near its
    # critical angle can carry most of a field at spp 8, so two estimates on
    # other draws can lie outside the 4x rule whichever route makes them
    # (remat_grad_step's default_vs_default_other_seed). The spp-8 ratios
    # of the canary's seed and two others are reported, not checked. -------
    s4, c4 = pt.scene_4_spheres(), pt.t_default_cam()
    target4 = pt.render_radiance(s4, c4, 256, 1, seed=123, device=dev)
    bad4 = s4._replace(albedo=torch.clamp(s4.albedo * 0.8, 0, 1))
    spp8 = {}
    for seed in (5, 6, 7):
        _, g_rec = pt.render_grads(bad4, c4, target4, 256, 8, seed=seed,
                                   device=dev)
        _, g_ref = pt.render_grads(bad4, c4, target4, 256, 8, seed=seed,
                                   device=dev, recorded=False, remat=True)
        spp8[seed] = {f: v["norm_ratio"]
                      for f, v in field_stats(g_rec, g_ref).items()}
    t0 = time.perf_counter()
    G.twin_ad_canary(s4, c4, 256, 64, device=dev)
    emit({"phase": "twin_ad_canary", "card": card, "width": 256, "spp": 64,
          "scene": "4_spheres", "seconds": time.perf_counter() - t0,
          "passed": True,
          "checks": "per-field norm ratio 0.25-4, albedo cosine > 0.5",
          "spp8_norm_ratios_by_seed": spp8})

    pkg, tpu = "raytracingweekend_jl_tpu_torch/csrc", \
        "raytracingweekend_jl_tpu/ops/pallas"
    rows_out = [kernel_row("sweep_fetch", f"{pkg}/sweep.cu",
                           f"{tpu}/intersect_kernel.py:389", k10_err, k10_ms,
                           k10_plain_ms, k10_bound),
                kernel_row("shade_pinned", f"{pkg}/shade_pinned.cu",
                           f"{tpu}/shade_kernel.py:343",
                           max(err9_inj, err9_ph), k9_ms, k9_plain_ms,
                           k9_bound)]
    rows_out[0]["launches"] = k10_launches
    rows_out[1]["launches"] = k9_launches
    return rows_out


def _strided_perm(n: int, k: int):
    """The strided route's lane order (``scripts/spatial_probe.py``): lane
    ``l`` serves pixels ``l, l + n/k, ...``."""
    import numpy as np
    stride = n // k
    idx = np.arange(n)
    return np.argsort((idx % stride) * k + idx // stride, kind="stable")


def _tile_perm(W: int, H: int, tw: int, th: int):
    """Pixels reordered into ``tw x th`` image tiles
    (``scripts/spatial_probe.py``)."""
    import numpy as np
    i, j = np.mgrid[0:H, 0:W]
    key = ((i // th) * ((W + tw - 1) // tw) + (j // tw)) * (W * H) \
        + (i % th) * tw + (j % tw)
    return np.argsort(key.ravel(), kind="stable")


def _bits(x):
    """A tensor's bit pattern (floats as int32), for bitwise comparisons."""
    import torch
    return x.contiguous().view(torch.int32) if x.is_floating_point() else x


def _bitwise_lanes(pairs, n: int):
    """Per lane (last axis of length ``n``): any word of any pair differs."""
    diffs = [(_bits(a).reshape(-1, n) != _bits(b).reshape(-1, n)).any(0)
             for a, b in pairs]
    for d in diffs[1:]:
        diffs[0] |= d
    return diffs[0]


def _k13_vs_k1(o, d, center, radius, t13, i13, t1, i1, start=None,
               tmin: float = 1e-4) -> dict:
    """K13's hits against K1's on the same rays. Both evaluate the expanded
    half-b quadratic in float32 from a ``ck`` rounded differently (float64
    in ``build_grid``, float32 in ``sphere_consts``). Where the two pick the
    same winner, t may differ by the quadratic's rounding: each lies within
    4x its first-order bound of the exact root (``tests/test_torch_
    intersect.py`` ``test_dot_form_sweep_matches_jax``), so the gap is held
    within 4x the sum of the two bounds. Where they disagree on the hit or
    the winner, the nearer of the two candidates must be a root that one
    rounding of ``ck`` keeps and the other drops: a grazed sphere (float64
    ``sqrt(disc)`` at most 5% of its radius) or, on a ray that leaves a
    sphere (``start``, the index of that sphere per ray, -1 where the ray
    leaves none), a root of that same sphere within 4x its bound of
    ``tmin``. Returns the counts; ``differing_unexplained`` must be 0."""
    import torch
    f64 = torch.float64
    o, d = o.to(f64), d.to(f64)
    big = 3.0e38
    h13, h1 = t13 < big, t1 < big
    both = h13 & h1
    same = both & (i13 == i1)
    u = 2.0 ** -24

    def first_order(idx, t):
        c, r = center[idx.long()].to(f64), radius[idx.long()].to(f64)
        ck = (c * c).sum(-1) - r * r
        od, cd = (o * d).sum(-1), (c * d).sum(-1)
        oc, oo = (o * c).sum(-1), (o * o).sum(-1)
        hb = od - cd
        disc = hb * hb - (oo - 2 * oc + ck)
        return (u * (hb * hb + oo + 2 * oc.abs() + ck.abs()
                     + 2 * (od.abs() + cd.abs()) * hb.abs())
                / disc.clamp(min=1e-300).sqrt() + 2 * u * t.to(f64).abs())

    gap = (t13.to(f64) - t1.to(f64)).abs() / (first_order(i13, t13)
                                              + first_order(i1, t1))
    rel = (t13 - t1).abs() / t1.abs().clamp(min=1e-30)
    differ = (h13 != h1) | (both & (i13 != i1))
    near13 = h13 & (~h1 | (t13 <= t1))
    near, t_near = torch.where(near13, i13, i1), torch.where(near13, t13, t1)
    oc = o - center[near.long()].to(f64)
    b = (oc * d).sum(-1)
    r = radius[near.long()].to(f64)
    disc = b * b - ((oc * oc).sum(-1) - r * r)
    grazed = differ & (disc.clamp(min=0).sqrt() <= 0.05 * r)
    at_tmin = differ & ((t_near.to(f64) - tmin).abs()
                        <= 4 * first_order(near, t_near)) & (
        torch.zeros_like(differ) if start is None else near == start)
    return {"rays_hit_differs_k1": int((h13 != h1).sum()),
            "rays_idx_differs_k1": int((both & (i13 != i1)).sum()),
            "differing_grazing": int(grazed.sum()),
            "differing_root_at_tmin": int((at_tmin & ~grazed).sum()),
            "differing_unexplained": int((differ & ~grazed & ~at_tmin).sum()),
            "rays_t_outside_5e-5_k1": int((same & (rel > 5e-5)).sum()),
            "t_max_rel_diff_k1": rel[same].max().item(),
            "t_max_gap_over_rounding_bound": gap[same].max().item()}


def fused_record_bound(lanes: int, n_live: int, n_miss: int, n_regen: int,
                       n_sph: int) -> dict:
    """K11's bound for one iteration: every lane's flag in and winner out;
    a dead lane a zero slot; a live lane 9 + 2 state words in (its ray read
    once), the 21-word slot and 9 + 3 state words out; a miss banks 3
    words, a regeneration reads 6 strip words; the two tables once. Live
    lanes: the sweep, the shade and the advance."""
    from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
    return bound(
        lanes * (4 + 4) + (lanes - n_live) * PK.N_REC * 4
        + n_live * ((9 + 2) + (PK.N_REC + 9 + 3)) * 4 + n_miss * 3 * 4
        + n_regen * 6 * 4 + n_sph * (16 + 40),
        n_live * (SWEEP_RAY_OPS + SWEEP_SPHERE_OPS * n_sph + SHADE_OPS
                  + ADVANCE_OPS))


def last_kernel_phases(dev, card, snap, W: int = 1920, H: int = 1080,
                       SPP: int = 4) -> list:
    """The last three TPU kernels and their paths. K11 (the fused record
    step) against its plain version and against the iteration it fuses
    (K3, then K4 with its winner fetch) at the K3/K4 shape, then the
    flagship gradient
    step through ``trace_recorded_persist(fused_step=True)``; K12 (the
    megakernel) against its plain version and the pinned iteration at K9's
    shape, then the flagship render through ``persistent_render_sum_mega``;
    K13 (the cluster sweep) against its plain version and K1 on the
    flagship's camera and bounce-1 rays in the lane orders of
    ``scripts/spatial_probe.py``. Returns the three rows of the ``kernels``
    line with their main-path launches."""
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops import integrator as I
    from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG
    from raytracingweekend_jl_tpu_torch.ops.cuda import grid_kernel as K13
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.cuda import mega_kernel as K12
    from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
    from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
    from raytracingweekend_jl_tpu_torch.ops.experimental import grid as GR
    from raytracingweekend_jl_tpu_torch.ops.experimental import mega as MG
    from raytracingweekend_jl_tpu_torch.ops.materials import fetch_attr_planes

    g = torch.Generator(device=dev).manual_seed(11)
    long_sleep = 3_000_000_000
    strips, spheres, amat = snap["strips"], snap["spheres"], snap["amat"]
    SEED, DEPTH, IT = snap["seed"], snap["depth"], snap["iteration"]
    lanes, n_sph = snap["sf"].shape[1], spheres.shape[0]
    i32 = torch.int32

    # -- K11 against its plain version and the iteration it fuses (K3, K4),
    # at the K3/K4 row's shape: 262 144 lanes before iteration 20 ---------
    def k11_run(fn, u5=None):
        sf, si, rad = snap["sf"].clone(), snap["si"].clone(), snap["rad"].clone()
        slot = torch.zeros((PK.N_REC, lanes), device=dev)
        idx = torch.zeros(lanes, dtype=i32, device=dev)
        fn(sf, si, rad, slot, idx, u5)
        torch.cuda.synchronize()
        return sf, si, rad, slot, idx

    def fused(step):
        return lambda sf, si, rad, slot, idx, u5: step(
            strips, sf, si, rad, slot, idx, spheres, amat, SEED, IT, DEPTH,
            1e-4, u5)

    def three(sf, si, rad, slot, idx_out, u5=None):  # K3, then K4
        t, idx = K1.sweep_masked(sf[0:6], si[2], spheres)
        PK.persist_record_step(t, idx, amat, strips, sf, si, rad, slot, SEED,
                               IT, DEPTH, u5)
        idx_out.copy_(idx)

    floats = [j for j in range(PK.N_REC) if j != 10]

    def k11_compare(u5):
        a = k11_run(fused(PK.persist_record_fused_step), u5)
        b = k11_run(fused(PK.persist_record_fused_step_ref), u5)
        return lanes_outside(
            [(a[0], b[0]), (a[2], b[2]), (a[3][floats], b[3][floats])], 1e-6,
            [(a[1], b[1]), (PK.flags_of(a[3]), PK.flags_of(b[3])),
             (a[4], b[4])])

    bad11_inj, err11_inj = k11_compare(torch.rand((5, lanes), generator=g,
                                                  device=dev))
    bad11_ph, err11_ph = k11_compare(None)
    k11 = k11_run(fused(PK.persist_record_fused_step))
    k3k4 = k11_run(three)
    fl = PK.flags_of(k11[3])
    hit = (fl & PK.F_HIT) != 0
    diff = _bitwise_lanes([(k11[0], k3k4[0]), (k11[1], k3k4[1]),
                           (k11[2], k3k4[2]), (k11[3][0:11], k3k4[3][0:11]),
                           (k11[4], k3k4[4])], lanes)
    diff |= hit & _bitwise_lanes([(k11[3][11:], k3k4[3][11:])], lanes)
    miss_attrs_zero = bool((k11[3][11:, ~hit] == 0).all())
    n_diff = int(diff.sum())
    live = [snap["sf"].clone(), snap["si"].clone(), snap["rad"].clone()]
    slot_t = torch.empty((PK.N_REC, lanes), device=dev)
    idx_t = torch.empty(lanes, dtype=i32, device=dev)

    def restore11():
        for x, y in zip(live, (snap["sf"], snap["si"], snap["rad"])):
            x.copy_(y)

    k11_ms = device_ms(lambda: PK.persist_record_fused_step(
        strips, *live, slot_t, idx_t, spheres, amat, SEED, IT, DEPTH, 1e-4),
        20, setup=restore11)
    k11_plain_ms = device_ms(lambda: PK.persist_record_fused_step_ref(
        strips, *live, slot_t, idx_t, spheres, amat, SEED, IT, DEPTH, 1e-4),
        3, setup=restore11, sleep_cycles=long_sleep)
    three_ms = device_ms(lambda: three(*live, slot_t, idx_t), 20,
                         setup=restore11)
    del live, slot_t, idx_t
    alive = snap["si"][2] != 0
    n_live = int(alive.sum())
    miss11 = int((alive & ~hit).sum())
    regen11 = int(((fl & PK.F_REGEN) != 0).sum())
    k11_bound = fused_record_bound(lanes, n_live, miss11, regen11, n_sph)
    emit({"phase": "k11", "card": card, "lanes": lanes, "strips": 8,
          "iteration": IT, "live_lanes": n_live,
          "lanes_outside_injected_u5": bad11_inj,
          "max_abs_err_injected": err11_inj,
          "lanes_outside_philox": bad11_ph, "max_abs_err_philox": err11_ph,
          "lanes_differing_from_k3_k4": n_diff,
          "miss_lane_attrs_zero": miss_attrs_zero,
          "device_ms": {"persist_record_fused": k11_ms,
                        "persist_record_fused_plain": k11_plain_ms,
                        "k3_k4": three_ms},
          "bound": k11_bound,
          "tolerance": "against the plain version: int planes, flags and "
                       "winners identical, float planes within "
                       "1e-6*max(1,|x|), on >= 99.99% of lanes; against "
                       "K3 + K4 (Philox): every state, radiance "
                       "and winner word, record planes 0-10 on every lane "
                       "and the attribute planes on hit lanes bitwise "
                       "equal; miss lanes record zero attributes"})
    limit = int(1e-4 * lanes)
    check(bad11_inj <= limit and bad11_ph <= limit,
          f"K11: {bad11_inj} / {bad11_ph} lanes outside")
    check(n_diff == 0 and miss_attrs_zero,
          f"K11 differs from K3 + K4 on {n_diff} lanes")

    # -- the flagship gradient step through the fused record step ---------
    flag_scene, flag_cam = pt.scene_random_spheres(seed=1), pt.t_cam1()
    scene_f = pt.trim_scene(flag_scene.to(dev))
    cam_f = flag_cam.to(dev)
    u_px, v_px = pt.pixel_coords(W, H, device=dev)
    o_c, d_c = pt.get_rays(cam_f, u_px, v_px,
                           generator=torch.Generator(device=dev).manual_seed(3))
    target_img = pt.render_radiance(flag_scene, flag_cam, W, 1, seed=123,
                                    device=dev, persistent=True)
    target = target_img.reshape(-1, 3)
    bad = scene_f._replace(albedo=torch.clamp(scene_f.albedo * 0.8, 0, 1))

    def fstep(fused_step, stats=None):
        leaves = [getattr(bad, f).clone().requires_grad_()
                  for f in pt.DIFF_FIELDS]
        sc = bad._replace(**dict(zip(pt.DIFF_FIELDS, leaves)))
        r = PG.trace_recorded_persist(sc, o_c, d_c, 77, 16, 1e-4, 8, None,
                                      fused_step=fused_step, strict=True,
                                      stats=stats)
        loss = torch.mean((r - target) ** 2)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return (loss.detach(), *grads)

    def same(a, b):
        return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))

    bad_cpu = flag_scene._replace(
        albedo=torch.clamp(flag_scene.albedo * 0.8, 0, 1))

    def default_step():
        out = pt.render_grads(bad_cpu, flag_cam, target_img, W, 1, device=dev)
        torch.cuda.synchronize()
        return out

    fstep(True)  # warm-up
    stats = {}
    reset_counts()
    first = fstep(True, stats)
    fused_launches = counts()
    again = fstep(True)
    unfused = fstep(False)
    default_step()  # warm-up
    repeat = same(first, again)
    vs_unfused = same(first, unfused)
    max_diff = {nm: (a.double() - b.double()).abs().max().item()
                for nm, a, b in zip(("loss",) + pt.DIFF_FIELDS, first,
                                     unfused)}
    secs = {"fused": [], "unfused": [], "default": []}
    for _ in range(5):
        for nm, fn in (("fused", lambda: fstep(True)),
                       ("unfused", lambda: fstep(False)),
                       ("default", default_step)):
            t0 = time.perf_counter()
            fn()
            secs[nm].append(time.perf_counter() - t0)
    torch.cuda.reset_peak_memory_stats()
    fstep(True)
    peak = torch.cuda.max_memory_allocated()
    med = {k: sorted(v)[2] for k, v in secs.items()}
    emit({"phase": "fused_step_grad", "card": card, "size": [W, H], "spp": 1,
          "route": "trace_recorded_persist(fused_step=True), 8 strips, "
                   "n_iters None (the worst case), strict; loss: mean "
                   "squared error against the spp-1 target",
          "launches": fused_launches, "dropped": stats["dropped"],
          "iterations": sum(c > 0 for c in stats["phase1_counts"][0]),
          "loss": float(first[0]), "bitwise_repeat": repeat,
          "bitwise_equal_to_unfused": vs_unfused,
          "max_abs_diff_vs_unfused": max_diff, "seconds_runs": secs,
          "seconds_median": med,
          "mpaths_per_s": {k: W * H / v / 1e6 for k, v in med.items()},
          "peak_allocated_bytes": peak,
          "tolerance": "0 dropped paths; two fused steps bitwise equal; "
                       "loss and every field gradient bitwise equal to the "
                       "unfused (8, None) step on the same seed"})
    check(fused_launches["persist_record_fused"] > 0
          and fused_launches["persist_record"] == 0
          and fused_launches["sweep_masked"] == 0
          and fused_launches["persist_replay_fused"] > 0,
          f"fused step launched {fused_launches}")
    check(stats["dropped"] == 0, f"{stats['dropped']} paths dropped")
    check(repeat, "two fused steps differ")
    check(vs_unfused, f"fused step differs from the unfused: {max_diff}")
    del first, again, unfused

    # -- K12 against its plain version and the pinned iteration, at K9's
    # shape: the whole flagship film pinned, 2 073 600 lanes, iteration 24
    n = u_px.shape[0]
    org, d = I.pinned_start_rays(cam_f, u_px, v_px, 0, 0, float(W), float(H))
    fs = torch.zeros((12, n), device=dev)
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=i32, device=dev)
    ist[2] = 1
    cc = K2.pack_camera_consts(cam_f, W, H)
    seed32, last = 0x9E3779B9, SPP - 1
    for it in range(24):
        K12.mega_step(fs, ist, spheres, amat, u_px, v_px, cc, seed32, it, last,
                      16, 1e-4)
    torch.cuda.synchronize()

    def k12_compare(u9):
        a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
        K12.mega_step(*a, spheres, amat, u_px, v_px, cc, seed32, 24, last, 16,
                      1e-4, u9)
        torch.cuda.synchronize()
        K12.mega_step_ref(*b, spheres, amat, u_px, v_px, cc, seed32, 24, last,
                          16, 1e-4, u9)
        return lanes_outside([(a[0], b[0])], 1e-6, [(a[1], b[1])])

    def pinned_iter(fs_, ist_):
        t, idx = K1.sweep(fs_[0:6], spheres)
        K2.shade_and_regen(fs_, ist_, t, fetch_attr_planes(idx, amat), u_px,
                           v_px, cc, seed32, 24, last, 16)

    bad12_inj, err12_inj = k12_compare(torch.rand((9, n), generator=g,
                                                  device=dev))
    bad12_ph, err12_ph = k12_compare(None)
    a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
    K12.mega_step(*a, spheres, amat, u_px, v_px, cc, seed32, 24, last, 16,
                  1e-4)
    pinned_iter(*b)
    torch.cuda.synchronize()
    n_diff12 = int(_bitwise_lanes([(a[0], b[0]), (a[1], b[1])], n).sum())
    del a, b
    live12 = [fs.clone(), ist.clone()]

    def restore12():
        live12[0].copy_(fs)
        live12[1].copy_(ist)

    k12_ms = device_ms(lambda: K12.mega_step(
        *live12, spheres, amat, u_px, v_px, cc, seed32, 24, last, 16, 1e-4),
        20, setup=restore12)
    k12_plain_ms = device_ms(lambda: K12.mega_step_ref(
        *live12, spheres, amat, u_px, v_px, cc, seed32, 24, last, 16, 1e-4),
        3, setup=restore12, sleep_cycles=long_sleep)
    pinned_ms = device_ms(lambda: pinned_iter(*live12), 20, setup=restore12)
    del live12
    n_active = int((ist[2] != 0).sum())
    k12_bound = mega_bound(fs, ist, spheres)
    del fs, ist
    emit({"phase": "k12", "card": card, "lanes": n, "iteration": 24,
          "active_lanes": n_active, "lanes_outside_injected_u9": bad12_inj,
          "max_abs_err_injected": err12_inj,
          "lanes_outside_philox": bad12_ph, "max_abs_err_philox": err12_ph,
          "lanes_differing_from_k1_gather_k9": n_diff12,
          "device_ms": {"mega": k12_ms, "mega_plain": k12_plain_ms,
                        "k1_gather_k9": pinned_ms},
          "bound": k12_bound,
          "tolerance": "against the plain version: int planes identical, "
                       "float planes within 1e-6*max(1,|x|), on >= 99.99% "
                       "of lanes; against K1 + gather + K9 (Philox): every "
                       "state word bitwise equal"})
    limit = int(1e-4 * n)
    check(bad12_inj <= limit and bad12_ph <= limit,
          f"K12: {bad12_inj} / {bad12_ph} lanes outside")
    check(n_diff12 == 0, f"K12 differs from K1 + gather + K9 on {n_diff12} "
                         "lanes")

    # -- the flagship render through the megakernel, beside the pinned and
    # the strided routes ----------------------------------------------------
    def mega():
        return MG.persistent_render_sum_mega(scene_f, cam_f, u_px, v_px, 7,
                                             SPP, 0, 16, 1e-4, float(W),
                                             float(H))

    def pinned():
        return I.persistent_render_sum_fused(scene_f, cam_f, u_px, v_px, 7,
                                             SPP, 0, 16, 1e-4, float(W),
                                             float(H))

    def strided():
        return pt.render_radiance(flag_scene, flag_cam, W, SPP, seed=7,
                                  device=dev, persistent=True)

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    for fn in (mega, pinned, strided):
        fn()  # warm-up
    reset_counts()
    _, img_m = timed(mega)
    mega_launches = counts()
    reset_counts()
    _, img_p = timed(pinned)
    pinned_launches = counts()
    bitwise = bool(torch.equal(_bits(img_m), _bits(img_p)))
    secs = {"mega": [], "pinned": [], "strided": []}
    for _ in range(5):
        for nm, fn in (("mega", mega), ("pinned", pinned),
                       ("strided", strided)):
            secs[nm].append(timed(fn)[0])
    med = {k: sorted(v)[2] for k, v in secs.items()}
    m_m = (img_m / SPP).mean(0)
    m_s = strided().reshape(-1, 3).mean(0)
    rel_s = ((m_m - m_s) / m_s).abs().max().item()
    emit({"phase": "mega_render", "card": card, "size": [W, H], "spp": SPP,
          "launches_mega": mega_launches, "launches_pinned": pinned_launches,
          "bitwise_equal_to_pinned": bitwise, "seconds_runs": secs,
          "seconds_median": med,
          "mpaths_per_s": {k: W * H * SPP / v / 1e6 for k, v in med.items()},
          "means": m_m.tolist(), "means_strided": m_s.tolist(),
          "max_rel_diff_strided": rel_s,
          "tolerance": "the image bitwise the pinned route's (same seed); "
                       "channel means within 1% of the strided route's "
                       "(other draws)"})
    check(mega_launches["mega"] > 0 and mega_launches["sweep"] == 0
          and mega_launches["shade_pinned"] == 0
          and mega_launches["gather"] == 0,
          f"megakernel render launched {mega_launches}")
    check(bitwise, "megakernel image differs from the pinned route's")
    check(bool(torch.isfinite(img_m).all()) and rel_s <= 0.01,
          f"megakernel means differ from strided by {rel_s}")
    del img_m, img_p

    # -- K13 against its plain version and K1: the flagship's camera rays
    # and bounce-1 rays in scripts/spatial_probe.py's lane orders --------
    gtab = GR.build_grid(pt.trim_scene(flag_scene))
    tabs = GR.grid_tables(gtab, dev)
    R = W * H
    rays_c = torch.cat([o_c.T, d_c.T]).contiguous()
    t0_, i0_ = K1.sweep(rays_c, spheres)
    hit0 = t0_ < K1.BIG
    hitp = o_c + torch.where(hit0, t0_, torch.ones_like(t0_))[:, None] * d_c
    nrm = hitp - spheres[i0_.long(), 0:3]
    nrm = nrm / nrm.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    d1 = nrm + pt.unit_sphere_directions((R,), generator=g, device=dev)
    d1 = d1 / d1.norm(dim=-1, keepdim=True).clamp(min=1e-9)
    orders = {"row_major": None,
              "strided_k64": _strided_perm(R, 64),
              "tile32": _tile_perm(W, H, 32, 32),
              "tile128x64": _tile_perm(W, H, 128, 64)}
    cases = {}
    reset_counts()
    left = torch.where(hit0, i0_, torch.full_like(i0_, -1))
    for rs, (oo, dd, st) in (("camera", (o_c, d_c, None)),
                             ("bounce1", (hitp, d1, left))):
        for nm, perm in orders.items():
            if perm is not None:
                p = torch.from_numpy(perm).to(dev)
                oo_, dd_ = oo[p].contiguous(), dd[p].contiguous()
                st_ = None if st is None else st[p]
            else:
                oo_, dd_, st_ = oo, dd, st
            res, skips = GR.intersect_spheres_grid(oo_, dd_, scene_f, gtab)
            cases[f"{rs}_{nm}"] = (oo_, dd_, st_, res, skips)
    grid_launches = counts()["grid_sweep"]
    torch.cuda.synchronize()
    out, err13 = {}, 0.0
    n_warps = -(-R // K13.WARP)
    for key, (oo_, dd_, st_, res, skips) in cases.items():
        rays6 = torch.cat([oo_.T, dd_.T]).contiguous()
        tp, ip, sp, reach_pairs = K13.grid_sweep_ref(rays6, *tabs, 1e-4,
                                                     with_reach=True)
        plain_bitwise = (bool(torch.equal(_bits(res.t), _bits(tp)))
                         and bool(torch.equal(res.index, ip))
                         and bool(torch.equal(skips, sp)))
        err13 = max(err13, (res.t - tp).abs().max().item())
        t1, i1 = K1.sweep(rays6, spheres)
        vs_k1 = _k13_vs_k1(oo_, dd_, scene_f.center, scene_f.radius, res.t,
                           res.index, t1, i1, st_)
        k13_ms = device_ms(lambda: K13.grid_sweep(rays6, *tabs, 1e-4), 20)
        k1_ms = device_ms(lambda: K1.sweep(rays6, spheres), 20)
        culled = int(skips.sum())
        out[key] = {"k13_ms": k13_ms, "k1_ms": k1_ms,
                    "k13_over_k1": k13_ms / k1_ms,
                    "culled_share": culled / (n_warps * tabs.K),
                    "ray_cluster_pairs_reached": reach_pairs,
                    "ray_cluster_pairs_swept": K13.WARP * (
                        n_warps * tabs.K - culled),
                    "plain_bitwise": plain_bitwise, **vs_k1}
        check(plain_bitwise, f"K13 differs from its plain version ({key})")
        check(vs_k1["differing_unexplained"] == 0
              and vs_k1["t_max_gap_over_rounding_bound"] <= 4,
              f"K13 against K1 ({key}): {out[key]}")
        if key == "camera_row_major":
            k13_row_ms = k13_ms
            k13_plain_ms = device_ms(
                lambda: K13.grid_sweep_ref(rays6, *tabs, 1e-4), 2,
                sleep_cycles=long_sleep)
            k13_bound = grid_bound(R, tabs, reach_pairs)
    emit({"phase": "grid_sweep", "card": card, "rays": R,
          "grid": {"n_global": tabs.n_global, "K": tabs.K, "P": tabs.P},
          "launches": grid_launches, "cases": out, "bound_camera_row_major":
          k13_bound,
          "tolerance": "t, idx and skips bitwise equal to the plain version; "
                       "against K1 (ck in float64 here, float32 in K1): "
                       "same-winner hits within 4x the sum of the two "
                       "first-order rounding bounds of the expanded "
                       "quadratic (rays beyond 5e-5 relative counted); a "
                       "ray whose hit or winner differs has its nearer "
                       "candidate grazed (float64 sqrt(disc) <= 5% of the "
                       "radius) or, on a bounce ray, a root of the sphere "
                       "the ray leaves at tmin within 4x its rounding "
                       "bound"})
    check(grid_launches == len(cases), f"grid sweep launched {grid_launches}")

    pkg, tpu = "raytracingweekend_jl_tpu_torch/csrc", \
        "raytracingweekend_jl_tpu/ops/pallas"
    rows = [kernel_row("persist_record_fused", f"{pkg}/persist_record.cu",
                       f"{tpu}/persist_grad_kernel.py:367",
                       max(err11_inj, err11_ph), k11_ms, k11_plain_ms,
                       k11_bound),
            kernel_row("mega", f"{pkg}/mega.cu",
                       f"{tpu}/experimental/mega_kernel.py:45",
                       max(err12_inj, err12_ph), k12_ms, k12_plain_ms,
                       k12_bound),
            kernel_row("grid_sweep", f"{pkg}/grid_sweep.cu",
                       f"{tpu}/experimental/grid_kernel.py:124", err13,
                       k13_row_ms, k13_plain_ms, k13_bound)]
    rows[0]["launches"] = fused_launches["persist_record_fused"]
    rows[1]["launches"] = mega_launches["mega"]
    rows[2]["launches"] = grid_launches
    return rows


def sweep_redesign_phases(dev, card, cam, rays_f, snap, W: int = 1920,
                          H: int = 1080, SPP: int = 4) -> None:
    """K1's split sweep and K3's compacted sweep at the widths the main
    paths give them: K1 at the flagship's 32 400 mid-render lanes, at the
    gradient step's 262 144 lanes (iteration 20, every lane) and at the
    2 073 600 camera rays of one film pass, for the P the wrapper picks and
    for each forced P, beside the kept one-thread kernel (the previous K10:
    the one-thread loop plus its 40-byte fetch) on the same rays; K3 at
    iterations 20 and 40 of the step's record phase; every run bitwise
    against the one-thread kernel; the kernels' registers and
    resident blocks; K1's device time per flagship render and K3's per
    flagship step from the profiler."""
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1

    spheres, amat = snap["spheres"], snap["amat"]
    n_sph = spheres.shape[0]
    g = torch.Generator(device=dev).manual_seed(13)
    u_px, v_px = pt.pixel_coords(W, H, device=dev)
    o, d = pt.get_rays(cam, u_px, v_px, generator=g)
    sets = {"mid_render_32400": rays_f,
            "grad_lanes_262144": snap["k3_states"][20][0].contiguous(),
            "camera_2073600": torch.cat([o.T, d.T]).contiguous()}
    del o, d, u_px, v_px
    resident = K1._resident_threads(dev, n_sph)
    k1, bitwise = {}, {}
    for name, r in sets.items():
        n = r.shape[1]
        bitwise[name] = split_vs_one_thread(r, spheres, amat)
        ms = {("auto" if P is None else str(P)): device_ms(
            lambda P=P: K1.sweep(r, spheres, parts=P), 20)
            for P in SPLIT_PARTS}
        k1[name] = {"rays": n,
                    "parts_chosen": K1.sweep_parts(n, n_sph, resident),
                    "device_ms_by_p": ms,
                    "one_thread_device_ms": device_ms(
                        lambda: K1.sweep_fetch_one_thread(r, spheres, amat),
                        20)}
    k3 = {}
    for it, (r, a) in snap["k3_states"].items():
        ms = {("auto" if P is None else str(P)): device_ms(
            lambda P=P: K1.sweep_masked(r, a, spheres, parts=P or 0), 20)
            for P in SPLIT_PARTS}
        k3[it] = {"live_share": (a != 0).float().mean().item(),
                  "device_ms_by_p": ms,
                  "k1_all_lanes_device_ms": device_ms(
                      lambda: K1.sweep(r, spheres), 20),
                  "one_thread_all_lanes_device_ms": device_ms(
                      lambda: K1.sweep_fetch_one_thread(r, spheres, amat),
                      20)}
    occ = {kern: K1.occupancy(kern, n_sph, dev)
           for kern in ("sweep", "sweep_masked", "sweep_fetch_one_thread")}

    # K1 per flagship render, K3 per flagship step (torch.profiler)
    flag_scene, flag_cam = pt.scene_random_spheres(seed=1), pt.t_cam1()
    bad = flag_scene._replace(albedo=torch.clamp(flag_scene.albedo * 0.8,
                                                 0, 1))
    target = pt.render_radiance(flag_scene, flag_cam, W, 1, seed=123,
                                device=dev, persistent=True)
    sums = {"sweep": r"\bsweep_kernel\b",
            "sweep_masked": r"\bsweep_masked_kernel\b"}
    render = profile_call(lambda: pt.render(
        flag_scene, flag_cam, W, SPP, persistent=True, device="cuda"), sums)
    step = profile_call(lambda: pt.render_grads(
        bad, flag_cam, target, W, 1, device=dev), sums)
    per_render = render["device_ms_by_match"]["sweep"]
    per_step = step["device_ms_by_match"]["sweep_masked"]
    emit({"phase": "sweep_redesign", "card": card, "spheres": n_sph,
          "resident_threads_k1": resident, "k1": k1, "k3": k3,
          "occupancy": occ, "lanes_differing_from_one_thread_by_p": bitwise,
          "k1_per_flagship_render": {
              **per_render, "wall_s_profiled": render["wall_s_profiled"],
              "device_idle_share": render["device_idle_share"]},
          "k3_per_flagship_step": {
              **per_step, "wall_s_profiled": step["wall_s_profiled"],
              "device_idle_share": step["device_idle_share"]},
          "note": "device_ms: card time only (queue pre-filled), 20 "
                  "launches; the one-thread kernel sweeps with the "
                  "one-thread loop and fetches 40 bytes per ray more",
          "tolerance": "0 lanes differ from the one-thread kernel in any "
                       "bit of t or idx, on every ray set at every P"})
    check(all(v == 0 for d in bitwise.values() for v in d.values()),
          f"K1 differs from the one-thread kernel: {bitwise}")
    check(per_render["count"] > 0 and per_step["count"] > 0,
          "the profiles found no K1 or K3 launch")


#: Kernel-name patterns summed by the flagship render's and step's
#: profiles: the main path's kernels, and the gather and cast of a
#: winner-attribute fetch outside them.
RENDER_SUMS = {"sweep": r"\bsweep_kernel\b",
               "shade_strided": r"\bshade_strided_kernel\b",
               "sweep_masked": r"\bsweep_masked_kernel\b",
               "persist_record": r"\bpersist_record_kernel\b",
               "gather": r"index_elementwise_kernel",
               "cast": r"direct_copy_kernel"}


def shade_redesign_phases(dev, card, fwd, snap, W: int = 1920,
                          H: int = 1080, SPP: int = 4) -> dict:
    """K2 and K4 with the winner fetch inside, beside the designs they were
    chosen over: ``scripts/torch_k2_k4_variants.py`` builds the previous
    kernels (timed alone and after their gather), the shared-memory table,
    K2's draws split over P = 2, 4 and 8 threads, K4's compaction and its
    record stores with and without the hint; each build is held bit for bit
    against its plain version on the render's mid and tail states and the
    step's iterations 20 and 40, and timed once by :func:`batch_ms`. Then
    K1, K2 and K4 through their wrappers by :func:`batch_ms` and by an event
    pair around each launch (:func:`device_ms`, the earlier method), and the
    flagship render and step under the profiler (each kernel's device time,
    the gathers, the idle share). Returns the ``event_ms`` of K1, K2 and K4
    for the ``kernels`` line."""
    import os
    import tempfile
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops.cuda import build
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
    from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_k2_k4_variants as V

    out = os.path.join(os.path.dirname(build.BUILD_DIR), "variants")
    os.makedirs(out, exist_ok=True)
    k2_libs, k4_libs, ptxas = V.build_variants(tempfile.mkdtemp(dir=out),
                                               fwd["spheres"].shape[0])
    shapes = V.k2_shapes(dev, fwd)
    bad = V.check_variants(dev, k2_libs, k4_libs, fwd, snap, shapes)
    tabs = V.variant_tables(dev, k2_libs, k4_libs, fwd, snap, shapes)
    emit({"phase": "shade_variants", "card": card, "ptxas": ptxas,
          "cases_bitwise": len(bad), "lanes_differing": sum(bad.values()),
          **tabs, "changes_alone": V.changes_alone(tabs),
          "note": "one pass; event_ms: one CUDA event pair around n "
                  "launches, each on its own copy of the state, queue "
                  "pre-filled; profiler_ms: the kernels of a second such "
                  "run by torch.profiler, per launch (gather+previous: the "
                  "gather, the cast and the previous kernel together)"})

    amat, cc, geom, seed = fwd["amat"], fwd["cc"], fwd["geom"], fwd["seed"]
    t, idx, rays, spheres = fwd["t"], fwd["idx"], fwd["rays"], fwd["spheres"]
    make2 = lambda: [x.clone() for x in fwd["state"]]
    strips, SEED, DEPTH = snap["strips"], snap["seed"], snap["depth"]
    st20 = snap["k4_states"][20]
    t4, i4 = snap["k4_hits"][20]
    make4 = lambda: [x.clone() for x in st20] + [
        torch.empty((PK.N_REC, strips.shape[1]), device=dev)]
    k2 = lambda fs, is_, buf: K2.shade_strided_step(
        fs, is_, buf, t, idx, amat, cc, geom, seed, 24, 0, 16)
    k4 = lambda sf, si, rad, slot: PK.persist_record_step(
        t4, i4, amat, strips, sf, si, rad, slot, SEED, 20, DEPTH)
    batch = {"sweep": batch_ms(lambda: K1.sweep(rays, spheres), lambda: (),
                               50, r"\bsweep_kernel\b"),
             "shade_strided": batch_ms(k2, make2, 50, V.K2_RE),
             "persist_record": batch_ms(k4, make4, 20, V.K4_RE)}
    live2, live4 = make2(), make4()
    pair = {"sweep": device_ms(lambda: K1.sweep(rays, spheres), 50),
            "shade_strided": device_ms(
                lambda: k2(*live2), 50,
                setup=lambda: [x.copy_(y) for x, y in zip(live2,
                                                          fwd["state"])]),
            "persist_record": device_ms(
                lambda: k4(*live4), 20,
                setup=lambda: [x.copy_(y) for x, y in zip(live4, st20)])}

    flag_scene, flag_cam = pt.scene_random_spheres(seed=1), pt.t_cam1()
    bad_scene = flag_scene._replace(albedo=torch.clamp(
        flag_scene.albedo * 0.8, 0, 1))
    target = pt.render_radiance(flag_scene, flag_cam, W, 1, seed=123,
                                device=dev, persistent=True)
    reset_counts()
    render = profile_call(lambda: pt.render(
        flag_scene, flag_cam, W, SPP, persistent=True, device="cuda"),
        RENDER_SUMS)
    render_counts = counts()
    reset_counts()
    step = profile_call(lambda: pt.render_grads(
        bad_scene, flag_cam, target, W, 1, device=dev), RENDER_SUMS)
    step_counts = counts()
    keep = ("top_kernels", "top_host_ops")
    per_launch = {name: by[name]["device_ms"] / max(by[name]["count"], 1)
                  for by, name in ((render["device_ms_by_match"],
                                    "shade_strided"),
                                   (step["device_ms_by_match"],
                                    "persist_record"))}
    emit({"phase": "shade_redesign", "card": card, "batch": batch,
          "device_ms_pair_per_launch": pair,
          "profiler_ms_per_launch_in_loop": per_launch,
          "flagship_render": {k: v for k, v in render.items()
                              if k not in keep},
          "flagship_render_launches": {
              k: render_counts[k] for k in ("gather", "sweep",
                                            "shade_strided")},
          "flagship_step": {k: v for k, v in step.items() if k not in keep},
          "flagship_step_launches": {
              k: step_counts[k] for k in ("gather", "sweep_masked",
                                          "persist_record")},
          "note": "batch: K1, K2 (mid-render, 32 400 lanes) and K4 "
                  "(iteration 20) through their wrappers by batch_ms; "
                  "device_ms_pair_per_launch: the earlier method, an event "
                  "pair around each launch; profiler_ms_per_launch_in_loop: "
                  "K2's and K4's device time per launch in the profiled "
                  "flagship render and step"})
    check(render_counts["gather"] == 0 and step_counts["gather"] == 0,
          f"a main-path loop gathered: {render_counts}, {step_counts}")
    check(render["device_ms_by_match"]["gather"]["count"] == 0,
          "the flagship render launched a gather kernel")
    return {k: v["event_ms"] for k, v in batch.items()}


def replay_redesign_phases(dev, card, W: int = 1920, H: int = 1080) -> dict:
    """K5 and K6 with the winner fetch inside, beside the designs they were
    chosen over: ``scripts/torch_k5_k6_variants.py`` builds the previous
    kernels and each change alone (K5's staged walk, its row on hit lanes,
    the cache hints, the launch shapes), holds each build bit for bit
    against the previous kernel on the flagship step's own record phases
    (and phase 1 as K11 records it), and times it once by :func:`batch_ms`.
    Then K5 (phase 1) and K6 (slot 10 of the lean record) through their
    wrappers by :func:`batch_ms` and by an event pair around each launch
    (:func:`device_ms`), and the lean flagship step under the profiler
    (K6's device time, no gather). Returns the ``event_ms`` of K5 and K6
    for the ``kernels`` line."""
    import os
    import tempfile
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops.cuda import build
    from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_k5_k6_variants as V

    ph = V.phases(dev, W, H)
    out = os.path.join(os.path.dirname(build.BUILD_DIR), "variants")
    os.makedirs(out, exist_ok=True)
    k5_libs, k6_libs, ptxas = V.build_variants(tempfile.mkdtemp(dir=out))
    bad = V.check_variants(dev, k5_libs, k6_libs, ph)
    tabs = V.variant_tables(dev, k5_libs, k6_libs, ph)
    emit({"phase": "replay_variants", "card": card, "ptxas": ptxas,
          "shapes": {k: list(v["rec"].shape) for k, v in ph.items()
                     if k != "amat"},
          "cases_bitwise": len(bad), "lanes_differing": sum(bad.values()),
          **tabs, "changes_alone": V.changes_alone(tabs),
          "note": "one pass; event_ms: one CUDA event pair around n "
                  "launches, each on its own copy of the carry, queue "
                  "pre-filled; profiler_ms: the kernels of a second such run "
                  "by torch.profiler, per launch (gather+previous: the "
                  "gather, the cast and the previous kernel together)"})

    amat, p1 = ph["amat"], ph["phase1"]
    q = V._k6_slot(ph, 10)
    lanes = p1["cot"].shape[1]
    k5 = lambda cot, dep: PK.persist_replay_fused(
        cot, dep, p1["rec"], p1["gs"], p1["i0"], V.SEED)
    k6 = lambda cot, dep, o: PK.persist_replay_step(
        cot, dep, q["slot"], q["idx"], amat, q["gs"], V.SEED, q["it"], out=o)
    make5 = lambda: (p1["cot"].clone(), p1["dep"].clone())
    make6 = lambda: make5() + (torch.empty((9, lanes), device=dev),)
    batch = {"persist_replay_fused": batch_ms(k5, make5, 10, V.K5_RE),
             "persist_replay_step": batch_ms(k6, make6, 50, V.K6_RE)}
    carry = list(make6())
    reset = lambda: [x.copy_(y) for x, y in zip(carry, make5())]
    pair = {"persist_replay_fused": device_ms(lambda: k5(*carry[:2]), 10,
                                              setup=reset),
            "persist_replay_step": device_ms(lambda: k6(*carry), 50,
                                             setup=reset)}
    del ph, k5_libs, k6_libs

    flag_scene, flag_cam = pt.scene_random_spheres(seed=1), pt.t_cam1()
    bad_scene = flag_scene._replace(albedo=torch.clamp(
        flag_scene.albedo * 0.8, 0, 1))
    target = pt.render_radiance(flag_scene, flag_cam, W, 1, seed=123,
                                device=dev, persistent=True)
    sums = {"persist_replay_fused": V.K5_RE,
            "persist_replay_step": V.K6_RE,
            "gather": RENDER_SUMS["gather"], "cast": RENDER_SUMS["cast"]}
    steps, step_counts = {}, {}
    for route, kw in (("default", {}),
                      ("lean", dict(recorded_persist=(8, None, (44, 16),
                                                      False),
                                    persist_strict=True))):
        reset_counts()
        steps[route] = profile_call(lambda: pt.render_grads(
            bad_scene, flag_cam, target, W, 1, device=dev, **kw), sums)
        step_counts[route] = {k: v for k, v in counts().items()
                              if k in ("gather", "persist_replay_fused",
                                       "persist_replay_step")}
    keep = ("top_kernels", "top_host_ops")
    emit({"phase": "replay_redesign", "card": card, "batch": batch,
          "device_ms_pair_per_launch": pair,
          "flagship_steps": {r: {k: v for k, v in x.items()
                                 if k not in keep}
                             for r, x in steps.items()},
          "flagship_step_launches": step_counts,
          "note": "batch: K5 over phase 1 of the flagship step (262 144 "
                  "lanes) and K6 at its slot 10 (lean record) through their "
                  "wrappers by batch_ms; device_ms_pair_per_launch: an event "
                  "pair around each launch; flagship_steps: the default and "
                  "lean flagship steps profiled (gather: every index kernel "
                  "of the step, the boundary's and the contraction's among "
                  "them; the lean replay adds none)"})
    check(all(c["gather"] == 0 for c in step_counts.values()),
          f"a flagship step's loops gathered: {step_counts}")
    gathers = {r: x["device_ms_by_match"]["gather"]["count"]
               for r, x in steps.items()}
    check(gathers["lean"] == gathers["default"],
          f"the lean replay launched gather kernels: {gathers}")
    check(step_counts["lean"]["persist_replay_step"] > 0,
          f"the lean step launched {step_counts['lean']}")
    return {k: v["event_ms"] for k, v in batch.items()}


FIT_SUMS = {"sweep_masked": r"\bsweep_masked_kernel\b",
            "record_shade": r"\brecord_shade_kernel\b",
            "replay_bwd_fused": r"\breplay_bwd_fused_kernel\b",
            "inline": r"\binline_kernel\b",
            "gather": RENDER_SUMS["gather"], "cast": RENDER_SUMS["cast"]}


def fit_redesign_phases(dev, card, f: dict) -> dict:
    """K7a with the winner fetch inside and K8 with a lane work queue,
    beside the designs they were chosen over:
    ``scripts/torch_k7a_k8_variants.py`` builds the previous kernels and
    each change alone, holds every build bit for bit against the previous
    kernel (K7a at every bounce of the demo's first pass, K8 on the demo,
    the hollow glass scene and a 64-sphere table, injected and Philox
    draws), reads K8's live share and times every build in one pass. Then
    K7a, K7b, K7c and K8 through their wrappers by :func:`batch_ms` (beside
    ``fit_kernel_times``' event pair around each launch), and one fit step
    under the profiler (device busy time, idle share, device events and
    ``cudaLaunchKernel`` calls per step, our kernels' launches and
    gathers). ``f``: the inputs of :func:`fit_slice_phases`. Returns the
    kernel ms of the four for the ``kernels`` line: ``event_ms`` through the
    wrapper; K8's from the variants pass, where it is launched alone (its
    wrapper also stages the sphere planes, the rays and the queue's
    counter)."""
    import os
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
    from raytracingweekend_jl_tpu_torch.ops.cuda import inline_kernel as K8
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_k7a_k8_variants as V

    out = V.run_pass_set(dev, 1)
    emit({"phase": "fit_variants", "card": card, **out,
          "note": "one pass; event_ms: one CUDA event pair around n "
                  "launches, each on its own copy of the state, queue "
                  "pre-filled; profiler_ms: the kernels of a second such "
                  "run by torch.profiler, per launch (gather+previous: the "
                  "gather, the cast and the previous kernel together; "
                  "record_pass: 16 x (K3 [+ gather] + K7a))"})

    R, seed, rec, g3 = f["R"], f["seed32"], f["rec"], f["g3"]
    k7a = lambda st, slot: GK.record_shade_step(
        f["t2"], f["idx2"], f["amat"], st, slot, seed, 2)
    make7a = lambda: (f["st2"].clone(),
                      torch.empty((GK.N_REC, R), device=dev))
    k7b = lambda cot, o: GK.replay_bwd_step(rec[2], g3, cot, seed, 2, out=o)
    make7b = lambda: (f["cot2"].clone(), torch.empty((9, R), device=dev))
    k7c = lambda cot: GK.replay_bwd_fused(rec, g3, cot, seed)
    k8 = lambda: K8.trace_inline(f["sc0"], f["o8"], f["d8"], f["seed8"], 16)
    batch = {"record_shade": batch_ms(k7a, make7a, 50, V.K7A_RE),
             "replay_bwd_step": batch_ms(k7b, make7b, 50,
                                         r"\breplay_bwd_step_kernel\b"),
             "replay_bwd_fused": batch_ms(
                 k7c, lambda: (torch.zeros((9, R), device=dev),), 20,
                 r"\breplay_bwd_fused_kernel\b"),
             "inline_wrapper": batch_ms(k8, lambda: (), 20, V.K8_RE)}
    times = out["times"]
    k8_alone = times["k8"]["demo"]["shipped"]

    scene0, cam, target = f["scene0"], f["cam"], f["target"]
    fit_step = lambda: pt.fit_scene(scene0, cam, target, f["W"], f["SPP"],
                                    steps=1)
    fit_step()  # warm-up
    reset_counts()
    prof = profile_call(fit_step, FIT_SUMS)
    step_counts = {k: v for k, v in counts().items() if v}
    emit({"phase": "fit_redesign", "card": card, "batch": batch,
          "inline_kernel_alone": k8_alone,
          "device_ms_pair_per_launch": {
              k: f["pair_ms"][k] for k in ("record_shade", "replay_bwd_step",
                                           "replay_bwd_fused", "inline")},
          "k7a_plus_fetch_per_bounce": {
              b: {"before": t["gather+previous"], "after": t["shipped"]}
              for b, t in times["k7a"].items() if b != "record_pass"},
          "record_pass": times["k7a"]["record_pass"],
          "fit_step": prof,
          "fit_step_launches": step_counts,
          "note": "batch: K7a (bounce 2 of the demo's first pass), K7b "
                  "(slot 2), K7c (the 16-slot walk) and K8 (the demo, "
                  "179 200 lanes; through its wrapper, which also stages "
                  "the sphere planes, the rays and the counter) by "
                  "batch_ms; inline_kernel_alone: K8 launched alone, from "
                  "the variants pass; device_ms_pair_per_launch: "
                  "fit_kernel_times' event pair around each launch (K8 "
                  "through its wrapper); fit_step: one fit_scene step "
                  "profiled"})
    check(step_counts.get("gather", 0) == 0,
          f"the fit step gathered: {step_counts}")
    check(step_counts.get("record_shade", 0) > 0
          and step_counts.get("inline", 0) > 0,
          f"the fit step launched {step_counts}")
    return {"record_shade": batch["record_shade"]["event_ms"],
            "replay_bwd_step": batch["replay_bwd_step"]["event_ms"],
            "replay_bwd_fused": batch["replay_bwd_fused"]["event_ms"],
            "inline": k8_alone["event_ms"]}


def k10_k12_redesign_phases(dev, card, rays, rays_f) -> dict:
    """K10 with K1's split loop and the winner's row by index, and K12
    sweeping and shading only its active lanes, beside the designs they
    were chosen over. K10 through its wrapper, bit for bit against the kept
    one-thread kernel (t, idx and the ten planes) at every P and the
    wrapper's own, on four ray sets: the K1 phase's 2^20 rays (``rays``),
    bounces 0 and 3 of the ``fused_attrs`` render's first pass (2 073 600
    rays each, captured at its launches) and the flagship's 32 400
    mid-render lanes (``rays_f``); K12 through its wrapper, every state
    word bit for bit against K1 + gather + K9 at iterations 0, 8, 24 and 40
    of the flagship film pinned, with injected and Philox draws (P per
    block, as the kernel chooses it). K10 also against its plain version
    on the 2 073 600 camera rays, with ``k10_vs_plain``'s tolerances: its
    row of the ``kernels`` line is measured at that shape, every column.
    Both kernels timed through their wrappers by
    :func:`batch_ms` at those shapes, with their bounds, registers and
    resident blocks. Then one pass of ``scripts/torch_k10_k12_variants.py``
    over the previous and the shipped designs: it builds the previous K12
    and the shipped sources, checks them bit for bit, times them in turns,
    then the megakernel and ``fused_attrs`` renders with each (host clock,
    the kernel's device time per render from the profiler, the images
    bitwise equal); the designs not chosen run in the script alone. Returns
    K10's ms, plain ms, bound and max_abs_err at the 2 073 600 camera rays
    (the shape its main-path launches sweep), and K12's ms at iteration
    24."""
    import os
    import torch
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.cuda import mega_kernel as K12
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_k10_k12_variants as V

    scene, cam, spheres, amat = V.flagship(dev)
    n_sph = spheres.shape[0]
    captured = V.fused_attrs_rays(dev)
    sets = {"rays_2p20": rays, "camera_2073600": captured[0],
            "bounce3_2073600": captured[3], "mid_render_32400": rays_f}
    del captured

    # K10 against the one-thread kernel, every P, every set
    k10 = {}
    for name, r in sets.items():
        ref = K1.sweep_fetch_one_thread(r, spheres, amat)
        diff = {}
        for P in SPLIT_PARTS:
            got = K1.sweep_fetch(r, spheres, amat, parts=P)
            torch.cuda.synchronize()
            diff["auto" if P is None else str(P)] = int(_bitwise_lanes(
                list(zip(got, ref)), r.shape[1]).sum())
        del got, ref
        ms = batch_ms(lambda: K1.sweep_fetch(r, spheres, amat), lambda: (),
                      20, V.K10_RE)
        k10[name] = {"rays": r.shape[1], "parts_chosen": K1.sweep_parts(
            r.shape[1], n_sph, K1._resident_threads(dev, n_sph,
                                                    "sweep_fetch")),
                     "lanes_differing_from_one_thread_by_p": diff,
                     "batch": ms, "bound": sweep_fetch_bound(r.shape[1],
                                                             n_sph)}
    # K10 against its plain version at the camera rays
    cam_rays = sets["camera_2073600"]
    t10, i10, a10 = K1.sweep_fetch(cam_rays, spheres, amat)
    t10r, i10r, a10r = K1.sweep_fetch_ref(cam_rays, spheres, amat)
    t1, _ = K1.sweep(cam_rays, spheres)
    torch.cuda.synchronize()
    k10_plain = {"rays": cam_rays.shape[1],
                 "idx_identical": bool(torch.equal(i10, i10r)),
                 "t_bitwise_k1": bool(torch.equal(t10, t1)),
                 "attrs_identical": bool(torch.equal(a10, a10r)),
                 "max_abs_err": max((t10 - t10r).abs().max().item(),
                                    (a10 - a10r).abs().max().item())}
    del t10, i10, a10, t10r, i10r, a10r, t1
    k10_plain_ms = device_ms(lambda: K1.sweep_fetch_ref(cam_rays, spheres,
                                                        amat), 3,
                             sleep_cycles=3_000_000_000)

    # K12 against K1 + gather + K9, four iterations
    st = V.k12_states(dev, scene, cam, spheres, amat)
    g = torch.Generator(device=dev).manual_seed(12)
    k12 = {}
    for it, (fs, ist, n_act) in st["at"].items():
        n = fs.shape[1]
        diff = {}
        for draws, u9 in (("injected", torch.rand((9, n), generator=g,
                                                   device=dev)),
                          ("philox", None)):
            ref, got = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
            V.pinned_iteration(st, *ref, it, u9)
            K12.mega_step(*got, spheres, amat, st["u"], st["v"], st["cc"],
                          st["seed"], it, V.SPP - 1, V.DEPTH, V.TMIN, u9)
            torch.cuda.synchronize()
            diff[draws] = int(_bitwise_lanes(list(zip(got, ref)), n).sum())
            del ref, got
        ms = batch_ms(lambda f, i: K12.mega_step(
            f, i, spheres, amat, st["u"], st["v"], st["cc"], st["seed"], it,
            V.SPP - 1, V.DEPTH, V.TMIN), lambda: (fs.clone(), ist.clone()),
            20, V.K12_RE)
        k12[f"iteration{it}"] = {
            "active_lanes": n_act, "lanes_differing_from_k1_gather_k9": diff,
            "batch": ms, "bound": mega_bound(fs, ist, spheres)}
        torch.cuda.empty_cache()
    occ = {"sweep_fetch": K1.occupancy("sweep_fetch", n_sph, dev),
           "sweep_fetch_one_thread": K1.occupancy("sweep_fetch_one_thread",
                                                  n_sph, dev),
           "mega": K12.occupancy(n_sph, dev)}
    emit({"phase": "k10_k12_redesign", "card": card, "spheres": n_sph,
          "k10": k10, "k12": k12, "occupancy": occ,
          "k10_vs_plain_camera_2073600": k10_plain,
          "k10_plain_ms_camera_2073600": k10_plain_ms,
          "note": "batch: batch_ms through the wrapper (event_ms: one "
                  "event pair around 20 launches; K12 each on its own copy "
                  "of the state); bound: from this run's inputs",
          "tolerance": "K10: t, idx and the ten planes bit for bit the "
                       "one-thread kernel's on every set at every P; at the "
                       "camera rays idx and planes identical to the plain "
                       "version's, t bitwise K1's; K12: every state word "
                       "bit for bit K1 + gather + K9's at every iteration "
                       "and draw"})
    check(all(v == 0 for c in k10.values()
              for v in c["lanes_differing_from_one_thread_by_p"].values()),
          f"K10 differs from the one-thread kernel: {k10}")
    check(k10_plain["idx_identical"] and k10_plain["t_bitwise_k1"]
          and k10_plain["attrs_identical"],
          f"K10 differs from its plain version: {k10_plain}")
    check(all(v == 0 for c in k12.values()
              for v in c["lanes_differing_from_k1_gather_k9"].values()),
          f"K12 differs from K1 + gather + K9: {k12}")
    del st

    out = V.run_pass_set(dev, 1, sets=sets, k10_builds=("shipped",),
                         k12_builds=("shipped", "previous"),
                         render_repeats=1)
    emit({"phase": "k10_k12_variants", "card": card, **out,
          "note": "one pass of the previous and the shipped designs (the "
                  "others: scripts/torch_k10_k12_variants.py alone); "
                  "event_ms: one CUDA event pair around n launches (K12: "
                  "each on its own copy of the state); profiler_ms: the "
                  "profiler's per-launch mean; renders: host-clock seconds "
                  "and the kernel's device time per render by the "
                  "profiler, one render each in turns (the script alone "
                  "takes medians of 3)"})
    return {"sweep_fetch": {"ms": k10["camera_2073600"]["batch"]["event_ms"],
                            "plain_ms": k10_plain_ms,
                            "max_abs_err": k10_plain["max_abs_err"],
                            "bound": k10["camera_2073600"]["bound"]},
            "mega": {"ms": k12["iteration24"]["batch"]["event_ms"]}}


def remat_passes_phases(dev, card, W: int = 1920, SPP: int = 4) -> None:
    """The flagship gradient step at spp 4 through the public
    ``render_grads`` with ``RECORD_HBM_BUDGET`` at 2 GiB: below the four
    passes' records, even lean, so the plan sets ``remat_passes=True``
    (each pass's record rebuilt in the backward), and it chunks the image
    to fit one pass's record. Beside it, the same chunks with the card's
    default budget (every pass's record kept: the same function, so the
    loss and the five gradient fields bit for bit equal), and the default
    step (one chunk). The plans the entry point made, each step's peak
    device memory above what was allocated before it and its time, the
    three in turns (twice)."""
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch import grad as G
    from raytracingweekend_jl_tpu_torch.ops.persist_grad import (
        persist_record_bytes)

    H = W * 9 // 16
    scene, cam = pt.scene_random_spheres(seed=1), pt.t_cam1()
    target = pt.render_radiance(scene, cam, W, 1, seed=123, device=dev,
                                persistent=True)
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.8, 0, 1))
    saved, real = G.RECORD_HBM_BUDGET, G.render_radiance
    plans, seen = {}, {}

    def spy(*a, **kw):  # the flags render_loss hands the render
        seen.update(kw)
        return real(*a, **kw)

    def step(name, budget, **kw):
        G.RECORD_HBM_BUDGET = budget
        seen.clear()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss, grads = pt.render_grads(bad, cam, target, W, SPP, device=dev,
                                      **kw)
        torch.cuda.synchronize()
        run = {"seconds": time.perf_counter() - t0,
               "peak_bytes_above_start":
                   torch.cuda.max_memory_allocated() - before}
        plans[name] = {"budget_bytes": G.record_hbm_budget(dev),
                       **{k: seen.get(k) for k in (
                           "pixel_chunk", "remat_passes",
                           "recorded_persist")}}
        return run, (loss, *grads)

    runs = {"forced_2gib": [], "kept_same_chunks": [], "default": []}
    outs = {}
    G.render_radiance = spy
    try:
        for _ in range(2):
            r, outs["forced_2gib"] = step("forced_2gib", 2 << 30)
            runs["forced_2gib"].append(r)
            chunk = plans["forced_2gib"]["pixel_chunk"]
            r, outs["kept_same_chunks"] = step("kept_same_chunks", None,
                                               pixel_chunk=chunk)
            runs["kept_same_chunks"].append(r)
            r, outs["default"] = step("default", None)
            runs["default"].append(r)
    finally:
        G.RECORD_HBM_BUDGET, G.render_radiance = saved, real
    same = all(torch.equal(_bits(a), _bits(b)) for a, b in
               zip(outs["forced_2gib"], outs["kept_same_chunks"]))
    chunk = plans["forced_2gib"]["pixel_chunk"] or W * H
    emit({"phase": "remat_passes_step", "card": card, "size": [W, H],
          "spp": SPP, "plans": plans, "runs": runs,
          "record_bytes_per_pass_and_chunk": persist_record_bytes(
              chunk, 8, None, (44, 16), 16, True),
          "loss": {k: float(v[0]) for k, v in outs.items()},
          "bitwise_equal_to_kept": same,
          "tolerance": "the 2 GiB budget plans remat_passes=True, the "
                       "default budget does not; the loss and every "
                       "gradient field bit for bit those of the same "
                       "chunks with every pass's record kept; the "
                       "recomputing step's peak memory below theirs"})
    check(plans["forced_2gib"]["remat_passes"]
          and not plans["kept_same_chunks"]["remat_passes"]
          and not plans["default"]["remat_passes"],
          f"remat_passes plans {plans}")
    check(same, "the step with recomputed passes differs from the step "
                "that keeps every pass's record")
    check(all(bool(torch.isfinite(v[0])) for v in outs.values()),
          "non-finite loss")
    check(runs["forced_2gib"][-1]["peak_bytes_above_start"]
          < runs["kept_same_chunks"][-1]["peak_bytes_above_start"],
          f"recomputed passes took no less memory: {runs}")


def k7c_k11_redesign_phases(dev, card, fit_losses) -> dict:
    """K7c (groups of G threads per lane stage a lane's next G live slots'
    forward halves at once, lanes ordered by depth; the one-thread walk
    where the lanes fill the card) and K11 (K3's compaction and split
    sweep, the winner's row by index, K4's step on the packed lanes),
    beside the kernels they replaced. One pass of
    ``scripts/torch_k7c_k11_variants.py`` over the previous and the
    shipped builds: every build bit for bit (K7c against K7b's walk at the
    fit's walk and at 131 071 lanes, at every G, injected and Philox; K11
    against K3 + K4 at iterations 0, 20, 44 and 70 of the flagship fused
    step), timed in turns by :func:`batch_ms` with registers and resident
    blocks, and K11's device time per fused step by the profiler. Then
    through the wrappers: K7c (the wrapper's G) and K11 bit for bit their
    plain versions at those shapes, injected and Philox, and timed; the
    120-step fit with the previous K7c routed in, its losses bit for bit
    the shipped fit's (``fit_losses``). Returns K11's row of the
    ``kernels`` line at iteration 20 of the fused step."""
    import os
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
    from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_k7c_k11_variants as V

    libs = {}
    out = V.run_pass_set(dev, 1, k7c_builds=("shipped", "previous"),
                         k11_builds=("shipped", "previous"), libs=libs)
    emit({"phase": "k7c_k11_variants", "card": card, **out,
          "note": "one pass; event_ms: one CUDA event pair around n "
                  "launches, each on its own copy of the state; "
                  "profiler_ms: the kernel's per-launch mean from a second "
                  "such run (k3_k4: the sweep, the record step and the "
                  "miss planes' zeroing summed); fused_step: the flagship "
                  "step with fused_step=True, K11's device time per step "
                  "by the profiler"})

    # -- through the wrappers: K7c and K11 against their plain versions ----
    g = torch.Generator(device=dev).manual_seed(23)
    states7, st11 = V.k7c_states(dev), V.k11_states(dev)
    k7c = {}
    for shape, (rec, g3, seed) in states7.items():
        K, _, R = rec.shape
        group = GK.replay_group(R, GK._resident_threads(dev))
        row = {"lanes": R, "group": group}
        for draws, u5 in (("injected", torch.rand((K, 5, R), generator=g,
                                                  device=dev)),
                          ("philox", None)):
            cot0 = torch.randn((9, R), generator=g, device=dev)
            ck, cp = cot0.clone(), cot0.clone()
            dk = GK.replay_bwd_fused(rec, g3, ck, seed, u5)
            torch.cuda.synchronize()
            dp = GK.replay_bwd_fused_ref(rec, g3, cp, seed, u5)
            row[f"lanes_differing_{draws}"] = int(_bitwise_lanes(
                [(dk, dp), (ck, cp)], R).sum())
            row[f"max_abs_err_{draws}"] = max(
                (dk - dp).abs().max().item(), (ck - cp).abs().max().item())
        row["batch"] = batch_ms(
            lambda c: GK.replay_bwd_fused(rec, g3, c, seed),
            lambda: (torch.zeros((9, R), device=dev),), 20,
            r"\breplay_bwd_fused_(one_thread_)?kernel\b")
        k7c[shape] = row
    k11, k11_row = {}, None
    amat, spheres, strips = st11["amat"], st11["spheres"], st11["strips"]
    n_sph = spheres.shape[0]
    for it, (sf, si, rad, live) in st11["at"].items():
        W = sf.shape[1]
        row = {"live_lanes": live}

        def run(step, u5=None, it=it, sf=sf, si=si, rad=rad):
            o = V.k11_outputs(sf, si, rad)
            step(strips, *o, spheres, amat, V.SEED11, it, V.DEPTH, V.TMIN,
                 u5)
            torch.cuda.synchronize()
            return o

        for draws, u5 in (("injected", torch.rand((5, W), generator=g,
                                                  device=dev)),
                          ("philox", None)):
            a = run(PK.persist_record_fused_step, u5)
            b = run(PK.persist_record_fused_step_ref, u5)
            row[f"lanes_differing_{draws}"] = int(_bitwise_lanes(
                list(zip(a, b)), W).sum())
            row[f"max_abs_err_{draws}"] = max(
                (x.float() - y.float()).abs().max().item()
                for x, y in zip(a, b))
        row["batch"] = batch_ms(
            lambda *o, it=it: PK.persist_record_fused_step(
                strips, *o, spheres, amat, V.SEED11, it, V.DEPTH, V.TMIN),
            lambda sf=sf, si=si, rad=rad: V.k11_outputs(sf, si, rad), 20,
            V.K11_RE)
        if it == 20:
            o = run(PK.persist_record_fused_step)
            fl = PK.flags_of(o[3])
            n_miss = int(((fl & PK.F_ACT) != 0).sum()
                         - ((fl & PK.F_HIT) != 0).sum())
            n_regen = int(((fl & PK.F_REGEN) != 0).sum())
            live_now = [x.clone() for x in (sf, si, rad)]

            def reset(live_now=live_now, sf=sf, si=si, rad=rad):
                for x, y in zip(live_now, (sf, si, rad)):
                    x.copy_(y)

            slot = torch.empty((PK.N_REC, W), device=dev)
            idx = torch.empty(W, dtype=torch.int32, device=dev)
            plain_ms = device_ms(lambda: PK.persist_record_fused_step_ref(
                strips, *live_now, slot, idx, spheres, amat, V.SEED11, it,
                V.DEPTH, V.TMIN), 3, setup=reset, sleep_cycles=3_000_000_000)
            k11_row = {"ms": row["batch"]["event_ms"], "plain_ms": plain_ms,
                       "max_abs_err": max(row["max_abs_err_injected"],
                                          row["max_abs_err_philox"]),
                       "bound": fused_record_bound(W, live, n_miss, n_regen,
                                                   n_sph)}
            row["bound"] = k11_row["bound"]
            row["plain_ms"] = plain_ms
        k11[f"iteration{it}"] = row
        torch.cuda.empty_cache()

    # -- the fit's losses with the previous K7c routed in ----------------
    scene_true, scene0, cam, _, _ = inverse_demo()
    target = pt.render_radiance(scene_true, cam, 200, 8, image_height=112,
                                seed=0, persistent=False, recorded_fused=True)
    with V.patched("rtw_replay_bwd_fused", libs["k7c"]["previous"]):
        prev_losses = pt.fit_scene(scene0, cam, target, 200, 8,
                                   steps=len(fit_losses)).losses
    same_fit = list(prev_losses) == list(fit_losses)
    occ = {"k7c": {f"g{G}": GK.replay_bwd_fused_occupancy(G, dev)
                   for G in GK.REPLAY_GROUPS},
           "k11": PK.persist_record_fused_occupancy(n_sph, dev)}
    emit({"phase": "k7c_k11_redesign", "card": card, "k7c": k7c,
          "k11": k11, "occupancy": occ,
          "k11_device_ms_per_fused_step": {
              b: r["k11_device_ms"] for b, r in out["fused_step"].items()},
          "fit_steps": len(fit_losses),
          "fit_losses_previous_k7c_bitwise": same_fit,
          "tolerance": "K7c (the wrapper's G) and K11 bit for bit their "
                       "plain versions on every word, injected and Philox; "
                       "the fit's losses with the previous K7c bit for bit "
                       "the shipped fit's"})
    check(all(r[f"lanes_differing_{d}"] == 0 for r in k7c.values()
              for d in ("injected", "philox")),
          f"K7c differs from its plain version: {k7c}")
    check(all(r[f"lanes_differing_{d}"] == 0 for r in k11.values()
              for d in ("injected", "philox")),
          f"K11 differs from its plain version: {k11}")
    check(same_fit, "the fit's losses differ with the previous K7c")
    return {"persist_record_fused": k11_row}


def k7b_redesign_phases(dev, card) -> None:
    """K7b (every load of a lane issued at once, its alive flag with them,
    64-thread blocks) beside the kernel it replaced. One
    pass of ``scripts/torch_k7b_variants.py`` over every build: each bit for
    bit the previous K7b over the demo's 16-bounce walk, injected and
    Philox, timed in turns by :func:`batch_ms` at bounces 0, 4, 8 and 15
    and per two unfused-replay fit steps (256 launches), beside the card's
    empty-kernel launch floor, with registers and spills. Then through the
    wrappers: K7b bit for bit the previous kernel
    (``replay_bwd_step_previous``) at every bounce of the walk, injected
    and Philox, and two unfused fit steps with the previous K7b routed in,
    their losses bit for bit the shipped kernel's."""
    import os
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops.cuda import build
    from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_k7b_variants as V7
    import torch_k7c_k11_variants as V

    out = V7.run(dev, 1)
    emit({"phase": "k7b_variants", "card": card, **out,
          "note": "one pass; event_ms: one CUDA event pair around n "
                  "launches, each on its own zeroed carry (per launch at a "
                  "bounce; per walk of 16 launches for two_steps, whose "
                  "per_two_steps_ms is the 16 walks' sum); empty_kernel: "
                  "the launch floor, event / 256"})

    # -- through the wrappers, at every bounce of the walk ----------------
    rec, seed = V7.demo_records(dev, 1)[0]
    K, _, R = rec.shape
    g = torch.Generator(device=dev).manual_seed(29)
    g3 = torch.rand((3, R), generator=g, device=dev) * 2 - 1
    bad, err = {}, 0.0
    for draws, u5 in (("injected", torch.rand((K, 5, R), generator=g,
                                              device=dev)),
                      ("philox", None)):
        runs = []
        for step in (GK.replay_bwd_step, GK.replay_bwd_step_previous):
            cot = torch.zeros((9, R), device=dev)
            dattr = torch.full((K, 9, R), float("nan"), device=dev)
            cots = []
            for b in reversed(range(K)):
                step(rec[b], g3, cot, seed, b,
                     None if u5 is None else u5[b], out=dattr[b])
                cots.append(cot.clone())
            torch.cuda.synchronize()
            runs.append((torch.stack(cots), dattr))
        (ck, dk), (cp, dp) = runs
        bad[draws] = [int(_bitwise_lanes([(ck[K - 1 - b], cp[K - 1 - b]),
                                          (dk[b], dp[b])], R).sum())
                      for b in range(K)]
        err = max(err, (ck - cp).abs().max().item(),
                  (dk - dp).abs().max().item())

    # -- two unfused fit steps with the previous K7b routed in -------------
    scene_true, scene0, cam, _, _ = inverse_demo()
    target = pt.render_radiance(scene_true, cam, 200, 8, image_height=112,
                                seed=0, persistent=False, recorded_fused=True)
    fit = lambda: pt.fit_scene(scene0, cam, target, 200, 8, steps=2,
                               render_kwargs={"replay_fused": False}).losses
    shipped_losses = fit()
    with V.patched("rtw_replay_bwd_step",
                   build.load().rtw_replay_bwd_step_previous):
        prev_losses = fit()
    times = out["times"]
    emit({"phase": "k7b_redesign", "card": card, "lanes": R, "bounces": K,
          "lanes_differing_by_bounce": bad, "max_abs_err": err,
          "occupancy": GK.replay_bwd_step_occupancy(dev),
          "ptxas": out["ptxas"],
          "event_ms": {k: {b: v["event_ms"] for b, v in t.items()}
                       for k, t in times.items() if k != "empty_kernel"},
          "per_two_steps_ms": {b: v["per_two_steps_ms"]
                               for b, v in times["two_steps"].items()},
          "launch_floor_ms": times["empty_kernel"]["event_ms"],
          "ratios": out["changes_alone"], "verdict": out["verdict"],
          "fit_losses_previous_k7b": prev_losses,
          "fit_losses_shipped_k7b": shipped_losses,
          "tolerance": "K7b's cot after every bounce and every dattr row bit "
                       "for bit the previous K7b's at all 16 bounces, "
                       "injected and Philox; two unfused fit steps' losses "
                       "bit for bit"})
    check(all(v == 0 for d in bad.values() for v in d),
          f"K7b differs from the previous K7b: {bad}")
    check(list(prev_losses) == list(shipped_losses),
          f"unfused fit losses differ with the previous K7b: {prev_losses} "
          f"against {shipped_losses}")


def edge_phases(dev, card) -> None:
    """The edge (silhouette) gradient estimator on the card (``ops/edge.py``,
    no kernel of its own: its bounces sweep through K1). (a) The primal bit
    for bit ``trace(keyed=True)`` on ``scene_4_spheres`` at 200x112, spp 1,
    one and two edge bounces, and whether K1's ``(t, idx)`` is the dense
    ``[R, N]`` reduction's bit for bit on those rays and on the flagship's
    first 64 800-pixel chunk (the edge bounce takes its hard result from
    K1 either way). (b) Two steps of ``fit_scene(geom="edge")`` at the JAX
    package's flagship joint fit (``examples/inverse_flagship_joint``:
    ``scene_random_spheres(seed=1)``, ``t_cam1``, 960x540, spp 8, two edge
    bounces, sigma at 3 pixel footprints, 64 800-pixel chunks checkpointed
    one by one, centers, albedos and fuzz perturbed as its script does, the
    target the edge primal of the truth, which is the keyed trace's, so
    it is rendered with no edge bounce): losses finite, the second step's
    seconds and peak memory, K1's launches. (c) The cosine of one center's
    edge gradient at the inverse demo (spp 8) against finite differences of
    the hard loss (the default render at spp 32)."""
    import numpy as np
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch import rng
    from raytracingweekend_jl_tpu_torch.ops import edge as E
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1

    def k1_vs_dense(scene, o, d):
        t1, i1 = K1.sweep(torch.cat([o.T, d.T]).contiguous(),
                          K1.sphere_consts(scene))
        with torch.no_grad():
            t, i, *_ = E.silhouette_coords(o, d, scene)
        return int(((t1 != t) | (i1 != i)).sum())

    # -- (a) the primal -----------------------------------------------------
    s4 = pt.trim_scene(pt.scene_4_spheres(device=dev))
    cam4 = pt.t_default_cam(device=dev)
    u, v = pt.pixel_coords(200, 112, device=dev)
    o, d = pt.get_rays(cam4, u, v, generator=rng.generator(
        0, rng.LENS, 0, device=dev))
    seed = rng.purpose_seed(0, rng.SCATTER_DIR, 0) & 0xFFFFFFFF
    ref = pt.trace(s4, o, d, seed, keyed=True)
    primal = {}
    for eb in (1, 2):
        out = E.trace_edge(s4, o, d, seed, sigma=0.05, edge_bounces=eb)
        primal[f"edge_bounces_{eb}"] = {
            "bitwise": bool(torch.equal(out, ref)),
            "max_abs_diff": (out - ref).abs().max().item()}
    flag = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    camf = pt.t_cam1(device=dev)
    uf, vf = pt.pixel_coords(960, 540, device=dev)
    of, df = pt.get_rays(camf, uf[:64800], vf[:64800], generator=rng.generator(
        0, rng.LENS, 0, device=dev))
    dense = {"demo_22400": k1_vs_dense(s4, o, d),
             "flagship_chunk_64800": k1_vs_dense(flag, of, df)}
    emit({"phase": "edge_primal", "card": card, "size": [200, 112],
          "scene": "4_spheres", "by_edge_bounces": primal,
          "k1_lanes_differing_from_dense_reduction": dense,
          "tolerance": "trace_edge bit for bit trace(keyed=True)"})
    check(all(r["bitwise"] for r in primal.values()),
          f"edge primal differs from the keyed trace: {primal}")
    del of, df

    # -- (b) two steps of the flagship joint fit ---------------------------
    truth, camf = pt.scene_random_spheres(seed=1), pt.t_cam1()
    movable = pt.movable_mask(truth)
    mat = truth.mat.numpy()
    g = np.random.default_rng(7)
    cj = g.uniform(-0.04, 0.04, tuple(truth.center.shape)).astype(np.float32)
    cj[~movable] = 0.0
    alb = truth.albedo.numpy().copy()
    scored = movable & (mat != pt.DIELECTRIC)
    alb[scored] = np.clip(alb[scored] * 0.75 + 0.1, 0, 1)
    fz = truth.fuzz.numpy().copy()
    metal = movable & (mat == pt.METAL)
    fz[metal] = np.clip(fz[metal] + g.uniform(-0.2, 0.2, fz.shape)[metal],
                        0, None)
    start = truth._replace(center=truth.center + torch.from_numpy(cj),
                           albedo=torch.from_numpy(alb),
                           fuzz=torch.from_numpy(fz.astype(np.float32)))
    ekw = dict(edge_bounces=2, sigma_px=3.0, pixel_chunk=64800,
               remat_chunks=True)
    with torch.no_grad():  # the edge primal is the keyed trace's
        target = E.render_radiance_edge(truth, camf, 960, 8,
                                        image_height=540, seed=0,
                                        **{**ekw, "edge_bounces": 0})
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    peaks = []

    def on_step(i, loss, params):
        peaks.append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    res = pt.fit_scene(start, camf, target, 960, 8, steps=2, seed=0,
                       lr_albedo=1e-2, lr_center=2e-3, lr_fuzz=5e-3,
                       geom="edge", edge_kwargs=ekw, cosine_decay=True,
                       on_step=on_step)
    launches = counts()
    emit({"phase": "edge_flagship_fit", "card": card, "size": [960, 540],
          "spp": 8, "steps": 2, "edge_kwargs": ekw, "losses": res.losses,
          "step_seconds": res.step_seconds,
          "second_step_seconds": res.step_seconds[1],
          "peak_memory_bytes_by_step": peaks,
          "memory_before_fit_bytes": mem0, "wall_s": time.perf_counter() - t0,
          "launches": launches,
          "checks": "losses finite; K1 launched"})
    check(bool(np.isfinite(res.losses).all()),
          f"non-finite edge fit losses {res.losses}")
    check(launches["sweep"] > 0, f"the edge fit launched {launches}")
    del target, res

    # -- (c) FD cosine of one center gradient at the demo -------------------
    scene_true, scene0, cam, movable4, _ = inverse_demo()
    tgt = pt.render_radiance(scene_true, cam, 200, 8, image_height=112,
                             seed=0, device="cuda")
    k = int(np.flatnonzero(movable4 & (scene_true.mat.numpy()
                                       != pt.DIELECTRIC))[0])
    c = scene0.center.clone().to(dev).requires_grad_(True)
    img = pt.render_radiance_edge(scene0.to(dev)._replace(center=c), cam, 200,
                                  8, image_height=112, seed=0, sigma_px=3.0,
                                  edge_bounces=2)
    torch.mean((img - tgt) ** 2).backward()
    grad = c.grad[k].double().cpu().numpy()

    def hard(center):
        im = pt.render_radiance(scene0._replace(center=center), cam, 200, 32,
                                image_height=112, seed=0, device="cuda")
        return float(torch.mean((im - tgt) ** 2))

    eps, fd = 1e-3, np.zeros(3)
    for j in range(3):
        cp, cm = scene0.center.clone(), scene0.center.clone()
        cp[k, j] += eps
        cm[k, j] -= eps
        fd[j] = (hard(cp) - hard(cm)) / (2 * eps)
    cos = float(fd @ grad / (np.linalg.norm(fd) * np.linalg.norm(grad)
                             + 1e-30))
    emit({"phase": "edge_fd", "card": card, "sphere": k, "edge_grad":
          grad.tolist(), "fd": fd.tolist(), "cosine": cos,
          "note": "edge gradient at spp 8 (sigma 3 px, two edge bounces); "
                  "finite differences (eps 1e-3) of the default render's "
                  "MSE at spp 32",
          "tolerance": "cosine >= 0.8"})
    check(cos >= 0.8, f"edge gradient against FD: cosine {cos}")


#: The host syncs a profile counts: the runtime's stream and device
#: synchronisations, and the device's copies to the host.
SYNC_SUMS = {"stream_sync": r"^cudaStreamSynchronize$",
             "device_sync": r"^cudaDeviceSynchronize$",
             "memcpy_dtoh": r"^Memcpy DtoH"}


def host_syncs(fn) -> dict:
    """Counts of :data:`SYNC_SUMS` over one call of ``fn()``, from
    torch.profiler (runtime calls on the host, copies on the device)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    return {label: sum(e.count for e in ev if re.search(pat, e.key))
            for label, pat in SYNC_SUMS.items()}


def fit_scan_phases(dev, card, STEPS: int = 4, EDGE_STEPS: int = 2) -> None:
    """``fit_scene_scan`` against ``fit_scene`` at the inverse demo
    (``scene_4_spheres``, 200x112, spp 8): ``STEPS`` steps of
    ``geom="spsa"`` (the default routes: K3, K7a, K7c and the K8 probes)
    and ``EDGE_STEPS`` of ``geom="edge"`` (sigma 3 px, one edge bounce, at
    spp 2: its steps are host-bound, ~0.6 s a sample),
    each function in turn: losses finite, the edge geom's losses and fitted
    scene bit for bit the loop's (the spsa geom's first loss too: its
    directions come from another stream), seconds per step side by side,
    and host syncs per step: :func:`host_syncs` over a run of the steps
    less a run of none (the set-up's), over the steps (the edge geom's at
    spp 1, whose profile stays small; its syncs are per render, not per
    pass)."""
    import numpy as np
    import torch
    import raytracingweekend_jl_tpu_torch as pt

    scene_true, scene0, cam, _, _ = inverse_demo()
    target = pt.render_radiance(scene_true, cam, 200, 8, image_height=112,
                                seed=0, persistent=False, recorded_fused=True)
    rows = {}
    for geom, steps, spp, kw, spp_syncs in (
            ("spsa", STEPS, 8, {}, 8),
            ("edge", EDGE_STEPS, 2, {"edge_kwargs": dict(sigma_px=3.0,
                                                         edge_bounces=1)},
             1)):
        row = {"spp": spp}
        for name, fit in (("fit_scene", pt.fit_scene),
                          ("fit_scene_scan", pt.fit_scene_scan)):
            def run(n, spp=spp, fit=fit):
                return fit(scene0, cam, target, 200, spp, steps=n,
                           geom=geom, **kw)
            reset_counts()
            t0 = time.perf_counter()
            res = run(steps)
            wall = time.perf_counter() - t0
            launched = counts()
            busy = host_syncs(lambda: run(steps, spp_syncs))
            idle = host_syncs(lambda: run(0, spp_syncs))
            row[name] = {"losses": res.losses, "wall_s": wall,
                         "seconds_per_step": wall / steps,
                         "step_seconds": res.step_seconds,
                         "host_syncs_per_step": {
                             k: (busy[k] - idle[k]) / steps for k in busy},
                         "host_syncs_setup": idle,
                         "host_syncs_spp": spp_syncs,
                         "launches_per_step": {
                             k: v / steps for k, v in launched.items()
                             if v},
                         "scene": res.scene}
        a, b = row["fit_scene"], row["fit_scene_scan"]
        same_scene = all(torch.equal(x, y) for x, y in zip(a.pop("scene"),
                                                           b.pop("scene")))
        row["losses_bitwise"] = a["losses"] == b["losses"]
        row["first_loss_bitwise"] = a["losses"][0] == b["losses"][0]
        row["fitted_scene_bitwise"] = same_scene
        rows[geom] = row
        check(bool(np.isfinite(a["losses"] + b["losses"]).all()),
              f"non-finite {geom} fit losses: {row}")
    emit({"phase": "fit_scan", "card": card, "size": [200, 112], **rows,
          "checks": "losses finite; edge: losses and fitted scene bit for "
                    "bit the loop's; spsa: the first loss bit for bit"})
    check(rows["edge"]["losses_bitwise"]
          and rows["edge"]["fitted_scene_bitwise"],
          "fit_scene_scan(geom='edge') differs from fit_scene")
    check(rows["spsa"]["first_loss_bitwise"],
          "fit_scene_scan's first spsa loss differs from fit_scene's")


def k9_k13_redesign_phases(dev, card) -> dict:
    """K9 fetching the winner's row itself on the active lanes only, and
    K13 with every pair's roots behind ``disc > 0``, beside the kept
    kernels they replaced. K9 through its wrapper, every
    state word bit for bit against K1 + gather + the previous K9 at
    iterations 0, 8, 24 and 40 of the flagship film pinned, with injected
    and Philox draws, one launch per call, and at every iteration of the
    even-row tile (540 of 1 080 rows, spp 4), whose image through the
    public ``render_tile_sum`` is bitwise the three-launch route's at the
    same seed; the tile's launches (K1 and K9, no gather) and wall time
    against the three-launch route, in turns. K13 through its wrapper, t,
    idx and skips bit for bit against the kept previous K13 and the plain
    version on the eight cases of the ``grid_sweep`` phase. Both timed by
    :func:`batch_ms` beside the kernels they replaced, with their bounds
    from this run's inputs. Then one pass of
    ``scripts/torch_k9_k13_variants.py`` over the shipped designs and the
    ones each change replaced (the others run in the script alone).
    Returns K9's ms and bound at iteration 24 and K13's at the camera rays
    in row-major order, the shapes of their ``kernels`` rows."""
    import os
    import torch
    from raytracingweekend_jl_tpu_torch import render_tile_sum
    from raytracingweekend_jl_tpu_torch.ops import integrator as I
    from raytracingweekend_jl_tpu_torch.ops.cuda import grid_kernel as K13
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
    from raytracingweekend_jl_tpu_torch.ops.materials import fetch_attr_planes
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    import torch_k9_k13_variants as V9
    V = V9.V

    scene, cam, spheres, amat = V.flagship(dev)
    n_sph = spheres.shape[0]
    st = V.k12_states(dev, scene, cam, spheres, amat)
    g = torch.Generator(device=dev).manual_seed(912)
    last = V.SPP - 1

    def k9(fs_, ist_, t, idx, it, u9=None):
        K2.shade_and_regen_fetch(fs_, ist_, t, idx, amat, st["u"], st["v"],
                                 st["cc"], st["seed"], it, last, V.DEPTH, u9)

    def gather_previous(fs_, ist_, t, idx, it, u9=None):
        K2.shade_and_regen(fs_, ist_, t, fetch_attr_planes(idx, amat),
                           st["u"], st["v"], st["cc"], st["seed"], it, last,
                           V.DEPTH, u9)

    # K9 against K1 + gather + the previous K9, four iterations
    out9 = {}
    for it, (fs, ist, n_act) in st["at"].items():
        n = fs.shape[1]
        t, idx = K1.sweep(fs[0:6], spheres)
        diff, one_launch = {}, True
        for draws, u9 in (("injected", torch.rand((9, n), generator=g,
                                                   device=dev)),
                          ("philox", None)):
            ref, got = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
            V.pinned_iteration(st, *ref, it, u9)
            before = K2.pinned_launches
            k9(*got, t, idx, it, u9)
            torch.cuda.synchronize()
            one_launch &= K2.pinned_launches == before + 1
            diff[draws] = int(_bitwise_lanes(list(zip(got, ref)), n).sum())
            del ref, got
        make = lambda: (fs.clone(), ist.clone())
        out9[f"iteration{it}"] = {
            "active_lanes": n_act,
            "lanes_differing_from_k1_gather_previous": diff,
            "one_launch_per_call": one_launch,
            "batch": batch_ms(lambda f, i: k9(f, i, t, idx, it), make, 20,
                              V9.K9_RE),
            "batch_gather_previous": batch_ms(
                lambda f, i: gather_previous(f, i, t, idx, it), make, 20,
                f"{V9.PREVIOUS_K9_RE}|{V9.GATHER_RE}"),
            "bound": pinned_fetch_bound(ist, t, n_sph)}
        torch.cuda.empty_cache()
    check(all(c["one_launch_per_call"] for c in out9.values()),
          "K9 launch count")
    check(all(v == 0 for c in out9.values()
              for v in c["lanes_differing_from_k1_gather_previous"].values()),
          f"K9 differs from K1 + gather + the previous K9: {out9}")

    # The even-row tile: the public route against the three-launch route
    W, H = V.W, V.H
    rows = torch.arange(W * H, device=dev).reshape(H, W)[::2].reshape(-1)
    tu, tv = st["u"][rows].contiguous(), st["v"][rows].contiguous()
    del st
    loop_args = (scene, cam, tu, tv, 7, V.SPP, 0, V.DEPTH, V.TMIN, float(W),
                 float(H), None)

    def three_launch(impl, tables, fs_, ist_, u_, v_, cc, seed32, it, last_,
                     md, tmin, u9):
        t, idx = K1.sweep(fs_[0:6], tables[1], tmin)
        K2.shade_and_regen(fs_, ist_, t, fetch_attr_planes(idx, tables[2]),
                           u_, v_, cc, seed32, it, last_, md, u9)

    tile_bad = {"injected": [], "philox": []}

    def side_by_side(key):
        def run(impl, tables, fs_, ist_, u_, v_, cc, seed32, it, last_, md,
                tmin, u9):
            t, idx = K1.sweep(fs_[0:6], tables[1], tmin)
            ref = [fs_.clone(), ist_.clone()]
            K2.shade_and_regen(*ref, t, fetch_attr_planes(idx, tables[2]),
                               u_, v_, cc, seed32, it, last_, md, u9)
            K2.shade_and_regen_fetch(fs_, ist_, t, idx, tables[2], u_, v_, cc,
                                     seed32, it, last_, md, u9)
            tile_bad[key].append(int(_bitwise_lanes(
                [(fs_, ref[0]), (ist_, ref[1])], fs_.shape[1]).sum()))
        return run

    def route():
        return render_tile_sum(scene, cam, rows.numel(), 7, V.SPP, 0,
                               V.DEPTH, V.TMIN, float(W), float(H),
                               persistent=True, u=tu, v=tv)

    def three():
        return I.pinned_render_loop(*loop_args, None, None, three_launch)

    I.pinned_render_loop(*loop_args, None, lambda it: torch.rand(
        (9, rows.numel()), generator=g, device=dev), side_by_side("injected"))
    I.pinned_render_loop(*loop_args, None, None, side_by_side("philox"))
    img_route = route()  # warm-up
    img_three = three()
    tile_bitwise = bool(torch.equal(_bits(img_route), _bits(img_three)))
    reset_counts()
    route()
    torch.cuda.synchronize()
    launches_route = counts()
    reset_counts()
    three()
    torch.cuda.synchronize()
    launches_three = counts()
    secs = {"route": [], "three_launch": []}
    order = [("route", route), ("three_launch", three)]
    for r in range(3):
        for nm, fn in (order[::-1] if r % 2 else order):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs[nm].append(time.perf_counter() - t0)
    del img_route, img_three
    keep = ("gather", "sweep", "shade_pinned")
    tile = {"pixels": rows.numel(), "spp": V.SPP,
            "iterations_differing_lanes": tile_bad,
            "image_bitwise_three_launch": tile_bitwise,
            "launches_route": {k: launches_route[k] for k in keep},
            "launches_three_launch": {k: launches_three[k] for k in keep},
            "seconds_runs": secs,
            "seconds_median": {k: sorted(v)[1] for k, v in secs.items()}}
    check(all(v == 0 for b in tile_bad.values() for v in b)
          and all(tile_bad.values()),
          f"K9 differs on the even-row tile: {tile_bad}")
    check(tile_bitwise, "the tile's image differs from the three-launch "
                        "route's")
    check(launches_route["shade_pinned"] > 0 and launches_route["gather"] == 0
          and launches_route["sweep"] == launches_route["shade_pinned"],
          f"the tile's route launched {launches_route}")

    # K13 against the previous K13 and the plain version, eight cases
    tabs, cases = V9.k13_cases(dev)
    out13 = {}
    for case, rays in cases.items():
        before = K13.launches
        got = K13.grid_sweep(rays, *tabs, V.TMIN)
        prev = K13.grid_sweep_all_roots(rays, *tabs, V.TMIN)
        torch.cuda.synchronize()
        one_launch = K13.launches == before + 1
        tp, ip, sp, reach = K13.grid_sweep_ref(rays, *tabs, V.TMIN,
                                               with_reach=True)
        same = {"previous": all(torch.equal(_bits(a), _bits(b))
                                for a, b in zip(got, prev)),
                "plain": all(torch.equal(_bits(a), _bits(b))
                             for a, b in zip(got, (tp, ip, sp)))}
        out13[case] = {
            "bitwise": same, "one_launch_per_call": one_launch,
            "culled_share": int(got[2].sum()) / (got[2].numel() * tabs.K),
            "batch": batch_ms(lambda: K13.grid_sweep(rays, *tabs, V.TMIN),
                              lambda: (), 20, V9.K13_RE),
            "batch_previous": batch_ms(
                lambda: K13.grid_sweep_all_roots(rays, *tabs, V.TMIN),
                lambda: (), 20, V9.PREVIOUS_K13_RE),
            "bound": grid_bound(rays.shape[1], tabs, reach)}
        del got, prev, tp, ip, sp
    del cases
    check(all(c["one_launch_per_call"] and all(c["bitwise"].values())
              for c in out13.values()),
          f"K13 differs from the previous K13 or its plain version: "
          f"{ {k: c['bitwise'] for k, c in out13.items()} }")
    occ = {"grid_sweep": K13.occupancy(tabs.n_global, tabs.K, tabs.P, dev)}
    emit({"phase": "k9_k13_redesign", "card": card, "spheres": n_sph,
          "grid": {"n_global": tabs.n_global, "K": tabs.K, "P": tabs.P},
          "k9": out9, "even_row_tile": tile, "k13": out13, "occupancy": occ,
          "note": "batch: batch_ms through the wrapper (event_ms: one "
                  "event pair around 20 launches; K9 each on its own copy "
                  "of the state); batch_gather_previous: the gather and "
                  "the previous K9; bound: from this run's inputs",
          "tolerance": "K9: every state word bit for bit K1 + gather + the "
                       "previous K9's at every iteration and draw, on the "
                       "film and at every iteration of the tile; the tile's "
                       "image bitwise the three-launch route's; K13: t, idx "
                       "and skips bit for bit the previous K13's and the "
                       "plain version's on every case"})
    torch.cuda.empty_cache()

    out = V9.run_pass_set(dev, 1, k9_builds=("shipped", "exit"),
                          k13_builds=("shipped", "persistent",
                                      "shipped_roots"))
    emit({"phase": "k9_k13_variants", "card": card, **out,
          "note": "one pass of the shipped designs and the ones each change "
                  "replaced (the others: scripts/torch_k9_k13_variants.py "
                  "alone); event_ms: one CUDA event pair around n launches "
                  "(K9: each on its own copy of the state); profiler_ms: "
                  "the profiler's per-launch mean; pinned_render: host-clock "
                  "seconds and the step's device time per render by the "
                  "profiler, medians of 3 in turns"})
    return {"shade_pinned": {"ms": out9["iteration24"]["batch"]["event_ms"],
                             "bound": out9["iteration24"]["bound"]},
            "grid_sweep": {"ms": out13["camera_row_major"]["batch"][
                "event_ms"], "bound": out13["camera_row_major"]["bound"]}}


def cli_phases(card) -> None:
    """The command line on the card (``raytracingweekend_jl_tpu_torch.cli``),
    in a temporary directory so that nothing lands in the tree, at the
    flagship film (``scene_random_spheres(seed=1)``, ``t_cam1``, 1920x1080):
    spp 8 in two chunks of 4 uninterrupted, then 4 samples to a checkpoint
    resumed to 8 (``main`` in-process; the uninterrupted run keeps its own
    checkpoint, whose sum the resumed one must equal bit for bit), with K1's
    and K2's launches counted over the three runs; the resumed PNG read back
    against the image it was written from; then one run of the module in a
    subprocess (spp 1), ``--stats``, the reference scene, float64 on the
    fixed-depth route (and raising on the persistent one), the refused
    ``--mesh-tiles 2``, and ``scripts/torch_inverse_render.py --steps 4``
    in a subprocess. Prints the runs' wall seconds, Mpaths/s and phases."""
    import contextlib
    import io
    import os
    import tempfile
    import numpy as np
    import torch
    from raytracingweekend_jl_tpu_torch import cli
    from raytracingweekend_jl_tpu_torch.utils.checkpoint import load_state
    from raytracingweekend_jl_tpu_torch.utils.image import read_png, to_uint8

    root = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": root}
    flag = ["--scene", "random_spheres", "--camera", "cam1", "--width",
            "1920"]
    name = torch.cuda.get_device_name(0)

    def main(argv) -> list:
        """``cli.main(argv)`` in-process; its JSON lines."""
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        return [json.loads(x) for x in buf.getvalue().splitlines()
                if x.startswith("{")]

    def figures(rec) -> dict:
        return {k: rec.get(k) for k in ("label", "wall_s", "paths",
                                        "mpaths_per_s", "phases", "device")}

    def subprocess_run(args, tmp) -> tuple:
        out = subprocess.run([sys.executable, *args], cwd=tmp, env=env,
                             capture_output=True, text=True, timeout=600)
        lines = [x for x in out.stdout.splitlines() if x.startswith("{")]
        return out.returncode, (json.loads(lines[-1]) if lines else None), \
            out.stderr[-2000:]

    here = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="rtw_cli_") as tmp:
        os.chdir(tmp)
        try:
            chunked = flag + ["--spp-chunk", "4"]
            reset_counts()
            full = main(chunked + ["--spp", "8", "--checkpoint", "full.npz",
                                   "-o", "full.png"])
            part = main(chunked + ["--spp", "4", "--checkpoint", "ck.npz",
                                   "-o", "part.png"])
            resumed = main(chunked + ["--spp", "8", "--checkpoint", "ck.npz",
                                      "-o", "resumed.png"])
            launched = counts()
            st_full, st_res = load_state("full.npz"), load_state("ck.npz")
            bitwise = bool(np.array_equal(st_full.radiance_sum,
                                          st_res.radiance_sum))
            written = to_uint8(np.sqrt(np.clip(st_res.image, 0.0, None)))
            png = read_png("resumed.png")
            png_equal = bool(np.array_equal(png, written / 255.0))
            png_same = bool(np.array_equal(png, read_png("full.png")))

            reset_counts()
            stats = main(flag + ["--spp", "1", "--stats", "-o", "stats.png"])
            stats_launches = counts()
            ref = main(["--scene", "random_spheres_reference", "--camera",
                        "cam1", "--width", "1920", "--spp", "1", "-o",
                        "reference.png"])
            ref_png = read_png("reference.png")
            f64 = main(["--width", "400", "--spp", "1", "--precision", "f64",
                        "--no-persistent", "-o", "f64.png"])
            try:
                main(["--width", "400", "--spp", "1", "--precision", "f64",
                      "-o", "f64_persistent.png"])
                f64_persistent = "ran"
            except NotImplementedError as e:
                f64_persistent = f"NotImplementedError: {e}"
            try:
                main(flag + ["--spp", "1", "--mesh-tiles", "2", "-o",
                             "mesh.png"])
                mesh_code = 0
            except SystemExit as e:
                mesh_code = e.code
            mesh_wrote = os.path.exists("mesh.png")

            mod_rc, mod_rec, mod_err = subprocess_run(
                ["-m", "raytracingweekend_jl_tpu_torch.cli", *flag, "--spp",
                 "1", "-o", "module.png"], tmp)
            t0 = time.perf_counter()
            inv_rc, inv_rec, inv_err = subprocess_run(
                [os.path.join(root, "scripts", "torch_inverse_render.py"),
                 "--steps", "4", "--out-dir", os.path.join(tmp, "inverse")],
                tmp)
            inv_s = time.perf_counter() - t0
        finally:
            os.chdir(here)

    emit({"phase": "cli", "card": card, "size": [1920, 1080],
          "resume": {"uninterrupted_spp8_chunks4": figures(full[-1]),
                     "first_spp4": figures(part[-1]),
                     "resumed_to_spp8": figures(resumed[-1]),
                     "progress_lines": [x for x in full + part + resumed
                                        if "samples_done" in x],
                     "samples_done": [st_full.samples_done,
                                      st_res.samples_done],
                     "radiance_sum_bitwise": bitwise,
                     "png_equals_written_image": png_equal,
                     "png_equals_uninterrupted_png": png_same,
                     "launches": {k: v for k, v in launched.items() if v}},
          "stats": {"occupancy": stats[0], "render": figures(stats[-1]),
                    "launches": {k: v for k, v in stats_launches.items()
                                 if v}},
          "reference_scene": figures(ref[-1]),
          "f64_no_persistent_400": figures(f64[-1]),
          "f64_persistent": f64_persistent,
          "mesh_tiles_2_exit": mesh_code, "mesh_tiles_2_wrote": mesh_wrote,
          "module_run": {"rc": mod_rc, "record": figures(mod_rec or {}),
                         "stderr_tail": mod_err if mod_rc else ""},
          "inverse_script": {"rc": inv_rc, "seconds": inv_s,
                             "record": inv_rec,
                             "stderr_tail": inv_err if inv_rc else ""},
          "checks": "resumed radiance sum bit for bit the uninterrupted "
                    "chunked run's; sweep and shade_strided launched; the "
                    "PNG reads back as the image written; the other runs "
                    "exit 0 and report the card, the sharded one non-zero"})
    check(st_full.samples_done == st_res.samples_done == 8,
          f"samples done {st_full.samples_done}, {st_res.samples_done}")
    check(bitwise, "the resumed render differs from the uninterrupted one")
    check(launched["sweep"] > 0 and launched["shade_strided"] > 0,
          f"the CLI's render launched {launched}")
    check(bool(np.isfinite(st_full.image).all())
          and st_full.image.shape == (1080, 1920, 3),
          "non-finite or misshapen CLI image")
    check(png_equal and png_same, "the written PNG does not read back")
    for rec in (full[-1], part[-1], resumed[-1], stats[-1], ref[-1],
                f64[-1]):
        check(rec["device"]["name"] == name, f"record's device {rec}")
        check(rec["mpaths_per_s"] > 0, f"record's rate {rec}")
    check(set(resumed[-1]["phases"]) == {"trace", "fetch", "checkpoint"},
          f"phases {resumed[-1]['phases']}")
    occ = stats[0]["bounce_occupancy"]
    check(occ[0] == 1.0 and stats_launches["sweep"] > 0,
          f"--stats: {stats[0]}, launches {stats_launches}")
    check(ref_png.shape == (1080, 1920, 3), "reference-scene PNG shape")
    check(f64_persistent.startswith("NotImplementedError"),
          "f64 on the persistent route did not raise")
    check(mesh_code not in (None, 0) and not mesh_wrote,
          f"--mesh-tiles 2 exited {mesh_code!r}")
    check(mod_rc == 0 and mod_rec is not None
          and mod_rec["device"]["name"] == name,
          f"the module run failed ({mod_rc}): {mod_err}")
    check(inv_rc == 0 and inv_rec is not None
          and bool(np.isfinite([inv_rec["loss_init"],
                                inv_rec["loss_final"]]).all()),
          f"the inverse script failed ({inv_rc}): {inv_err}")


def k1_phase_rays(dev, cam, spheres, g=None):
    """The K1 phase's 2^20 rays [6, 2^20] of the flagship: 2^19 camera rays
    (film points and lens samples from ``g``, by default a generator seeded
    with 0), then 2^19 rays leaving their hit points (or the camera, on a
    miss) in random unit directions."""
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    if g is None:
        g = torch.Generator(device=dev).manual_seed(0)
    n_half = 1 << 19
    s = torch.rand(n_half, generator=g, device=dev)
    t = torch.rand(n_half, generator=g, device=dev)
    disk = pt.unit_disk_points((n_half,), generator=g, device=dev)
    o_cam, d_cam = pt.make_rays(cam, s, t, disk)
    rays_cam = torch.cat([o_cam.T, d_cam.T]).contiguous()
    t_cam, _ = K1.sweep_ref(rays_cam, spheres)
    hit = t_cam < K1.BIG
    p = o_cam + torch.where(hit, t_cam, torch.ones_like(t_cam))[:, None] * d_cam
    d_sc = pt.unit_sphere_directions((n_half,), generator=g, device=dev)
    return torch.cat([rays_cam, torch.cat([p.T, d_sc.T])], dim=1).contiguous()


def mid_render_state(scene, cam, W: int, H: int, SPP: int, k: int = 64):
    """The flagship's strided state after 24 iterations (32 400 lanes at
    k = 64): ``(state, camera constants, tables, seed)``."""
    from raytracingweekend_jl_tpu_torch import rng
    from raytracingweekend_jl_tpu_torch.ops import integrator as I
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
    from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat
    st = I.init_strided_state(cam, W * H, W, H, 5, SPP, 0, 16, k,
                              device=scene.device)
    cc = K2.pack_camera_consts(cam, W, H)
    tables = (scene, K1.sphere_consts(scene), attr_mat(scene))
    seed32 = rng.persistent_seed(5, 0)
    for it in range(24):  # a realistic mid-render state
        I.strided_step(tables, st, cc, seed32, it, 0, 16, 1e-4, "kernels")
    return st, cc, tables, seed32


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops import integrator as I
    from raytracingweekend_jl_tpu_torch.ops.cuda import build
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2

    # Full float32 in every matrix product of the plain path (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    build.build(verbose=True)
    build.load()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": build.library_path(), "flags": build.NVCC_FLAGS})

    W, H, SPP = 1920, 1080, 4
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    cam = pt.t_cam1(device=dev)
    spheres = K1.sphere_consts(scene)
    check(scene.n_spheres == 488, f"flagship scene has {scene.n_spheres}")

    # -- 2. K1 against sweep_ref: 2^20 rays and the flagship's lanes -------
    g = torch.Generator(device=dev).manual_seed(0)
    rays = k1_phase_rays(dev, cam, spheres, g)
    k = 64
    st, cc, tables, seed32 = mid_render_state(scene, cam, W, H, SPP, k)
    n_lanes = st.fstate.shape[1]
    check(n_lanes == 32400, f"flagship lanes {n_lanes}")
    rays_f = st.fstate[0:6].contiguous()

    # K1 at the P its rule picks for each set (1 and 8 on an H100)
    resident = K1._resident_threads(dev, spheres.shape[0])
    by_set = {}
    for name, r in (("rays_2p20", rays), ("mid_render_32400", rays_f)):
        t_k, i_k = K1.sweep(r, spheres)
        torch.cuda.synchronize()
        t_r, i_r = K1.sweep_ref(r, spheres)
        by_set[name] = {
            "rays": r.shape[1],
            "parts_chosen": K1.sweep_parts(r.shape[1], spheres.shape[0],
                                           resident),
            "hit_share": (t_r < K1.BIG).float().mean().item(),
            "idx_identical": bool(torch.equal(i_k, i_r)),
            "t_bit_equal_share": (t_k == t_r).float().mean().item(),
            "t_max_rel_err": ((t_k - t_r).abs()
                              / t_r.abs().clamp(min=1e-30)).max().item(),
            "t_max_abs_err": (t_k - t_r).abs().max().item()}
    k1_err = by_set["mid_render_32400"]["t_max_abs_err"]  # the main path's
    vs_one = {"rays_2p20": split_vs_one_thread(rays, spheres, tables[2]),
              "mid_render_32400": split_vs_one_thread(rays_f, spheres,
                                                      tables[2])}
    emit({"phase": "k1_vs_plain", "by_set": by_set,
          "lanes_differing_from_one_thread_by_p": vs_one,
          "tolerance": "against sweep_ref, on both ray sets at the P the "
                       "rule picks: idx identical; t bit-equal on >= "
                       "99.99%, rel 1e-6 on all; against the kept "
                       "one-thread kernel, on both ray sets at every P: 0 "
                       "lanes differ in any bit"})
    for name, c in by_set.items():
        check(c["idx_identical"], f"K1 idx differs from sweep_ref ({name})")
        check(c["t_bit_equal_share"] >= 0.9999,
              f"K1 t bit-equal on only {c['t_bit_equal_share']} ({name})")
        check(c["t_max_rel_err"] <= 1e-6,
              f"K1 t relative error {c['t_max_rel_err']} ({name})")
    check(all(v == 0 for d in vs_one.values() for v in d.values()),
          f"K1 differs from the one-thread kernel: {vs_one}")

    # -- 3. K2 against its plain version (the gather, then
    # shade_strided_step_ref) at the flagship lane count, injected and
    # Philox draws, every word of the state and the strip buffers bit for
    # bit ---------------------------------------------------------------------
    t_s, i_s = K1.sweep(rays_f, spheres)
    state0 = [x.clone() for x in (st.fstate, st.istate, st.buf)]

    def restore(dst):
        for x, y in zip(dst, state0):
            x.copy_(y)

    def k2_diff(u9):
        kern = [x.clone() for x in state0]
        ref = [x.clone() for x in state0]
        K2.shade_strided_step(*kern, t_s, i_s, tables[2], cc, st.geom, seed32,
                              24, 0, 16, u9)
        torch.cuda.synchronize()
        K2.shade_strided_fetch_ref(*ref, t_s, i_s, tables[2], cc, st.geom,
                                   seed32, 24, 0, 16, u9)
        return int(_bitwise_lanes(list(zip(kern, ref)), n_lanes).sum())

    u9 = torch.rand((9, n_lanes), generator=g, device=dev)
    k2_bad = {"injected": k2_diff(u9), "philox": k2_diff(None)}
    k2_err = 0.0  # every word equal (checked below)
    emit({"phase": "k2_vs_plain", "lanes": n_lanes, "k": k,
          "active_share": state0[1][5].float().mean().item(),
          "lanes_differing_by_case": k2_bad,
          "tolerance": "fstate, istate and buf bit for bit on every lane"})
    check(all(v == 0 for v in k2_bad.values()),
          f"K2 differs from its plain version: {k2_bad}")

    # The render's first 32 iterations: K1, then K2 on one state and the
    # plain step on a copy, from the same sweep; the two states bit for bit
    # after every iteration (Philox draws, the render's own seed).
    st_k = I.init_strided_state(cam, W * H, W, H, 5, SPP, 0, 16, k,
                                device=dev)
    st_p = [x.clone() for x in (st_k.fstate, st_k.istate, st_k.buf)]
    loop_bad = []
    for it in range(32):
        t_i, i_i = K1.sweep(st_k.fstate[0:6].contiguous(), spheres)
        K2.shade_strided_step(st_k.fstate, st_k.istate, st_k.buf, t_i, i_i,
                              tables[2], cc, st_k.geom, seed32, it, 0, 16)
        K2.shade_strided_fetch_ref(*st_p, t_i, i_i, tables[2], cc, st_k.geom,
                                   seed32, it, 0, 16)
        loop_bad.append(int(_bitwise_lanes(list(zip(
            (st_k.fstate, st_k.istate, st_k.buf), st_p)), n_lanes).sum()))
    emit({"phase": "k2_loop_vs_plain", "lanes": n_lanes, "iterations": 32,
          "active_share_after": (st_k.istate[5] != 0).float().mean().item(),
          "strips_done_max": int(st_k.istate[2].max()),
          "lanes_differing_by_iteration": loop_bad,
          "tolerance": "0 lanes differ in any word after every iteration"})
    check(not any(loop_bad), f"K2's loop differs from plain: {loop_bad}")
    del st_k, st_p

    # -- 4. in-kernel Philox against the plain path: 4 spheres, 256x144x64,
    # the strided route pinned (the image is small enough for K8) -----------
    s4, c4 = pt.scene_4_spheres(device=dev), pt.t_default_cam(device=dev)
    img_k = pt.render_radiance(s4, c4, 256, 64, seed=2, device=dev,
                               persistent=True, inline=False)
    img_p = pt.render_radiance(s4, c4, 256, 64, seed=2, device=dev,
                               impl="plain", persistent=True, inline=False)
    mk, mp = img_k.mean((0, 1)), img_p.mean((0, 1))
    rel4 = ((mk - mp).abs() / mp).max().item()
    emit({"phase": "philox_render_vs_plain", "scene": "4_spheres",
          "size": [256, 144], "spp": 64, "means_kernels": mk.tolist(),
          "means_plain": mp.tolist(), "max_rel_diff": rel4,
          "tolerance": "each channel mean within 1%"})
    check(bool(torch.isfinite(img_k).all()), "non-finite 4_spheres image")
    check(rel4 <= 0.01, f"4_spheres means differ by {rel4}")

    # -- 5. the slice: the flagship render through the public entry point ----
    flag_scene = pt.scene_random_spheres(seed=1)
    flag_cam = pt.t_cam1()
    pt.render(flag_scene, flag_cam, W, SPP, persistent=True, device="cuda")
    torch.cuda.synchronize()  # warm-up: first-call allocations and loads
    reset_counts()
    t0 = time.perf_counter()
    img = pt.render(flag_scene, flag_cam, W, SPP, persistent=True,
                    device="cuda")
    torch.cuda.synchronize()
    sec_k = time.perf_counter() - t0
    launches = {k: v for k, v in counts().items()
                if k in ("gather", "sweep", "shade_strided")}

    def timed(**kw):
        t0 = time.perf_counter()
        out = pt.render(flag_scene, flag_cam, W, SPP, persistent=True,
                        device="cuda", **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    runs_k = sorted([sec_k] + [timed()[0] for _ in range(4)])
    sec_p, img_plain = timed(impl="plain")
    runs_p = sorted([sec_p, timed(impl="plain")[0]])
    sec_k, sec_p = runs_k[len(runs_k) // 2], runs_p[0]
    check(launches["sweep"] > 0 and launches["shade_strided"] > 0,
          f"main path launched {launches}")
    check(launches["gather"] == 0, f"the strided loop gathered: {launches}")
    check(tuple(img.shape) == (H, W, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "non-finite flagship image")
    lin_k = (img * img).mean((0, 1))
    lin_p = (img_plain * img_plain).mean((0, 1))
    rel6 = ((lin_k - lin_p).abs() / lin_p).max().item()
    paths = W * H * SPP
    emit({"phase": "flagship", "card": card, "size": [W, H], "spp": SPP,
          "launches": launches, "seconds_kernels_runs": runs_k,
          "seconds_plain_runs": runs_p,
          "seconds_kernels_median": sec_k, "seconds_plain_min": sec_p,
          "mpaths_per_s_kernels": paths / sec_k / 1e6,
          "mpaths_per_s_plain": paths / sec_p / 1e6,
          "means_kernels": lin_k.tolist(), "means_plain": lin_p.tolist(),
          "max_rel_diff": rel6, "tolerance": "each channel mean within 1%"})
    check(rel6 <= 0.01, f"flagship means differ by {rel6}")

    # -- 6. kernel times at the flagship shapes (CUDA events) ----------------
    live = [x.clone() for x in state0]
    k1 = lambda: K1.sweep(rays_f, spheres)
    k1_plain = lambda: K1.sweep_ref(rays_f, spheres)
    k2 = lambda: K2.shade_strided_step(*live, t_s, i_s, tables[2], cc,
                                       st.geom, seed32, 24, 0, 16)
    k2_plain = lambda: K2.shade_strided_fetch_ref(*live, t_s, i_s, tables[2],
                                                  cc, st.geom, seed32, 24, 0,
                                                  16)
    reset = lambda: restore(live)
    long_sleep = 3_000_000_000  # covers the plain versions' host enqueue
    k1_ms = device_ms(k1, 50)
    k1_plain_ms = device_ms(k1_plain, 3, sleep_cycles=long_sleep)
    k2_ms = device_ms(k2, 50, setup=reset)
    k2_plain_ms = device_ms(k2_plain, 5, setup=reset,
                            sleep_cycles=long_sleep)
    fwd_dev_ms = {"sweep": k1_ms, "sweep_plain": k1_plain_ms,
                  "shade_strided": k2_ms, "shade_strided_plain": k2_plain_ms}
    fwd_call_ms = {"sweep": call_ms(k1, 50),
                   "sweep_plain": call_ms(k1_plain, 3),
                   "shade_strided": call_ms(k2, 50, setup=reset),
                   "shade_strided_plain": call_ms(k2_plain, 5, setup=reset)}

    # -- 7. where the flagship render's time goes (torch.profiler) ----------
    emit({"phase": "profile", "card": card, **profile_call(
        lambda: pt.render(flag_scene, flag_cam, W, SPP, persistent=True,
                          device="cuda"), RENDER_SUMS)})

    # -- 8-9. the gradient slice: K3-K6, then the public entry point -------
    grad_rows, grad_dev_ms, grad_call_ms, snap = grad_kernel_phases(
        dev, card, scene, cam, W, H)
    emit({"phase": "kernel_times", "card": card,
          "device_ms": {**fwd_dev_ms, **grad_dev_ms},
          "call_ms": {**fwd_call_ms, **grad_call_ms},
          "shapes": "sweep, shade_strided: 32 400 lanes mid-render, 488 "
                    "spheres, k = 64; sweep_masked, persist_record: one "
                    "record iteration (20) at 262 144 lanes, 8 strips; "
                    "persist_replay_fused: the whole 44-slot phase; "
                    "persist_replay_step: one slot of the lean record",
          "note": "device_ms: card time only (queue pre-filled); call_ms: "
                  "per synchronised call, host enqueue included"})
    grad_launches = grad_entry_phases(dev, card)
    for row in grad_rows:
        row["launches"] = grad_launches[row["name"]]

    # -- 10-11. the inverse-rendering slice: K7 and K8, then fit_scene -----
    fit_rows, _, _, fit_in = fit_slice_phases(dev, card)

    # -- 12. the fixed-depth wavefront and the pinned route: K10, K9 -------
    trace_rows = trace_slice_phases(dev, card, scene, cam, rays, lin_k)

    # -- 13. the fused record step, the megakernel, the cluster sweep ------
    last_rows = last_kernel_phases(dev, card, snap)

    # -- 14. K1's and K3's schedules at the main paths' widths ------------
    sweep_redesign_phases(dev, card, cam, rays_f, snap)

    # -- 15. K2 and K4 beside their previous forms, by both timing methods
    fwd = dict(state=state0, t=t_s, idx=i_s, amat=tables[2], cc=cc,
               geom=st.geom, seed=seed32, rays=rays_f, spheres=spheres,
               cam=cam)
    batch = shade_redesign_phases(dev, card, fwd, snap)
    del fwd, snap

    # -- 16. K5 and K6 beside their previous forms, by both timing methods
    batch.update(replay_redesign_phases(dev, card))

    # -- 17. K7a and K8 beside their previous forms; the fit step profiled
    fit_batch = fit_redesign_phases(dev, card, fit_in)
    fit_losses = fit_in["losses"]
    del fit_in
    for row in fit_rows:
        row["ms"] = fit_batch[row["name"]]

    # -- 18. K10 and K12 beside their previous forms; both per render -----
    redesign = k10_k12_redesign_phases(dev, card, rays, rays_f)
    for row in trace_rows + last_rows:
        r = redesign.get(row["name"])
        if r is not None:
            row["ms"] = r["ms"]
            if "bound" in r:
                row.update(plain_ms=r["plain_ms"],
                           max_abs_err=r["max_abs_err"],
                           bound_ms=r["bound"]["bound_ms"],
                           bound_by=r["bound"]["bound_by"])

    # -- 19. the flagship step with recomputed passes -----------------------
    remat_passes_phases(dev, card)

    # -- 20. K7c and K11 beside their previous forms ------------------------
    redesign = k7c_k11_redesign_phases(dev, card, fit_losses)
    for row in last_rows:
        r = redesign.get(row["name"])
        if r is not None:
            row.update(ms=r["ms"], plain_ms=r["plain_ms"],
                       max_abs_err=r["max_abs_err"],
                       bound_ms=r["bound"]["bound_ms"],
                       bound_by=r["bound"]["bound_by"])

    # -- 21. K9 and K13 beside their previous forms ------------------------
    redesign = k9_k13_redesign_phases(dev, card)
    for row in trace_rows + last_rows:
        r = redesign.get(row["name"])
        if r is not None:
            row.update(ms=r["ms"], bound_ms=r["bound"]["bound_ms"],
                       bound_by=r["bound"]["bound_by"])

    # -- 22. K7b beside its previous form ----------------------------------
    k7b_redesign_phases(dev, card)

    # -- 23. the edge estimator and fit_scene_scan --------------------------
    edge_phases(dev, card)
    fit_scan_phases(dev, card)

    # -- 24. the command line and the checkpointed render ------------------
    cli_phases(card)

    # -- the kernels line: every ported kernel, with its bound -------------
    n_rays, n_sph = rays_f.shape[1], spheres.shape[0]
    n_active = int((state0[1][5] != 0).sum())
    # K1: rays and table in, t and idx out; every ray against every sphere.
    k1_bound = bound(n_rays * (24 + 8) + 16 * n_sph,
                     n_rays * (SWEEP_RAY_OPS + SWEEP_SPHERE_OPS * n_sph))
    # K2: per lane the 12 float and 7 int state words, t and idx in, the 12
    # float and 6 int state words out (lane_lim is only read); on the lanes
    # that fold a finished pixel (their strip advances in this step, from
    # below k) the strip's 3 buf words in and out; the camera constants and
    # the attribute table once.
    after = [x.clone() for x in state0]
    K2.shade_strided_fetch_ref(*after, t_s, i_s, tables[2], cc, st.geom,
                               seed32, 24, 0, 16)
    n_fold = int(((after[1][2] != state0[1][2]) & (state0[1][2] < k)).sum())
    k2_bound = bound(n_lanes * ((12 + 7 + 1 + 1) + (12 + 6)) * 4
                     + n_fold * 6 * 4 + 21 * 4 + n_sph * 40,
                     n_active * (SHADE_OPS + ADVANCE_OPS))
    del after
    pkg, tpu = "raytracingweekend_jl_tpu_torch/csrc", \
        "raytracingweekend_jl_tpu/ops/pallas"
    fwd_rows = [kernel_row("sweep", f"{pkg}/sweep.cu",
                           f"{tpu}/intersect_kernel.py:55", k1_err,
                           batch["sweep"], k1_plain_ms, k1_bound),
                kernel_row("shade_strided", f"{pkg}/shade_strided.cu",
                           f"{tpu}/shade_kernel.py:380", k2_err,
                           batch["shade_strided"], k2_plain_ms, k2_bound)]
    fwd_rows[0]["launches"] = launches["sweep"]
    fwd_rows[1]["launches"] = launches["shade_strided"]
    for row in grad_rows:
        if row["name"] in ("persist_record", "persist_replay_fused",
                           "persist_replay_step"):
            row["ms"] = batch[row["name"]]
    rows = fwd_rows + grad_rows + fit_rows + trace_rows + last_rows
    for row in rows:
        check(row["launches"] > 0, f"{row['name']} never launched on its "
                                   "main path")
    emit({"kernels": rows})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
