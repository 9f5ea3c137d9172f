"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``raytracingweekend_jl_tpu_torch/csrc``,
checks each against its plain PyTorch version on the card, drives the
flagship forward render through the public ``render(..., device="cuda")``
entry point, and times the kernels and the render against the plain path.
Each phase prints one JSON line; a failed check raises and the script exits
non-zero without printing a result. The last line is
``{"ok": true, "device": {...}}``. It needs a CUDA device and exits non-zero
without one. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def emit(obj) -> None:
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


def profile_render(render_once) -> dict:
    """Device time by kernel and the device's busy share over one render,
    from torch.profiler (CUPTI)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        render_once()
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
    return {"wall_s_profiled": wall, "device_busy_s": busy_s,
            "device_idle_share": (1 - busy_s / wall) if rows else None,
            "top_kernels": [{"name": k[:80], "device_ms": us / 1e3,
                             "count": c} for k, us, c in rows[:10]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch import rng
    from raytracingweekend_jl_tpu_torch.ops import integrator as I
    from raytracingweekend_jl_tpu_torch.ops.cuda import build
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
    from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
    from raytracingweekend_jl_tpu_torch.ops.materials import (
        attr_mat, fetch_attr_planes)

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

    # -- 2. K1 against sweep_ref: 2^20 rays ---------------------------------
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
    rays = torch.cat([rays_cam, torch.cat([p.T, d_sc.T])], dim=1).contiguous()
    K1.launches = 0
    t_k, i_k = K1.sweep(rays, spheres)
    torch.cuda.synchronize()
    t_r, i_r = K1.sweep_ref(rays, spheres)
    bit_equal = (t_k == t_r).float().mean().item()
    rel = ((t_k - t_r).abs() / t_r.abs().clamp(min=1e-30)).max().item()
    idx_equal = bool(torch.equal(i_k, i_r))
    k1_err = (t_k - t_r).abs().max().item()
    emit({"phase": "k1_vs_plain", "rays": rays.shape[1],
          "hit_share": (t_r < K1.BIG).float().mean().item(),
          "idx_identical": idx_equal, "t_bit_equal_share": bit_equal,
          "t_max_rel_err": rel, "t_max_abs_err": k1_err,
          "tolerance": "idx identical; t bit-equal on >= 99.99%, rel 1e-6 on all"})
    check(idx_equal, "K1 idx differs from sweep_ref")
    check(bit_equal >= 0.9999, f"K1 t bit-equal on only {bit_equal}")
    check(rel <= 1e-6, f"K1 t relative error {rel}")

    # -- 3. K2 against shade_strided_step_ref at the flagship lane count -----
    k = 64
    st = I.init_strided_state(cam, W * H, W, H, 5, SPP, 0, 16, k, device=dev)
    n_lanes = st.fstate.shape[1]
    check(n_lanes == 32400, f"flagship lanes {n_lanes}")
    cc = K2.pack_camera_consts(cam, W, H)
    tables = (scene, spheres, attr_mat(scene))
    seed32 = rng.persistent_seed(5, 0)
    for it in range(24):  # a realistic mid-render state
        I.strided_step(tables, st, cc, seed32, it, 0, 16, 1e-4, "kernels")
    t_s, i_s = K1.sweep(st.fstate[0:6], spheres)
    attrs = fetch_attr_planes(i_s, tables[2])
    state0 = [x.clone() for x in (st.fstate, st.istate, st.buf)]

    def restore(dst):
        for x, y in zip(dst, state0):
            x.copy_(y)

    def k2_compare(u9, it):
        kern = [x.clone() for x in state0]
        ref = [x.clone() for x in state0]
        K2.shade_strided_step(*kern, t_s, attrs, cc, st.geom, seed32, it, 0,
                              16, u9)
        torch.cuda.synchronize()
        K2.shade_strided_step_ref(*ref, t_s, attrs, cc, st.geom, seed32, it,
                                  0, 16, u9)
        ok = (kern[1] == ref[1]).all(0)
        err = 0.0
        for a, b in ((kern[0], ref[0]), (kern[2], ref[2])):
            ok &= ((a - b).abs() <= 1e-6 * b.abs().clamp(min=1)).all(0)
            err = max(err, (a - b).abs().max().item())
        return int((~ok).sum().item()), err

    u9 = torch.rand((9, n_lanes), generator=g, device=dev)
    bad_inj, k2_err = k2_compare(u9, 24)
    bad_philox, k2_err_philox = k2_compare(None, 24)
    emit({"phase": "k2_vs_plain", "lanes": n_lanes, "k": k,
          "active_share": state0[1][5].float().mean().item(),
          "lanes_outside_injected_u9": bad_inj, "max_abs_err_injected": k2_err,
          "lanes_outside_philox": bad_philox,
          "max_abs_err_philox": k2_err_philox,
          "tolerance": "int planes identical, float planes within "
                       "1e-6*max(1,|x|), on >= 99.99% of lanes"})
    limit = int(0.0001 * n_lanes)
    check(bad_inj <= limit, f"K2 (injected u9): {bad_inj} lanes outside")
    check(bad_philox <= limit, f"K2 (Philox): {bad_philox} lanes outside")

    # -- 4. in-kernel Philox against the plain path: 4 spheres, 256x144x64 ----
    s4, c4 = pt.scene_4_spheres(device=dev), pt.t_default_cam(device=dev)
    img_k = pt.render_radiance(s4, c4, 256, 64, seed=2, device=dev)
    img_p = pt.render_radiance(s4, c4, 256, 64, seed=2, device=dev,
                               impl="plain")
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
    K1.launches = 0
    K2.launches = 0
    t0 = time.perf_counter()
    img = pt.render(flag_scene, flag_cam, W, SPP, persistent=True,
                    device="cuda")
    torch.cuda.synchronize()
    sec_k = time.perf_counter() - t0
    launches = {"sweep": K1.launches, "shade_strided": K2.launches}

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
    rays_f = state0[0][0:6].contiguous()
    live = [x.clone() for x in state0]
    k1 = lambda: K1.sweep(rays_f, spheres)
    k1_plain = lambda: K1.sweep_ref(rays_f, spheres)
    k2 = lambda: K2.shade_strided_step(*live, t_s, attrs, cc, st.geom, seed32,
                                       24, 0, 16)
    k2_plain = lambda: K2.shade_strided_step_ref(*live, t_s, attrs, cc,
                                                 st.geom, seed32, 24, 0, 16)
    reset = lambda: restore(live)
    long_sleep = 3_000_000_000  # covers the plain versions' host enqueue
    k1_ms = device_ms(k1, 50)
    k1_plain_ms = device_ms(k1_plain, 3, sleep_cycles=long_sleep)
    k2_ms = device_ms(k2, 50, setup=reset)
    k2_plain_ms = device_ms(k2_plain, 5, setup=reset,
                            sleep_cycles=long_sleep)
    emit({"phase": "kernel_times", "card": card, "lanes": n_lanes,
          "spheres": scene.n_spheres, "k": k,
          "device_ms": {"sweep": k1_ms, "sweep_plain": k1_plain_ms,
                        "shade_strided": k2_ms,
                        "shade_strided_plain": k2_plain_ms},
          "call_ms": {"sweep": call_ms(k1, 50),
                      "sweep_plain": call_ms(k1_plain, 3),
                      "shade_strided": call_ms(k2, 50, setup=reset),
                      "shade_strided_plain": call_ms(k2_plain, 5,
                                                     setup=reset)},
          "note": "device_ms: card time only (queue pre-filled); call_ms: "
                  "per synchronised call, host enqueue included"})

    # -- 7. where the flagship render's time goes (torch.profiler) ----------
    emit({"phase": "profile", "card": card, **profile_render(
        lambda: pt.render(flag_scene, flag_cam, W, SPP, persistent=True,
                          device="cuda"))})

    pkg = "raytracingweekend_jl_tpu_torch"
    emit({"kernels": [
        {"name": "sweep", "route": "cuda", "source": f"{pkg}/csrc/sweep.cu",
         "replaces": "raytracingweekend_jl_tpu/ops/pallas/intersect_kernel.py:55",
         "launches": launches["sweep"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "shade_strided", "route": "cuda",
         "source": f"{pkg}/csrc/shade_strided.cu",
         "replaces": "raytracingweekend_jl_tpu/ops/pallas/shade_kernel.py:380",
         "launches": launches["shade_strided"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]})
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
