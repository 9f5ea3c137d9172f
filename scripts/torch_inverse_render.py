"""Inverse-rendering demo on the PyTorch/CUDA port: recover perturbed scene
parameters by gradient descent on an image loss, with the port's
``fit_scene`` (or ``fit_scene_scan`` with ``--scan``). The counterpart of
``scripts/inverse_render.py``, with its flags.

Perturb the sphere centers and albedos of a known scene, then run Adam
steps until the render matches the target. Artifacts (target, initial,
midway and final PNGs and the per-step losses as JSON lines) go to
``build/torch_inverse/`` by default. One JSON record of the run (losses,
parameter errors, seconds per step, Mpaths/s, the card's name and power
limit) is printed and appended to ``bench_history_torch.jsonl`` in the
working directory.

Usage:
  python scripts/torch_inverse_render.py                   # 4_spheres, card
  python scripts/torch_inverse_render.py --steps 150 --spp 8
  python scripts/torch_inverse_render.py --geom edge --steps 20
  python scripts/torch_inverse_render.py --width 48 --height 27 --steps 4 --cpu
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="4_spheres")
    ap.add_argument("--grid-half", type=int, default=None,
                    help="for --scene random_spheres: shrink the sphere "
                         "grid to (2N)^2 cells (e.g. 3 -> ~40 spheres)")
    ap.add_argument("--cam", default=None, choices=["default", "cam1"],
                    help="camera (default: cam1 for random_spheres, "
                         "else the default camera)")
    ap.add_argument("--width", type=int, default=200)
    ap.add_argument("--height", type=int, default=112)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--lr", type=float, default=2e-2,
                    help="Adam lr for albedo")
    ap.add_argument("--lr-center", type=float, default=8e-3,
                    help="Adam lr for centers (SPSA gradients)")
    ap.add_argument("--spsa-c", type=float, default=2e-2,
                    help="SPSA perturbation scale for centers")
    ap.add_argument("--spsa-pairs", type=int, default=2,
                    help="averaged SPSA probe pairs per step")
    ap.add_argument("--center-jitter", type=float, default=0.12)
    ap.add_argument("--albedo-scale", type=float, default=0.55)
    ap.add_argument("--albedo-shift", type=float, default=0.15,
                    help="additive albedo perturbation (scale*a + shift); "
                         "scale=1 shift=0 disables it")
    ap.add_argument("--lr-fuzz", type=float, default=0.0,
                    help=">0 jointly fits metal fuzz")
    ap.add_argument("--fuzz-jitter", type=float, default=0.0,
                    help="perturb metal movables' fuzz by U(-j, j), "
                         "clipped at 0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--geom", default="spsa", choices=["spsa", "edge"],
                    help="center-gradient estimator: SPSA probes or the "
                         "boundary-aware edge render's autodiff "
                         "(ops/edge.py)")
    ap.add_argument("--edge-sigma", type=float, default=None,
                    help="edge band half-width in scene units (default: "
                         "per-ray pixel footprint)")
    ap.add_argument("--edge-bounces", type=int, default=1)
    ap.add_argument("--edge-sigma-px", type=float, default=1.5,
                    help="auto-sigma band width in pixel footprints")
    ap.add_argument("--edge-chunk", type=int, default=None,
                    help="pixel chunk bounding the [R,N] silhouette sweep")
    ap.add_argument("--edge-remat", action="store_true",
                    help="recompute each edge chunk in the backward")
    ap.add_argument("--cosine-decay", action="store_true",
                    help="anneal every lr to 0 over the run")
    ap.add_argument("--scan", action="store_true",
                    help="fit_scene_scan: no host sync of its own per step")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (device='cpu'); default: the card")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build",
                                                      "torch_inverse"))
    return ap


def _errs(a, b, mask):
    """(max, mean) absolute error of ``a - b`` over the ``mask`` rows."""
    e = np.abs(a - b)[mask]
    return float(e.max()), float(e.mean())


def _per_sphere(a, b, mask):
    """Per-sphere error (max over components) of the ``mask`` rows."""
    e = np.abs(a - b)[mask]
    return e.reshape(e.shape[0], -1).max(axis=1)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops.edge import (pixel_angle,
                                                         render_radiance_edge)
    from raytracingweekend_jl_tpu_torch.ops.vecmath import gamma2_encode
    from raytracingweekend_jl_tpu_torch.utils.image import write_png
    from raytracingweekend_jl_tpu_torch.utils.metrics import (
        append_history, device_info)

    dev = "cpu" if args.cpu else None
    W, H, spp = args.width, args.height, args.spp
    if args.scene == "random_spheres" and args.grid_half is not None:
        scene_true = pt.scene_random_spheres(grid_half=args.grid_half)
    else:
        scene_true = pt.ALL_SCENES[args.scene]()
    cam_name = args.cam or ("cam1" if args.scene == "random_spheres"
                            else "default")
    cam = pt.t_cam1() if cam_name == "cam1" else pt.t_default_cam()

    # Target: the true scene through the estimator the fit uses (fixed
    # seed: a deterministic loss surface, with the truth its minimum). The
    # edge geom's target is the edge primal, bit for bit the keyed trace.
    tkw = dict(recorded=True, recorded_fused=True, device=dev)
    if args.geom == "edge":
        target = render_radiance_edge(
            scene_true, cam, W, spp, image_height=H, seed=args.seed,
            sigma=1.0, edge_bounces=0, pixel_chunk=args.edge_chunk,
            device=dev)
    else:
        target = pt.render_radiance(scene_true, cam, W, spp, image_height=H,
                                    seed=args.seed, **tkw)
    target = target.detach()

    # Perturb the centers of the movable spheres (not the ground) and the
    # albedo of the movable non-glass ones: glass shades with (1, 1, 1)
    # (src/material.jl:42), so its albedo has no gradient and is not scored.
    gen = np.random.default_rng(7)
    mat = scene_true.mat.numpy()
    movable = pt.movable_mask(scene_true)
    albedo_scored = movable & (mat != pt.DIELECTRIC)
    fuzz_scored = movable & (mat == pt.METAL)
    jit = gen.uniform(-args.center_jitter, args.center_jitter,
                      tuple(scene_true.center.shape))
    jit[~movable] = 0.0
    alb = scene_true.albedo.numpy().copy()
    alb[albedo_scored] = np.clip(
        alb[albedo_scored] * args.albedo_scale + args.albedo_shift, 0, 1)
    scene0 = scene_true._replace(
        center=scene_true.center + torch.from_numpy(jit.astype(np.float32)),
        albedo=torch.from_numpy(alb))
    if args.fuzz_jitter > 0:
        fj = gen.uniform(-args.fuzz_jitter, args.fuzz_jitter,
                         tuple(scene_true.fuzz.shape))
        fz = scene_true.fuzz.numpy().copy()
        fz[fuzz_scored] = np.clip(fz[fuzz_scored] + fj[fuzz_scored], 0, None)
        scene0 = scene0._replace(fuzz=torch.from_numpy(fz.astype(np.float32)))

    os.makedirs(args.out_dir, exist_ok=True)

    def save(scene, name):
        with torch.no_grad():
            img = pt.render_radiance(scene, cam, W, spp, image_height=H,
                                     seed=args.seed, **tkw)
        write_png(gamma2_encode(img), os.path.join(args.out_dir, name))

    write_png(gamma2_encode(target), os.path.join(args.out_dir, "target.png"))
    save(scene0, "initial.png")

    ekw = dict(sigma=args.edge_sigma, sigma_px=args.edge_sigma_px,
               edge_bounces=args.edge_bounces)
    if args.edge_chunk:
        ekw["pixel_chunk"] = args.edge_chunk
    if args.edge_remat:
        ekw["remat_chunks"] = True
    fit_tkw = None if args.geom == "edge" else {
        k: v for k, v in tkw.items() if k != "device"}
    common = dict(steps=args.steps, seed=args.seed, lr_albedo=args.lr,
                  lr_center=args.lr_center, lr_fuzz=args.lr_fuzz,
                  spsa_c=args.spsa_c, spsa_pairs=args.spsa_pairs,
                  render_kwargs=fit_tkw, geom=args.geom, edge_kwargs=ekw,
                  cosine_decay=args.cosine_decay, device=dev)
    log_path = os.path.join(args.out_dir, "loss_history.jsonl")
    t_all0 = time.time()
    with open(log_path, "w") as lf:
        if args.scan:
            res = pt.fit_scene_scan(scene0, cam, target, W, spp, **common)
        else:
            def on_step(i, loss, params):
                lf.write(json.dumps({"step": i, "loss": loss}) + "\n")
                if i % 10 == 0 or i == args.steps - 1:
                    print(f"step {i:4d}  loss {loss:.6f}", flush=True)
                if i == args.steps // 2:
                    save(scene0._replace(
                        center=params["center"].detach().cpu(),
                        albedo=params["albedo"].detach().cpu().clamp(0, 1)),
                        "midway.png")

            res = pt.fit_scene(scene0, cam, target, W, spp, on_step=on_step,
                               **common)
        if args.scan:
            lf.write("".join(json.dumps({"step": i, "loss": l}) + "\n"
                             for i, l in enumerate(res.losses)))
    mean_step_s = (time.time() - t_all0) / max(args.steps, 1)
    losses = res.losses
    scene_fit = res.scene.to("cpu")
    save(scene_fit, "final.png")

    # Parameter-space recovery: max = the worst sphere, mean = the
    # aggregate; per sphere, whether it moved towards the truth.
    c_true, c0, c1 = (s.center.detach().numpy() for s in (scene_true, scene0,
                                                          scene_fit))
    a_true, a0, a1 = (s.albedo.detach().numpy() for s in (scene_true, scene0,
                                                          scene_fit))
    c_err0, c_mean0 = _errs(c0, c_true, movable)
    c_err1, c_mean1 = _errs(c1, c_true, movable)
    a_err0, a_mean0 = _errs(a0, a_true, albedo_scored)
    a_err1, a_mean1 = _errs(a1, a_true, albedo_scored)
    ec0 = _per_sphere(c0, c_true, movable)
    ec1 = _per_sphere(c1, c_true, movable)

    # Primary visibility: spheres that win at least 4 camera-ray pixels of
    # the true scene; the recovery of off-frame spheres means nothing.
    with torch.no_grad():
        u, v = pt.pixel_coords(W, H)
        o, d = pt.get_rays(cam, u, v,
                           generator=torch.Generator().manual_seed(0))
        hit = pt.intersect_spheres(o, d, scene_true)
        idx = hit.index[hit.hit].numpy()
        pa_v = float(pixel_angle(cam, float(np.float32(H))))
    visible_all = np.bincount(idx, minlength=scene_true.n_spheres) >= 4
    dist = np.linalg.norm(c_true - cam.origin.numpy(), axis=1)
    px_r = (np.abs(scene_true.radius.numpy())
            / np.maximum(dist * pa_v, 1e-9))[movable]
    vis = visible_all[movable]
    big = vis & (px_r >= 15.0)

    def rounded(x, n=4):
        return None if x is None else round(float(x), n)

    stats = {
        "center_err_p50_init": rounded(np.median(ec0)),
        "center_err_p50_final": rounded(np.median(ec1)),
        "center_err_p90_init": rounded(np.percentile(ec0, 90)),
        "center_err_p90_final": rounded(np.percentile(ec1, 90)),
        "center_improved_frac": rounded((ec1 < ec0).mean(), 3),
        "n_visible": int(vis.sum()),
        "center_improved_frac_visible": (
            rounded((ec1 < ec0)[vis].mean(), 3) if vis.any() else None),
        "center_p50_init_visible": (
            rounded(np.median(ec0[vis])) if vis.any() else None),
        "center_p50_final_visible": (
            rounded(np.median(ec1[vis])) if vis.any() else None),
        "center_improved_frac_ge15px": (
            rounded((ec1 < ec0)[big].mean(), 3) if big.any() else None),
        "center_p50_init_ge15px": (
            rounded(np.median(ec0[big])) if big.any() else None),
        "center_p50_final_ge15px": (
            rounded(np.median(ec1[big])) if big.any() else None),
        "n_ge15px": int(big.sum()),
    }
    if args.lr_fuzz > 0 and fuzz_scored.any():
        f_true, f0, f1 = (s.fuzz.detach().numpy()
                          for s in (scene_true, scene0, scene_fit))
        f_err0, f_mean0 = _errs(f0, f_true, fuzz_scored)
        f_err1, f_mean1 = _errs(f1, f_true, fuzz_scored)
        stats.update(fuzz_err_init=rounded(f_err0),
                     fuzz_err_final=rounded(f_err1),
                     fuzz_mean_err_init=rounded(f_mean0),
                     fuzz_mean_err_final=rounded(f_mean1))
    av = albedo_scored & visible_all
    if av.any():
        stats["albedo_mean_err_init_visible"] = rounded(
            _errs(a0, a_true, av)[1])
        stats["albedo_mean_err_final_visible"] = rounded(
            _errs(a1, a_true, av)[1])
        stats["n_albedo_visible"] = int(av.sum())

    paths = W * H * spp
    rec = {"ts": time.time(),
           "label": (f"inverse_{args.scene}"
                     + (f"_g{args.grid_half}" if args.grid_half else "")
                     + f"_{W}x{H}x{spp}_{args.steps}steps"
                     + ("_scan" if args.scan else "")
                     + ("_edge" if args.geom == "edge" else "")),
           "loss_init": round(losses[0], 6), "loss_final": round(losses[-1], 6),
           "loss_min": round(min(losses), 6),
           "center_err_init": rounded(c_err0),
           "center_err_final": rounded(c_err1),
           "center_mean_err_init": rounded(c_mean0),
           "center_mean_err_final": rounded(c_mean1),
           "albedo_err_init": rounded(a_err0),
           "albedo_err_final": rounded(a_err1),
           "albedo_mean_err_init": rounded(a_mean0),
           "albedo_mean_err_final": rounded(a_mean1),
           **stats,
           "n_movable": int(movable.sum()),
           "mean_step_s": round(mean_step_s, 3), "paths": paths,
           "mpaths_per_s": round(paths / mean_step_s / 1e6, 3),
           "device": device_info("cpu" if args.cpu else None)}
    append_history(rec)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
