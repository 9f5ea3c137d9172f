"""Command-line interface of the port — the counterpart of
``raytracingweekend_jl_tpu.cli`` (reference: src/proto/proto.jl; SURVEY.md
§2.2). It renders on the CUDA card unless
``--device cpu`` is given, and raises without CUDA.

    python -m raytracingweekend_jl_tpu_torch.cli --scene random_spheres \\
        --camera cam1 --width 1920 --spp 1000 --spp-chunk 50 \\
        --checkpoint ckpt.npz -o out.png

Every option of the JAX package's parser, with its defaults and choices,
plus ``--device``. Each run prints one JSON record and appends it to
``bench_history_torch.jsonl`` in the working directory. Not ported yet:
sharded renders (``--mesh-tiles`` / ``--mesh-samples`` above 1,
``--multihost``), which exit non-zero (ROADMAP.md Queue 1, item 18).
``--precision f64`` runs only with ``--no-persistent`` (the fixed-depth
wavefront); the persistent routes raise ``NotImplementedError`` for it.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from .utils.config import RenderConfig, CAMERA_PRESETS


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytracingweekend_jl_tpu_torch",
        description="Differentiable path tracer on PyTorch and CUDA")
    from .models.scenes import ALL_SCENES
    d = RenderConfig()
    p.add_argument("--scene", default=d.scene, choices=sorted(ALL_SCENES),
                   help="scene name")
    p.add_argument("--camera", default=d.camera, choices=CAMERA_PRESETS)
    p.add_argument("--width", type=int, default=d.image_width)
    p.add_argument("--height", type=int, default=None,
                   help="default: width*9//16 (reference formula)")
    p.add_argument("--spp", type=int, default=d.n_samples)
    p.add_argument("--depth", type=int, default=d.max_depth)
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--scene-seed", type=int, default=d.scene_seed)
    p.add_argument("--precision", default=d.precision, choices=("f32", "f64"),
                   help="f64 runs only with --no-persistent")
    p.add_argument("--compact", action="store_true", default=d.compact,
                   help="the forward-only compacting wavefront when the "
                        "persistent integrators are disabled")
    p.add_argument("--no-compact", dest="no_compact", action="store_true",
                   help="deprecated alias (compaction is already off by "
                        "default); kept so older invocations still parse")
    p.add_argument("--no-persistent", action="store_true",
                   help="disable the persistent integrators (the "
                        "fixed-depth wavefront)")
    p.add_argument("--rays-per-pass", type=int, default=d.rays_per_pass)
    p.add_argument("--mesh-tiles", type=int, default=d.mesh_tiles,
                   help="not ported: above 1 exits (multi-GPU)")
    p.add_argument("--mesh-samples", type=int, default=d.mesh_samples,
                   help="not ported: above 1 exits (multi-GPU)")
    p.add_argument("--tile-size", type=int, default=d.tile_size)
    p.add_argument("--multihost", action="store_true",
                   help="not ported: exits (multi-GPU)")
    p.add_argument("--strip-dir", default=d.strip_dir,
                   help="directory for per-host image strips (multihost)")
    p.add_argument("--spp-chunk", type=int, default=d.spp_chunk,
                   help=">0 enables chunked rendering with checkpoints")
    p.add_argument("--checkpoint", default=None, help="checkpoint .npz path")
    p.add_argument("-o", "--output", default=d.output, help=".png or .ppm")
    p.add_argument("--stats", action="store_true",
                   help="print per-bounce wavefront occupancy before rendering")
    p.add_argument("--device", default=d.device,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "the kernels' plain versions on the CPU)")
    return p


def config_from_args(args) -> RenderConfig:
    if getattr(args, "no_compact", False) and args.compact:
        raise SystemExit("--compact and --no-compact are mutually exclusive")
    return RenderConfig(
        scene=args.scene, camera=args.camera, image_width=args.width,
        image_height=args.height, n_samples=args.spp, max_depth=args.depth,
        seed=args.seed, scene_seed=args.scene_seed, precision=args.precision,
        compact=args.compact, persistent=not args.no_persistent,
        rays_per_pass=args.rays_per_pass,
        mesh_tiles=args.mesh_tiles, mesh_samples=args.mesh_samples,
        tile_size=args.tile_size, spp_chunk=args.spp_chunk,
        checkpoint_path=args.checkpoint, output=args.output,
        multihost=args.multihost, strip_dir=args.strip_dir,
        device=args.device)


def refuse_sharded(cfg: RenderConfig) -> None:
    """Exit for the sharded renders, which the port does not have yet: it
    never renders them on one card in their place."""
    if cfg.multihost or cfg.mesh_tiles * cfg.mesh_samples > 1:
        raise SystemExit(
            "sharded renders (--mesh-tiles x --mesh-samples above 1, "
            "--multihost) are not ported yet: ROADMAP.md Queue 1, item 18 "
            "(multi-GPU)")


def print_occupancy(cfg: RenderConfig) -> None:
    """Per-bounce live-ray and active-tile counts of the fixed-depth
    wavefront for this config's camera rays (SURVEY.md §5 observability:
    bounce occupancy and compaction ratio)."""
    import torch
    from .camera import get_rays
    from .ops.integrator import trace_occupancy
    from .render import _resolve_device, pixel_coords, image_height_for
    from .scene import trim_scene

    device = _resolve_device(cfg.device)
    scene = trim_scene(cfg.build_scene().to(device))
    cam = cfg.build_camera().to(device)
    H = cfg.image_height or image_height_for(cfg.image_width)
    u, v = pixel_coords(cfg.image_width, H, dtype=cam.origin.dtype,
                        device=device)
    o, d = get_rays(cam, u, v, generator=torch.Generator(
        device=device).manual_seed(cfg.seed))
    counts, tiles = trace_occupancy(scene, o, d, cfg.seed,
                                    max_depth=cfg.max_depth, tmin=cfg.tmin)
    n = cfg.image_width * H
    print(json.dumps({
        "bounce_occupancy": [round(c / n, 4) for c in counts],
        "active_tiles": tiles,
        "mean_path_length": round(sum(counts) / n, 3),
    }))


def run(cfg: RenderConfig) -> dict:
    """Render ``cfg``, write its image (gamma 2) and return, print and
    append to the history its throughput record. The record's ``paths``
    (and so ``mpaths_per_s``) count the paths this run rendered: a resumed
    run leaves out the samples its checkpoint already held."""
    import numpy as np
    from .render import _resolve_device, render_radiance, image_height_for
    from .utils.image import write_png, write_ppm
    from .utils.metrics import PhaseTimer, append_history, throughput_record

    refuse_sharded(cfg)
    device = _resolve_device(cfg.device)
    scene = cfg.build_scene()
    cam = cfg.build_camera()
    H = cfg.image_height or image_height_for(cfg.image_width)

    t0 = time.time()
    phases = None
    n_rendered = cfg.n_samples
    if cfg.spp_chunk > 0:
        from .utils.checkpoint import render_checkpointed
        if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
            # A resume renders only the samples the checkpoint lacks.
            with np.load(cfg.checkpoint_path) as z:
                n_rendered -= min(int(z["samples_done"]), cfg.n_samples)
        timer = PhaseTimer()
        state = render_checkpointed(
            scene, cam, cfg.image_width, cfg.n_samples,
            image_height=cfg.image_height, seed=cfg.seed,
            spp_chunk=cfg.spp_chunk, checkpoint_path=cfg.checkpoint_path,
            max_depth=cfg.max_depth, tmin=cfg.tmin, compact=cfg.compact,
            persistent=cfg.persistent, rays_per_pass=cfg.rays_per_pass,
            progress=True, timer=timer, device=device)
        linear = state.image
        phases = timer.as_dict()
    else:
        linear = render_radiance(
            scene, cam, cfg.image_width, cfg.n_samples,
            image_height=cfg.image_height, max_depth=cfg.max_depth,
            tmin=cfg.tmin, seed=cfg.seed, compact=cfg.compact,
            persistent=cfg.persistent, rays_per_pass=cfg.rays_per_pass,
            dtype=cfg.dtype(), device=device).cpu().numpy()
    wall = time.time() - t0

    img = np.sqrt(np.clip(linear, 0.0, None))  # gamma 2 (src/vec.jl:22)
    if cfg.output.endswith(".ppm"):
        write_ppm(img, cfg.output)
    else:
        write_png(img, cfg.output)

    extra = {"config": cfg.to_dict()}
    if phases:
        extra["phases"] = phases
    rec = throughput_record(
        f"{cfg.scene}_{cfg.image_width}x{H}x{cfg.n_samples}", wall,
        cfg.image_width * H * n_rendered, extra=extra, device=device)
    append_history(rec)
    print(json.dumps(rec))
    return rec


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    refuse_sharded(cfg)
    if args.stats:
        print_occupancy(cfg)
    run(cfg)


if __name__ == "__main__":
    main()
