"""Where the strided render's image parts from the fixed-depth wavefront's.

    python scripts/torch_strided_gap_probe.py [--seeds 7 8] [--spp 4]

On the card, at the flagship film (``scene_random_spheres(seed=1)``,
``t_cam1``, 1920x1080), renders the same image through several routes and
layouts at each seed and prints, for each, the per-channel mean of its
per-pixel difference to the fixed-depth wavefront's image (``trace``, the
reference package's default route) with the standard error, one JSON line
each, then the card's name and power limit (also after ``--ablate``):

- ``strided_k64``: the unsharded ``persistent=True`` render (k = 64: each
  lane regenerates 255 of every 256 camera rays in the strided step);
- ``strided_k8``, ``strided_k1``: the strided loop at k = 8 and k = 1, no
  sample groups (later samples' camera rays regenerated in the step);
- ``strided_k1_torch_draws``: ``strided_k1`` with the step's nine
  uniforms a lane drawn by ``torch.rand`` from a seeded generator
  (``rng_u9_fn``) in place of the in-kernel Philox stream;
- ``strided_k1_groups``: k = 1 with the samples folded into groups (every
  camera ray from the host's strip-0 draws);
- ``sharded``: ``render_radiance_sharded`` on a mesh of one (8 192-pixel
  tiles, each strided at k = 1 with 4 sample groups);
- ``pinned``: the pixel-pinned route over the whole film
  (``persistent_render_sum_fused``: K1 and K9, each lane regenerating its
  own pixel's camera rays in the step);
- ``mega``: the megakernel route (``persistent_render_sum_mega``: K12,
  the same regeneration as K9);
- ``trace``: the wavefront at another seed (the spread of the reference).

Then one JSON line per route with its gap pooled over the seeds (the mean
of the per-seed gaps, and its standard error), and, for ``strided_k64``,
the pooled gap split by what the pixel's centred camera ray first meets:
the sky, the ground sphere or another sphere.

``--ablate`` prints instead, at spp 2 and k = 1, the gap of the layout
that regenerates sample 1's camera ray in the step (no sample groups)
to the one that starts it from the host's strip-0 rays (2 groups), with
the same uniforms in both: ``constant`` gives every lane one set of nine
uniforms at every iteration (sample 1's jitter and lens from its rows
5-8 in both layouts), so both trace the same paths up to the camera
ray's rounding; ``fresh`` draws new uniforms every iteration (the paths
then differ, the gap is statistical). Then ``host_rsqrt``: the 2-group
layout with constant uniforms, its strip-0 camera directions normalised
with ``torch.rsqrt`` of the squared length (``rsqrtf`` on the card, as
the step normalised a regenerated camera ray before it took
``camera.make_rays``' ``1 / sqrt``), minus the same layout unchanged. Then
``bounce_rsqrt``, at ``--spp``: what the scatter directions'
normalisation does to the image. Every route normalises them with
``vecmath.inv_length`` (the kernels' ``rtw_inv_length``: ``1 / sqrt``
rounded once); the strided, pinned and megakernel steps took ``rsqrtf``
before (as both packages' TPU kernels take ``rsqrt``). The ablation
renders ``trace`` with the Lambertian, metal and refracted directions of
its scatter normalised by ``torch.rsqrt`` (``rsqrtf`` on the card; this
script's own imports of ``materials.normalize`` and
``vecmath.normalize`` replaced), minus ``trace`` unchanged, the same
draws in both.

``--goldens`` asks instead whether ``chip_smoke.py``'s ``jax_goldens``
phase (the strided, pinned and megakernel routes at 64x36, spp 4, against
the JAX package's goldens) can see a fault of the size of the camera-ray
bias that the regenerated rays carried before they took ``make_rays``'
construction: it runs the phase with the shipped kernels, then with the
kernels built from a copy of the sources whose camera ray is the former
one (``rsqrtf`` of the squared length, and K2's film point times 1/W),
and prints each run's lines and whether the phase's checks passed.

``--scatter-former`` runs ``chip_smoke.py``'s ``scatter_unit`` phase with
the shipped kernels and plain versions, then with the former
normalisation: kernels built from a copy of the sources whose
``rtw_inv_length`` is ``rsqrtf`` (the scatter directions before the
repair; the camera ray a float square root then division, as it was), and
the plain versions' ``inv_length`` replaced by ``torch.rsqrt`` (the
shading core, ``slot_draws``, ``unit_sphere_directions``) and by the
twice-rounded ``1 / torch.sqrt`` (``vecmath``), as they were; and prints
whether the phase's checks passed each time.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def ablate(seeds, scene, cam, W: int, H: int, spp: int, dev) -> None:
    """The ``--ablate`` lines (module docstring)."""
    import torch
    from raytracingweekend_jl_tpu_torch.ops.integrator import (
        persistent_render_sum_strided)
    n = W * H

    def pair(seed, fresh):
        g = torch.Generator(device=dev).manual_seed(seed)
        u4 = torch.rand((n, 4), generator=g, device=dev)
        u9 = torch.rand((9, n), generator=g, device=dev)
        draws = {}

        def rows(it, lanes):
            if fresh and it not in draws:
                draws[it] = torch.rand((9, n), generator=g, device=dev)
            x = draws[it] if fresh else u9
            return x if lanes == n else torch.cat([x, x], 1)

        first = u9 if not fresh else rows(0, n)
        u4_1 = first[5:9].T.contiguous()
        run = {}
        for m in (1, 2):
            run[m] = persistent_render_sum_strided(
                scene, cam, n, seed, 2, 0, 16, 1e-4, float(W), float(H),
                k=1, sample_groups=m,
                init_u4=u4 if m == 1 else torch.cat([u4, u4_1]),
                rng_u9_fn=lambda it, m=m: rows(it, n * m)) / 2
        return (run[1].double() - run[2].double())

    from raytracingweekend_jl_tpu_torch import camera
    from raytracingweekend_jl_tpu_torch.ops import integrator

    def make_rays_rsqrt(cam_, s_, t_, disk):
        o, d = camera.make_rays(cam_, s_, t_, disk)
        raw = (cam_.lower_left_corner + s_[..., None] * cam_.horizontal
               + t_[..., None] * cam_.vertical - o)
        return o, raw * torch.rsqrt((raw * raw).sum(-1, keepdim=True))

    def host_rsqrt(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        u4 = torch.rand((2 * n, 4), generator=g, device=dev)
        u9 = torch.rand((9, 2 * n), generator=g, device=dev)
        run = []
        for patched in (True, False):
            integrator.make_rays = (make_rays_rsqrt if patched
                                    else camera.make_rays)
            try:
                run.append(persistent_render_sum_strided(
                    scene, cam, n, seed, 2, 0, 16, 1e-4, float(W), float(H),
                    k=1, sample_groups=2, init_u4=u4,
                    rng_u9_fn=lambda it: u9).double() / 2)
            finally:
                integrator.make_rays = camera.make_rays
        return run[0] - run[1]

    from raytracingweekend_jl_tpu_torch.ops import materials, vecmath
    import raytracingweekend_jl_tpu_torch as pt

    def rsqrt_normalize(v):
        sq = (v * v).sum(-1)
        return v * torch.rsqrt(torch.clamp(sq, min=1e-20))[..., None]

    def bounce_rsqrt(seed):
        run = []
        for patched in (True, False):
            fn = rsqrt_normalize if patched else vecmath.normalize
            saved = materials.normalize, vecmath.normalize
            materials.normalize = fn
            vecmath.normalize = fn
            try:
                run.append(pt.render_radiance(
                    scene, cam, W, spp, device=dev,
                    seed=seed).double().reshape(-1, 3))
            finally:
                materials.normalize, vecmath.normalize = saved
        return run[0] - run[1]

    for mode in ("constant", "fresh", "host_rsqrt", "bounce_rsqrt"):
        gaps = []
        for seed in seeds:
            d = (host_rsqrt(seed) if mode == "host_rsqrt"
                 else bounce_rsqrt(seed) if mode == "bounce_rsqrt"
                 else pair(seed, mode == "fresh"))
            gaps.append(d.mean(0))
            print(json.dumps({
                "ablate": mode, "seed": seed, "size": [W, H],
                "spp": spp if mode == "bounce_rsqrt" else 2,
                "pixels_bit_equal": float((d == 0).all(1).float().mean()),
                "pixels_off_1e-3": int((d.abs() > 1e-3).any(1).sum()),
                ("mean_gap_rsqrt_minus_unchanged" if mode == "bounce_rsqrt"
                 else "mean_gap_regenerated_minus_host"): d.mean(0).tolist(),
                "standard_error": (d.std(0) / n ** 0.5).tolist()}),
                flush=True)
        g = torch.stack(gaps)
        print(json.dumps({
            "ablate": mode, "seeds": seeds, "pooled_gap": g.mean(0).tolist(),
            "pooled_standard_error": (g.std(0) / len(seeds) ** 0.5).tolist()
            if len(seeds) > 1 else None}), flush=True)


def _sub(src: str, old: str, new: str) -> str:
    """``src`` with the one occurrence of ``old`` replaced by ``new``."""
    if src.count(old) != 1:
        raise RuntimeError(f"rewrite target found {src.count(old)} times: "
                           f"{old!r:.80}")
    return src.replace(old, new)


#: The camera ray's normalisation in the shipped shading core.
CAMERA_INV = ("  const float inv = rtw_inv_length(gdx * gdx + gdy * gdy + "
              "gdz * gdz);\n")

#: The former camera ray of K2, K9 and K12: (file, shipped text, former).
FORMER_CAMERA_RAY = (
    ("shade_core.cuh", CAMERA_INV,
     "  const float inv = rsqrtf(fmaxf(gdx * gdx + gdy * gdy + gdz * gdz, "
     "1e-20f));\n"),
    ("shade_strided.cu",
     "(float)(pxi + 1) / (float)W,\n"
     "                   (float)(H - 1 - pyi) / (float)H,",
     "(float)(pxi + 1) * cam[19],\n"
     "                   (float)(H - 1 - pyi) * cam[20],"),
)


#: The shipped body of ``rtw_inv_length`` (csrc/shade_core.cuh).
INV_LENGTH = "  return __frsqrt_rn(fmaxf(x, 1e-20f));\n"

#: The kernels' normalisation before it was rounded once: the scatter
#: directions by ``rsqrtf``, the camera ray by a float square root then a
#: float division (file, shipped text, former).
FORMER_NORMALISATION = (
    ("shade_core.cuh", INV_LENGTH, "  return rsqrtf(fmaxf(x, 1e-20f));\n"),
    ("shade_core.cuh", CAMERA_INV,
     "  const float inv =\n"
     "      1.0f / sqrtf(fmaxf(gdx * gdx + gdy * gdy + gdz * gdz, 1e-20f));\n"),
)


def rewritten_csrc(work: str, rewrites) -> str:
    """A copy of the kernel sources under ``work`` with ``rewrites``
    ((file, shipped text, former), each found once) applied; its path."""
    import shutil
    from raytracingweekend_jl_tpu_torch.ops.cuda import build
    csrc = os.path.join(work, "csrc")
    shutil.copytree(build.CSRC_DIR, csrc)
    for name, old, new in rewrites:
        path = os.path.join(csrc, name)
        with open(path) as f:
            src = _sub(f.read(), old, new)
        with open(path, "w") as f:
            f.write(src)
    return csrc


def load_library(csrc: str, out: str):
    """The kernel library built from the sources ``csrc`` into ``out``,
    loaded. Every kernel wrapper calls the library that ``build._LIB``
    holds: set it to route them to this one."""
    from raytracingweekend_jl_tpu_torch.ops.cuda import build
    saved = build.CSRC_DIR, build.BUILD_DIR, build._LIB
    build.CSRC_DIR, build.BUILD_DIR, build._LIB = csrc, out, None
    try:
        return build.load()
    finally:
        build.CSRC_DIR, build.BUILD_DIR, build._LIB = saved


def _phase_passes(fn) -> str | None:
    """Runs a ``chip_smoke`` phase; the failed check's message, or None."""
    try:
        fn()
    except AssertionError as e:
        return str(e)
    return None


def goldens(dev, card) -> None:
    """The ``--goldens`` lines (module docstring)."""
    import shutil
    import tempfile
    import chip_smoke
    from raytracingweekend_jl_tpu_torch.ops.cuda import build
    shipped = build.load()
    work = tempfile.mkdtemp()
    try:
        for kernels in ("shipped", "former_camera_ray"):
            if kernels == "former_camera_ray":
                build._LIB = load_library(
                    rewritten_csrc(work, FORMER_CAMERA_RAY),
                    os.path.join(work, "kernels"))
            print(json.dumps({"goldens_kernels": kernels}), flush=True)
            failure = _phase_passes(
                lambda: chip_smoke.jax_goldens_phase(dev, card))
            print(json.dumps({"goldens_kernels": kernels,
                              "checks_pass": failure is None,
                              "failure": failure}), flush=True)
    finally:
        build._LIB = shipped
        shutil.rmtree(work, ignore_errors=True)


def scatter_former(dev, card) -> None:
    """The ``--scatter-former`` lines (module docstring)."""
    import shutil
    import tempfile
    import torch
    import chip_smoke
    from raytracingweekend_jl_tpu_torch.ops import materials, sampling, vecmath
    from raytracingweekend_jl_tpu_torch.ops.cuda import build, grad_kernel
    from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel

    def rsqrt(x):
        return torch.rsqrt(torch.clamp(x, min=1e-20))

    def twice(x):
        return 1.0 / torch.sqrt(torch.clamp(x, min=1e-20))

    plain = ((shade_kernel, rsqrt), (grad_kernel, rsqrt), (materials, rsqrt),
             (sampling, rsqrt), (vecmath, twice))
    saved = [(m, m.inv_length) for m, _ in plain]
    shipped = build.load()
    work = tempfile.mkdtemp()
    try:
        for kernels in ("shipped", "former_normalisation"):
            if kernels == "former_normalisation":
                build._LIB = load_library(
                    rewritten_csrc(work, FORMER_NORMALISATION),
                    os.path.join(work, "kernels"))
                for m, fn in plain:
                    m.inv_length = fn
            print(json.dumps({"scatter_kernels": kernels}), flush=True)
            failure = _phase_passes(
                lambda: chip_smoke.scatter_unit_phase(dev, card))
            print(json.dumps({"scatter_kernels": kernels,
                              "checks_pass": failure is None,
                              "failure": failure}), flush=True)
    finally:
        for m, fn in saved:
            m.inv_length = fn
        build._LIB = shipped
        shutil.rmtree(work, ignore_errors=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 8])
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--goldens", action="store_true")
    ap.add_argument("--scatter-former", action="store_true")
    args = ap.parse_args()
    import torch
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.ops.experimental.mega import (
        persistent_render_sum_mega)
    from raytracingweekend_jl_tpu_torch.ops.integrator import (
        persistent_render_sum_fused, persistent_render_sum_strided)
    from raytracingweekend_jl_tpu_torch.parallel.mesh import make_render_mesh
    from raytracingweekend_jl_tpu_torch.parallel.shard import (
        render_radiance_sharded)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    if args.goldens or args.scatter_former:
        card = card_line()
        (goldens if args.goldens else scatter_former)(dev, card)
        print(card, flush=True)
        return
    W, H, S = 1920, 1080, args.spp
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1).to(dev))
    cam = pt.t_cam1(device=dev)
    mesh = make_render_mesh(1, 1, device=dev)

    def strided(seed, k, groups):
        out = persistent_render_sum_strided(
            scene, cam, W * H, seed, S, 0, 16, 1e-4, float(W), float(H),
            k=k, sample_groups=groups)
        return (out / S).reshape(H, W, 3)

    def torch_draws(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        out = persistent_render_sum_strided(
            scene, cam, W * H, seed, S, 0, 16, 1e-4, float(W), float(H),
            k=1, rng_u9_fn=lambda it: torch.rand((9, W * H), generator=g,
                                                 device=dev))
        return (out / S).reshape(H, W, 3)

    u, v = pt.pixel_coords(W, H, device=dev)

    def pinned(seed, fn):
        out = fn(scene, cam, u, v, seed, S, 0, 16, 1e-4, float(W), float(H))
        return (out / S).reshape(H, W, 3)

    if args.ablate:
        ablate(args.seeds, scene, cam, W, H, S, dev)
        print(card_line(), flush=True)
        return

    routes = {
        "strided_k64": lambda s: pt.render_radiance(
            scene, cam, W, S, persistent=True, device=dev, seed=s),
        "strided_k8": lambda s: strided(s, 8, 1),
        "strided_k1": lambda s: strided(s, 1, 1),
        "strided_k1_torch_draws": torch_draws,
        "strided_k1_groups": lambda s: strided(s, 1, S),
        "sharded": lambda s: render_radiance_sharded(
            scene, cam, W, S, mesh=mesh, persistent=True, seed=s),
        "pinned": lambda s: pinned(s, persistent_render_sum_fused),
        "mega": lambda s: pinned(s, persistent_render_sum_mega),
        "trace": lambda s: pt.render_radiance(scene, cam, W, S, device=dev,
                                              seed=s + 1000),
    }
    # What each pixel's centred camera ray meets first: 0 sky, 1 the ground
    # (the largest sphere), 2 another sphere.
    o, d = pt.make_rays(cam, u, v, torch.zeros((W * H, 2), device=dev))
    hit = pt.intersect_spheres(o, d, scene)
    ground = int(scene.radius.argmax())
    cls = torch.where(~hit.hit, 0, torch.where(hit.index == ground, 1, 2))
    gaps = {name: [] for name in routes}
    by_class = []
    for seed in args.seeds:
        ref = pt.render_radiance(scene, cam, W, S, device=dev, seed=seed)
        for name, fn in routes.items():
            d = (fn(seed).double() - ref.double()).reshape(-1, 3)
            gaps[name].append(d.mean(0))
            if name == "strided_k64":
                by_class.append(torch.stack([
                    d[cls == c].sum(0) / d.shape[0] for c in range(3)]))
            print(json.dumps({
                "route": name, "seed": seed, "size": [W, H], "spp": S,
                "mean_gap_vs_trace": d.mean(0).tolist(),
                "standard_error": (d.std(0) / d.shape[0] ** 0.5).tolist()}),
                flush=True)
    n = len(args.seeds)
    for name, g in gaps.items():
        g = torch.stack(g)
        print(json.dumps({
            "route": name, "seeds": args.seeds,
            "pooled_gap": g.mean(0).tolist(),
            "pooled_standard_error": (g.std(0) / n ** 0.5).tolist()
            if n > 1 else None}), flush=True)
    b = torch.stack(by_class)
    print(json.dumps({
        "route": "strided_k64", "pooled_gap_by_first_hit": {
            name: {"pixel_share": float((cls == c).float().mean()),
                   "gap_share_of_image_mean": b[:, c].mean(0).tolist(),
                   "standard_error": (b[:, c].std(0) / n ** 0.5).tolist()
                   if n > 1 else None}
            for c, name in enumerate(("sky", "ground", "other"))}}),
        flush=True)
    print(card_line(), flush=True)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


if __name__ == "__main__":
    main()
