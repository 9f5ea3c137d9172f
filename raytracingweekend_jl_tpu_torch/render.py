"""Render driver — the ``render`` entry point of the port (counterpart of
``raytracingweekend_jl_tpu.render``).

Reference semantics (src/render.jl:8-44): ``H = W * 9 // 16`` unless given;
film coordinates ``u = (j+1)/W``, ``v = (H-1-i)/H`` with row 0 at the top;
global sample 0 centered, later samples jittered by ``U[0,1)/W`` and
``U[0,1)/H``; radiance averaged over samples and gamma-2 encoded.

The entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA they raise. On the CPU every route runs the kernels' plain
PyTorch versions.

Forward routes (``persistent=True``, the default), picked as the reference
package picks them on its device:

- a small full image (at most 65 536 pixels, or 131 072 with at most 64
  spheres) renders in one launch of the inline kernel (K8,
  ``ops/inline.py``);
- every other contiguous full image or chunk takes the persistent strided
  integrator (K1 and K2, ``ops/integrator.py``).

The reference's pixel-pinned route for non-contiguous tiles
(``shade_kernel._shade_kernel``, K9) raises ``NotImplementedError``.

Differentiable routes (``persistent=False``, which ``grad.render_loss``
picks) trace each sample pass through a kernel pair: the fixed-depth
record/replay pair (``recorded_fused``, K3 and K7, ``ops/fused_grad.py``) or
the persistent-record pair (``recorded_persist``, K3-K6,
``ops/persist_grad.py``). The other gradient integrators raise
``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .camera import Camera, sample_pass_rays
from .ops.fused_grad import trace_recorded_fused
from .ops.inline import render_inline_sum
from .ops.integrator import DEFAULT_MAX_DEPTH, persistent_render_sum_strided
from .ops.intersect import DEFAULT_TMIN
from .ops.persist_grad import trace_recorded_persist
from .ops.vecmath import gamma2_encode
from .scene import Scene, trim_scene


def image_height_for(image_width: int) -> int:
    """Reference: ``image_width ÷ (16//9)`` (src/render.jl:11-12)."""
    return image_width * 9 // 16


def pixel_coords(image_width: int, image_height: int, dtype=torch.float32,
                 device="cpu"):
    """Flattened ``[H*W]`` film coordinates (u, v) in reference convention,
    computed in float64 on the host and cast once."""
    j = np.arange(image_width, dtype=np.float64)
    i = np.arange(image_height, dtype=np.float64)
    u = (j + 1.0) / image_width
    v = (image_height - 1.0 - i) / image_height
    uu, vv = np.meshgrid(u, v)  # [H, W]
    return (torch.as_tensor(uu.ravel(), dtype=dtype).to(device),
            torch.as_tensor(vv.ravel(), dtype=dtype).to(device))


def pick_samples_per_pass(n_pix: int, n_samples: int,
                          rays_per_pass: int = 1 << 21) -> int:
    """Largest divisor of ``n_samples`` whose merged wavefront stays under
    ``rays_per_pass`` rays."""
    best = 1
    for d in range(1, n_samples + 1):
        if n_samples % d == 0 and n_pix * d <= rays_per_pass:
            best = d
    return best


#: Lane-count floor for the strided path: below this many lanes k shrinks.
STRIDED_MIN_LANES = 32768


def strided_k_for(n_pix: int, k_full: int = 64) -> int:
    """Pixels per lane for a tile: full k while the tile still yields
    >= STRIDED_MIN_LANES lanes, else as many lanes as possible (k -> 1)."""
    return max(1, min(k_full, n_pix // STRIDED_MIN_LANES))


def strided_sample_groups_for(n_pix: int, n_samples: int) -> int:
    """Sample-group folding for small tiles: the largest divisor of
    ``n_samples`` keeping lanes <= ~4x the lane floor; 1 for big tiles."""
    if n_pix >= STRIDED_MIN_LANES:
        return 1
    cap = max(1, (4 * STRIDED_MIN_LANES) // max(n_pix, 1))
    best = 1
    for mm in range(1, n_samples + 1):
        if n_samples % mm == 0 and mm <= cap:
            best = mm
    return best


def inline_route_for(n_pix: int, n_spheres: int) -> bool:
    """The reference's pick of the single-launch route for a full image: at
    most 65 536 pixels, or at most 131 072 with at most 64 spheres."""
    return n_pix <= 65536 or (n_pix <= 131072 and n_spheres <= 64)


def _resolve_device(device) -> torch.device:
    """``None`` means the card. Asking for CUDA without it raises: the port
    never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port runs on a CUDA device unless "
                           "device='cpu' is passed, and CUDA is not "
                           "available; it does not fall back to the CPU")
    return device


def render_tile_sum(scene: Scene, cam: Camera, n_pix: int, seed: int,
                    n_samples: int, sample_offset: int, max_depth: int,
                    tmin: float, f32_w: float, f32_h: float,
                    persistent: bool = True, pixel_start: int | None = None,
                    impl: str | None = None,
                    generator: torch.Generator | None = None,
                    inline: bool | None = None) -> torch.Tensor:
    """Radiance *sum* ``[n_pix, 3]`` of ``n_samples`` samples for the
    contiguous pixel range from ``pixel_start`` (``None`` = a full image),
    on the scene's device.

    ``inline=None`` picks the route as the reference package does: a small
    full image (:func:`inline_route_for`) takes the single-launch inline
    kernel, everything else the strided integrator, with ``k`` and the
    sample-group fold picked as the reference picks them. ``inline=False``
    pins the strided route, ``inline=True`` the inline one. ``generator``
    feeds the strided route's strip-0 draws; the inline route draws its
    camera rays per sample pass (:func:`camera.sample_pass_rays`) and
    refuses it."""
    if not persistent:
        raise NotImplementedError(
            "the fixed-depth wavefront (persistent=False, ops/integrator.trace) "
            "is not ported yet; use persistent=True")
    W, H = int(f32_w), int(f32_h)
    full_image = n_pix == W * H
    if pixel_start is None and not full_image:
        raise NotImplementedError(
            "non-contiguous tiles need the pixel-pinned persistent kernel "
            "(TPU ops/pallas/shade_kernel.py::_shade_kernel), not ported yet")
    if inline is None:
        inline = pixel_start is None and inline_route_for(n_pix,
                                                          scene.n_spheres)
    if inline:
        if generator is not None:
            raise ValueError(
                "generator feeds the strided route's strip-0 draws; the "
                "inline route draws its camera rays from generators keyed by "
                "(seed, purpose, sample): pass inline=False to use one")
        start = 0 if pixel_start is None else pixel_start
        u, v = pixel_coords(W, H, device=scene.device)
        return render_inline_sum(
            scene, cam, u[start:start + n_pix], v[start:start + n_pix], seed,
            n_samples, sample_offset, max_depth, tmin, f32_w, f32_h, impl)
    m = strided_sample_groups_for(n_pix, n_samples)
    k = (1 if m > 1 else
         (64 if n_pix >= 48 * STRIDED_MIN_LANES else strided_k_for(n_pix)))
    return persistent_render_sum_strided(
        scene, cam, n_pix, seed, n_samples, sample_offset, max_depth, tmin,
        f32_w, f32_h, k=k, pixel_start=0 if pixel_start is None else pixel_start,
        sample_groups=m, impl=impl, generator=generator)


def _check_grad_route(recorded: bool, remat: bool, recorded_fused: bool,
                      recorded_stage, recorded_persist, remat_passes: bool,
                      persistent: bool) -> None:
    """Raise for the gradient integrators that are not ported."""
    if persistent:
        return
    if remat_passes:
        raise NotImplementedError(
            "remat_passes=True (recomputing each pass's record in the "
            "backward) is not ported yet; lower n_samples or raise the "
            "record budget")
    if recorded_stage is not None:
        raise NotImplementedError(
            "recorded_stage (ops/grad_trace.trace_recorded_staged) is not "
            "ported; use recorded_fused or recorded_persist")
    if recorded_persist is None and not recorded_fused:
        what = ("the remat XLA transpose and the sweep VJP _sweep_bwd"
                if remat else
                "the XLA recorded path (ops/grad_trace.trace_recorded)"
                if recorded else
                "the fixed-depth wavefront (ops/integrator.trace)")
        raise NotImplementedError(
            f"{what} is not ported yet; the differentiable routes are "
            "recorded_fused (the fixed-depth kernel pair) and "
            "recorded_persist (the persistent-record kernel pair)")


def render_tile_sum_recorded(scene: Scene, cam: Camera, n_pix: int,
                             pixel_start: int, seed: int, n_samples: int,
                             sample_offset: int, max_depth: int, tmin: float,
                             f32_w: float, f32_h: float,
                             samples_per_pass: int,
                             recorded_persist: tuple | None = None,
                             persist_strict: bool = False,
                             impl: str | None = None,
                             stats: dict | None = None,
                             replay_fused: bool = True) -> torch.Tensor:
    """Differentiable radiance *sum* ``[n_pix, 3]`` of the contiguous pixel
    range from ``pixel_start``: the reference's recorded pass loop.

    Pass ``p`` traces ``samples_per_pass`` samples of every pixel in one
    wavefront, global samples from ``s0 = sample_offset + p *
    samples_per_pass``, with the camera rays of
    :func:`camera.sample_pass_rays`. Its trace draws are keyed by
    ``purpose_seed(seed, SCATTER_DIR, s0)``, cut to 32 bits. Each pass runs
    the persistent-record pair when ``recorded_persist = (n_strips,
    n_iters|None[, tail_compact[, rec_attrs]])`` is given, else the
    fixed-depth pair (``replay_fused=False`` replays it bounce by
    bounce)."""
    device = scene.device
    spp = samples_per_pass
    if n_samples % spp:
        raise ValueError(f"samples_per_pass={spp} must divide "
                         f"n_samples={n_samples}")
    W, H = int(f32_w), int(f32_h)
    u, v = pixel_coords(W, H, device=device)
    u = u[pixel_start:pixel_start + n_pix]
    v = v[pixel_start:pixel_start + n_pix]
    if recorded_persist is not None:
        p_strips, p_iters = recorded_persist[0], recorded_persist[1]
        p_tc = recorded_persist[2] if len(recorded_persist) > 2 else None
        p_rec_attrs = recorded_persist[3] if len(recorded_persist) > 3 \
            else True

        def trace(origin, direction, seed32):
            return trace_recorded_persist(
                scene, origin, direction, seed32, max_depth, tmin, p_strips,
                p_iters, tail_compact=p_tc, rec_attrs=p_rec_attrs,
                strict=persist_strict, impl=impl, stats=stats)
    else:
        def trace(origin, direction, seed32):
            return trace_recorded_fused(
                scene, origin, direction, seed32, max_depth, tmin,
                replay_fused=replay_fused, impl=impl)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    for p in range(n_samples // spp):
        s0 = sample_offset + p * spp
        origin, direction = sample_pass_rays(cam, u, v, seed, s0, spp, f32_w,
                                             f32_h)
        radiance = trace(origin, direction,
                         rng.purpose_seed(seed, rng.SCATTER_DIR, s0)
                         & 0xFFFFFFFF)
        acc = acc + radiance.reshape(spp, n_pix, 3).sum(0)
    return acc


def render_radiance(scene: Scene, cam: Camera, image_width: int = 400,
                    n_samples: int = 1, *, image_height: int | None = None,
                    max_depth: int = DEFAULT_MAX_DEPTH,
                    tmin: float = DEFAULT_TMIN, seed: int = 0,
                    pixel_chunk: int | None = None, persistent: bool = True,
                    device=None, impl: str | None = None,
                    generator: torch.Generator | None = None,
                    inline: bool | None = None,
                    recorded: bool = False, remat: bool = False,
                    recorded_fused: bool = False,
                    recorded_stage: tuple | None = None,
                    recorded_persist: tuple | None = None,
                    rays_per_pass: int | None = None,
                    remat_passes: bool = False,
                    persist_strict: bool = False,
                    replay_fused: bool = True,
                    stats: dict | None = None) -> torch.Tensor:
    """Linear mean radiance ``[H, W, 3]`` (no gamma) on ``device``: the card
    unless ``device="cpu"`` (the scene and camera move there). ``pixel_chunk``
    renders contiguous chunks of that many pixels one after another, chunk
    ``c`` with seed ``fold_in(seed, c)``. ``inline`` picks the forward route
    (see :func:`render_tile_sum`); ``generator`` (single-chunk strided
    renders only) supplies the strip-0 draws.

    ``persistent=False`` with ``recorded_fused`` or ``recorded_persist``
    renders differentiably (gradients reach the scene's tensors),
    ``rays_per_pass`` samples merged per wavefront (see
    :func:`pick_samples_per_pass`); ``replay_fused=False`` replays the
    fixed-depth pair bounce by bounce; ``persist_strict`` NaN-poisons the
    image and its gradients if the persistent pair drops any path;
    ``stats`` (a dict) collects its dropped count and occupancy. The other
    gradient integrators (``recorded_stage``, ``remat``, ``remat_passes``,
    ``recorded`` alone) raise ``NotImplementedError``."""
    _check_grad_route(recorded, remat, recorded_fused, recorded_stage,
                      recorded_persist, remat_passes, persistent)
    device = _resolve_device(device)
    scene = trim_scene(scene.to(device))
    cam = cam.to(device)
    H = image_height if image_height is not None else image_height_for(image_width)
    W = image_width
    n_pix = H * W
    fw, fh = float(np.float32(W)), float(np.float32(H))
    chunks = ([(0, n_pix)] if pixel_chunk is None or pixel_chunk >= n_pix
              else [(st, min(pixel_chunk, n_pix - st))
                    for st in range(0, n_pix, pixel_chunk)])
    if len(chunks) > 1 and generator is not None:
        raise ValueError("generator is for single-chunk renders; chunked "
                         "renders seed each chunk from fold_in(seed, c)")
    pieces = []
    for c, (start, size) in enumerate(chunks):
        seed_c = seed if len(chunks) == 1 else rng.fold_in(seed, c)
        if persistent:
            pieces.append(render_tile_sum(
                scene, cam, size, seed_c, n_samples, 0, max_depth, tmin, fw,
                fh, True, None if len(chunks) == 1 else start, impl,
                generator, inline))
        else:
            spp_pass = 1 if rays_per_pass is None else \
                pick_samples_per_pass(size, n_samples, rays_per_pass)
            pieces.append(render_tile_sum_recorded(
                scene, cam, size, start, seed_c, n_samples, 0, max_depth,
                tmin, fw, fh, spp_pass, recorded_persist, persist_strict,
                impl, stats, replay_fused))
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)
    return (out / n_samples).reshape(H, W, 3)


def render(scene: Scene, cam: Camera, image_width: int = 400,
           n_samples: int = 1, **kwargs) -> torch.Tensor:
    """Gamma-2 encoded image ``[H, W, 3]`` in [0, 1] (src/render.jl:8-9), on
    the card unless ``device="cpu"`` is passed."""
    return gamma2_encode(render_radiance(scene, cam, image_width, n_samples,
                                         **kwargs))
