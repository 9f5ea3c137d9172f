"""Render driver — the ``render`` entry point of the port (counterpart of
``raytracingweekend_jl_tpu.render``).

Reference semantics (src/render.jl:8-44): ``H = W * 9 // 16`` unless given;
film coordinates ``u = (j+1)/W``, ``v = (H-1-i)/H`` with row 0 at the top;
global sample 0 centered, later samples jittered by ``U[0,1)/W`` and
``U[0,1)/H``; radiance averaged over samples and gamma-2 encoded.

Two routes are ported. The forward route (``persistent=True``, the
default) is the persistent strided integrator: every contiguous full image
or chunk takes it, on the CPU through the plain versions and on a card
through the CUDA kernels. The reference package's two other persistent
routes raise ``NotImplementedError``: its single-launch small-image route
(the Pallas kernel ``inline_kernel._inline_kernel``) and its pixel-pinned
route for non-contiguous tiles (``shade_kernel._shade_kernel``). Small
images take the strided route here with sample-group folding.

The differentiable route (``persistent=False`` with ``recorded_persist``,
which ``grad.render_loss`` picks) traces each sample pass through the
persistent-record kernel pair (``ops/persist_grad.py``). Its other gradient
integrators raise ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .camera import Camera, get_rays
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


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was asked for but CUDA is not "
                           "available; the port does not fall back to the CPU")
    return device


def render_tile_sum(scene: Scene, cam: Camera, n_pix: int, seed: int,
                    n_samples: int, sample_offset: int, max_depth: int,
                    tmin: float, f32_w: float, f32_h: float,
                    persistent: bool = True, pixel_start: int | None = None,
                    impl: str | None = None,
                    generator: torch.Generator | None = None,
                    inline: bool = False) -> torch.Tensor:
    """Radiance *sum* ``[n_pix, 3]`` of ``n_samples`` samples for the
    contiguous pixel range from ``pixel_start`` (``None`` = a full image).

    Picks ``k`` and the sample-group fold as the reference package does for
    its strided route. ``inline=True`` asks for the reference package's
    single-launch small-image route, which is not ported yet."""
    if inline:
        raise NotImplementedError(
            "the single-launch small-image route needs the inline kernel "
            "(TPU ops/pallas/inline_kernel.py::_inline_kernel), not ported "
            "yet; small images take the strided route")
    if not persistent:
        raise NotImplementedError(
            "the fixed-depth wavefront (persistent=False, ops/integrator.trace) "
            "is not ported yet; use persistent=True")
    full_image = n_pix == int(f32_w) * int(f32_h)
    if pixel_start is None and not full_image:
        raise NotImplementedError(
            "non-contiguous tiles need the pixel-pinned persistent kernel "
            "(TPU ops/pallas/shade_kernel.py::_shade_kernel), not ported yet")
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
    if recorded_fused:
        raise NotImplementedError(
            "recorded_fused needs the fixed-depth record/replay kernels "
            "(TPU ops/pallas/grad_kernel.py, K7), not ported yet; use "
            "recorded_persist")
    if recorded_stage is not None:
        raise NotImplementedError(
            "recorded_stage (ops/grad_trace.trace_recorded_staged) is not "
            "ported; use recorded_persist")
    if recorded_persist is None:
        what = ("the remat XLA transpose and the sweep VJP _sweep_bwd"
                if remat else
                "the XLA recorded path (ops/grad_trace.trace_recorded)"
                if recorded else
                "the fixed-depth wavefront (ops/integrator.trace)")
        raise NotImplementedError(
            f"{what} is not ported yet; the differentiable route is "
            "recorded_persist (the persistent-record kernel pair)")


def render_tile_sum_recorded(scene: Scene, cam: Camera, n_pix: int,
                             pixel_start: int, seed: int, n_samples: int,
                             sample_offset: int, max_depth: int, tmin: float,
                             f32_w: float, f32_h: float,
                             samples_per_pass: int, recorded_persist: tuple,
                             persist_strict: bool = False,
                             impl: str | None = None,
                             stats: dict | None = None) -> torch.Tensor:
    """Differentiable radiance *sum* ``[n_pix, 3]`` of the contiguous pixel
    range from ``pixel_start``: the reference's recorded pass loop over the
    persistent-record kernel pair.

    Pass ``p`` traces ``samples_per_pass`` samples of every pixel in one
    wavefront, global samples from ``s0 = sample_offset + p *
    samples_per_pass``. Its jitter and lens draws come from generators
    keyed by ``(seed, purpose, s0)``; global sample 0 is centered. Its trace
    draws are keyed by ``purpose_seed(seed, SCATTER_DIR, s0)``, cut to 32
    bits. ``recorded_persist = (n_strips, n_iters|None[, tail_compact[,
    rec_attrs]])``."""
    device = scene.device
    spp = samples_per_pass
    if n_samples % spp:
        raise ValueError(f"samples_per_pass={spp} must divide "
                         f"n_samples={n_samples}")
    W, H = int(f32_w), int(f32_h)
    u, v = pixel_coords(W, H, device=device)
    u = u[pixel_start:pixel_start + n_pix]
    v = v[pixel_start:pixel_start + n_pix]
    scale = torch.tensor([1.0 / f32_w, 1.0 / f32_h], dtype=torch.float32,
                         device=device)
    p_strips, p_iters = recorded_persist[0], recorded_persist[1]
    p_tc = recorded_persist[2] if len(recorded_persist) > 2 else None
    p_rec_attrs = recorded_persist[3] if len(recorded_persist) > 3 else True
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    for p in range(n_samples // spp):
        s0 = sample_offset + p * spp
        sid = s0 + torch.arange(spp, device=device).repeat_interleave(n_pix)
        jit = torch.rand((spp * n_pix, 2), device=device,
                         generator=rng.generator(seed, rng.PIXEL_JITTER, s0,
                                                 device=device))
        jit = torch.where((sid == 0)[:, None], torch.zeros_like(jit),
                          jit * scale)
        origin, direction = get_rays(
            cam, u.repeat(spp) + jit[:, 0], v.repeat(spp) + jit[:, 1],
            generator=rng.generator(seed, rng.LENS, s0, device=device))
        radiance = trace_recorded_persist(
            scene, origin, direction,
            rng.purpose_seed(seed, rng.SCATTER_DIR, s0) & 0xFFFFFFFF,
            max_depth, tmin, p_strips, p_iters, tail_compact=p_tc,
            rec_attrs=p_rec_attrs, strict=persist_strict, impl=impl,
            stats=stats)
        acc = acc + radiance.reshape(spp, n_pix, 3).sum(0)
    return acc


def render_radiance(scene: Scene, cam: Camera, image_width: int = 400,
                    n_samples: int = 1, *, image_height: int | None = None,
                    max_depth: int = DEFAULT_MAX_DEPTH,
                    tmin: float = DEFAULT_TMIN, seed: int = 0,
                    pixel_chunk: int | None = None, persistent: bool = True,
                    device=None, impl: str | None = None,
                    generator: torch.Generator | None = None,
                    recorded: bool = False, remat: bool = False,
                    recorded_fused: bool = False,
                    recorded_stage: tuple | None = None,
                    recorded_persist: tuple | None = None,
                    rays_per_pass: int | None = None,
                    remat_passes: bool = False,
                    persist_strict: bool = False,
                    stats: dict | None = None) -> torch.Tensor:
    """Linear mean radiance ``[H, W, 3]`` (no gamma) on ``device`` (default:
    the scene's). ``pixel_chunk`` renders contiguous chunks of that many
    pixels one after another, chunk ``c`` with seed ``fold_in(seed, c)``.
    ``generator`` (single-chunk forward renders only) supplies the strip-0
    draws.

    ``persistent=False`` with ``recorded_persist`` renders differentiably
    (gradients reach the scene's tensors) through the persistent-record
    kernel pair, ``rays_per_pass`` samples merged per wavefront (see
    :func:`pick_samples_per_pass`); ``persist_strict`` NaN-poisons the
    image and its gradients if any path is dropped; ``stats`` (a dict)
    collects the dropped count and the occupancy. The other gradient
    integrators (``recorded_fused``, ``recorded_stage``, ``remat``,
    ``remat_passes``) raise ``NotImplementedError``."""
    _check_grad_route(recorded, remat, recorded_fused, recorded_stage,
                      recorded_persist, remat_passes, persistent)
    device = _resolve_device(scene.device if device is None else device)
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
                generator))
        else:
            spp_pass = 1 if rays_per_pass is None else \
                pick_samples_per_pass(size, n_samples, rays_per_pass)
            pieces.append(render_tile_sum_recorded(
                scene, cam, size, start, seed_c, n_samples, 0, max_depth,
                tmin, fw, fh, spp_pass, recorded_persist, persist_strict,
                impl, stats))
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)
    return (out / n_samples).reshape(H, W, 3)


def render(scene: Scene, cam: Camera, image_width: int = 400,
           n_samples: int = 1, **kwargs) -> torch.Tensor:
    """Gamma-2 encoded image ``[H, W, 3]`` in [0, 1] (src/render.jl:8-9)."""
    return gamma2_encode(render_radiance(scene, cam, image_width, n_samples,
                                         **kwargs))
