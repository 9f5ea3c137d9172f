"""Render driver — the ``render`` entry point of the port (counterpart of
``raytracingweekend_jl_tpu.render``).

Reference semantics (src/render.jl:8-44): ``H = W * 9 // 16`` unless given;
film coordinates ``u = (j+1)/W``, ``v = (H-1-i)/H`` with row 0 at the top;
global sample 0 centered, later samples jittered by ``U[0,1)/W`` and
``U[0,1)/H``; radiance averaged over samples and gamma-2 encoded.

Only the persistent strided route is ported. Every contiguous full image or
chunk takes it, on the CPU through the plain versions and on a card through
the CUDA kernels. The reference package's two other persistent routes raise
``NotImplementedError``: its single-launch small-image route (the Pallas
kernel ``inline_kernel._inline_kernel``) and its pixel-pinned route for
non-contiguous tiles (``shade_kernel._shade_kernel``). Small images take the
strided route here with sample-group folding.
"""

from __future__ import annotations

import numpy as np
import torch

from . import rng
from .camera import Camera
from .ops.integrator import DEFAULT_MAX_DEPTH, persistent_render_sum_strided
from .ops.intersect import DEFAULT_TMIN
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


def render_radiance(scene: Scene, cam: Camera, image_width: int = 400,
                    n_samples: int = 1, *, image_height: int | None = None,
                    max_depth: int = DEFAULT_MAX_DEPTH,
                    tmin: float = DEFAULT_TMIN, seed: int = 0,
                    pixel_chunk: int | None = None, persistent: bool = True,
                    device=None, impl: str | None = None,
                    generator: torch.Generator | None = None) -> torch.Tensor:
    """Linear mean radiance ``[H, W, 3]`` (no gamma) on ``device`` (default:
    the scene's). ``pixel_chunk`` renders contiguous chunks of that many
    pixels one after another, chunk ``c`` with seed ``fold_in(seed, c)``.
    ``generator`` (single-chunk renders only) supplies the strip-0 draws."""
    device = _resolve_device(scene.device if device is None else device)
    scene = trim_scene(scene.to(device))
    cam = cam.to(device)
    H = image_height if image_height is not None else image_height_for(image_width)
    W = image_width
    n_pix = H * W
    fw, fh = float(np.float32(W)), float(np.float32(H))
    if pixel_chunk is None or pixel_chunk >= n_pix:
        out = render_tile_sum(scene, cam, n_pix, seed, n_samples, 0, max_depth,
                              tmin, fw, fh, persistent, None, impl, generator)
    else:
        if generator is not None:
            raise ValueError("generator is for single-chunk renders; chunked "
                             "renders seed each chunk from fold_in(seed, c)")
        pieces = []
        for c, start in enumerate(range(0, n_pix, pixel_chunk)):
            size = min(pixel_chunk, n_pix - start)
            pieces.append(render_tile_sum(
                scene, cam, size, rng.fold_in(seed, c), n_samples, 0,
                max_depth, tmin, fw, fh, persistent, start, impl))
        out = torch.cat(pieces, dim=0)
    return (out / n_samples).reshape(H, W, 3)


def render(scene: Scene, cam: Camera, image_width: int = 400,
           n_samples: int = 1, **kwargs) -> torch.Tensor:
    """Gamma-2 encoded image ``[H, W, 3]`` in [0, 1] (src/render.jl:8-9)."""
    return gamma2_encode(render_radiance(scene, cam, image_width, n_samples,
                                         **kwargs))
