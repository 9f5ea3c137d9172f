"""The single-launch small-image render — the counterpart of
``raytracingweekend_jl_tpu.ops.pallas.inline_kernel.render_inline_sum``.

Every (pixel, sample) path gets a lane of one K8 launch
(``cuda/inline_kernel.trace_inline``); samples are grouped into several
launches only when the lanes would exceed :data:`INLINE_MAX_LANES`. The
camera rays follow the recorded route's stream layout
(:func:`camera.sample_pass_rays`); the scatter draws of a group are keyed by
``rng.persistent_seed(seed, s0)``.
"""

from __future__ import annotations

from typing import Callable

import torch

from .. import rng
from ..camera import Camera, sample_pass_rays
from ..scene import Scene, check_static
from .cuda import inline_kernel
from .integrator import resolve_impl

#: Lane budget per kernel launch (the reference package's: 512 blocks of
#: 64 x 128 lanes, ~150 MB of ray planes).
INLINE_MAX_LANES = 1 << 22


def inline_samples_per_pass(n_pix: int, n_samples: int) -> int:
    """The largest divisor of ``n_samples`` whose lanes fit
    :data:`INLINE_MAX_LANES` (1 when even one sample does not)."""
    spg = 1
    for d in range(1, n_samples + 1):
        if n_samples % d == 0 and n_pix * d <= INLINE_MAX_LANES:
            spg = d
    return spg


def render_inline_sum(scene: Scene, cam: Camera, u: torch.Tensor,
                      v: torch.Tensor, seed: int, n_samples: int,
                      sample_offset: int, max_depth: int, tmin: float,
                      f32_w: float, f32_h: float, impl: str | None = None,
                      rng_u5_fn: Callable[[int], torch.Tensor] | None = None
                      ) -> torch.Tensor:
    """Radiance *sum* ``[n_pix, 3]`` over ``n_samples`` samples of the
    pixels at film coordinates ``u``/``v`` [n_pix], global samples from
    ``sample_offset`` (global sample 0 is centered).

    Group ``p`` traces samples ``s0 = sample_offset + p * spg`` onwards of
    every pixel in one launch, sample-major. ``scene``, ``cam`` and the
    coordinates must be on one device, which is where it runs. Float32
    only. Test hook: ``rng_u5_fn(p)`` -> [max_depth, 5, spg * n_pix]
    replaces group ``p``'s scatter draws."""
    check_static(scene, "the inline route (K8)")
    device = scene.device
    if cam.origin.device != device or u.device != device:
        raise ValueError(f"scene on {device}, camera on {cam.origin.device}, "
                         f"coordinates on {u.device}")
    impl = resolve_impl(impl, device)
    if scene.center.dtype != torch.float32:
        raise NotImplementedError(
            "only float32 renders are ported (the kernels are float32); "
            f"got {scene.center.dtype}")
    trace = (inline_kernel.trace_inline if impl == "kernels"
             else inline_kernel.trace_inline_ref)
    n_pix = u.shape[0]
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    if max_depth <= 0 or n_samples <= 0:
        return acc
    spg = inline_samples_per_pass(n_pix, n_samples)
    for p in range(n_samples // spg):
        s0 = sample_offset + p * spg
        origin, direction = sample_pass_rays(cam, u, v, seed, s0, spg, f32_w,
                                             f32_h)
        rng_u5 = None if rng_u5_fn is None else rng_u5_fn(p).to(u.device)
        radiance = trace(scene, origin, direction,
                         rng.persistent_seed(seed, s0), max_depth, tmin,
                         rng_u5)
        acc = acc + radiance.reshape(spg, n_pix, 3).sum(0)
    return acc
