"""The megakernel forward renderer — the counterpart of
``raytracingweekend_jl_tpu/ops/pallas/experimental/mega_kernel.py``'s
``persistent_render_sum_mega``.

The same renderer as the pixel-pinned :func:`ops.integrator.
persistent_render_sum_fused` (one lane per pixel, a finished ray starts its
pixel's next sample in place, the same first rays, state, draws and loop
bound), with each iteration one launch of K12
(``cuda/mega_kernel.mega_step``) in place of the sweep, the fetch and K9.
On the card the two give the same image bit for bit. The JAX package drives
it only from ``scripts/mega_bench.py``; the port's measurement is
``chip_smoke.py``'s ``mega_render`` phase.
"""

from __future__ import annotations

from typing import Callable

import torch

from ...scene import Scene
from ..cuda import mega_kernel
from ..integrator import DEFAULT_MAX_DEPTH, pinned_render_loop
from ..intersect import DEFAULT_TMIN


def _mega_iteration(impl, tables, fstate, istate, u, v, cam_consts, seed32,
                    it, last_sample, max_depth, tmin, u9) -> None:
    """One iteration: K12 or its plain version."""
    _, spheres, amat = tables
    step = (mega_kernel.mega_step if impl == "kernels"
            else mega_kernel.mega_step_ref)
    step(fstate, istate, spheres, amat, u, v, cam_consts, seed32, it,
         last_sample, max_depth, tmin, u9)


def persistent_render_sum_mega(
        scene: Scene, cam, u: torch.Tensor, v: torch.Tensor, seed: int,
        n_samples: int, sample_offset: int = 0,
        max_depth: int = DEFAULT_MAX_DEPTH, tmin: float = DEFAULT_TMIN,
        f32_w: float = 0.0, f32_h: float = 0.0, impl: str | None = None,
        init_u4: torch.Tensor | None = None,
        rng_u9_fn: Callable[[int], torch.Tensor] | None = None
) -> torch.Tensor:
    """Radiance sums ``[R, 3]`` of ``n_samples`` samples (global ids from
    ``sample_offset``) of the pixels at film coordinates ``u``/``v`` [R] of
    a ``f32_w x f32_h`` image, one lane pinned to each pixel, each iteration
    one K12 launch (``impl="kernels"``, the default on CUDA) or its plain
    version (``"plain"``, the default on the CPU).

    Arguments, draws and loop bound as
    :func:`ops.integrator.persistent_render_sum_fused` (the same loop,
    :func:`ops.integrator.pinned_render_loop`): the first rays from
    :func:`ops.integrator.pinned_start_rays` (``init_u4`` [R, 4] replaces
    their draws), then Philox keyed by ``(persistent_seed(seed,
    sample_offset), iteration)`` with the lane as the counter, or
    ``rng_u9_fn(it)`` -> [9, R]. Float32 only."""
    return pinned_render_loop(scene, cam, u, v, seed, n_samples,
                              sample_offset, max_depth, tmin, f32_w, f32_h,
                              impl, init_u4, rng_u9_fn, _mega_iteration)
