"""Batched ray–sphere closest-hit sweep in the reference package's dot form
(``raytracingweekend_jl_tpu.ops.intersect``).

This is the sweep of the port's CPU strided path: the reference package's
CPU strided driver runs the same dot form, so the two agree per ray. The
hand-written CUDA sweep (``ops/cuda/intersect_kernel.py``) uses the
expanded per-sphere form instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene import Scene

#: Shadow-acne epsilon (reference: src/ray_color.jl:19 uses T(1e-4)).
DEFAULT_TMIN = 1e-4
#: Stand-in for the reference's ``typemax(T)`` tmax.
BIG = 3.0e38


class HitResult(NamedTuple):
    """SoA hit records (reference: HitRecord, src/structs.jl:16-29)."""

    t: torch.Tensor      # [R] distance of closest hit (BIG where no hit)
    index: torch.Tensor  # [R] int32 sphere index of closest hit (0 if none)
    hit: torch.Tensor    # [R] bool


def intersect_spheres(origin: torch.Tensor, direction: torch.Tensor,
                      scene: Scene, tmin: float = DEFAULT_TMIN,
                      tmax: float = BIG) -> HitResult:
    """Closest hit of ``R`` rays (``[R,3]`` origins, unit directions) against
    all spheres: half-b quadratic with a == 1 (src/hit.jl:12-29), the
    ``|o|^2 - 2 o.c + (|c|^2 - r^2)`` expansion, near root then far root in
    the closed interval [tmin, tmax], and a first-index argmin over spheres
    (src/hit.jl:38-50).

    The two ray-sphere contractions are matrix products; on a CUDA device
    they must run in full float32 (TF32 would corrupt hit distances), which
    is checked.
    """
    if origin.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("intersect_spheres needs full-float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    dtype = origin.dtype
    centers = scene.center.to(dtype)
    radius = scene.radius.to(dtype)
    ck = (centers * centers).sum(dim=-1) - radius * radius   # [N]

    od = (origin * direction).sum(dim=-1)                     # [R]
    oo = (origin * origin).sum(dim=-1)                        # [R]
    cd = direction @ centers.T                                # [R,N]
    oc = origin @ centers.T                                   # [R,N]

    half_b = od[:, None] - cd
    c = oo[:, None] - 2.0 * oc + ck[None, :]
    disc = half_b * half_b - c
    sqrtd = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
    root_near = -half_b - sqrtd
    root_far = -half_b + sqrtd

    valid = disc > 0
    near_ok = valid & (root_near >= tmin) & (root_near <= tmax)
    far_ok = valid & (root_far >= tmin) & (root_far <= tmax)
    big = torch.full_like(root_near, tmax)
    t_cand = torch.where(near_ok, root_near, torch.where(far_ok, root_far, big))

    t, idx = torch.min(t_cand, dim=-1)
    return HitResult(t=t, index=idx.to(torch.int32), hit=t < tmax)
