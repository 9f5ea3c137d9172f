"""Branch-free random samplers on explicit ``torch.Generator``s — the
counterpart of ``raytracingweekend_jl_tpu.ops.sampling``.

Closed forms of the reference's rejection samplers (src/rand.jl:15-38):
a normalised 3-D Gaussian for unit-sphere directions and Shirley's concentric
map for unit-disk points.
"""

from __future__ import annotations

import math

import torch

from .vecmath import inv_length


def unit_sphere_directions(shape: tuple, generator: torch.Generator | None = None,
                           dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``shape + (3,)`` i.i.d. uniform unit vectors (src/rand.jl:29):
    Gaussian triples times ``inv_length`` of ``(x*x + y*y) + z*z``, the
    kernels' normalisation, in that order on every device."""
    g = torch.randn(tuple(shape) + (3,), generator=generator, dtype=dtype,
                    device=device)
    sq = (g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]) + g[..., 2] * g[..., 2]
    return g * inv_length(sq)[..., None]


def concentric_disk_map(uv: torch.Tensor) -> torch.Tensor:
    """Shirley's concentric square->disk map. ``uv`` in [-1,1]^2 on the
    trailing axis; points are uniform in the unit disk when ``uv`` is uniform."""
    a, b = uv[..., 0], uv[..., 1]
    use_a = torch.abs(a) > torch.abs(b)
    r = torch.where(use_a, a, b)
    quarter_pi = torch.full((), math.pi / 4, dtype=uv.dtype, device=uv.device)
    half_pi = torch.full((), math.pi / 2, dtype=uv.dtype, device=uv.device)
    one = torch.ones_like(a)
    safe_a = torch.where(a == 0, one, a)
    safe_b = torch.where(b == 0, one, b)
    theta = torch.where(use_a, quarter_pi * (b / safe_a),
                        half_pi - quarter_pi * (a / safe_b))
    theta = torch.where((a == 0) & (b == 0), torch.zeros_like(theta), theta)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], dim=-1)


def unit_disk_points(shape: tuple, generator: torch.Generator | None = None,
                     dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``shape + (2,)`` uniform points in the unit disk (src/rand.jl:31-38)."""
    u = torch.rand(tuple(shape) + (2,), generator=generator, dtype=dtype,
                   device=device)
    return concentric_disk_map(u * 2.0 - 1.0)


def per_ray_uniforms(n_rays: int, n: int,
                     generator: torch.Generator | None = None,
                     dtype=torch.float32, device="cpu") -> torch.Tensor:
    """``[R, n]`` U[0,1) draws from ``generator``."""
    return torch.rand((n_rays, n), generator=generator, dtype=dtype,
                      device=device)


def uniform_between(generator: torch.Generator | None, shape: tuple, lo, hi,
                    dtype=torch.float32, device=None) -> torch.Tensor:
    """Uniform in [lo, hi) (reference: random_between, src/rand.jl:24): the
    U[0,1) draws ``u`` of ``generator`` mapped as the JAX package maps them,
    ``max(lo, u * (hi - lo) + lo)`` in ``dtype``."""
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype,
                   device=device)
    lo = torch.as_tensor(lo, dtype=dtype, device=u.device)
    hi = torch.as_tensor(hi, dtype=dtype, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)
