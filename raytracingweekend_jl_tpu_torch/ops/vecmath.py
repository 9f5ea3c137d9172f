"""Vector math on stacked ``[..., 3]`` tensors — the PyTorch counterpart of
``raytracingweekend_jl_tpu.ops.vecmath`` (reference: src/vec.jl:1-22,
src/light.jl:1-25).

Every helper is shape-polymorphic over leading batch dims and keeps the
reference package's operation order, so float32 results agree with it to the
last few ulps on the same inputs.
"""

from __future__ import annotations

import torch

# Reference thresholds (src/vec.jl:20, src/ray_color.jl:19).
NEAR_ZERO_EPS = 1e-5
#: Guard inside the normalisation so degenerate lanes stay finite.
_SAFE_EPS = 1e-20


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis (reference: src/vec.jl:19)."""
    return (a * b).sum(dim=-1)


def squared_length(v: torch.Tensor) -> torch.Tensor:
    """``|v|^2`` (reference: squared_length, src/vec.jl:19)."""
    return dot(v, v)


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """True where ``|v|^2 < 1e-5`` (reference: near_zero, src/vec.jl:20)."""
    return squared_length(v) < NEAR_ZERO_EPS


def inv_length(sq: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(sq)``, ``sq`` clamped to a tiny floor, rounded once to
    ``sq``'s dtype: the square root and the division in float64, then one
    rounding. Every normalisation of the port takes it, as every kernel
    takes ``rtw_inv_length`` (csrc/shade_core.cuh, the correctly rounded
    ``__frsqrt_rn``): the same bits on every non-negative float32, on the
    card and on the CPU, whose float32 square root is not correctly rounded
    (it differs from IEEE on ~0.7% of inputs and biases ``|d|^2 - 1`` by
    +1.1e-9). The card's approximate reciprocal square root leaves
    directions short (-6.5e-9); the sweep takes a direction as unit, so a
    biased length biases the hits."""
    x = torch.clamp(sq, min=_SAFE_EPS)
    return (1.0 / torch.sqrt(x.to(torch.float64))).to(sq.dtype)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Unit-normalise ``[..., 3]`` vectors; a zero vector stays zero.
    ``|v|^2`` is summed as ``(x*x + y*y) + z*z`` on every device, as the
    kernels that rebuild a camera ray sum it: a reduction's order is the
    library's (PyTorch's CPU sum of a row of three adds in this order, its
    CUDA sum of ``[R, 3]`` rows as ``(x*x + z*z) + y*y``, one ulp apart on
    some rows)."""
    sq = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]
    inv = torch.where(sq > 0, inv_length(sq), torch.zeros_like(sq))
    return v * inv[..., None]


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt that is 0 for x <= 0."""
    pos = x > 0
    return torch.sqrt(torch.where(pos, x, torch.ones_like(x))) * pos


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of ``v`` about unit normal ``n`` (src/light.jl:6)."""
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(d: torch.Tensor, n: torch.Tensor,
            eta_ratio: torch.Tensor) -> torch.Tensor:
    """Snell refraction returning a unit direction (src/light.jl:12-17)."""
    cos_theta = torch.clamp(-dot(d, n), max=1.0)
    r_perp = eta_ratio[..., None] * (d + cos_theta[..., None] * n)
    r_par = -safe_sqrt(torch.abs(1.0 - squared_length(r_perp)))[..., None] * n
    return normalize(r_perp + r_par)


def reflectance(cos_theta: torch.Tensor, eta_ratio: torch.Tensor) -> torch.Tensor:
    """Schlick's reflectance approximation (src/light.jl:19-25)."""
    r0 = (1.0 - eta_ratio) / (1.0 + eta_ratio)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5


def gamma2_encode(linear: torch.Tensor) -> torch.Tensor:
    """Gamma-2 encode = sqrt (reference: rgb_gamma2, src/vec.jl:22)."""
    return torch.sqrt(torch.clamp(linear, min=0.0))


def color_vec3_in_rgb(v: torch.Tensor) -> torch.Tensor:
    """A vector field as RGB for debugging, ``0.5 * normalize(v) + 0.5``
    (reference: color_vec3_in_rgb, src/ray_color.jl:8)."""
    return 0.5 * normalize(v) + 0.5
