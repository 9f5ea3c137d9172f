"""Vector helpers on ``[..., 3]`` tensors (src/vec.jl, src/light.jl)."""

from __future__ import annotations

import torch

#: src/vec.jl:20.
NEAR_ZERO_EPS = 1e-5


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    """Unit vectors; the root and the division in float64, rounded once to
    ``v``'s type; a zero vector stays zero."""
    sq = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]
    inv = (1.0 / torch.sqrt(sq.to(torch.float64).clamp(min=1e-20))).to(v.dtype)
    return v * torch.where(sq > 0, inv, torch.zeros_like(inv))[..., None]


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    pos = x > 0
    return torch.sqrt(torch.where(pos, x, torch.ones_like(x))) * pos


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return v - (2.0 * dot(v, n))[..., None] * n


def refract(d: torch.Tensor, n: torch.Tensor, eta: torch.Tensor
            ) -> torch.Tensor:
    cos_t = torch.clamp(-dot(d, n), max=1.0)
    r_perp = eta[..., None] * (d + cos_t[..., None] * n)
    r_par = -safe_sqrt(torch.abs(1.0 - dot(r_perp, r_perp)))[..., None] * n
    return normalize(r_perp + r_par)


def schlick(cos_t: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    r0 = ((1.0 - eta) / (1.0 + eta)) ** 2
    return r0 + (1.0 - r0) * (1.0 - cos_t) ** 5


def skycolor(d: torch.Tensor) -> torch.Tensor:
    """White to sky blue by ``d.y`` (src/ray_color.jl:1-6)."""
    t = 0.5 * (d[..., 1] + 1.0)
    white = torch.ones(3, dtype=d.dtype, device=d.device)
    blue = torch.tensor((0.5, 0.7, 1.0), dtype=d.dtype, device=d.device)
    return (1.0 - t)[..., None] * white + t[..., None] * blue
