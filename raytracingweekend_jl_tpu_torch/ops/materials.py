"""Per-sphere attribute table, the winner-attribute fetch and the scatter
stage — the counterpart of ``raytracingweekend_jl_tpu.ops.materials``.

The reference package fetches the winning sphere's attributes with a
bf16-split one-hot matrix product, a form that exists only for the TPU's
matrix unit. On the card it is a plain gather; its backward sums the rows'
cotangents onto the spheres with the ordered fixed-point contraction
(``cuda/grad_kernel.dattr_contract``), so gradients come out the same bits
on every run.

:func:`scatter` blends the three materials' scatter directions by material
code, with the draws passed in: a positional draw per bounce
(:func:`positional_draws`), or per-ray draws keyed by slot
(:func:`slot_draws`, Philox by ``(seed, bounce)`` with the slot as the
counter, the draws of the fixed-depth record kernel K7a). The reference
package draws both from threefry; tests inject its numbers instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import rng
from ..scene import Scene, LAMBERTIAN, METAL
from .sampling import unit_sphere_directions
from .vecmath import (dot, inv_length, normalize, reflect, refract,
                      reflectance, safe_sqrt, NEAR_ZERO_EPS)
from .cuda.grad_kernel import dattr_contract
from .cuda.shade_kernel import gauss3


class ScatterResult(NamedTuple):
    """Batch counterpart of the reference's ``Scatter`` (src/structs.jl:37-44)."""

    origin: torch.Tensor       # [R, 3] new ray origins (the hit points)
    direction: torch.Tensor    # [R, 3] new unit ray directions
    attenuation: torch.Tensor  # [R, 3] throughput multiplier


def attr_mat(scene: Scene) -> torch.Tensor:
    """``[N, 10]`` float32 per-sphere attributes, columns
    ``center.xyz | radius | albedo.rgb | fuzz | ir | mat``: the interface
    the shade kernels share (reference: materials.attr_mat)."""
    f32 = torch.float32
    return torch.cat([
        scene.center.to(f32), scene.radius[:, None].to(f32),
        scene.albedo.to(f32), scene.fuzz[:, None].to(f32),
        scene.ir[:, None].to(f32), scene.mat[:, None].to(f32)], dim=1)


def motion_attr_mat(scene) -> torch.Tensor:
    """``[N, 13]`` float32: :func:`attr_mat`'s columns, then the sphere's
    motion ``m`` (a ``MovingScene``): the rows K2m fetches."""
    return torch.cat([attr_mat(scene), scene.motion.to(torch.float32)],
                     dim=1).contiguous()


#: Calls of :func:`fetch_attr_planes` since the last reset: on the card
#: each is a cast and a gather launch (the strided and record loops fetch
#: inside K2 and K4 and make none).
fetch_calls = 0


def fetch_attr_planes(index: torch.Tensor, attr: torch.Tensor) -> torch.Tensor:
    """Winner attributes in ``[C, R]`` plane-major layout, ``C`` the
    table's columns (10; 13 for a moving scene's): ``attr[index].T``,
    contiguous."""
    global fetch_calls
    fetch_calls += 1
    return attr.T[:, index.long()].contiguous()


class _GatherRows(torch.autograd.Function):
    """``table[index]`` whose backward sums the rows' cotangents onto
    ``table`` with the ordered contraction (autograd's own backward of a
    gather accumulates with atomics on the card: not repeatable)."""

    @staticmethod
    def forward(ctx, table, index):
        ctx.save_for_backward(index)
        ctx.n = table.shape[0]
        return table[index.long()]

    @staticmethod
    def backward(ctx, g):
        (index,) = ctx.saved_tensors
        return dattr_contract(g.T.unsqueeze(0), index.unsqueeze(0), ctx.n), None


def gather_rows(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` ([N, F] -> [R, F]) with a deterministic backward."""
    return _GatherRows.apply(table, index)


def gather_sphere_attrs(scene: Scene, index: torch.Tensor, dtype) -> tuple:
    """Per-ray ``(center [R,3], radius, albedo [R,3], fuzz, ir, mat)`` of the
    spheres ``index`` [R]: one gather of the differentiable fields, whose
    backward is the ordered contraction (reference:
    materials.gather_sphere_attrs)."""
    table = torch.cat([scene.center, scene.radius[:, None], scene.albedo,
                       scene.fuzz[:, None], scene.ir[:, None]], 1).to(dtype)
    rows = gather_rows(table, index)
    return (rows[:, 0:3], rows[:, 3], rows[:, 4:7], rows[:, 7], rows[:, 8],
            scene.mat[index.long()])


def positional_draws(seed: int, bounce: int, n_rays: int, dtype=torch.float32,
                     device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """One bounce's shaped draws ``(u [R, 3] unit vectors, xi [R] Schlick
    coins)`` from generators keyed by ``(seed, purpose, bounce)``: a pure
    function of its arguments, so a recomputed bounce redraws them exactly
    (the reference splits ``fold_in(key, bounce)`` into the same two)."""
    u = unit_sphere_directions((n_rays,), generator=rng.generator(
        seed, rng.SCATTER_DIR, bounce, device=device), dtype=dtype,
        device=device)
    xi = torch.rand((n_rays,), generator=rng.generator(
        seed, rng.SCHLICK, bounce, device=device), dtype=dtype, device=device)
    return u, xi


def slot_draws(seed: int, bounce: int, slots: torch.Tensor,
               dtype=torch.float32, coords: tuple = (0, 0)
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-ray draws keyed by slot (reference: ``slot_keys`` and
    ``_per_ray_draws``): 5 Philox uniforms keyed by ``(seed, bounce)`` with
    the slot as the counter, a unit vector from the first four by
    Box-Muller and the fifth as the coin — the draws of K7a for lane ==
    slot. Independent of where the ray sits in the wavefront. ``coords``
    fill the counter's last two words (:func:`rng.philox_uniforms`)."""
    u5 = rng.philox_uniforms(seed, bounce, slots.shape[0], 5,
                             device=slots.device, lanes=slots, coords=coords)
    g0, g1, g2 = gauss3(u5[0], u5[1], u5[2], u5[3])
    gn = inv_length(g0 * g0 + g1 * g1 + g2 * g2)
    return (torch.stack([g0 * gn, g1 * gn, g2 * gn], -1).to(dtype),
            u5[4].to(dtype))


def scatter(origin: torch.Tensor, direction: torch.Tensor, t: torch.Tensor,
            attrs: tuple, u: torch.Tensor, xi: torch.Tensor) -> ScatterResult:
    """Scatter ``R`` rays that hit the spheres of ``attrs`` = (center,
    radius, albedo, fuzz, ir, mat) rows at parameter ``t`` (reference:
    materials.scatter, src/material.jl:13-53), with the unit-vector draws
    ``u`` [R, 3] and Schlick coins ``xi`` [R].

    Rays that hit nothing get finite garbage that the integrator masks; ``t``
    must already be finite for them. Every guard sits before its operation
    (``inv_r``, ``safe_sqrt``, the clamped ``inv_length`` of ``normalize``), so a
    branch that is not taken cannot put a NaN into the gradients."""
    one = torch.ones((), dtype=origin.dtype, device=origin.device)
    p = origin + t[..., None] * direction
    center, radius, albedo, fuzz, ir, mat = attrs
    # Signed radius: a negative radius flips the outward normal (hollow
    # shells, src/hit.jl:33).
    zero_r = radius == 0
    inv_r = torch.where(zero_r, torch.zeros_like(radius),
                        1.0 / torch.where(zero_r, one, radius))
    n_out = (p - center) * inv_r[..., None]
    front_face = dot(direction, n_out) < 0
    n = torch.where(front_face[..., None], n_out, -n_out)

    # Lambertian (src/material.jl:13-23).
    lam_raw = n + u
    lam_degenerate = (lam_raw * lam_raw).sum(-1) < NEAR_ZERO_EPS
    lam_dir = torch.where(lam_degenerate[..., None], n, normalize(lam_raw))

    # Metal (src/material.jl:25-34; fuzz not clamped).
    refl = reflect(direction, n)
    metal_dir = normalize(refl + fuzz[..., None] * u)

    # Dielectric (src/material.jl:41-53).
    eta_ratio = torch.where(front_face, 1.0 / ir, ir)
    cos_theta = torch.clamp(-dot(direction, n), max=1.0)
    sin_theta = safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = eta_ratio * sin_theta > 1.0
    schlick = reflectance(cos_theta, eta_ratio)
    reflect_choice = cannot_refract | (schlick > xi)
    refr_dir = refract(direction, n, eta_ratio)
    diel_dir = torch.where(reflect_choice[..., None], refl, refr_dir)

    new_dir = torch.where((mat == LAMBERTIAN)[..., None], lam_dir,
                          torch.where((mat == METAL)[..., None], metal_dir,
                                      diel_dir))
    # Dielectric rows store albedo (1, 1, 1) (src/material.jl:42).
    return ScatterResult(origin=p, direction=new_dir, attenuation=albedo)
