"""SoA sphere scene as torch tensors — the counterpart of
``raytracingweekend_jl_tpu.scene``.

Layout, padding and signed-radius semantics are the reference package's: a
negative radius flips the outward normal (hollow glass, src/hit.jl:33); padding
spheres have radius 0, sit far away and can never be hit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .utils.profiling import sync

# Material codes (replace the reference's Material type hierarchy).
LAMBERTIAN = 0
METAL = 1
DIELECTRIC = 2

#: Sphere count is padded to a multiple of this, as in the reference package.
SPHERE_PAD = 128

#: Padding spheres sit this far away.
_PAD_DISTANCE = 1e4

_FIELDS = ("center", "radius", "albedo", "fuzz", "ir", "mat")


class Scene(NamedTuple):
    """Dense sphere scene. All tensors share the leading axis ``N`` and one
    device."""

    center: torch.Tensor  # [N, 3] sphere centers
    radius: torch.Tensor  # [N] signed radii (< 0 = hollow shell)
    albedo: torch.Tensor  # [N, 3] (dielectrics store (1, 1, 1))
    fuzz: torch.Tensor    # [N] metal fuzz (not clamped, src/scenes.jl:70)
    ir: torch.Tensor      # [N] index of refraction
    mat: torch.Tensor     # [N] int32 material codes

    @property
    def n_spheres(self) -> int:
        return self.center.shape[0]

    @property
    def device(self) -> torch.device:
        return self.center.device

    def to(self, device) -> "Scene":
        return Scene(*(x.to(device) for x in self))


def scene_from_numpy(arrays, device="cpu", dtype=torch.float32,
                     requires_grad: bool = False) -> Scene:
    """Build a :class:`Scene` from numpy arrays keyed by field name (or any
    object with those attributes, e.g. the JAX package's ``Scene``).
    ``requires_grad`` makes every field but ``mat`` a leaf that gradients
    reach (it carries through :func:`trim_scene` and :meth:`Scene.to`)."""
    get = (arrays.__getitem__ if isinstance(arrays, dict)
           else lambda f: getattr(arrays, f))
    vals = {f: np.array(get(f)) for f in _FIELDS}
    out = {f: torch.as_tensor(vals[f], dtype=torch.int32 if f == "mat"
                              else dtype).to(device) for f in _FIELDS}
    if requires_grad:
        for f in _FIELDS[:-1]:
            out[f].requires_grad_(True)
    return Scene(**out)


def trim_scene(scene: Scene, multiple: int = 8) -> Scene:
    """Drop trailing zero-radius padding spheres, keeping ``N`` a multiple of
    ``multiple``. Bitwise-safe: a padding sphere never changes a hit."""
    with sync("trim_scene"):  # a copy to the host waits for the card
        r = scene.radius.detach().cpu().numpy()
    nz = np.flatnonzero(r != 0)
    n = int(nz[-1]) + 1 if nz.size else 1
    n = min(scene.n_spheres, max(multiple, -(-n // multiple) * multiple))
    if n == scene.n_spheres:
        return scene
    return Scene(*(x[:n] for x in scene))


def make_scene(spheres: list[dict], dtype=torch.float32,
               pad_to: int | None = SPHERE_PAD, device="cpu") -> Scene:
    """Build a padded :class:`Scene` from sphere dicts (see :func:`sphere`)."""
    n = len(spheres)
    n_pad = n
    if pad_to:
        n_pad = max(pad_to, -(-n // pad_to) * pad_to)

    center = np.full((n_pad, 3), _PAD_DISTANCE, dtype=np.float64)
    radius = np.zeros((n_pad,), dtype=np.float64)
    albedo = np.ones((n_pad, 3), dtype=np.float64)
    fuzz = np.zeros((n_pad,), dtype=np.float64)
    ir = np.ones((n_pad,), dtype=np.float64)
    mat = np.zeros((n_pad,), dtype=np.int32)

    for i, s in enumerate(spheres):
        center[i] = np.asarray(s["center"], dtype=np.float64)
        radius[i] = s["radius"]
        mat[i] = s["mat"]
        if s["mat"] == DIELECTRIC:
            albedo[i] = (1.0, 1.0, 1.0)  # src/material.jl:42
            ir[i] = s["ir"]
        else:
            albedo[i] = np.asarray(s["albedo"], dtype=np.float64)
            if s["mat"] == METAL:
                fuzz[i] = s.get("fuzz", 0.0)

    # Cast on the host exactly as the reference package does (float64 ->
    # float32 round to nearest), then move.
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return scene_from_numpy(
        dict(center=center.astype(np_dtype), radius=radius.astype(np_dtype),
             albedo=albedo.astype(np_dtype), fuzz=fuzz.astype(np_dtype),
             ir=ir.astype(np_dtype), mat=mat), device=device, dtype=dtype)


def sphere(center, radius, mat, albedo=(1.0, 1.0, 1.0), fuzz=0.0,
           ir=1.0) -> dict:
    """Mirrors the reference's ``Sphere(center, r, material)``."""
    return dict(center=tuple(center), radius=float(radius), mat=int(mat),
                albedo=tuple(albedo), fuzz=float(fuzz), ir=float(ir))


def lambertian(center, radius, albedo) -> dict:
    """Reference: ``Sphere(c, r, Lambertian(albedo))`` (src/material.jl:3-5)."""
    return sphere(center, radius, LAMBERTIAN, albedo=albedo)


def metal(center, radius, albedo, fuzz=0.0) -> dict:
    """Reference: ``Sphere(c, r, Metal(albedo, fuzz))`` (src/material.jl:25-29)."""
    return sphere(center, radius, METAL, albedo=albedo, fuzz=fuzz)


def dielectric(center, radius, ir) -> dict:
    """Reference: ``Sphere(c, r, Dielectric(ir))`` (src/material.jl:37-39)."""
    return sphere(center, radius, DIELECTRIC, ir=ir)
