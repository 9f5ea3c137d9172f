"""SoA sphere scene as torch tensors — the counterpart of
``raytracingweekend_jl_tpu.scene``.

Layout, padding and signed-radius semantics are the reference package's: a
negative radius flips the outward normal (hollow glass, src/hit.jl:33); padding
spheres have radius 0, sit far away and can never be hit.

:class:`MovingScene` is a :class:`Scene` with a motion per sphere (book 2's
motion blur, *Ray Tracing: The Next Week* §2): the centre at shutter time
``t`` in [0, 1) is ``center + t * motion``. Only the strided forward route
renders it (K1m and K2m); every route without a time refuses it
(:func:`check_static`) rather than render it frozen.
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
        return type(self)(*(x.to(device) for x in self))


class MovingScene(NamedTuple):
    """A :class:`Scene` whose spheres move over the shutter [0, 1): sphere
    ``s`` is centred at ``center[s] + t * motion[s]`` at time ``t``."""

    center: torch.Tensor  # [N, 3] sphere centers at t = 0
    radius: torch.Tensor  # [N] signed radii
    albedo: torch.Tensor  # [N, 3]
    fuzz: torch.Tensor    # [N]
    ir: torch.Tensor      # [N]
    mat: torch.Tensor     # [N] int32 material codes
    motion: torch.Tensor  # [N, 3] displacement over the shutter

    n_spheres = Scene.n_spheres
    device = Scene.device

    def to(self, device) -> "MovingScene":
        out = Scene.to(self, device)
        _carry_moving(self, out)
        return out


def moving_spheres(scene: MovingScene) -> int:
    """How many of ``scene``'s spheres move: the count taken on the host
    where its motion was made (:func:`scene_from_numpy`, the presets) and
    carried by :meth:`MovingScene.to` and :func:`trim_scene`, else read from
    the device once and kept on the motion tensor."""
    n = getattr(scene.motion, "moving_spheres", None)
    if n is None:
        with sync("moving_spheres"):  # a copy to the host waits for the card
            n = int((scene.motion != 0).any(1).sum())
        scene.motion.moving_spheres = n
    return n


def _carry_moving(src, dst) -> None:
    """Give ``dst``'s motion ``src``'s count of moving spheres, where it
    was taken (padding, which trimming drops, never moves)."""
    n = getattr(src.motion, "moving_spheres", None)
    if n is not None:
        dst.motion.moving_spheres = n


def scene_moves(scene) -> bool:
    """Whether ``scene`` is a :class:`MovingScene`, which only the strided
    forward route renders."""
    return isinstance(scene, MovingScene)


def check_static(scene, route: str) -> None:
    """Raise ``NotImplementedError`` if ``scene`` moves: ``route`` has no
    shutter time, and would render it frozen at t = 0."""
    if scene_moves(scene):
        raise NotImplementedError(
            f"{route} has no shutter time and cannot render a MovingScene; "
            "a moving scene renders only on the strided route: "
            "render_tile_sum(persistent=True, inline=False) of a whole "
            "image or a contiguous pixel range, float32")


def scene_from_numpy(arrays, device="cpu", dtype=torch.float32,
                     requires_grad: bool = False) -> Scene:
    """Build a :class:`Scene` from numpy arrays keyed by field name (or any
    object with those attributes, e.g. the JAX package's ``Scene``); a
    ``motion`` key or attribute makes it a :class:`MovingScene`.
    ``requires_grad`` makes every field but ``mat`` and ``motion`` a leaf
    that gradients reach (it carries through :func:`trim_scene` and
    :meth:`Scene.to`)."""
    get = (arrays.__getitem__ if isinstance(arrays, dict)
           else lambda f: getattr(arrays, f))
    has_motion = ("motion" in arrays if isinstance(arrays, dict)
                  else hasattr(arrays, "motion"))
    fields = _FIELDS + ("motion",) if has_motion else _FIELDS
    out = {f: torch.as_tensor(np.array(get(f)), dtype=torch.int32
                              if f == "mat" else dtype).to(device)
           for f in fields}
    if requires_grad:
        for f in _FIELDS[:-1]:
            out[f].requires_grad_(True)
    if not has_motion:
        return Scene(**out)
    out["motion"].moving_spheres = int(
        (np.asarray(get("motion")) != 0).any(-1).sum())
    return MovingScene(**out)


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
    out = type(scene)(*(x[:n] for x in scene))
    if scene_moves(scene):
        _carry_moving(scene, out)
    return out


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
