"""Scene library — the reference scenes as SoA builders (src/scenes.jl:1-84).

Each builder is the counterpart of the one in
``raytracingweekend_jl_tpu.models.scenes``: the same constants and the same
seeded numpy draws, so the arrays are equal bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..scene import (LAMBERTIAN, MovingScene, Scene, make_scene,
                     scene_from_numpy, lambertian, metal, dielectric)


def scene_2_spheres(dtype=torch.float32, device="cpu") -> Scene:
    """Two Lambertian spheres (src/scenes.jl:2-11)."""
    return make_scene([
        lambertian((0, 0, -1), 0.5, (0.7, 0.3, 0.3)),
        lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0)),
    ], dtype=dtype, device=device)


def scene_4_spheres(dtype=torch.float32, device="cpu") -> Scene:
    """2 Lambertian + 2 Metal spheres (src/scenes.jl:16-23)."""
    return make_scene([
        lambertian((0, 0, -1), 0.5, (0.7, 0.3, 0.3)),
        lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0)),
        metal((-1, 0, -1), 0.5, (0.8, 0.8, 0.8), 0.3),
        metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.8),
    ], dtype=dtype, device=device)


def scene_diel_spheres(left_radius: float = 0.5, dtype=torch.float32,
                       device="cpu") -> Scene:
    """Dielectric scene; ``left_radius=-0.5`` gives the hollow bubble
    (src/scenes.jl:25-39)."""
    return make_scene([
        lambertian((0, 0, -1), 0.5, (0.1, 0.2, 0.5)),
        lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0)),
        dielectric((-1, 0, -1), left_radius, 1.5),
        metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.0),
    ], dtype=dtype, device=device)


def scene_diel_spheres_hollow(dtype=torch.float32, device="cpu") -> Scene:
    """Glass shell with a hollow interior via a negative radius
    (src/scenes.jl:35-36)."""
    return make_scene([
        lambertian((0, 0, -1), 0.5, (0.1, 0.2, 0.5)),
        lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0)),
        dielectric((-1, 0, -1), 0.5, 1.5),
        dielectric((-1, 0, -1), -0.45, 1.5),
        metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.0),
    ], dtype=dtype, device=device)


def scene_blue_red_spheres(dtype=torch.float32, device="cpu") -> Scene:
    """Wide-angle blue/red pair (src/scenes.jl:41-47)."""
    R = math.cos(math.pi / 4)
    return make_scene([
        lambertian((-R, 0, -1), R, (0, 0, 1)),
        lambertian((R, 0, -1), R, (1, 0, 0)),
    ], dtype=dtype, device=device)


def _random_spheres(seed: int, grid_half: int) -> list[dict]:
    """The spheres of book 1's final scene (:func:`scene_random_spheres`)."""
    g = np.random.default_rng(seed)
    spheres = [lambertian((0, -1000, -1), 1000.0, (0.5, 0.5, 0.5))]

    for a in range(-grid_half, grid_half):
        for b in range(-grid_half, grid_half):
            choose_mat = g.random()
            center = np.array([a + 0.9 * g.random(), 0.2, b + 0.9 * g.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) < 0.9:
                continue
            if choose_mat < 0.8:
                albedo = g.random(3) * g.random(3)
                spheres.append(lambertian(center, 0.2, albedo))
            elif choose_mat < 0.95:
                albedo = 0.5 + 0.5 * g.random(3)
                fuzz = 5.0 * g.random()
                spheres.append(metal(center, 0.2, albedo, fuzz))
            else:
                spheres.append(dielectric(center, 0.2, 1.5))

    spheres.append(dielectric((0, 1, 0), 1.0, 1.5))
    spheres.append(lambertian((-4, 1, 0), 1.0, (0.4, 0.2, 0.1)))
    spheres.append(metal((4, 1, 0), 1.0, (0.7, 0.6, 0.5), 0.0))
    return spheres


def scene_random_spheres(seed: int = 1, dtype=torch.float32,
                         grid_half: int = 11, device="cpu") -> Scene:
    """Book-1 final scene: ground, a ``(2*grid_half)^2`` grid of random small
    spheres and 3 hero spheres (src/scenes.jl:49-84), drawn from a seeded
    numpy Generator in the reference package's order."""
    return make_scene(_random_spheres(seed, grid_half), dtype=dtype,
                      device=device)


def scene_bouncing_spheres(seed: int = 1, dtype=torch.float32,
                           grid_half: int = 11, device="cpu"
                           ) -> MovingScene:
    """Book 2's first image (*Ray Tracing: The Next Week* §2, "Motion
    Blur"): :func:`scene_random_spheres` bit for bit, each diffuse sphere of
    the random grid moving from ``center`` to ``center + (0, U[0, 0.5),
    0)`` over the shutter. The draws come from a second generator,
    ``numpy.random.default_rng(2)``, one per diffuse grid sphere in the
    grid's order, so the grid's own draws are untouched; the ground, the
    three hero spheres and the padding stay still."""
    spheres = _random_spheres(seed, grid_half)
    g = np.random.default_rng(2)
    motion = np.zeros((len(spheres), 3))
    for i, s in enumerate(spheres[1:-3], start=1):
        if s["mat"] == LAMBERTIAN:
            motion[i, 1] = 0.5 * g.random()
    scene = make_scene(spheres, dtype=dtype, device=device)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    padded = np.zeros((scene.n_spheres, 3), dtype=np_dtype)
    padded[:len(spheres)] = motion.astype(np_dtype)
    moving = MovingScene(*scene, motion=torch.as_tensor(padded).to(device))
    moving.motion.moving_spheres = int((padded != 0).any(1).sum())
    return moving


def scene_random_spheres_reference(dtype=torch.float32, device="cpu",
                                   warmup: int = 2,
                                   low52: bool = False) -> Scene:
    """The reference's own instance of ``scene_random_spheres``: its
    generator replayed bit for bit after ``reseed!`` (src/scenes.jl:49-84
    with trand = a fresh Xoroshiro128Plus(1), src/proto/proto.jl:198-199).

    Draw order per grid cell, as Julia evaluates arguments left to right:
    choose_mat, then the x and z jitter (drawn also for cells the
    0.9-exclusion around (4, 0.2, 0) skips), then 6 draws for a diffuse
    albedo (rand*rand per component, the first vector drawn whole before
    the second), or 3 + 1 for a metal's albedo in [0.5, 1] and fuzz in
    [0, 5], or none for glass; ``a`` outer, ``b`` inner over -11:10. The
    geometry is float64, as in Julia, cast once to ``dtype``.
    ``warmup``/``low52`` select the two RandomNumbers.jl details the fixture
    pins (see ``utils/xoroshiro.py``)."""
    from ..utils.xoroshiro import Xoroshiro128Plus

    rng = Xoroshiro128Plus(1, warmup=warmup, low52=low52)
    spheres = [lambertian((0, -1000, -1), 1000.0, (0.5, 0.5, 0.5))]

    for a in range(-11, 11):
        for b in range(-11, 11):
            choose_mat = rng.rand()
            cx = a + 0.9 * rng.rand()
            cz = b + 0.9 * rng.rand()
            center = np.array([cx, 0.2, cz])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) < 0.9:
                continue
            if choose_mat < 0.8:
                r1 = [rng.rand() for _ in range(3)]
                r2 = [rng.rand() for _ in range(3)]
                spheres.append(lambertian(center, 0.2,
                                          np.array(r1) * np.array(r2)))
            elif choose_mat < 0.95:
                albedo = np.array([rng.rand_between(0.5, 1.0)
                                   for _ in range(3)])
                fuzz = rng.rand_between(0.0, 5.0)
                spheres.append(metal(center, 0.2, albedo, fuzz))
            else:
                spheres.append(dielectric(center, 0.2, 1.5))

    spheres.append(dielectric((0, 1, 0), 1.0, 1.5))
    spheres.append(lambertian((-4, 1, 0), 1.0, (0.4, 0.2, 0.1)))
    spheres.append(metal((4, 1, 0), 1.0, (0.7, 0.6, 0.5), 0.0))
    return make_scene(spheres, dtype=dtype, device=device)


def save_scene(scene: Scene, path: str) -> None:
    """Write a scene's six arrays to ``.npz``, under the field names the
    JAX package's ``save_scene`` uses: a file either package writes loads
    in the other. A :class:`MovingScene` adds its ``motion``."""
    np.savez(path, **{f: getattr(scene, f).detach().cpu().numpy()
                      for f in scene._fields})


def load_scene(path: str, dtype=torch.float32, device="cpu") -> Scene:
    """Load a scene written by :func:`save_scene` (or by the JAX package's)
    onto ``device``, its floats in ``dtype`` and ``mat`` int32."""
    with np.load(path) as data:
        return scene_from_numpy({f: data[f] for f in MovingScene._fields
                                 if f in data.files},
                                device=device, dtype=dtype)


#: The static scene presets, which every route renders.
STATIC_SCENES = {
    "2_spheres": scene_2_spheres,
    "4_spheres": scene_4_spheres,
    "diel_spheres": scene_diel_spheres,
    "diel_spheres_hollow": scene_diel_spheres_hollow,
    "blue_red_spheres": scene_blue_red_spheres,
    "random_spheres": scene_random_spheres,
    "random_spheres_reference": scene_random_spheres_reference,
}

#: Every scene preset: the static ones and book 2's moving lattice, which
#: only the strided forward route renders.
ALL_SCENES = {**STATIC_SCENES, "bouncing_spheres": scene_bouncing_spheres}
