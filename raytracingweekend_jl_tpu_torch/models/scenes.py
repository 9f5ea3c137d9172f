"""Scene library — the reference scenes as SoA builders (src/scenes.jl:1-84).

Each builder is the counterpart of the one in
``raytracingweekend_jl_tpu.models.scenes``: the same constants and the same
seeded numpy draws, so the arrays are equal bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..scene import Scene, make_scene, lambertian, metal, dielectric


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


def scene_random_spheres(seed: int = 1, dtype=torch.float32,
                         grid_half: int = 11, device="cpu") -> Scene:
    """Book-1 final scene: ground, a ``(2*grid_half)^2`` grid of random small
    spheres and 3 hero spheres (src/scenes.jl:49-84), drawn from a seeded
    numpy Generator in the reference package's order."""
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
    return make_scene(spheres, dtype=dtype, device=device)


ALL_SCENES = {
    "2_spheres": scene_2_spheres,
    "4_spheres": scene_4_spheres,
    "diel_spheres": scene_diel_spheres,
    "diel_spheres_hollow": scene_diel_spheres_hollow,
    "blue_red_spheres": scene_blue_red_spheres,
    "random_spheres": scene_random_spheres,
}
