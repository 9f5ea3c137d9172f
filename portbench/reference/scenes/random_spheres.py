"""Book-1 final scene (src/scenes.jl:49-84): ground, a grid of random small
spheres and three hero spheres, drawn from a seeded numpy Generator in the
order the JAX package and the port draw them (486 spheres at seed 1)."""

from __future__ import annotations

import numpy as np

from ..scene import dielectric, lambertian, metal


def build(seed: int = 1, grid_half: int = 11) -> list[dict]:
    g = np.random.default_rng(seed)
    spheres = [lambertian((0.0, -1000.0, -1.0), 1000.0, (0.5, 0.5, 0.5))]
    for a in range(-grid_half, grid_half):
        for b in range(-grid_half, grid_half):
            choose_mat = g.random()
            center = np.array([a + 0.9 * g.random(), 0.2, b + 0.9 * g.random()])
            if np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) < 0.9:
                continue
            if choose_mat < 0.8:
                spheres.append(lambertian(center, 0.2, g.random(3) * g.random(3)))
            elif choose_mat < 0.95:
                albedo = 0.5 + 0.5 * g.random(3)
                spheres.append(metal(center, 0.2, albedo, 5.0 * g.random()))
            else:
                spheres.append(dielectric(center, 0.2, 1.5))
    spheres.append(dielectric((0.0, 1.0, 0.0), 1.0, 1.5))
    spheres.append(lambertian((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1)))
    spheres.append(metal((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), 0.0))
    return spheres
