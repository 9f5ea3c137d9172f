"""Book 2's first image (*Ray Tracing: The Next Week* §2, "Motion Blur"):
book 1's final scene (:mod:`.random_spheres`), each diffuse sphere of the
random grid moving from ``center`` to ``center + (0, U[0, 0.5), 0)`` over
the shutter [0, 1). The motions are drawn from a second seeded numpy
Generator, ``default_rng(2)``, one per diffuse grid sphere in the grid's
order, so the grid is ``random_spheres``' sphere for sphere; the ground and
the three hero spheres stay still."""

from __future__ import annotations

import numpy as np

from ..scene import LAMBERTIAN
from . import random_spheres


def build(seed: int = 1, grid_half: int = 11,
          motion_seed: int = 2) -> list[dict]:
    spheres = random_spheres.build(seed, grid_half)
    g = np.random.default_rng(motion_seed)
    for s in spheres[1:-3]:
        if s["mat"] == LAMBERTIAN:
            s["motion"] = (0.0, 0.5 * g.random(), 0.0)
    return spheres
