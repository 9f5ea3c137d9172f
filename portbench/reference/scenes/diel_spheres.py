"""The dielectric scene (src/scenes.jl:25-39): a diffuse sphere on a
diffuse ground, a glass sphere on the left, a polished metal sphere on the
right."""

from __future__ import annotations

from ..scene import dielectric, lambertian, metal


def build(left_radius: float = 0.5) -> list[dict]:
    return [lambertian((0.0, 0.0, -1.0), 0.5, (0.1, 0.2, 0.5)),
            lambertian((0.0, -100.5, -1.0), 100.0, (0.8, 0.8, 0.0)),
            dielectric((-1.0, 0.0, -1.0), left_radius, 1.5),
            metal((1.0, 0.0, -1.0), 0.5, (0.8, 0.6, 0.2), 0.0)]
