"""A forward render's work: every path sweeps every sphere once a segment
and shades once a segment; each call writes its radiance sum once.

Segments per path are the configuration's, measured with the plain
reference (its ``segments_per_path``)."""

from __future__ import annotations

from ..harness.peaks import SHADE_OPS, SWEEP_SPHERE_OPS


def work(loop, paths: int) -> dict:
    """``{"ops", "bytes"}`` of ``paths`` paths of ``loop``'s cell."""
    segments = paths * loop.segments_per_path
    return {"ops": segments * (loop.n_spheres * SWEEP_SPHERE_OPS + SHADE_OPS),
            "bytes": paths / loop.spp * 3 * 4}
