"""A gradient step's work: the forward's sweep and shade a segment, and the
segment's adjoint; each step reads its target image once.

Segments per path are the configuration's, measured with the plain
reference (its ``segments_per_path``)."""

from __future__ import annotations

from ..harness.peaks import ADJOINT_OPS, SHADE_OPS, SWEEP_SPHERE_OPS


def work(loop, paths: int) -> dict:
    """``{"ops", "bytes"}`` of ``paths`` paths of ``loop``'s cell."""
    segments = paths * loop.segments_per_path
    return {"ops": segments * (loop.n_spheres * SWEEP_SPHERE_OPS + SHADE_OPS
                               + ADJOINT_OPS),
            "bytes": paths / loop.spp * 3 * 4}
