"""A moving scene's forward render: every path sweeps every sphere once a
segment and shades once a segment at the winner's moved centre; each call
writes its radiance sum once.

A moving pair is counted at the least work it needs, not at K1m's own
expressions: the centre at the ray's time, ``c0 + time * m`` (3 multiplies,
3 adds), then the static pair's 20 operations on ``o - c`` (the half-b
quadratic and its roots), 26 in all. K1m (``rtw_sweep_pair_motion``,
csrc/sweep_core.cuh) spends 6 more, forming ``|c|^2 - r^2`` for K1's
expanded form; those are not counted. The shade moves the winner's centre
the same way (6). Segments per path are the configuration's, measured with
the plain reference of moving scenes (its ``segments_per_path``)."""

from __future__ import annotations

from ..harness.peaks import SHADE_OPS, SWEEP_SPHERE_OPS

#: Float operations per sphere a ray is swept against at its time: the
#: centre at the time (6), then a static pair's.
MOTION_PAIR_OPS = SWEEP_SPHERE_OPS + 6
#: Per segment that shades: K2's, and the winner's centre at the time.
MOTION_SHADE_OPS = SHADE_OPS + 6
#: Bytes a segment's sweep moves at least: the ray's 6 planes and its time
#: read, ``t`` and ``idx`` written.
SWEEP_SEGMENT_BYTES = 7 * 4 + 2 * 4


def work(loop, paths: int) -> dict:
    """``{"ops", "bytes"}`` of ``paths`` paths of ``loop``'s cell."""
    segments = paths * loop.segments_per_path
    return {"ops": segments * (loop.n_spheres * MOTION_PAIR_OPS
                               + MOTION_SHADE_OPS),
            "bytes": paths / loop.spp * 3 * 4}


def sweep_work(loop, paths: int) -> dict:
    """``{"ops", "bytes"}`` of the moving sweep (K1m) alone over ``paths``
    paths: its pairs, and each segment's ray and hit."""
    segments = paths * loop.segments_per_path
    return {"ops": segments * loop.n_spheres * MOTION_PAIR_OPS,
            "bytes": segments * SWEEP_SEGMENT_BYTES}
