"""Published peaks of one NVIDIA H100 SXM (data sheet, at its 700 W
limit), and the least time a count of work could take at them.

The peaks and the operation counts are copied from ``chip_smoke.py``
(``PEAK_BYTES_S`` and ``PEAK_F32_OPS_S``, lines 173-174; the counts per
unit of work, lines 180-183), which took them from the kernels' code: the
Philox integer arithmetic, compares and selects are not counted, so each
bound is a lower bound.
"""

from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

#: Float operations per sphere a ray is swept against (the half-b
#: quadratic and its roots).
SWEEP_SPHERE_OPS = 20
#: Per segment that shades: sky, normal, the unit-vector draw, three
#: materials.
SHADE_OPS = 150
#: Per segment of a gradient: the bounce's adjoint, its forward recomputed.
ADJOINT_OPS = 400


def least_time(work: dict) -> dict:
    """``{"seconds", "bound_by"}``: the larger of ``work["ops"]`` float32
    operations at :data:`PEAK_F32_OPS_S` and ``work["bytes"]`` at
    :data:`PEAK_BYTES_S`, and which one it is."""
    t_ops = work["ops"] / PEAK_F32_OPS_S
    t_bytes = work["bytes"] / PEAK_BYTES_S
    return {"seconds": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
