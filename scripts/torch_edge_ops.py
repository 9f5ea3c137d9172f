"""Counts the PyTorch operators one edge trace dispatches, on the CPU: the
host-side work behind the edge path's step time on the card, where every
operator is at least one launch.

One ``trace_edge`` of the inverse demo's scene (``scene_4_spheres``,
``t_default_cam``) at 20x11 rays, sigma at 3 pixel footprints, two edge
bounces, depth 16: the operators of the forward and of the backward of
the radiance's sum (which recomputes each checkpointed bounce), and of
those the ones inside the ordered contraction ``dattr_contract``. The
sphere sweep runs its plain loop here (one launch of K1 on the card), so
its operators are left out of the counts. The counts do not depend on the
number of rays. ``--per-field`` sums the contraction's fields one at a
time (``CONTRACT_BLOCK`` at 1, the schedule before the fields were
blocked). Prints one JSON object.

    python3 scripts/torch_edge_ops.py [--per-field]
"""

from __future__ import annotations

import collections
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402
from torch.utils._python_dispatch import (  # noqa: E402
    TorchDispatchMode, _disable_current_modes)

import raytracingweekend_jl_tpu_torch as pt  # noqa: E402
from raytracingweekend_jl_tpu_torch import rng  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops import edge as E  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops import materials as M  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import (  # noqa: E402
    grad_kernel as GK, intersect_kernel as K1)


class Count(TorchDispatchMode):
    """Counts every operator dispatched inside the block."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def main() -> int:
    sweep_ref, contract = K1.sweep_ref, GK.dattr_contract
    inner = collections.Counter()

    def one_launch(*a, **k):  # the plain sweep loop stands for one K1
        with _disable_current_modes():
            return sweep_ref(*a, **k)

    def counted_contract(*a, **k):
        with Count() as c:
            out = contract(*a, **k)
        inner["ops"] += sum(c.n.values())
        inner["calls"] += 1
        return out

    if "--per-field" in sys.argv[1:]:
        GK.CONTRACT_BLOCK = 1
    K1.sweep_ref = one_launch
    M.dattr_contract = K1.dattr_contract = counted_contract
    try:
        scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
        u, v = pt.pixel_coords(20, 11)
        o, d = pt.get_rays(cam, u, v,
                           generator=rng.generator(0, rng.LENS, 0))
        c = scene.center.clone().requires_grad_(True)
        with Count() as fwd:
            out = E.trace_edge(scene._replace(center=c), o, d, 5,
                               sigma_px=3.0,
                               pix_angle=E.pixel_angle(cam, 11.0),
                               edge_bounces=2, impl="plain")
        with Count() as bwd:
            out.sum().backward()
    finally:
        K1.sweep_ref, M.dattr_contract = sweep_ref, contract
        K1.dattr_contract = contract
    print(json.dumps({
        "contract_block": GK.CONTRACT_BLOCK,
        "forward_ops": sum(fwd.n.values()),
        "backward_ops": sum(bwd.n.values()),
        "contraction_ops": inner["ops"], "contraction_calls": inner["calls"],
        "forward_top": fwd.n.most_common(6),
        "backward_top": bwd.n.most_common(6)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
