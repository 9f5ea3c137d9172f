"""A block of lanes that each start a sample in one step of K2, K9 or K12,
beside the camera rays the host builds for the same pixels, samples and
uniforms: the check that the camera ray a kernel (or its plain version)
rebuilds inside a step is ``camera.make_rays``' bit for bit.

Used by ``tests/test_torch_regen_ray.py`` on the CPU and by
``chip_smoke.py``'s ``regen_ray`` phase on the card.
"""

from __future__ import annotations

import torch

#: The ways a lane starts a sample: ``strided_same`` (K2, the same pixel's
#: next sample, every pixel a lane), ``strided_switch`` (K2 at k = 2, the
#: lanes of strip 0 move to their strip-1 pixel), ``pinned`` (K9), ``mega``
#: (K12).
KINDS = ("strided_same", "strided_switch", "pinned", "mega")


def regen_lanes(kind: str, scene, cam, sample: int, kernels: bool, w: int,
                h: int) -> tuple:
    """``(regenerated [6, n], host-built [6, n])``: origins and directions of
    the ``n`` lanes of a ``w x h`` film that each start ``sample`` of a
    pixel in one step of ``kind`` (:data:`KINDS`), by the kernel
    (``kernels``) or its plain version, beside the rays
    ``init_strided_state`` / ``pinned_start_rays`` build through
    ``camera.make_rays`` for those pixels, samples and uniforms. Every ray
    misses (origins far above the scene, looking up); ``scene`` and ``cam``
    lie on the device the step runs on. The film's edges and, for
    ``strided_switch``, the last pixel of strip 0 are among the lanes."""
    from .. import integrator as I
    from ..intersect import BIG
    from ..materials import attr_mat
    from ...render import pixel_coords
    from . import intersect_kernel as K1
    from . import mega_kernel as K12
    from . import shade_kernel as K2
    dev = cam.origin.device
    f32, i32 = torch.float32, torch.int32
    n_pix = w * h
    n = n_pix // 2 if kind == "strided_switch" else n_pix
    g = torch.Generator(device=dev).manual_seed(sample + 11)
    u9 = torch.rand((9, n), generator=g, device=dev)
    u4 = u9[5:9].T.contiguous()
    cc = K2.pack_camera_consts(cam, w, h, device=dev)
    amat = attr_mat(scene)
    t = torch.full((n,), BIG, dtype=f32, device=dev)
    idx = torch.zeros((n,), dtype=i32, device=dev)
    fs = torch.zeros((12, n), dtype=f32, device=dev)
    fs[1], fs[4] = 1.0e4, 1.0  # far above the scene, looking up: a miss
    lane = torch.arange(n, dtype=i32, device=dev)
    if kind in ("strided_same", "strided_switch"):
        switch = kind == "strided_switch"
        ist = torch.zeros((7, n), dtype=i32, device=dev)
        ist[1] = sample if switch else sample - 1  # this sample is the last
        ist[3], ist[4], ist[5] = lane % w, lane // w, 1
        ist[6] = sample
        buf = torch.zeros((6 if switch else 3, n), dtype=f32, device=dev)
        step = K2.shade_strided_step if kernels else K2.shade_strided_fetch_ref
        step(fs, ist, buf, t, idx, amat, cc, (w, h, n % w, n // w, n_pix), 3,
             1, sample if switch else 0, 16, u9)
        host = I.init_strided_state(cam, n, w, h, 0, 1, sample, 16, 1,
                                    pixel_start=n if switch else 0,
                                    init_u4=u4, device=dev).fstate
        return fs[0:6], host[0:6]
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    u, v = pixel_coords(w, h, device=dev)
    ist = torch.zeros((3, n), dtype=i32, device=dev)
    ist[1], ist[2] = sample - 1, 1
    if kind == "pinned":
        step = (K2.shade_and_regen_fetch if kernels
                else K2.shade_and_regen_fetch_ref)
        step(fs, ist, t, idx, amat, u, v, cc, 3, 1, sample, 16, u9)
    else:
        step = K12.mega_step if kernels else K12.mega_step_ref
        step(fs, ist, K1.sphere_consts(scene), amat, u, v, cc, 3, 1, sample,
             16, 1e-4, u9)
    org, d = I.pinned_start_rays(cam, u, v, 0, sample, float(w), float(h),
                                 init_u4=u4)
    return fs[0:6], torch.cat([org.T, d.T])
