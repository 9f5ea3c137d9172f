"""The scatter directions that one step of K2, K9, K12 or K7a gives the
camera rays of a film, every sphere made one material: the check that each
shading kernel (or its plain version) returns unit directions, with no
bias in ``|d|^2 - 1``.

Every direction a kernel builds is normalised by ``rtw_inv_length``
(csrc/shade_core.cuh), a correctly rounded ``1 / sqrt``, and every plain
version by ``vecmath.inv_length``. The approximate reciprocal square root
the card offers returns directions that are short on average (``|d|^2 - 1``
about -6.5e-9), and the sweep takes a direction as unit, so it shifted
every hit the same way and darkened the persistent routes' image.

Used by ``tests/test_torch_scatter_norm.py`` on the CPU and by
``chip_smoke.py``'s ``scatter_unit`` and ``inv_length_exhaustive`` phases
on the card.
"""

from __future__ import annotations

import torch

#: The steps: ``strided`` (K2), ``pinned`` (K9), ``mega`` (K12, its own
#: sweep), ``record`` (K7a, the fixed-depth record bounce).
KINDS = ("strided", "pinned", "mega", "record")

#: The material every sphere is made, by its ``attr_mat`` code: a metal's
#: fuzz is 0.5 and a dielectric's index 1.5, and the Schlick coin is 1, so
#: a camera ray (front face, eta < 1) always refracts.
MATERIALS = {"lambertian": 0.0, "metal": 1.0, "dielectric": 2.0}

#: The uniforms' seed, and the tmin of the sweep.
SEED, TMIN = 5, 1e-4


def film_lanes(scene, cam, w: int, h: int) -> dict:
    """The lanes of a ``w x h`` film: every pixel's centred camera ray
    (``pinned_start_rays``, sample 0, a seeded lens point) in ``fs`` [12, n] (origin, direction,
    throughput 1, radiance 0), their sweep (``t``, ``idx``: K1 on the card)
    and the ``hit`` mask, the film coordinates ``u``, ``v``, the camera
    constants ``cc`` and nine seeded uniforms a lane ``u9`` (row 4, the
    Schlick coin, set to 1). ``scene`` and ``cam`` lie on one device."""
    from .. import integrator as I
    from ..intersect import BIG
    from ...render import pixel_coords
    from . import intersect_kernel as K1
    from . import shade_kernel as K2
    dev = cam.origin.device
    n = w * h
    u, v = pixel_coords(w, h, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    u4 = torch.rand((n, 4), generator=g, device=dev)
    u9 = torch.rand((9, n), generator=g, device=dev)
    u9[4] = 1.0
    org, d = I.pinned_start_rays(cam, u, v, 0, 0, float(w), float(h),
                                 init_u4=u4)
    fs = torch.zeros((12, n), dtype=torch.float32, device=dev)
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    spheres = K1.sphere_consts(scene)
    t, idx = K1.sweep(fs[0:6].contiguous(), spheres, TMIN)
    return {"fs": fs, "t": t, "idx": idx, "hit": t < BIG, "u": u, "v": v,
            "cc": K2.pack_camera_consts(cam, w, h, device=dev),
            "spheres": spheres, "u9": u9, "w": w, "h": h}


def material_table(scene, material: str) -> torch.Tensor:
    """``attr_mat(scene)`` with every sphere made ``material``
    (:data:`MATERIALS`)."""
    from ..materials import attr_mat
    amat = attr_mat(scene).clone()
    amat[:, 9] = MATERIALS[material]
    amat[:, 7] = 0.5
    amat[:, 8] = 1.5
    return amat


def scatter_lanes(kind: str, amat: torch.Tensor, lanes: dict,
                  kernels: bool) -> torch.Tensor:
    """The directions [3, n] after one step of ``kind`` (:data:`KINDS`) on
    ``lanes`` (:func:`film_lanes`) with the table ``amat``
    (:func:`material_table`), by the kernel (``kernels``; its wrapper, so
    the plain version on CPU tensors) or its plain version. On the
    ``hit`` lanes they are the material's scatter direction (the lane
    continues at depth 1); other lanes are not scatter directions."""
    from . import grad_kernel as K7
    from . import mega_kernel as K12
    from . import shade_kernel as K2
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; one of {KINDS}")
    fs = lanes["fs"].clone()
    t, idx, u9, cc = lanes["t"], lanes["idx"], lanes["u9"], lanes["cc"]
    n, dev = t.shape[0], t.device
    i32 = torch.int32
    if kind == "strided":
        w, h = lanes["w"], lanes["h"]
        lane = torch.arange(n, dtype=i32, device=dev)
        ist = torch.zeros((7, n), dtype=i32, device=dev)
        ist[3], ist[4], ist[5] = lane % w, lane // w, 1
        buf = torch.zeros((3, n), dtype=torch.float32, device=dev)
        step = K2.shade_strided_step if kernels else K2.shade_strided_fetch_ref
        step(fs, ist, buf, t, idx, amat, cc, (w, h, n % w, n // w, n), SEED,
             0, 0, 16, u9)
        return fs[3:6]
    if kind == "record":
        st = torch.zeros((K7.N_STATE, n), dtype=torch.float32, device=dev)
        st[0:12] = fs
        st[12].view(i32).fill_(1)
        rec = torch.zeros((K7.N_REC, n), dtype=torch.float32, device=dev)
        step = K7.record_shade_step if kernels else K7.record_shade_fetch_ref
        step(t, idx, amat, st, rec, SEED, 0, u9[0:5].contiguous())
        return st[3:6]
    ist = torch.zeros((3, n), dtype=i32, device=dev)
    ist[2] = 1
    if kind == "pinned":
        step = (K2.shade_and_regen_fetch if kernels
                else K2.shade_and_regen_fetch_ref)
        step(fs, ist, t, idx, amat, lanes["u"], lanes["v"], cc, SEED, 0, 0,
             16, u9)
    else:
        step = K12.mega_step if kernels else K12.mega_step_ref
        step(fs, ist, lanes["spheres"], amat, lanes["u"], lanes["v"], cc,
             SEED, 0, 0, 16, TMIN, u9)
    return fs[3:6]


def inv_length_bits(start: int, n: int, device) -> torch.Tensor:
    """``rtw_inv_length`` (csrc/inv_length.cu) of the ``n`` floats whose
    bit patterns run from ``start``, [n] float32 on ``device``. On the CPU
    its plain version, ``vecmath.inv_length``; on a CUDA device the kernel
    or a raise."""
    from ..vecmath import inv_length
    from . import build
    dev = torch.device(device)
    bits = torch.arange(start, start + n, dtype=torch.int64, device=dev)
    if dev.type == "cpu":
        return inv_length(bits.to(torch.int32).view(torch.float32))
    if dev.type != "cuda":
        raise ValueError(f"inv_length_bits: unsupported device {dev}")
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = build.load().rtw_inv_length_bits(
            start & 0xFFFFFFFF, n, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "inv_length_bits")
    return out


def unit_vectors(u9: torch.Tensor) -> torch.Tensor:
    """The unit vectors [3, n] the plain shading core draws from
    ``u9[0:4]`` (Box-Muller, then its ``inv_length`` of ``(x*x + y*y) +
    z*z``: the kernels' ``rtw_gauss3`` and ``rtw_inv_length``)."""
    from . import shade_kernel as K2
    g0, g1, g2 = K2.gauss3(u9[0], u9[1], u9[2], u9[3])
    gn = K2.inv_length(g0 * g0 + g1 * g1 + g2 * g2)
    return torch.stack([g0 * gn, g1 * gn, g2 * gn])


def wavefront_scatter(amat: torch.Tensor, lanes: dict) -> torch.Tensor:
    """The directions [3, n] the wavefront ``trace`` scatters the same hits
    into (``materials.scatter``) with the same unit vectors and coins: its
    refracted direction is the same near-unit vector, normalised the same
    way, so it carries the same float32 rounding of ``|d|^2`` near 1."""
    from ..materials import scatter
    fs, hit = lanes["fs"], lanes["hit"]
    rows = amat[lanes["idx"].long()]
    attrs = (rows[:, 0:3], rows[:, 3], rows[:, 4:7], rows[:, 7], rows[:, 8],
             rows[:, 9])
    t = torch.where(hit, lanes["t"], torch.ones_like(lanes["t"]))
    out = scatter(fs[0:3].T, fs[3:6].T, t, attrs,
                  unit_vectors(lanes["u9"]).T, lanes["u9"][4])
    return out.direction.T


def unit_length_error(d: torch.Tensor) -> dict:
    """Mean of ``|d|^2 - 1`` over the directions ``d`` [3, n] (float32
    components, squared and summed in float64) that were normalised, its
    standard error, the largest ``| |d|^2 - 1 |`` and the counts. A lane
    more than 1e-5 off unit length was not normalised (a degenerate
    Lambertian scatter takes the surface normal as it is) and is counted
    apart: one such lane among a million moves the mean by ~1e-9."""
    e = (d.double() ** 2).sum(0) - 1.0
    keep = e.abs() <= 1e-5
    k = e[keep]
    return {"mean": k.mean().item(),
            "standard_error": (k.std() / k.numel() ** 0.5).item(),
            "max_abs": k.abs().max().item(), "lanes": k.numel(),
            "not_normalised": int((~keep).sum())}
