"""K8 — the whole small-image render in one launch (csrc/inline.cu) — and
its plain version.

Counterpart of ``raytracingweekend_jl_tpu/ops/pallas/inline_kernel.py``
(``_inline_kernel`` with its sweep ``_sweep_select``, launched by
``trace_inline``). Every (pixel, sample) path gets a lane and the bounce loop
runs inside the kernel: each bounce sweeps the sphere table with a running
select of the winner's attributes, then shades with the shared core
(:func:`shade_kernel.shade_core`, csrc/shade_core.cuh) and advances a hit.

Draws: 5 uniforms per lane and bounce, Philox4x32-10 keyed by ``(seed,
bounce)`` with the lane as the counter (:func:`rng.philox_uniforms`), or
injected as ``rng_u5`` [max_depth, 5, R].

:func:`trace_inline` launches the CUDA kernel on CUDA tensors and runs
:func:`trace_inline_ref` on CPU tensors; nothing else.
"""

from __future__ import annotations

import torch

from ... import rng
from ...scene import Scene
from ..intersect import BIG, DEFAULT_TMIN
from . import build
from .intersect_kernel import sphere_consts
from .shade_kernel import shade_core

#: Number of K8 launches since the last reset (incremented only where the
#: kernel is launched).
launches = 0


def sphere_planes(scene: Scene) -> torch.Tensor:
    """``[11, N]`` float32 planes the kernel stages in shared memory: cx,
    cy, cz, ck (as :func:`sphere_consts`, so the sweep gets K1's bits),
    radius, albedo rgb, fuzz, ir, mat."""
    f32 = torch.float32
    return torch.cat([sphere_consts(scene).T,
                      scene.radius[None].to(f32), scene.albedo.T.to(f32),
                      scene.fuzz[None].to(f32), scene.ir[None].to(f32),
                      scene.mat[None].to(f32)]).contiguous()


def _uniforms(rng_u5, seed: int, b: int, R: int, device) -> torch.Tensor:
    if rng_u5 is not None:
        return rng_u5[b]
    return rng.philox_uniforms(seed, b, R, 5, device=device)


def trace_inline_ref(scene: Scene, origin: torch.Tensor,
                     direction: torch.Tensor, seed: int,
                     max_depth: int = 16, tmin: float = DEFAULT_TMIN,
                     rng_u5: torch.Tensor | None = None,
                     stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch K8: radiance ``[R, 3]`` of rays ``origin``/``direction``
    [R, 3] over ``max_depth`` bounces.

    Each bounce is ``_sweep_select`` written out: one sphere at a time, a
    running ``(t, 10 attributes)`` select updated on a strict ``t < best``,
    in K1's expanded form; then the shade core, and a hit advances. A miss
    banks the sky and ends the lane's path; a path alive after the last
    bounce reads black. ``stats`` (a dict) collects the live lanes of each
    bounce (``"live"``)."""
    planes = sphere_planes(scene)
    f32 = torch.float32
    ox, oy, oz = origin.to(f32).T
    dx, dy, dz = direction.to(f32).T
    R = ox.shape[0]
    one = torch.ones_like(ox)
    tx, ty, tz = one, one, one
    zero = torch.zeros_like(ox)
    rx, ry, rz = zero, zero, zero
    alive = torch.ones(R, dtype=torch.bool, device=ox.device)
    w = torch.where
    for b in range(max_depth):
        if stats is not None:
            stats.setdefault("live", []).append(int(alive.sum()))
        od = ox * dx + oy * dy + oz * dz
        oo = ox * ox + oy * oy + oz * oz
        bt = torch.full_like(ox, BIG)
        sel = [zero] * 10
        for s in range(planes.shape[1]):
            cx, cy, cz, ck = planes[0:4, s]
            cd = cx * dx + cy * dy + cz * dz
            oc = cx * ox + cy * oy + cz * oz
            hb = od - cd
            c = oo - 2.0 * oc + ck
            disc = hb * hb - c
            sq = torch.sqrt(torch.clamp(disc, min=0.0))
            r1 = -hb - sq
            t = w(r1 >= tmin, r1, -hb + sq)
            ok = (disc > 0) & (t >= tmin) & (t < bt)
            bt = w(ok, t, bt)
            vals = (cx, cy, cz) + tuple(planes[4:11, s])
            sel = [w(ok, v, a) for v, a in zip(vals, sel)]
        attrs = torch.stack(sel)
        u5 = _uniforms(rng_u5, seed, b, R, ox.device)
        rx, ry, rz, hitm, _, px, py, pz, ndx, ndy, ndz = shade_core(
            u5, bt, attrs, ox, oy, oz, dx, dy, dz, tx, ty, tz, alive, rx, ry,
            rz)
        ox, oy, oz = w(hitm, px, ox), w(hitm, py, oy), w(hitm, pz, oz)
        dx, dy, dz = w(hitm, ndx, dx), w(hitm, ndy, dy), w(hitm, ndz, dz)
        tx = w(hitm, tx * attrs[4], tx)
        ty = w(hitm, ty * attrs[5], ty)
        tz = w(hitm, tz * attrs[6], tz)
        alive = hitm
    return torch.stack([rx, ry, rz], dim=1)


def trace_inline(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
                 seed: int, max_depth: int = 16, tmin: float = DEFAULT_TMIN,
                 rng_u5: torch.Tensor | None = None) -> torch.Tensor:
    """K8: radiance ``[R, 3]`` of the rays in one launch (arguments as
    :func:`trace_inline_ref`). CPU tensors run the plain version; CUDA
    tensors launch the kernel on the current stream, and anything it does
    not take raises."""
    global launches
    if origin.device.type == "cpu":
        return trace_inline_ref(scene, origin, direction, seed, max_depth,
                                tmin, rng_u5)
    dev = origin.device
    if dev.type != "cuda":
        raise ValueError(f"trace_inline: unsupported device {dev}")
    f32 = torch.float32
    R = origin.shape[0]
    if origin.dtype != f32 or direction.dtype != f32 \
            or tuple(direction.shape) != (R, 3) or origin.shape[1:] != (3,):
        raise TypeError("trace_inline: origin and direction must be float32 "
                        f"[R, 3], got {origin.dtype} {tuple(origin.shape)} "
                        f"and {direction.dtype} {tuple(direction.shape)}")
    if scene.device != dev or direction.device != dev:
        raise ValueError(f"trace_inline: scene on {scene.device}, rays on "
                         f"{dev} and {direction.device}")
    planes = sphere_planes(scene)
    n_sph = planes.shape[1]
    if planes.numel() * 4 > 227 * 1024:
        raise ValueError(f"trace_inline: {n_sph} spheres exceed the kernel's "
                         f"shared-memory table (max {227 * 1024 // 44})")
    if rng_u5 is not None:
        build.check_arg("trace_inline: rng_u5", rng_u5, f32,
                        (max_depth, 5, R), dev)
    rays = torch.cat([origin.T, direction.T]).contiguous()
    rad = torch.empty((3, R), dtype=f32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_inline(
            rays.data_ptr(), planes.data_ptr(), rad.data_ptr(),
            None if rng_u5 is None else rng_u5.data_ptr(), R, n_sph,
            int(max_depth), float(tmin), seed & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "trace_inline")
    launches += 1
    return rad.T
