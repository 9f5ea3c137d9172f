"""K1 — the closest-hit sphere sweep — and K3 — its occupancy-masked form —
(csrc/sweep.cu) with their plain versions.

Counterparts of ``raytracingweekend_jl_tpu/ops/pallas/intersect_kernel.py``
``_sweep_kernel`` (forward only) and ``_sweep_masked_kernel``. :func:`sweep`
and :func:`sweep_masked` launch the CUDA kernels on CUDA tensors and run
:func:`sweep_ref` and :func:`sweep_masked_ref` on CPU tensors; nothing else.
"""

from __future__ import annotations

import torch

from ...scene import Scene
from ..intersect import DEFAULT_TMIN, BIG
from . import build

#: Number of K1 launches since the last reset (incremented only where the
#: kernel is launched).
launches = 0

#: Number of K3 launches since the last reset.
masked_launches = 0


def sphere_consts(scene: Scene) -> torch.Tensor:
    """``[N, 4]`` float32 rows ``(cx, cy, cz, |c|^2 - r^2)``: the sphere
    table both sweeps read."""
    c = scene.center.to(torch.float32)
    r = scene.radius.to(torch.float32)
    ck = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - r * r
    return torch.stack([c[:, 0], c[:, 1], c[:, 2], ck], dim=1).contiguous()


def sweep_ref(rays: torch.Tensor, spheres: torch.Tensor,
              tmin: float = DEFAULT_TMIN) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: ``rays`` [6, R] planes (o.xyz, d.xyz), ``spheres``
    [N, 4] from :func:`sphere_consts`. Returns ``(t [R] f32, idx [R] i32)``.

    The TPU kernel's expanded form, one sphere at a time with a running
    ``(best_t, best_idx)`` updated only on a strict ``t < best_t``."""
    ox, oy, oz, dx, dy, dz = rays
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    best_t = torch.full_like(ox, BIG)
    best_i = torch.zeros(ox.shape, dtype=torch.int32, device=ox.device)
    for s in range(spheres.shape[0]):
        cx, cy, cz, ck = spheres[s]
        cd = cx * dx + cy * dy + cz * dz
        oc = cx * ox + cy * oy + cz * oz
        hb = od - cd
        c = oo - 2.0 * oc + ck
        disc = hb * hb - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = -hb - sq
        t = torch.where(r1 >= tmin, r1, -hb + sq)
        ok = (disc > 0) & (t >= tmin) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, torch.full_like(best_i, s), best_i)
    return best_t, best_i


def sweep_masked_ref(rays: torch.Tensor, alive: torch.Tensor,
                     spheres: torch.Tensor, tmin: float = DEFAULT_TMIN
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: :func:`sweep_ref` with dead lanes (``alive`` [R]
    int32 == 0) set to the miss values ``(BIG, 0)``."""
    t, idx = sweep_ref(rays, spheres, tmin)
    live = alive != 0
    return (torch.where(live, t, torch.full_like(t, BIG)),
            torch.where(live, idx, torch.zeros_like(idx)))


def _check_sweep_args(what, rays, spheres, alive=None):
    if not (rays.is_cuda and spheres.device == rays.device):
        raise ValueError(f"{what}: rays on {rays.device}, spheres on "
                         f"{spheres.device}; both must be on one CUDA device")
    if rays.dtype != torch.float32 or spheres.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32 only, got "
                        f"{rays.dtype} and {spheres.dtype}")
    if rays.dim() != 2 or rays.shape[0] != 6 or spheres.dim() != 2 \
            or spheres.shape[1] != 4:
        raise ValueError(f"{what}: rays must be [6, R] and spheres [N, 4], "
                         f"got {tuple(rays.shape)} and "
                         f"{tuple(spheres.shape)}")
    if not (rays.is_contiguous() and spheres.is_contiguous()):
        raise ValueError(f"{what}: rays and spheres must be contiguous")
    if alive is not None and (alive.device != rays.device
                              or alive.dtype != torch.int32
                              or tuple(alive.shape) != (rays.shape[1],)
                              or not alive.is_contiguous()):
        raise ValueError(f"{what}: alive must be a contiguous int32 [R] "
                         f"tensor on {rays.device}, got {alive.dtype} "
                         f"{tuple(alive.shape)} on {alive.device}")
    if spheres.shape[0] * 16 > 227 * 1024:
        raise ValueError(f"{what}: {spheres.shape[0]} spheres exceed the "
                         f"kernel's shared-memory table "
                         f"(max {227 * 1024 // 16})")


def sweep(rays: torch.Tensor, spheres: torch.Tensor,
          tmin: float = DEFAULT_TMIN) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: closest hit of ``rays`` [6, R] against ``spheres`` [N, 4].

    CPU tensors run :func:`sweep_ref`. CUDA tensors launch the kernel on the
    current stream; anything the kernel does not take raises."""
    global launches
    if rays.device.type == "cpu" and spheres.device.type == "cpu":
        return sweep_ref(rays, spheres, tmin)
    _check_sweep_args("sweep", rays, spheres)
    n_rays, n_sph = rays.shape[1], spheres.shape[0]
    t = torch.empty(n_rays, dtype=torch.float32, device=rays.device)
    idx = torch.empty(n_rays, dtype=torch.int32, device=rays.device)
    lib = build.load()
    with torch.cuda.device(rays.device):  # the launch uses the current device
        err = lib.rtw_sweep(rays.data_ptr(), spheres.data_ptr(), n_rays, n_sph,
                            float(tmin), t.data_ptr(), idx.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep")
    launches += 1
    return t, idx


def sweep_masked(rays: torch.Tensor, alive: torch.Tensor,
                 spheres: torch.Tensor, tmin: float = DEFAULT_TMIN
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: :func:`sweep` of the lanes whose ``alive`` [R] int32 is non-zero;
    dead lanes get ``(BIG, 0)``.

    CPU tensors run :func:`sweep_masked_ref`. CUDA tensors launch the kernel
    on the current stream; anything the kernel does not take raises."""
    global masked_launches
    if rays.device.type == "cpu" and spheres.device.type == "cpu" \
            and alive.device.type == "cpu":
        return sweep_masked_ref(rays, alive, spheres, tmin)
    _check_sweep_args("sweep_masked", rays, spheres, alive)
    n_rays, n_sph = rays.shape[1], spheres.shape[0]
    t = torch.empty(n_rays, dtype=torch.float32, device=rays.device)
    idx = torch.empty(n_rays, dtype=torch.int32, device=rays.device)
    lib = build.load()
    with torch.cuda.device(rays.device):
        err = lib.rtw_sweep_masked(
            rays.data_ptr(), alive.data_ptr(), spheres.data_ptr(), n_rays,
            n_sph, float(tmin), t.data_ptr(), idx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep_masked")
    masked_launches += 1
    return t, idx
