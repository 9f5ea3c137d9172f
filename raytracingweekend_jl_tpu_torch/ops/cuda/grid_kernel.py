"""K13 — the two-level (cluster-bounded) closest-hit sweep
(csrc/grid_sweep.cu) — and its plain version.

Counterpart of ``raytracingweekend_jl_tpu/ops/pallas/experimental/
grid_kernel.py`` (``_grid_sweep_kernel``, launched by ``grid_sweep``). The
tables come from ``ops/experimental/grid.py``: ``sph`` [G + K*P, 4] float32
rows ``(cx, cy, cz, ck)`` in slot order (the G global spheres, then each of
the K clusters' P slots, padding slots with ``ck = 1e30``), ``im`` [G + K*P]
int32 (each slot's index in the scene) and ``bnd`` [K, 4] float32 (each
cluster's bounding sphere as ``(bx, by, bz, |b|^2 - r^2)``).

The unit of culling is a warp, 32 consecutive rays: a cluster's slots are
swept for all 32 if the bound test passes for any of them, and ``skips``
[ceil(R / 32)] int32 counts the clusters each warp culled. The plain
version makes the same per-32-ray decision, so its ``skips`` are the
kernel's. The kernel takes each pair's roots only where its discriminant
is positive.

:func:`grid_sweep` launches the kernel on CUDA tensors and runs
:func:`grid_sweep_ref` on CPU tensors; nothing else.
:func:`grid_sweep_all_roots` launches the kernel before that redesign,
kept on no route as the card's bitwise reference.
"""

from __future__ import annotations

import torch

from ..intersect import BIG
from . import build

#: Number of K13 launches since the last reset (incremented only where the
#: kernel is launched).
launches = 0

#: Rays per culling decision (one warp).
WARP = 32

#: Rays (and threads) per block of K13 (``RTW_GRID_THREADS`` in
#: csrc/grid_sweep.cu).
THREADS = 128


def _closer(best_t, best_s, s, c4, rays, od, oo, tmin, run=None):
    """K1's update for one slot ``s`` (``sweep_ref``'s expressions), only
    on the rays where ``run`` is true when it is given."""
    ox, oy, oz, dx, dy, dz = rays
    cx, cy, cz, ck = c4
    cd = cx * dx + cy * dy + cz * dz
    oc = cx * ox + cy * oy + cz * oz
    hb = od - cd
    c = oo - 2.0 * oc + ck
    disc = hb * hb - c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    r1 = -hb - sq
    t = torch.where(r1 >= tmin, r1, -hb + sq)
    ok = (disc > 0) & (t >= tmin) & (t < best_t)
    if run is not None:
        ok = ok & run
    return (torch.where(ok, t, best_t),
            torch.where(ok, torch.full_like(best_s, s), best_s))


def grid_sweep_ref(rays: torch.Tensor, sph: torch.Tensor, im: torch.Tensor,
                   bnd: torch.Tensor, n_global: int, K: int, P: int,
                   tmin: float, with_reach: bool = False) -> tuple:
    """Plain PyTorch K13: ``rays`` [6, R] planes against the grid tables
    (module docstring). Returns ``(t [R] f32, idx [R] i32, skips
    [ceil(R / 32)] i32)``; ``idx`` indexes the scene (0 on a miss). With
    ``with_reach`` a fourth item, the number of (ray, cluster) pairs whose
    own bound test passes: the slot sweeps the result needs, whatever the
    warp around the ray runs."""
    ox, oy, oz, dx, dy, dz = rays
    R = ox.shape[0]
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    best_t = torch.full_like(ox, BIG)
    best_s = torch.zeros(ox.shape, dtype=torch.int32, device=ox.device)
    for s in range(n_global):
        best_t, best_s = _closer(best_t, best_s, s, sph[s], rays, od, oo,
                                 tmin)
    n_warps = -(-R // WARP)
    skips = torch.zeros(n_warps, dtype=torch.int32, device=ox.device)
    reach_pairs = 0
    for k in range(K):
        bx, by, bz, bk = bnd[k]
        cd = bx * dx + by * dy + bz * dz
        oc = bx * ox + by * oy + bz * oz
        hb = od - cd
        cq = oo - 2.0 * oc + bk
        disc = hb * hb - cq
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        reach = (disc > 0) & (-hb + sq >= tmin) & (-hb - sq < best_t)
        if with_reach:
            reach_pairs += int(reach.sum())
        padded = torch.zeros(n_warps * WARP, dtype=torch.bool,
                             device=ox.device)
        padded[:R] = reach
        warp_runs = padded.reshape(n_warps, WARP).any(1)
        skips += (~warp_runs).to(torch.int32)
        if not bool(warp_runs.any()):
            continue
        run = warp_runs.repeat_interleave(WARP)[:R]
        base = n_global + k * P
        for j in range(P):
            best_t, best_s = _closer(best_t, best_s, base + j, sph[base + j],
                                     rays, od, oo, tmin, run)
    idx = torch.where(best_t < BIG, im[best_s.long()],
                      torch.zeros_like(best_s))
    if with_reach:
        return best_t, idx, skips, reach_pairs
    return best_t, idx, skips


def _launch(name: str, rays: torch.Tensor, sph: torch.Tensor,
            im: torch.Tensor, bnd: torch.Tensor, n_global: int, K: int,
            P: int, tmin: float
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Checks the arguments and launches the library's ``name`` on the
    current stream: ``(t, idx, skips)``."""
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    R = rays.shape[1] if rays.dim() == 2 else -1
    total = n_global + K * P
    f32 = torch.float32
    for arg, x, dtype, shape in (
            ("rays", rays, f32, (6, R)), ("sph", sph, f32, (total, 4)),
            ("im", im, torch.int32, (total,)), ("bnd", bnd, f32, (K, 4))):
        build.check_arg(f"{name}: {arg}", x, dtype, shape, dev)
    if total * 20 + K * 16 > 227 * 1024:
        raise ValueError(f"{name}: {total} slots and {K} clusters exceed "
                         "the kernel's shared-memory tables")
    t = torch.empty(R, dtype=f32, device=dev)
    idx = torch.empty(R, dtype=torch.int32, device=dev)
    skips = torch.empty(-(-R // WARP), dtype=torch.int32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = getattr(lib, f"rtw_{name}")(
            rays.data_ptr(), sph.data_ptr(), im.data_ptr(), bnd.data_ptr(), R,
            n_global, K, P, float(tmin), t.data_ptr(), idx.data_ptr(),
            skips.data_ptr(), torch.cuda.current_stream().cuda_stream)
    build.check(err, name)
    return t, idx, skips


def grid_sweep(rays: torch.Tensor, sph: torch.Tensor, im: torch.Tensor,
               bnd: torch.Tensor, n_global: int, K: int, P: int,
               tmin: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K13 (arguments and results as :func:`grid_sweep_ref`).

    CPU tensors run :func:`grid_sweep_ref`. CUDA tensors launch the kernel
    on the current stream; anything it does not take raises."""
    global launches
    if rays.device.type == "cpu":
        return grid_sweep_ref(rays, sph, im, bnd, n_global, K, P, tmin)
    out = _launch("grid_sweep", rays, sph, im, bnd, n_global, K, P, tmin)
    launches += 1
    return out


def grid_sweep_all_roots(rays: torch.Tensor, sph: torch.Tensor,
                         im: torch.Tensor, bnd: torch.Tensor, n_global: int,
                         K: int, P: int, tmin: float
                         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The previous K13 (``grid_sweep_all_roots_kernel``: one block per 128
    rays staging the tables, both roots of every pair). The independent
    reference that the card checks hold K13 against bit for bit; no route
    runs it, and its launches are not counted. Arguments and results as
    :func:`grid_sweep`; CPU tensors run :func:`grid_sweep_ref`."""
    if rays.device.type == "cpu":
        return grid_sweep_ref(rays, sph, im, bnd, n_global, K, P, tmin)
    return _launch("grid_sweep_all_roots", rays, sph, im, bnd, n_global, K,
                   P, tmin)


def occupancy(n_global: int, K: int, P: int, device=None) -> dict:
    """``{"registers", "blocks_per_sm", "threads_per_block", "sm_count"}``
    of K13 on ``device`` (the current CUDA device by default), from the
    CUDA runtime, at its block size and shared memory for these tables."""
    import ctypes
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = build.load().rtw_grid_sweep_occupancy(
            n_global, K, P, *(ctypes.byref(x) for x in out))
    build.check(err, "grid_sweep occupancy")
    regs, blocks, sms = (x.value for x in out)
    return {"registers": regs, "blocks_per_sm": blocks,
            "threads_per_block": THREADS, "sm_count": sms}
