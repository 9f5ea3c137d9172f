"""The two-level (cluster-bounded) sphere sweep — the counterpart of
``raytracingweekend_jl_tpu/ops/pallas/experimental/grid_kernel.py``.

The book scene lays its small spheres on a lattice (src/scenes.jl:56), so
:func:`build_grid` clusters them by (x, z) into a ``grid x grid`` lattice
of cells padded to a common capacity P, each with a bounding sphere, and
keeps the big and degenerate spheres in a global list that is always
swept. The sweep (K13, ``cuda/grid_kernel.py``) skips a cluster for a warp
of 32 rays when no ray of the warp can reach its bound; the bound contains
its members, so the winners are the flat sweep's (K1's). The JAX package
drives it only from ``scripts/spatial_probe.py``; the port's measurement is
``chip_smoke.py``'s ``grid_sweep`` phase. Forward only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...scene import Scene
from ..cuda import grid_kernel
from ..integrator import resolve_impl
from ..intersect import BIG, DEFAULT_TMIN, HitResult

#: Padding-slot ck: disc = hb^2 - (oo - 2 oc + ck) < 0 for any plausible
#: ray (float32-safe: far below overflow, far above scene scale).
_DUMMY_CK = np.float32(1e30)


def build_grid(scene: Scene, grid: int = 6, pad_mult: int = 4) -> dict:
    """Cluster a (trimmed) scene's small spheres into a ``grid x grid``
    (x, z) lattice of cluster lists of one capacity, with bounding spheres.

    Returns the JAX package's dict of numpy arrays: the permuted sphere
    table (``cx cy cz ck``) laid out [global..., cluster 0's slots, cluster
    1's slots, ...], the original index map ``im``, the cluster bounds
    (``bx by bz bk``) and the layout (``n_global``, ``K``, ``P``). ``ck``
    and ``bk`` are computed in float64 and stored in float32."""
    c = scene.center.detach().cpu().numpy().astype(np.float64)
    r = scene.radius.detach().cpu().numpy().astype(np.float64)
    n = c.shape[0]
    # Global: big (|r| >= 1, the ground among them), degenerate or far.
    is_global = (np.abs(r) >= 1.0) | (r == 0.0) | (np.abs(c).max(1) > 100.0)
    gi = np.where(is_global)[0]
    si = np.where(~is_global)[0]

    # Uniform (x, z) bins over the small spheres' bounding box.
    if len(si):
        lo = c[si][:, [0, 2]].min(0) - 1e-6
        hi = c[si][:, [0, 2]].max(0) + 1e-6
        span = np.maximum(hi - lo, 1e-9)
        cell = np.minimum(((c[si][:, [0, 2]] - lo) / span * grid).astype(int),
                          grid - 1)
        cid = cell[:, 0] * grid + cell[:, 1]
    else:
        cid = np.zeros((0,), int)
    K = grid * grid
    members = [si[cid == k] for k in range(K)]
    P = max(max(len(m) for m in members), 1)
    P = -(-P // pad_mult) * pad_mult

    n_global = len(gi)
    total = n_global + K * P
    cx = np.zeros(total, np.float32)
    cy = np.zeros(total, np.float32)
    cz = np.zeros(total, np.float32)
    ck = np.full(total, _DUMMY_CK, np.float32)
    im = np.zeros(total, np.int32)
    ck_all = (c * c).sum(1) - r * r
    cx[:n_global], cy[:n_global], cz[:n_global] = c[gi].T
    ck[:n_global] = ck_all[gi]
    im[:n_global] = gi
    bx = np.zeros(K, np.float32)
    by = np.zeros(K, np.float32)
    bz = np.zeros(K, np.float32)
    bk = np.zeros(K, np.float32)
    for k, m in enumerate(members):
        base = n_global + k * P
        sl = slice(base, base + len(m))
        cx[sl], cy[sl], cz[sl] = c[m].T
        ck[sl] = ck_all[m]
        im[sl] = m
        if len(m):
            ctr = c[m].mean(0)
            rad = np.max(np.linalg.norm(c[m] - ctr, axis=1) + np.abs(r[m]))
        else:
            ctr, rad = np.zeros(3), 0.0
        bx[k], by[k], bz[k] = ctr
        bk[k] = (ctr * ctr).sum() - rad * rad
    assert n_global + sum(len(m) for m in members) == n
    return dict(cx=cx, cy=cy, cz=cz, ck=ck, im=im, bx=bx, by=by, bz=bz,
                bk=bk, n_global=n_global, K=K, P=P)


class GridTables(NamedTuple):
    """:func:`build_grid`'s arrays as K13 reads them, on one device."""

    sph: torch.Tensor  # [G + K*P, 4] f32 (cx, cy, cz, ck)
    im: torch.Tensor   # [G + K*P] i32
    bnd: torch.Tensor  # [K, 4] f32 (bx, by, bz, bk)
    n_global: int
    K: int
    P: int


def grid_tables(g: dict, device="cpu") -> GridTables:
    """The tables of :func:`build_grid`'s ``g`` as tensors on ``device``."""
    st = lambda *ks: torch.from_numpy(np.stack([g[k] for k in ks], 1)).to(
        device=device, dtype=torch.float32).contiguous()
    return GridTables(st("cx", "cy", "cz", "ck"),
                      torch.from_numpy(g["im"]).to(device=device,
                                                   dtype=torch.int32),
                      st("bx", "by", "bz", "bk"), int(g["n_global"]),
                      int(g["K"]), int(g["P"]))


def grid_sweep(rays: torch.Tensor, tables: GridTables,
               tmin: float = DEFAULT_TMIN, impl: str | None = None
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closest hits of ``rays`` [6, R] float32 planes (o.xyz, d.xyz) through
    the two-level sweep: ``(t [R], idx [R] int32 into the scene, skips
    [ceil(R / 32)] int32)``, the clusters each warp of 32 consecutive rays
    culled. ``impl``: ``"kernels"`` (K13, the default on CUDA) or
    ``"plain"`` (its plain version, the default on the CPU)."""
    impl = resolve_impl(impl, rays.device)
    run = (grid_kernel.grid_sweep if impl == "kernels"
           else grid_kernel.grid_sweep_ref)
    return run(rays, tables.sph, tables.im, tables.bnd, tables.n_global,
               tables.K, tables.P, tmin)


def intersect_spheres_grid(origin: torch.Tensor, direction: torch.Tensor,
                           scene: Scene, g: dict | None = None,
                           tmin: float = DEFAULT_TMIN,
                           impl: str | None = None
                           ) -> tuple[HitResult, torch.Tensor]:
    """``(HitResult, skips)`` of rays ``origin``/``direction`` [R, 3] against
    ``scene`` through :func:`grid_sweep` (reference:
    ``intersect_spheres_grid``, forward only), on the rays' device.
    ``g`` is :func:`build_grid` of the scene (built when not given)."""
    if g is None:
        g = build_grid(scene)
    rays = torch.cat([origin.T, direction.T]).to(torch.float32).contiguous()
    t, idx, skips = grid_sweep(rays, grid_tables(g, origin.device), tmin,
                               impl)
    return HitResult(t=t, index=idx, hit=t < BIG), skips
