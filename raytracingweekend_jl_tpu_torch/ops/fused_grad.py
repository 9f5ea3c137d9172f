"""The fixed-depth record/replay gradient trace — the counterpart of the
driver half of ``raytracingweekend_jl_tpu/ops/pallas/grad_kernel.py``
(``trace_recorded_fused`` with its custom VJP), the small-image gradient
path.

Every ray owns a lane for all ``max_depth`` bounces. The forward runs one
record bounce per step:

1. the occupancy-masked sweep (K3, ``cuda/intersect_kernel.sweep_masked``);
2. the record step (K7a, ``cuda/grad_kernel.record_shade_step``), which
   reads each sweep winner's attribute row, shades and advances the lanes
   and writes the bounce's record slot.

The backward walks the slots newest first: one launch of the fused replay
(K7c, ``replay_bwd_fused``), or one launch of the per-bounce replay (K7b,
``replay_bwd_step``) per slot with ``replay_fused=False``. The per-lane
attribute cotangent rows of all slots are then summed onto the spheres by
one deterministic ``dattr_contract``.

``impl`` picks the kernels (``"kernels"``, the default on CUDA) or their
plain PyTorch versions (``"plain"``, the default on the CPU, and selectable
on a card for comparison).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..scene import Scene
from .integrator import resolve_impl
from .intersect import DEFAULT_TMIN
from .materials import attr_mat
from .cuda import grad_kernel as GK, intersect_kernel


class _Config(NamedTuple):
    max_depth: int
    tmin: float
    seed: int
    replay_fused: bool
    impl: str
    u5_fn: Callable | None


def start_state(origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """The state [13, R] before the first bounce: the rays, throughput 1,
    radiance 0, every lane alive (layout in ``cuda/grad_kernel.py``)."""
    R = origin.shape[0]
    st = torch.zeros((GK.N_STATE, R), dtype=torch.float32,
                     device=origin.device)
    st[0:3] = origin.T
    st[3:6] = direction.T
    st[6:9] = 1.0
    st[12].view(torch.int32).fill_(1)
    return st


def _record_forward(scene: Scene, origin, direction, cfg: _Config):
    """The record bounces. Returns ``(radiance [R, 3], rec [depth, 21, R],
    rec_idx [depth, R])``."""
    R = origin.shape[0]
    dev = origin.device
    st = start_state(origin, direction)
    spheres, amat = intersect_kernel.sphere_consts(scene), attr_mat(scene)
    if cfg.impl == "kernels":
        sweep, step = intersect_kernel.sweep_masked, GK.record_shade_step
    else:
        sweep, step = intersect_kernel.sweep_masked_ref, GK.record_shade_fetch_ref
    rec = torch.empty((cfg.max_depth, GK.N_REC, R), dtype=torch.float32,
                      device=dev)
    rec_idx = torch.empty((cfg.max_depth, R), dtype=torch.int32, device=dev)
    for b in range(cfg.max_depth):
        t, idx = sweep(st[0:6], st[12].view(torch.int32), spheres, cfg.tmin)
        rec_idx[b] = idx
        u5 = None if cfg.u5_fn is None else cfg.u5_fn(b, R).to(dev)
        step(t, idx, amat, st, rec[b], cfg.seed, b, u5)
    return st[9:12].T.contiguous(), rec, rec_idx


def _replay_backward(rec, rec_idx, g_rad, n: int, cfg: _Config):
    """The backward of the record: ``(g_attr [N, 9], g_org [R, 3], g_dir
    [R, 3])``."""
    K, R = rec.shape[0], rec.shape[2]
    dev = rec.device
    g3 = g_rad.T.contiguous()
    cot = torch.zeros((9, R), dtype=torch.float32, device=dev)
    u5_all = None
    if cfg.u5_fn is not None:
        u5_all = torch.stack([cfg.u5_fn(b, R) for b in range(K)]).to(dev)
    kern = cfg.impl == "kernels"
    if cfg.replay_fused:
        fused = GK.replay_bwd_fused if kern else GK.replay_bwd_fused_ref
        dattr = fused(rec, g3, cot, cfg.seed, u5_all)
    else:
        step = GK.replay_bwd_step if kern else GK.replay_bwd_step_ref
        dattr = torch.empty((K, 9, R), dtype=torch.float32, device=dev)
        for b in reversed(range(K)):
            step(rec[b], g3, cot, cfg.seed, b,
                 None if u5_all is None else u5_all[b], out=dattr[b])
    g_attr = GK.dattr_contract(dattr, rec_idx, n)
    return g_attr, cot[0:3].T, cot[3:6].T


class _FusedTrace(torch.autograd.Function):
    """Forward: the record bounces. Backward: the replay. The record lives
    on ``ctx`` between the two and is released by the backward."""

    @staticmethod
    def forward(ctx, center, radius, albedo, fuzz, ir, origin, direction,
                mat, cfg):
        scene = Scene(center, radius, albedo, fuzz, ir, mat)
        radiance, rec, rec_idx = _record_forward(scene, origin, direction,
                                                 cfg)
        ctx.res = (rec, rec_idx)
        ctx.n = scene.n_spheres
        ctx.cfg = cfg
        return radiance

    @staticmethod
    def backward(ctx, g_rad):
        (rec, rec_idx), ctx.res = ctx.res, None
        g_attr, g_org, g_dir = _replay_backward(
            rec, rec_idx, g_rad.to(torch.float32).contiguous(), ctx.n,
            ctx.cfg)
        del rec, rec_idx
        return (g_attr[:, 0:3], g_attr[:, 3], g_attr[:, 4:7], g_attr[:, 7],
                g_attr[:, 8], g_org, g_dir, None, None)


def trace_recorded_fused(scene: Scene, origin: torch.Tensor,
                         direction: torch.Tensor, seed: int,
                         max_depth: int = 16, tmin: float = DEFAULT_TMIN, *,
                         replay_fused: bool = True, impl: str | None = None,
                         u5_fn: Callable | None = None) -> torch.Tensor:
    """Differentiable radiance ``[R, 3]`` of rays ``origin``/``direction``
    [R, 3] through the fixed-depth kernel pair.

    Gradients reach the scene's center, radius, albedo, fuzz and ir (``mat``
    gets none) and the rays. ``seed`` keys the record and replay draws (its
    low 32 bits). ``replay_fused=False`` replays bounce by bounce (K7b)
    instead of in one launch (K7c). Test hook: ``u5_fn(b, R)`` -> [5, R]
    replaces the draws of bounce ``b`` (record and replay)."""
    if scene.center.dtype != torch.float32:
        raise NotImplementedError(
            "only float32 gradients are ported (the record kernels are "
            f"float32); got {scene.center.dtype}")
    cfg = _Config(int(max_depth), float(tmin), GK.base_seed(seed),
                  bool(replay_fused), resolve_impl(impl, scene.device), u5_fn)
    return _FusedTrace.apply(*scene[:5], origin, direction, scene.mat, cfg)
