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

:func:`trace_recorded_fused_staged` runs the same pair over a stage
schedule ``((first_bounce, width_divisor), ...)``: at each stage's first
bounce the live lanes are compacted (a stable partition) into a wavefront
of ``ceil(R / divisor)`` lanes rounded up to the JAX package's block of
8 192 lanes, and the lanes that died bank their radiance into the image.
Its replay walks the stages newest first with the per-bounce replay (K7b)
and expands the cotangents at each boundary. Lanes alive at a boundary
beyond its stage's width lose their tails (black): the count of those
lanes stays on the device.

``impl`` picks the kernels (``"kernels"``, the default on CUDA) or their
plain PyTorch versions (``"plain"``, the default on the CPU, and selectable
on a card for comparison).
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import torch

from ..scene import Scene, check_static
from ..utils.profiling import count, span
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
    """The record bounces, counted under ``rtw.grad.record_iters``. Returns
    ``(radiance [R, 3], rec [depth, 21, R], rec_idx [depth, R])``."""
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
    count("rtw.grad.record_iters", cfg.max_depth)
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
    """Forward: the record bounces (span ``rtw.grad.record``, as the
    persistent pair's). Backward: the replay. The record lives on ``ctx``
    between the two and is released by the backward."""

    @staticmethod
    def forward(ctx, center, radius, albedo, fuzz, ir, origin, direction,
                mat, cfg):
        scene = Scene(center, radius, albedo, fuzz, ir, mat)
        with span("rtw.grad.record"):
            radiance, rec, rec_idx = _record_forward(scene, origin,
                                                     direction, cfg)
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
    check_static(scene, "the fixed-depth gradient pair")
    if scene.center.dtype != torch.float32:
        raise NotImplementedError(
            "only float32 gradients are ported (the record kernels are "
            f"float32); got {scene.center.dtype}")
    cfg = _Config(int(max_depth), float(tmin), GK.base_seed(seed),
                  bool(replay_fused), resolve_impl(impl, scene.device), u5_fn)
    return _FusedTrace.apply(*scene[:5], origin, direction, scene.mat, cfg)


# ---------------------------------------------------------------------------
# The staged pair: the wavefront compacted at stage boundaries
# ---------------------------------------------------------------------------

#: ``(first_bounce, width_divisor)`` schedule of the reference (2x margin
#: over the flagship's live shares [1, .84, .37, .22, .14, ...] at each
#: boundary).
DEFAULT_STAGES = ((0, 1), (2, 2), (4, 4), (8, 8))

#: The JAX package's block: stage widths are whole multiples of
#: ``LANES * SHADE_ROWS`` = 8 192 lanes (``intersect_kernel.py:41``,
#: ``shade_kernel.py:40`` there), so the same lanes overflow a budget.
LANES = 128
SHADE_ROWS = 64


def check_stages(stages) -> tuple:
    """``stages`` as a tuple of ``(first_bounce, width_divisor)`` int pairs,
    the first at bounce 0, first bounces increasing and divisors positive
    and non-decreasing (no stage wider than the one before); ``ValueError``
    otherwise."""
    try:
        st = tuple((int(b0), int(div)) for b0, div in stages)
    except (TypeError, ValueError):
        raise ValueError("fused_stages must be ((first_bounce, "
                         f"width_divisor), ...), got {stages!r}") from None
    if not st or st[0][0] != 0 or st[0][1] < 1 \
            or any(a[0] >= b[0] or a[1] > b[1] for a, b in zip(st, st[1:])):
        raise ValueError("fused_stages must start at bounce 0, with "
                         "increasing first bounces and non-decreasing "
                         f"divisors >= 1, got {stages!r}")
    return st


def stage_plan(R: int, max_depth: int, stages) -> list:
    """``[(b0, b1, rows)]``: each stage's bounces ``[b0, b1)`` and its
    width in rows of ``LANES`` (``_stage_plan`` of the JAX package)."""
    plan = []
    for i, (b0, div) in enumerate(stages):
        b1 = stages[i + 1][0] if i + 1 < len(stages) else max_depth
        b1 = min(b1, max_depth)
        if b0 >= max_depth or b1 <= b0:
            break
        rows = -(-(-(-R // div)) // LANES)
        rows = -(-rows // SHADE_ROWS) * SHADE_ROWS
        plan.append((b0, b1, rows))
    return plan


def partition_alive(alive: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(order, n_alive)``: the stable partition of the lanes, live ones
    first, each group in lane order, from two prefix sums and a scatter
    (``_partition_alive`` of the JAX package)."""
    ai = alive.to(torch.int64)
    n_alive = ai.sum()
    pos = torch.where(alive, torch.cumsum(ai, 0) - 1,
                      n_alive + torch.cumsum(1 - ai, 0) - 1)
    order = torch.empty_like(pos)
    order[pos] = torch.arange(pos.shape[0], dtype=pos.dtype,
                              device=pos.device)
    return order, n_alive


class _Stage(NamedTuple):
    b0: int
    rec: torch.Tensor      # [nb, 21, Rs]
    rec_idx: torch.Tensor  # [nb, Rs]
    ids: torch.Tensor      # [Rs] the ray each lane carries (>= R: padding)
    sel: torch.Tensor | None  # [Rs] lane of the previous stage, per lane


def _record_forward_staged(scene: Scene, origin, direction, cfg: _Config,
                           stages: tuple):
    """The staged record. Returns ``(radiance [R, 3], stages, n_over)``:
    ``n_over`` (a device tensor) counts the lanes alive at a boundary that
    its stage had no room for."""
    R = origin.shape[0]
    dev = origin.device
    plan = stage_plan(R, cfg.max_depth, stages)
    spheres, amat = intersect_kernel.sphere_consts(scene), attr_mat(scene)
    if cfg.impl == "kernels":
        sweep, step = intersect_kernel.sweep_masked, GK.record_shade_step
    else:
        sweep, step = intersect_kernel.sweep_masked_ref, GK.record_shade_fetch_ref
    W0 = plan[0][2] * LANES
    pad = torch.zeros((W0 - R, 3), dtype=torch.float32, device=dev)
    st = start_state(torch.cat([origin.to(torch.float32), pad]),
                     torch.cat([direction.to(torch.float32), pad]))
    st[12].view(torch.int32)[R:] = 0
    ids = torch.arange(W0, device=dev)
    rad = torch.zeros((W0, 3), dtype=torch.float32, device=dev)
    n_over = torch.zeros((), dtype=torch.int64, device=dev)
    out = []
    for s, (b0, b1, rows) in enumerate(plan):
        Rs, sel = rows * LANES, None
        if s:
            alive = st[12].view(torch.int32) != 0
            order, n_alive = partition_alive(alive)
            n_over = n_over + torch.clamp(n_alive - Rs, min=0)
            # Only lanes that died carry radiance (a lane banks sky light at
            # its death bounce), so banking every lane counts nothing twice.
            rad[ids] = rad[ids] + st[9:12].T
            sel = order[:Rs]
            st = st[:, sel]
            st[9:12] = 0.0
            ids = ids[sel]
        rec = torch.empty((b1 - b0, GK.N_REC, Rs), dtype=torch.float32,
                          device=dev)
        rec_idx = torch.empty((b1 - b0, Rs), dtype=torch.int32, device=dev)
        for i in range(b1 - b0):
            t, idx = sweep(st[0:6], st[12].view(torch.int32), spheres,
                           cfg.tmin)
            rec_idx[i] = idx
            u5 = None if cfg.u5_fn is None else cfg.u5_fn(b0 + i, Rs).to(dev)
            step(t, idx, amat, st, rec[i], cfg.seed, b0 + i, u5)
        out.append(_Stage(b0, rec, rec_idx, ids, sel))
    rad[ids] = rad[ids] + st[9:12].T
    return rad[:R], out, n_over


def _replay_backward_staged(stages: list, g_rad, n: int, cfg: _Config):
    """The staged replay: ``(g_attr [N, 9], g_org [R, 3], g_dir [R, 3])``."""
    R = g_rad.shape[0]
    dev = g_rad.device
    g_pad = torch.zeros((stages[0].ids.shape[0], 3), dtype=torch.float32,
                        device=dev)
    g_pad[:R] = g_rad
    step = (GK.replay_bwd_step if cfg.impl == "kernels"
            else GK.replay_bwd_step_ref)
    dattrs = [None] * len(stages)
    cot_next, sel_next = None, None
    for s in reversed(range(len(stages))):
        stg = stages[s]
        nb, Rs = stg.rec_idx.shape
        g3 = g_pad[stg.ids].T.contiguous()
        cot = torch.zeros((9, Rs), dtype=torch.float32, device=dev)
        if cot_next is not None:
            # The lanes dropped at the boundary were dead: their cotangent
            # is zero.
            cot[:, sel_next] = cot_next
        dattr = torch.empty((nb, 9, Rs), dtype=torch.float32, device=dev)
        for i in reversed(range(nb)):
            b = stg.b0 + i
            u5 = None if cfg.u5_fn is None else cfg.u5_fn(b, Rs).to(dev)
            step(stg.rec[i], g3, cot, cfg.seed, b, u5, out=dattr[i])
        dattrs[s] = dattr
        cot_next, sel_next = cot, stg.sel
    # The first stage's padding lanes never live: contract only the rays.
    dattrs[0] = dattrs[0][:, :, :R]
    g_attr = GK.dattr_contract_stages(
        dattrs, [stages[0].rec_idx[:, :R]] + [s.rec_idx for s in stages[1:]],
        n)
    return g_attr, cot_next[0:3, :R].T, cot_next[3:6, :R].T


class _StagedTrace(torch.autograd.Function):
    """:class:`_FusedTrace` over a stage schedule."""

    @staticmethod
    def forward(ctx, center, radius, albedo, fuzz, ir, origin, direction,
                mat, cfg, stages):
        scene = Scene(center, radius, albedo, fuzz, ir, mat)
        radiance, recs, n_over = _record_forward_staged(
            scene, origin, direction, cfg, stages)
        ctx.res = recs
        ctx.n = scene.n_spheres
        ctx.cfg = cfg
        ctx.mark_non_differentiable(n_over)
        return radiance, n_over

    @staticmethod
    def backward(ctx, g_rad, _g_over):
        recs, ctx.res = ctx.res, None
        g_attr, g_org, g_dir = _replay_backward_staged(
            recs, g_rad.to(torch.float32).contiguous(), ctx.n, ctx.cfg)
        del recs
        return (g_attr[:, 0:3], g_attr[:, 3], g_attr[:, 4:7], g_attr[:, 7],
                g_attr[:, 8], g_org, g_dir, None, None, None)


def trace_recorded_fused_staged(scene: Scene, origin: torch.Tensor,
                                direction: torch.Tensor, seed: int,
                                max_depth: int = 16,
                                tmin: float = DEFAULT_TMIN,
                                stages: tuple = DEFAULT_STAGES, *,
                                impl: str | None = None,
                                u5_fn: Callable | None = None,
                                stats: dict | None = None) -> torch.Tensor:
    """:func:`trace_recorded_fused` with the wavefront compacted at the
    stage boundaries of ``stages`` (module docstring; :func:`check_stages`
    says which schedules it takes). With one stage ``((0, 1),)`` it is the
    unstaged pair bit for bit.

    Lanes alive at a boundary beyond its stage's width lose their tails,
    which biases the radiance and the gradients low. Their number
    (``n_over``, a device tensor) is added to ``stats["n_over"]`` when
    ``stats`` (a dict) is given; without it, a ``RuntimeWarning`` reports
    any overflow (one host read per call). Test hook: ``u5_fn(b, width)``
    -> [5, width] replaces bounce ``b``'s draws at its stage's width."""
    check_static(scene, "the staged fixed-depth gradient pair")
    if scene.center.dtype != torch.float32:
        raise NotImplementedError(
            "only float32 gradients are ported (the record kernels are "
            f"float32); got {scene.center.dtype}")
    cfg = _Config(int(max_depth), float(tmin), GK.base_seed(seed), False,
                  resolve_impl(impl, scene.device), u5_fn)
    radiance, n_over = _StagedTrace.apply(*scene[:5], origin, direction,
                                          scene.mat, cfg, check_stages(stages))
    if stats is not None:
        stats["n_over"] = stats.get("n_over", 0) + n_over
    else:
        warn_overflow(n_over, "trace_recorded_fused_staged")
    return radiance


def warn_overflow(n_over: torch.Tensor, what: str) -> None:
    """Warn (``RuntimeWarning``) when ``n_over`` (one host read) is not 0:
    that many lanes alive at a stage boundary had no room in the stage."""
    n = int(n_over)
    if n:
        warnings.warn(
            f"{what}: {n} lanes overflowed a stage budget; their tails were "
            "truncated (radiance and gradients biased low); widen the stage "
            "schedule or the stage width", RuntimeWarning, stacklevel=3)

