"""The recorded gradient traces of the fixed-depth wavefront — the
counterpart of ``raytracingweekend_jl_tpu/ops/grad_trace.py``.

:func:`trace_recorded` is :func:`integrator.trace` under autograd without
the bounce recompute. Its forward builds no graph: it runs the wavefront and
records, for every bounce, the input state (origin, direction, throughput),
the hit distance and the winner of each lane that hit while alive. Its
backward walks the record newest first and takes the VJP of one local
bounce function per bounce (sky banking and scatter, no sweep): the hit
distance re-enters at its recorded value with the derivative of implicit
differentiation of the sphere equation at the recorded winner (the
derivative the sweep's own backward takes; the JAX package solves the
closed-form root again, which differs only along a unit direction), so
cotangents reach the rays and the winner's center and radius, while the
discrete choices (winner, alive, the Schlick coin) replay as constants. The draws are
:func:`integrator.trace`'s positional draws, a pure function of (seed,
bounce), so the replay redraws them exactly and the primal is bit for bit
``trace(remat=False)``'s.

:func:`trace_recorded_staged` records bounces ``[0, B)`` at full width,
then compacts the survivors (a stable sort, live lanes first) to a fixed
width ``R2`` and records the rest there. Lanes alive at ``B`` beyond ``R2``
lose their tails (they read black): the returned live count at ``B`` lets a
caller police that budget.

Every backward sums the winners' attribute-row cotangents of all bounces
onto the spheres once, with the ordered contraction
(``cuda/grad_kernel.dattr_contract_stages``): no atomics, the same bits on
every run. The sweep is K1 for float32 rays (its plain version with
``impl="plain"``, the default on the CPU) and the dot-form sweep for
float64 rays, as :func:`integrator.trace` sweeps.

The record costs 11 words per ray and bounce (origin, direction and
throughput, the hit distance, the winner index), and the backward's
attribute rows 9 more: 80 bytes in float32, inside the 104 that
``grad.auto_pixel_chunk`` prices this path at.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..scene import Scene, check_static
from .cuda.grad_kernel import dattr_contract_stages
from .integrator import (DEFAULT_MAX_DEPTH, _pick_intersector, bounce_advance,
                         resolve_impl, skycolor)
from .intersect import DEFAULT_TMIN
from .materials import positional_draws, scatter


class _Config(NamedTuple):
    max_depth: int
    tmin: float
    seed: int
    impl: str
    draws: Callable | None
    stage_bounce: int | None  # None: unstaged
    stage_width: int


class _Record(NamedTuple):
    """The record of bounces ``[b0, b0 + n)`` at width ``R``."""

    b0: int
    alive0: torch.Tensor  # [R] bool, the lanes alive entering bounce b0
    o: torch.Tensor       # [n, R, 3] input origins
    d: torch.Tensor       # [n, R, 3] input directions
    thr: torch.Tensor     # [n, R, 3] input throughputs
    t: torch.Tensor       # [n, R] hit distance, 1 on a miss
    idx: torch.Tensor     # [n, R] int32 winner of a live hit, else -1


def _draws(cfg: _Config, b: int, n: int, dtype, dev):
    """Bounce ``b``'s draws ``(u [n, 3], xi [n])``: positional, or the hook."""
    if cfg.draws is None:
        return positional_draws(cfg.seed, b, n, dtype, dev)
    u, xi = cfg.draws(b, n)
    return u.to(device=dev, dtype=dtype), xi.to(device=dev, dtype=dtype)


def _record(scene: Scene, isect: Callable, cfg: _Config, b0: int, b1: int,
            state: tuple) -> tuple[_Record, tuple]:
    """Run bounces ``[b0, b1)`` from ``state`` = (org, d, thr, rad, alive)
    and record them. Returns the record and the state after ``b1 - 1``."""
    org, d, thr, rad, alive = state
    R, n = org.shape[0], b1 - b0
    rec = _Record(b0, alive, org.new_empty((n, R, 3)), org.new_empty((n, R, 3)),
                  org.new_empty((n, R, 3)), org.new_empty((n, R)),
                  torch.empty((n, R), dtype=torch.int32, device=org.device))
    for j in range(n):
        res, attrs = isect(org, d, scene, cfg.tmin)
        u, xi = _draws(cfg, b0 + j, R, org.dtype, org.device)
        rec.o[j], rec.d[j], rec.thr[j] = org, d, thr
        rec.t[j] = torch.where(res.hit, res.t, torch.ones_like(res.t))
        rec.idx[j] = torch.where(alive & res.hit, res.index.to(torch.int32),
                                 torch.full_like(rec.idx[j], -1))
        org, d, thr, rad, alive = bounce_advance(scene, res, attrs, u, xi,
                                                 org, d, thr, rad, alive)
    return rec, (org, d, thr, rad, alive)


def _implicit_t(org, d, center, radius, t_rec, hit):
    """Differentiable hit distance: the value ``t_rec`` (1 off ``hit``),
    with the gradients of implicit differentiation of ``|p|^2 = r^2`` at
    ``p = o + t_rec d - c``: ``dt = -(p . dp - r dr) / (p . d)`` (0 where
    ``|p . d| <= 1e-12``), the expression the sweep's own backward takes
    (``cuda/intersect_kernel._winner_scale``). ``F - F.detach()`` is 0 in
    value, so the root is never solved again: solving it again in float32
    cancels (``|oc|^2 - r^2`` of a 1 000-radius ground sphere), and at a
    grazing hit any other rounding of ``p . d`` moves ``1 / (p . d)`` far
    from the remat route's."""
    t0 = torch.where(hit, t_rec, torch.ones_like(t_rec))
    p = org + t0[:, None] * d - center
    f = (p * p).sum(-1) - radius * radius
    pd = (p * d).sum(-1).detach()
    ok = hit & (pd.abs() > 1e-12)
    inv = torch.where(ok, 0.5 / torch.where(ok, pd, torch.ones_like(pd)),
                      torch.zeros_like(pd))
    return t0 - (f - f.detach()) * inv


def _bounce_local(org, d, thr, rows, mat, t_rec, live_hit, alive, u, xi):
    """One bounce as a function of its input state and its winners'
    attribute rows ``rows`` [R, 9] (center, radius, albedo, fuzz, ir),
    with the recorded discrete outcome as constants. Returns ``(org', d',
    thr', radiance increment)``."""
    center, radius = rows[:, 0:3], rows[:, 3]
    miss_now = (alive & ~live_hit)[:, None]
    rad_inc = torch.where(miss_now, thr * skycolor(d), torch.zeros_like(thr))
    t = _implicit_t(org, d, center, radius, t_rec, live_hit)
    s = scatter(org, d, t, (center, radius, rows[:, 4:7], rows[:, 7],
                            rows[:, 8], mat), u, xi)
    lh = live_hit[:, None]
    return (torch.where(lh, s.origin, org), torch.where(lh, s.direction, d),
            torch.where(lh, thr * s.attenuation, thr), rad_inc)


def _replay(rec: _Record, table: torch.Tensor, mat: torch.Tensor,
            cfg: _Config, cots: tuple, g_rad: torch.Tensor) -> tuple:
    """The backward of one record, newest bounce first. ``cots`` = the
    cotangents of the state after the record's last bounce (origin,
    direction, throughput), ``g_rad`` the radiance's. Returns the
    cotangents before its first bounce and the attribute rows [n, 9, R]."""
    n, R = rec.idx.shape
    dattr = table.new_empty((n, table.shape[1], R))
    g_o, g_d, g_t = cots
    for j in reversed(range(n)):
        alive = rec.alive0 if j == 0 else rec.idx[j - 1] >= 0
        live_hit = rec.idx[j] >= 0
        win = rec.idx[j].clamp(min=0).long()
        u, xi = _draws(cfg, rec.b0 + j, R, table.dtype, table.device)
        leaves = [x[j].detach().requires_grad_(True)
                  for x in (rec.o, rec.d, rec.thr)]
        leaves.append(table[win].requires_grad_(True))
        with torch.enable_grad():
            outs = _bounce_local(*leaves, mat[win], rec.t[j], live_hit,
                                 alive, u, xi)
            grads = torch.autograd.grad(outs, leaves, (g_o, g_d, g_t, g_rad),
                                        allow_unused=True)
        g_o, g_d, g_t, rows = (torch.zeros_like(x) if g is None else g
                               for g, x in zip(grads, leaves))
        dattr[j] = rows.T
    return (g_o, g_d, g_t), dattr


def _forward(scene: Scene, origin, direction, cfg: _Config):
    """The record forward: ``(radiance [R, 3], live count at the stage
    bounce, records, sel)``; ``sel`` [R2] are the lanes the tail stage
    took (None unstaged)."""
    dtype, dev = origin.dtype, origin.device
    R = origin.shape[0]
    isect = _pick_intersector(dtype, False, cfg.impl)
    state = (origin, direction, torch.ones((R, 3), dtype=dtype, device=dev),
             torch.zeros((R, 3), dtype=dtype, device=dev),
             torch.ones((R,), dtype=torch.bool, device=dev))
    B = cfg.max_depth if cfg.stage_bounce is None \
        else min(cfg.stage_bounce, cfg.max_depth)
    head, state = _record(scene, isect, cfg, 0, B, state)
    org, d, thr, rad, alive = state
    count = alive.sum()
    if B == cfg.max_depth:
        return rad, count, (head,), None
    # Live lanes first (stable), then the fixed-width prefix.
    sel = torch.argsort((~alive).to(torch.int8), stable=True)[
        :cfg.stage_width]
    zero = torch.zeros((sel.shape[0], 3), dtype=dtype, device=dev)
    tail, state = _record(scene, isect, cfg, B, cfg.max_depth,
                          (org[sel], d[sel], thr[sel], zero, alive[sel]))
    rad[sel] = rad[sel] + state[3]
    return rad, count, (head, tail), sel


class _RecordedTrace(torch.autograd.Function):
    """Forward: the record. Backward: the local VJPs, newest bounce first,
    then one contraction onto the spheres. The records live on ``ctx``
    between the two and are released by the backward."""

    @staticmethod
    def forward(ctx, center, radius, albedo, fuzz, ir, origin, direction,
                mat, cfg):
        scene = Scene(center, radius, albedo, fuzz, ir, mat)
        rad, count, recs, sel = _forward(scene, origin, direction, cfg)
        dtype = origin.dtype
        table = torch.cat([center, radius[:, None], albedo, fuzz[:, None],
                           ir[:, None]], 1).to(dtype)
        ctx.res = (recs, sel, table, mat)
        ctx.cfg = cfg
        ctx.dtypes = tuple(x.dtype for x in (center, radius, albedo, fuzz,
                                             ir))
        ctx.mark_non_differentiable(count)
        return rad, count

    @staticmethod
    def backward(ctx, g_rad, _g_count):
        (recs, sel, table, mat), ctx.res = ctx.res, None
        cfg = ctx.cfg
        g_rad = g_rad.to(table.dtype)
        R = g_rad.shape[0]
        cots = (torch.zeros_like(g_rad),) * 3
        dattrs = []
        if len(recs) == 2:
            z2 = torch.zeros((sel.shape[0], 3), dtype=g_rad.dtype,
                             device=g_rad.device)
            tail_cots, d_tail = _replay(recs[1], table, mat, cfg,
                                        (z2, z2, z2), g_rad[sel])
            dattrs.append(d_tail)
            cots = []
            for c in tail_cots:
                full = torch.zeros((R, 3), dtype=c.dtype, device=c.device)
                full[sel] = c
                cots.append(full)
        (g_org, g_dir, _), d_head = _replay(recs[0], table, mat, cfg,
                                            tuple(cots), g_rad)
        dattrs.insert(0, d_head)
        g = dattr_contract_stages(dattrs, [r.idx for r in recs],
                                  table.shape[0])
        fields = (g[:, 0:3], g[:, 3], g[:, 4:7], g[:, 7], g[:, 8])
        return (*(f.to(t) for f, t in zip(fields, ctx.dtypes)), g_org, g_dir,
                None, None)


def _config(seed, max_depth, tmin, impl, draws, device, stage_bounce=None,
            stage_width=0) -> _Config:
    return _Config(int(max_depth), float(tmin), int(seed),
                   resolve_impl(impl, device), draws, stage_bounce,
                   int(stage_width))


def trace_recorded(scene: Scene, origin: torch.Tensor,
                   direction: torch.Tensor, seed: int,
                   max_depth: int = DEFAULT_MAX_DEPTH,
                   tmin: float = DEFAULT_TMIN, *, impl: str | None = None,
                   draws: Callable | None = None) -> torch.Tensor:
    """Differentiable radiance ``[R, 3]`` of rays ``origin``/``direction``
    [R, 3]: bit for bit ``integrator.trace(..., remat=False)`` with the same
    ``seed``, with the recorded backward (module docstring). Gradients
    reach the rays and the scene's center, radius, albedo, fuzz and ir
    (``mat`` gets none). Float32 or float64. Test hook: ``draws(b, n) ->
    (u [n, 3], xi [n])`` replaces bounce ``b``'s draws, in the forward and
    the backward."""
    check_static(scene, "the recorded wavefront")
    cfg = _config(seed, max_depth, tmin, impl, draws, origin.device)
    rad, _ = _RecordedTrace.apply(*scene[:5], origin, direction, scene.mat,
                                  cfg)
    return rad


def trace_recorded_staged(scene: Scene, origin: torch.Tensor,
                          direction: torch.Tensor, seed: int,
                          max_depth: int = DEFAULT_MAX_DEPTH,
                          tmin: float = DEFAULT_TMIN, stage_bounce: int = 4,
                          stage_width: int = 0, *, impl: str | None = None,
                          draws: Callable | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(radiance [R, 3], live count at stage_bounce)``: the recorded trace
    with bounces from ``stage_bounce`` run over the survivors compacted to
    ``stage_width`` lanes (0: ``R // 4``; ``ValueError`` outside ``[1,
    R]``). Survivors beyond that width lose their tails: a count above
    ``stage_width`` says the radiance and the gradients are biased low.
    The count is a device tensor (no host read). The tail's draws are
    positional at its own width, so they differ from :func:`trace_recorded`'s
    from the stage bounce on. Arguments otherwise as
    :func:`trace_recorded`."""
    check_static(scene, "the staged recorded wavefront")
    R = origin.shape[0]
    width = stage_width or R // 4
    if not 1 <= width <= R:
        raise ValueError(
            f"stage_width={width} must be in [1, R={R}] (0 selects R//4; "
            "R < 4 makes that default degenerate — pass it explicitly)")
    cfg = _config(seed, max_depth, tmin, impl, draws, origin.device,
                  int(stage_bounce), width)
    return _RecordedTrace.apply(*scene[:5], origin, direction, scene.mat, cfg)
