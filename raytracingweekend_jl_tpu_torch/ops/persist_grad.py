"""The persistent-record gradient trace — the counterpart of the host-side half
of ``raytracingweekend_jl_tpu/ops/pallas/persist_grad_kernel.py``
(``trace_recorded_persist`` with its custom VJP).

Each of ``W`` lanes owns ``S`` rays spaced ``W`` apart (its strips) and
traces them one after another, refilling in place when a path ends. The
record phase runs one iteration per step until every lane is dead or the
phase's slot cap is reached:

1. the occupancy-masked sweep (K3, ``cuda/intersect_kernel.sweep_masked``);
2. the record step (K4, ``cuda/persist_grad_kernel.persist_record_step``),
   which fetches the winner's attributes from the sweep's index, shades,
   banks, advances, refills and writes one record slot.

With ``fused_step=True`` the two run as one launch of K11
(``cuda/persist_grad_kernel.persist_record_fused_step``), which also writes
the winner indices; the replay is unchanged.

With tail compaction ``(b1, wdiv)`` the lanes still alive after ``b1``
iterations are gathered into a ``W / wdiv``-wide second phase. The backward
walks each phase's slots newest first: one launch of the fused replay (K5)
per phase over the 21-plane record, or one launch of the per-slot replay
(K6) per slot over the lean 11-plane record, which takes the recorded
winner indices and reads the winners' rows itself. The per-lane attribute
cotangent rows are summed onto the spheres by the deterministic
``dattr_contract``.

``impl`` picks the kernels (``"kernels"``, the default on CUDA) or their
plain PyTorch versions (``"plain"``, the default on the CPU, and selectable
on a card for comparison).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..scene import Scene, check_static
from ..utils.profiling import count, span, sync
from .integrator import ACTIVE_CHECK_EVERY, resolve_impl
from .intersect import DEFAULT_TMIN
from .materials import attr_mat
from .cuda import intersect_kernel, persist_grad_kernel as PK
from .cuda.grad_kernel import base_seed, dattr_contract

#: Lanes per plane row and rows per block of the reference layout: lane
#: counts are padded to 64-row x 128-lane multiples, so the tests can inject
#: the JAX package's ``(5, rows, 128)`` uniforms lane for lane.
LANES = 128
SHADE_ROWS = 64

#: Origin.y of the padding rays: one-iteration sky paths, sliced off.
DUMMY_Y = -1e7


def persist_block_rows(n_strips: int) -> int:
    """Rows per block of the reference's persistent kernels (64, or 32 for
    16 or more strips); the phase-2 width is a multiple of it."""
    return SHADE_ROWS if n_strips < 16 else 32


def strip_geometry(R: int, n_strips: int) -> tuple[int, int]:
    """``(rows, W)``: lanes per strip, padded to whole 64 x 128 blocks."""
    per = -(-R // n_strips)
    rows = -(-(-(-per // LANES)) // SHADE_ROWS) * SHADE_ROWS
    return rows, rows * LANES


def phase2_width(rows: int, n_strips: int, wdiv: int) -> int:
    """Lanes of the tail-compacted phase: ``rows // wdiv`` rounded up to
    whole blocks."""
    br2 = persist_block_rows(n_strips)
    return -(-max(rows // wdiv, br2) // br2) * br2 * LANES


def default_n_iters(n_strips: int, max_depth: int = 16) -> int:
    """Default iteration cap: the worst case ``n_strips * max_depth``, so no
    path can be dropped."""
    return n_strips * max_depth


def persist_record_bytes(R: int, n_strips: int, n_iters: int | None = None,
                         tail_compact: tuple | None = None,
                         max_depth: int = 16, rec_attrs: bool = True) -> int:
    """Bytes of one pass's record for :func:`trace_recorded_persist` at the
    reference's accounting: per slot the record planes plus the winner
    index, and a count; plus the boundary's two index vectors."""
    S = n_strips
    if n_iters is None:
        n_iters = default_n_iters(S, max_depth)
    rows, W = strip_geometry(R, S)
    n_rec = PK.N_REC if rec_attrs else PK.N_REC_LEAN

    def phase(nslices, lanes):
        return nslices * (lanes * (n_rec + 1) * 4 + 4)

    if tail_compact is None:
        return phase(n_iters, W)
    b1 = min(tail_compact[0], n_iters)
    W2 = phase2_width(rows, S, tail_compact[1])
    return phase(b1, W) + phase(n_iters - b1, W2) + 2 * W2 * 4


class _Phase(NamedTuple):
    rec: torch.Tensor      # [n_slots, 21 or 11, W] f32
    rec_idx: torch.Tensor  # [n_slots, W] i32 winner indices
    counts: torch.Tensor   # [n_slots] i64 active lanes at each iteration
    i0: int                # absolute iteration of slot 0


class _Config(NamedTuple):
    max_depth: int
    tmin: float
    n_strips: int
    n_iters: int
    fused_step: bool
    tail_compact: tuple | None
    rec_attrs: bool
    strict: bool
    impl: str
    seed: int
    u5_fn: Callable | None
    stats: dict | None


def _strips(x: torch.Tensor, S: int, W: int, dummy: float) -> torch.Tensor:
    """[R] -> [S, W]: ray ``s * W + l`` is lane ``l``'s strip ``s``."""
    R = x.shape[0]
    pad = torch.full((S * W - R,), dummy, dtype=torch.float32,
                     device=x.device)
    return torch.cat([x.to(torch.float32), pad]).reshape(S, W)


def _unstrip(planes: torch.Tensor, S: int, R: int, first: int) -> torch.Tensor:
    """Rows ``k * c + first + j`` (j < 3) of ``planes`` [k S, W] -> [R, 3]."""
    k = planes.shape[0] // S
    W = planes.shape[1]
    p = planes.reshape(S, k, W)[:, first:first + 3]
    return p.permute(1, 0, 2).reshape(3, S * W)[:, :R].T


def _dummy_future(sp: torch.Tensor, oy: torch.Tensor) -> torch.Tensor:
    """Per lane: unstarted strips whose ray is a padding dummy.
    ``oy`` [S, W] is the strips' origin.y."""
    s = torch.arange(oy.shape[0], device=sp.device)[:, None]
    return ((oy == DUMMY_Y) & (sp[None, :] < s)).sum(0)


def _real_inflight(sf: torch.Tensor, si: torch.Tensor) -> torch.Tensor:
    """Active lanes whose current ray is not a padding dummy."""
    return si[2] * (sf[1] != DUMMY_Y).to(si.dtype)


def _run_record_phase(scene_tabs, strips, sf, si, rad, n_slots: int,
                      i0: int, cfg: _Config) -> _Phase:
    """Record iterations ``i0 .. i0 + n_slots - 1`` over the given planes,
    stopping early once every lane is dead (checked every
    ``ACTIVE_CHECK_EVERY`` iterations; an all-dead iteration writes a zero
    record and changes nothing). Each iteration is K3 and K4 (which fetches
    the winner's attributes itself), or with ``cfg.fused_step`` one K11,
    which writes ``rec_idx`` itself. Counts its passes under
    ``rtw.grad.record_iters``."""
    spheres, amat = scene_tabs
    W = sf.shape[1]
    dev = sf.device
    kern = cfg.impl == "kernels"
    if kern:
        sweep, step = intersect_kernel.sweep_masked, PK.persist_record_step
    else:
        sweep = intersect_kernel.sweep_masked_ref
        step = PK.persist_record_fetch_ref
    fused = (PK.persist_record_fused_step if kern
             else PK.persist_record_fused_step_ref)
    n_rec = PK.N_REC if cfg.rec_attrs else PK.N_REC_LEAN
    rec = torch.empty((n_slots, n_rec, W), dtype=torch.float32, device=dev)
    rec_idx = torch.empty((n_slots, W), dtype=torch.int32, device=dev)
    counts = torch.zeros((n_slots,), dtype=torch.int64, device=dev)
    seed = base_seed(cfg.seed)
    passes = 0
    for s in range(n_slots):
        passes += 1
        if s % ACTIVE_CHECK_EVERY == 0:
            with sync("active_check"):
                if not bool(si[2].any()):
                    break
        counts[s] = si[2].sum()
        u5 = None if cfg.u5_fn is None else cfg.u5_fn(i0 + s, W).to(dev)
        if cfg.fused_step:
            fused(strips, sf, si, rad, rec[s], rec_idx[s], spheres, amat,
                  seed, i0 + s, cfg.max_depth, cfg.tmin, u5)
            continue
        t, idx = sweep(sf[0:6], si[2], spheres, cfg.tmin)
        rec_idx[s] = idx
        step(t, idx, amat, strips, sf, si, rad, rec[s], seed, i0 + s,
             cfg.max_depth, u5)
    count("rtw.grad.record_iters", passes)
    return _Phase(rec, rec_idx, counts, i0)


def start_planes(origin: torch.Tensor, direction: torch.Tensor,
                 n_strips: int):
    """The record phase's planes before its first iteration, for rays
    ``origin``/``direction`` [R, 3]: ``(strips [6S, W], sf [9, W], si [3, W],
    rad [3S, W])`` (layout in ``cuda/persist_grad_kernel.py``). Strip ``s``
    holds rows ``6s .. 6s + 5`` of ``strips``; every lane starts on strip 0,
    active, with throughput 1. Rays past ``R`` are padding dummies."""
    S = n_strips
    R = origin.shape[0]
    _, W = strip_geometry(R, S)
    dev = origin.device
    so = torch.stack([_strips(origin[:, j], S, W, DUMMY_Y if j == 1 else 0.0)
                      for j in range(3)])
    sd = torch.stack([_strips(direction[:, j], S, W, -1.0 if j == 1 else 0.0)
                      for j in range(3)])
    strips = torch.cat([so, sd]).permute(1, 0, 2).reshape(6 * S, W).contiguous()
    sf = torch.cat([strips[0:6], torch.ones((3, W), device=dev)])
    si = torch.zeros((3, W), dtype=torch.int32, device=dev)
    si[2] = 1
    rad = torch.zeros((3 * S, W), dtype=torch.float32, device=dev)
    return strips, sf, si, rad


def _record_forward(scene: Scene, origin, direction, cfg: _Config):
    """The record phases. Returns ``(radiance [R, 3], residuals, dropped)``
    with ``dropped`` a 0-d int64 tensor: real paths lost to the iteration
    cap or the boundary width."""
    R = origin.shape[0]
    S = cfg.n_strips
    rows, W = strip_geometry(R, S)
    dev = origin.device
    strips, sf, si, rad = start_planes(origin, direction, S)
    tabs = (intersect_kernel.sphere_consts(scene), attr_mat(scene))

    b1 = (cfg.n_iters if cfg.tail_compact is None
          else min(cfg.tail_compact[0], cfg.n_iters))
    with span("rtw.grad.record.phase1"):
        ph1 = _run_record_phase(tabs, strips, sf, si, rad, b1, 0, cfg)
    oy = strips[1::6]
    if cfg.tail_compact is None:
        dropped = (_real_inflight(sf, si).sum()
                   + ((S - 1 - si[1]) - _dummy_future(si[1], oy)).sum())
        _note_stats(cfg, dropped, ph1, None, W, None)
        return _unstrip(rad, S, R, 0), (ph1,), dropped

    # Boundary: gather the survivors into a W2-wide wavefront.
    with span("rtw.grad.boundary"):
        act = si[2]
        with sync("boundary"):
            nz = torch.nonzero(act).squeeze(1)
        n_act = nz.numel()
        W2 = phase2_width(rows, S, cfg.tail_compact[1])
        sel = torch.zeros((W2,), dtype=torch.int64, device=dev)
        k = min(n_act, W2)
        sel[:k] = nz[:k]
        valid2 = (torch.arange(W2, device=dev) < n_act).to(torch.int32)
        sf2 = sf[:, sel]
        si2 = si[:, sel]
        si2[2] *= valid2
        strips2 = strips[:, sel]
        rad2 = torch.zeros((3 * S, W2), dtype=torch.float32, device=dev)
    with span("rtw.grad.record.phase2"):
        ph2 = _run_record_phase(tabs, strips2, sf2, si2, rad2,
                                cfg.n_iters - b1, b1, cfg)
    # Each ray banks once, in one phase; padded sel entries add exact zeros.
    rad.index_add_(1, sel, rad2 * valid2.to(torch.float32))

    selected = torch.zeros((W,), dtype=torch.int32, device=dev)
    with sync("dropped_audit"):  # the 1 is copied from the host
        selected[sel[:k]] = 1
    unsel = act * (1 - selected)
    cur_real = (sf[1] != DUMMY_Y).to(torch.int32)
    fut_dummy = _dummy_future(si[1], oy)
    oy2 = strips2[1::6]
    dropped = ((unsel * (cur_real + (S - 1 - si[1]) - fut_dummy)).sum()
               + (_real_inflight(sf2, si2) * valid2).sum()
               + (((S - 1 - si2[1]) - _dummy_future(si2[1], oy2))
                  * valid2).sum())
    _note_stats(cfg, dropped, ph1, ph2, W, n_act)
    return (_unstrip(rad, S, R, 0), (ph1, ph2, sel, valid2), dropped)


def _note_stats(cfg: _Config, dropped, ph1, ph2, W: int, n_act) -> None:
    """Add this trace's audit numbers to ``cfg.stats`` (when asked for)."""
    st = cfg.stats
    if st is None:
        return
    st["dropped"] = st.get("dropped", 0) + int(dropped)
    st.setdefault("lanes", []).append(W)
    st.setdefault("phase1_counts", []).append(ph1.counts.tolist())
    if ph2 is not None:
        st.setdefault("boundary_active", []).append(n_act)
        st.setdefault("phase2_counts", []).append(ph2.counts.tolist())


def _replay_phase(ph: _Phase, amat, grad_strips, cot, dep,
                  cfg: _Config) -> torch.Tensor:
    """Reverse-walk one phase's realized slots, in place on ``cot`` and
    ``dep``. Returns the phase's per-sphere cotangent rows [N, 9]."""
    with sync("replay_walk"):
        n_walk = int((ph.counts > 0).sum())
    n = amat.shape[0]
    W = cot.shape[1]
    if n_walk == 0:
        return torch.zeros((n, 9), dtype=torch.float32, device=cot.device)
    seed = base_seed(cfg.seed)
    u5_all = None
    if cfg.u5_fn is not None:
        u5_all = torch.stack([cfg.u5_fn(ph.i0 + s, W)
                              for s in range(n_walk)]).to(cot.device)
    kern = cfg.impl == "kernels"
    rec_idx = ph.rec_idx[:n_walk]
    if cfg.rec_attrs:
        fused = PK.persist_replay_fused if kern else PK.persist_replay_fused_ref
        dattr = fused(cot, dep, ph.rec[:n_walk], grad_strips, ph.i0, seed,
                      u5_all)
    else:
        step = (PK.persist_replay_step if kern
                else PK.persist_replay_step_fetch_ref)
        dattr = torch.empty((n_walk, 9, W), dtype=torch.float32,
                            device=cot.device)
        for s in reversed(range(n_walk)):
            step(cot, dep, ph.rec[s], rec_idx[s], amat, grad_strips, seed,
                 ph.i0 + s, None if u5_all is None else u5_all[s],
                 out=dattr[s])
    with span("rtw.grad.contract"):
        return dattr_contract(dattr, rec_idx, n)


def grad_strip_planes(g_rad: torch.Tensor, n_strips: int,
                      W: int) -> torch.Tensor:
    """Radiance cotangent ``g_rad`` [R, 3] in the strip layout [3S, W]:
    plane ``3c + ch`` holds channel ``ch`` of strip ``c``'s rays."""
    S = n_strips
    gp = torch.zeros((3, S * W), dtype=torch.float32, device=g_rad.device)
    gp[:, :g_rad.shape[0]] = g_rad.T
    return gp.reshape(3, S, W).permute(1, 0, 2).reshape(3 * S, W).contiguous()


def _replay_backward(amat, res, g_rad, R: int, cfg: _Config):
    """The backward of the record phases: ``(g_attr [N, 9], g_org [R, 3],
    g_dir [R, 3])``."""
    S = cfg.n_strips
    W = res[0].rec.shape[2]
    dev = g_rad.device
    grad_strips = grad_strip_planes(g_rad, S, W)
    cot = torch.zeros((9, W), dtype=torch.float32, device=dev)
    dep = torch.zeros((6 * S, W), dtype=torch.float32, device=dev)
    g_attr = torch.zeros((amat.shape[0], 9), dtype=torch.float32, device=dev)
    if cfg.tail_compact is not None:
        ph1, ph2, sel, valid2 = res
        W2 = sel.shape[0]
        cot2 = torch.zeros((9, W2), dtype=torch.float32, device=dev)
        dep2 = torch.zeros((6 * S, W2), dtype=torch.float32, device=dev)
        with span("rtw.grad.replay.phase2"):
            g_attr = g_attr + _replay_phase(ph2, amat,
                                            grad_strips[:, sel].contiguous(),
                                            cot2, dep2, cfg)
        # Transpose of the boundary gather; padded entries add exact zeros.
        v2f = valid2.to(torch.float32)
        cot.index_add_(1, sel, cot2 * v2f)
        dep.index_add_(1, sel, dep2 * v2f)
    else:
        (ph1,) = res
    with span("rtw.grad.replay.phase1"):
        g_attr = g_attr + _replay_phase(ph1, amat, grad_strips, cot, dep,
                                        cfg)
    # The carry left after slot 0 is the cotangent of strip 0's camera rays.
    dep[0:6] = cot[0:6]
    return g_attr, _unstrip(dep, S, R, 0), _unstrip(dep, S, R, 3)


def _poison(dropped: torch.Tensor) -> torch.Tensor:
    """NaN where any path was dropped, else 1."""
    with sync("poison"):  # a copy from the host waits for the card
        nan = torch.tensor(float("nan"), device=dropped.device)
    with sync("poison"):
        one = torch.tensor(1.0, device=dropped.device)
    return torch.where(dropped > 0, nan, one)


class _PersistTrace(torch.autograd.Function):
    """Forward: the record phases (span ``rtw.grad.record``). Backward:
    the replay phases. The records live on ``ctx`` between the two and are
    released by the backward."""

    @staticmethod
    def forward(ctx, center, radius, albedo, fuzz, ir, origin, direction,
                mat, cfg):
        with span("rtw.grad.record"):
            scene = Scene(center, radius, albedo, fuzz, ir, mat)
            radiance, res, dropped = _record_forward(scene, origin,
                                                     direction, cfg)
            if cfg.strict:
                radiance = radiance * _poison(dropped)
        ctx.res = res
        ctx.amat = attr_mat(scene)
        ctx.cfg = cfg
        ctx.dropped = dropped
        ctx.R = origin.shape[0]
        ctx.mark_non_differentiable(dropped)
        return radiance, dropped

    @staticmethod
    def backward(ctx, g_rad, _g_dropped):
        cfg = ctx.cfg
        res, ctx.res = ctx.res, None
        if g_rad is None:
            return (None,) * 9
        g_attr, g_org, g_dir = _replay_backward(
            ctx.amat, res, g_rad.to(torch.float32).contiguous(), ctx.R, cfg)
        del res
        if cfg.strict:
            # Poison the output cotangents too: a loss linear in radiance
            # hands back finite constants even when the primal is NaN.
            p = _poison(ctx.dropped)
            g_attr, g_org, g_dir = g_attr * p, g_org * p, g_dir * p
        return (g_attr[:, 0:3], g_attr[:, 3], g_attr[:, 4:7], g_attr[:, 7],
                g_attr[:, 8], g_org, g_dir, None, None)


def _config(seed, max_depth, tmin, n_strips, n_iters, fused_step,
            tail_compact, rec_attrs, strict, impl, u5_fn, stats,
            device) -> _Config:
    if fused_step and not rec_attrs:
        raise ValueError("rec_attrs=False requires fused_step=False (the "
                         "fused record kernel stores attrs in-kernel)")
    if fused_step and tail_compact is not None:
        raise ValueError("tail_compact requires fused_step=False")
    if n_iters is None:
        n_iters = default_n_iters(n_strips, max_depth)
    return _Config(int(max_depth), float(tmin), int(n_strips), int(n_iters),
                   bool(fused_step),
                   None if tail_compact is None else tuple(tail_compact),
                   bool(rec_attrs), bool(strict), resolve_impl(impl, device),
                   int(seed), u5_fn, stats)


def trace_recorded_persist(scene: Scene, origin: torch.Tensor,
                           direction: torch.Tensor, seed: int,
                           max_depth: int = 16, tmin: float = DEFAULT_TMIN,
                           n_strips: int = 8, n_iters: int | None = None, *,
                           fused_step: bool = False,
                           tail_compact: tuple | None = None,
                           rec_attrs: bool = True, strict: bool = False,
                           impl: str | None = None,
                           u5_fn: Callable | None = None,
                           stats: dict | None = None) -> torch.Tensor:
    """Differentiable radiance ``[R, 3]`` of rays ``origin``/``direction``
    [R, 3] through the persistent-record kernel pair.

    Gradients reach the scene's center, radius, albedo, fuzz and ir (``mat``
    gets none) and the rays. ``seed`` keys the record and replay draws
    (its low 32 bits). ``n_iters`` caps the iterations (default: the worst
    case, no dropped paths); paths past the cap, or past the phase-2 width
    under ``tail_compact = (b1, wdiv)``, read black, unless ``strict``, when
    any dropped path turns the radiance and every gradient to NaN.
    ``rec_attrs=False`` records 11 planes instead of 21 and replays slot by
    slot (K6), refetching the winner attributes. ``fused_step=True`` runs
    each record iteration as one launch of K11 (sweep, winner attributes
    and record step) with the same draws, so the radiance and the gradients
    are the two-launch iteration's; it takes neither ``tail_compact`` nor
    ``rec_attrs=False`` (``ValueError``, as the JAX package). Test hooks:
    ``u5_fn(i, width)`` -> [5, width] replaces the draws of absolute
    iteration ``i`` (record and replay), ``stats`` (a dict) collects the
    dropped count and the per-iteration occupancy."""
    check_static(scene, "the persistent-record gradient pair")
    cfg = _config(seed, max_depth, tmin, n_strips, n_iters, fused_step,
                  tail_compact, rec_attrs, strict, impl, u5_fn, stats,
                  scene.device)
    if scene.center.dtype != torch.float32:
        raise NotImplementedError(
            "only float32 gradients are ported (the record kernels are "
            f"float32); got {scene.center.dtype}")
    radiance, _ = _PersistTrace.apply(*scene[:5], origin, direction,
                                      scene.mat, cfg)
    return radiance


def persist_dropped_paths(scene: Scene, origin: torch.Tensor,
                          direction: torch.Tensor, seed: int,
                          max_depth: int = 16, tmin: float = DEFAULT_TMIN,
                          n_strips: int = 8, n_iters: int | None = None, *,
                          fused_step: bool = False,
                          tail_compact: tuple | None = None,
                          rec_attrs: bool = True, impl: str | None = None,
                          u5_fn: Callable | None = None) -> int:
    """Number of real paths the iteration cap or the boundary width drops
    (0 = exact; the default cap is exact by construction)."""
    cfg = _config(seed, max_depth, tmin, n_strips, n_iters, fused_step,
                  tail_compact, rec_attrs, False, impl, u5_fn, None,
                  scene.device)
    with torch.no_grad():
        _, _, dropped = _record_forward(
            Scene(*(x.detach() for x in scene)), origin.detach(),
            direction.detach(), cfg)
    return int(dropped)
