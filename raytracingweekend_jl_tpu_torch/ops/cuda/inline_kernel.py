"""K8 — the whole small-image render in one launch (csrc/inline.cu) — and
its plain version.

Counterpart of ``raytracingweekend_jl_tpu/ops/pallas/inline_kernel.py``
(``_inline_kernel`` with its sweep ``_sweep_select``, launched by
``trace_inline``). Every (pixel, sample) path gets a lane and the bounce loop
runs inside the kernel: each bounce sweeps the sphere table, then shades the
winner with the shared core (:func:`shade_kernel.shade_core`,
csrc/shade_core.cuh) and advances a hit. The plain version keeps the JAX
package's running select of the winner's attributes
(:func:`sweep_select_ref`); the kernel keeps the winner's index and reads its
attributes after the sweep (:func:`sweep_index_ref`,
:func:`attrs_by_index`: the same bits, zeros on a miss).

The kernel is persistent: its warps take lanes from a work queue as their
paths end, so a warp stays full while lanes remain. A lane's arithmetic
depends only on its lane id and bounce, so any schedule gives the same bits;
:func:`trace_inline_queue_ref` is the plain mirror of that schedule, and
:func:`warp_live_share` reads what the one-thread-per-lane loop issued.

Draws: 5 uniforms per lane and bounce, Philox4x32-10 keyed by ``(seed,
bounce)`` with the lane as the counter (:func:`rng.philox_uniforms`), or
injected as ``rng_u5`` [max_depth, 5, R].

:func:`trace_inline` launches the CUDA kernel on CUDA tensors and runs
:func:`trace_inline_ref` on CPU tensors; nothing else.
"""

from __future__ import annotations

import ctypes

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

#: Threads per block of the kernel (``RTW_K8_THREADS``, csrc/inline.cu).
THREADS = 128


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


def _hits(planes, ox, oy, oz, dx, dy, dz, tmin: float):
    """Yield ``(s, t, ok)`` per sphere ``s`` in table order: the half-b
    quadratic's root in K1's expanded form and its hit mask, before the
    strict ``t < best`` test (which the caller applies)."""
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    for s in range(planes.shape[1]):
        cx, cy, cz, ck = planes[0:4, s]
        cd = cx * dx + cy * dy + cz * dz
        oc = cx * ox + cy * oy + cz * oz
        hb = od - cd
        c = oo - 2.0 * oc + ck
        disc = hb * hb - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = -hb - sq
        t = torch.where(r1 >= tmin, r1, -hb + sq)
        yield s, t, (disc > 0) & (t >= tmin)


def sweep_select_ref(planes, ox, oy, oz, dx, dy, dz, tmin: float):
    """``_sweep_select`` written out: one sphere at a time, a running
    ``(t, 10 attributes)`` select updated on a strict ``t < best``.
    Returns ``(t [R], attrs [10, R])``: ``BIG`` and zeros on a miss."""
    w = torch.where
    bt = torch.full_like(ox, BIG)
    sel = [torch.zeros_like(ox)] * 10
    for s, t, hit in _hits(planes, ox, oy, oz, dx, dy, dz, tmin):
        ok = hit & (t < bt)
        bt = w(ok, t, bt)
        vals = tuple(planes[0:3, s]) + tuple(planes[4:11, s])
        sel = [w(ok, v, a) for v, a in zip(vals, sel)]
    return bt, torch.stack(sel)


def sweep_index_ref(planes, ox, oy, oz, dx, dy, dz, tmin: float):
    """The kernel's sweep: the same tests, keeping the winner's index.
    Returns ``(t [R], idx [R] int64)``, ``(BIG, -1)`` on a miss."""
    bt = torch.full_like(ox, BIG)
    bi = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    for s, t, hit in _hits(planes, ox, oy, oz, dx, dy, dz, tmin):
        ok = hit & (t < bt)
        bt = torch.where(ok, t, bt)
        bi = torch.where(ok, s, bi)
    return bt, bi


def attrs_by_index(planes, idx) -> torch.Tensor:
    """The winners' 10 attributes [10, R] (cx, cy, cz, then the table's 7)
    read by index after the sweep, as the kernel reads them; zeros where
    ``idx`` is -1 (a miss), which is what the running select leaves."""
    rows = torch.cat([planes[0:3], planes[4:11]])
    got = rows[:, idx.clamp(min=0)]
    return torch.where(idx >= 0, got, torch.zeros_like(got))


def _bounce(u5, bt, attrs, state, alive):
    """Shade one bounce and advance the hits: ``(state, hitm)``, ``state``
    the 12 planes (o, d, T, radiance)."""
    ox, oy, oz, dx, dy, dz, tx, ty, tz, rx, ry, rz = state
    rx, ry, rz, hitm, _, px, py, pz, ndx, ndy, ndz = shade_core(
        u5, bt, attrs, ox, oy, oz, dx, dy, dz, tx, ty, tz, alive, rx, ry, rz)
    w = torch.where
    return (w(hitm, px, ox), w(hitm, py, oy), w(hitm, pz, oz),
            w(hitm, ndx, dx), w(hitm, ndy, dy), w(hitm, ndz, dz),
            w(hitm, tx * attrs[4], tx), w(hitm, ty * attrs[5], ty),
            w(hitm, tz * attrs[6], tz), rx, ry, rz), hitm


def _start(origin, direction):
    f32 = torch.float32
    o, d = origin.to(f32).T, direction.to(f32).T
    one, zero = torch.ones_like(o[0]), torch.zeros_like(o[0])
    return (*o, *d, one, one, one, zero, zero, zero)


def trace_inline_ref(scene: Scene, origin: torch.Tensor,
                     direction: torch.Tensor, seed: int,
                     max_depth: int = 16, tmin: float = DEFAULT_TMIN,
                     rng_u5: torch.Tensor | None = None,
                     stats: dict | None = None) -> torch.Tensor:
    """Plain PyTorch K8: radiance ``[R, 3]`` of rays ``origin``/``direction``
    [R, 3] over ``max_depth`` bounces.

    Each bounce is ``_sweep_select`` written out (:func:`sweep_select_ref`),
    then the shade core, and a hit advances. A miss banks the sky and ends
    the lane's path; a path alive after the last bounce reads black.
    ``stats`` (a dict) collects the live lanes of each bounce (``"live"``)
    and the bounces each lane ran (``"bounces"``, [R] int64)."""
    planes = sphere_planes(scene)
    state = _start(origin, direction)
    R = state[0].shape[0]
    alive = torch.ones(R, dtype=torch.bool, device=state[0].device)
    ran = torch.zeros(R, dtype=torch.int64, device=alive.device)
    for b in range(max_depth):
        if stats is not None:
            stats.setdefault("live", []).append(int(alive.sum()))
        ran += alive
        bt, attrs = sweep_select_ref(planes, *state[0:6], tmin)
        u5 = _uniforms(rng_u5, seed, b, R, alive.device)
        state, alive = _bounce(u5, bt, attrs, state, alive)
    if stats is not None:
        stats["bounces"] = ran
    return torch.stack(state[9:12], dim=1)


def warp_live_share(bounces: torch.Tensor, warp: int = 32) -> dict:
    """The one-thread-per-lane loop's issue: ``bounces`` [R] are the
    bounces each lane ran; a warp of ``warp`` consecutive lanes runs as
    many as its longest lane. Returns the live lane-bounces, the lane-bounce
    slots the warps issue, and their ratio (``live_share``)."""
    pad = (-bounces.shape[0]) % warp
    b = torch.cat([bounces, bounces.new_zeros(pad)]).reshape(-1, warp)
    live, issued = int(b.sum()), int(b.max(1).values.sum()) * warp
    return {"lane_bounces": live, "issued_slots": issued,
            "live_share": live / issued if issued else 0.0}


def trace_inline_queue_ref(scene: Scene, origin: torch.Tensor,
                           direction: torch.Tensor, seed: int,
                           max_depth: int = 16, tmin: float = DEFAULT_TMIN,
                           rng_u5: torch.Tensor | None = None, *,
                           n_warps: int, refill: int = 1,
                           stats: dict | None = None) -> torch.Tensor:
    """Plain mirror of the kernel's schedule: ``n_warps`` warps of 32 slots
    loop; at the top of each round every warp with at least ``refill`` idle
    slots (and a queue that may hold lanes) gives them the next lane ids in
    slot order from one counter, warp after warp; then every slot that
    holds a lane runs that lane's next bounce (the index sweep
    :func:`sweep_index_ref`, draws keyed by the slot's own ``(lane,
    bounce)``) and a finished lane stores its radiance and frees its slot.
    Arguments and result as :func:`trace_inline_ref`, bit for bit.
    ``stats`` gets ``lane_bounces``, ``issued_slots`` (32 per warp round in
    which any slot runs a bounce), their ratio ``live_share``, ``rounds``
    and ``refills`` (the counter's atomic adds)."""
    planes = sphere_planes(scene)
    rays = _start(origin, direction)
    R = rays[0].shape[0]
    dev = rays[0].device
    S = 32 * n_warps
    lane_of = torch.full((S,), -1, dtype=torch.int64, device=dev)
    bounce = torch.zeros(S, dtype=torch.int64, device=dev)
    state = tuple(torch.zeros(S, dtype=torch.float32, device=dev)
                  for _ in range(12))
    more = torch.ones(n_warps, dtype=torch.bool, device=dev)
    out = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    head, counts = 0, dict(lane_bounces=0, issued_slots=0, rounds=0,
                           refills=0)
    while True:
        idle = (lane_of < 0).reshape(n_warps, 32)
        n_idle = idle.sum(1)
        go = more & (n_idle >= refill)
        take = torch.where(go, n_idle, 0)
        base = head + torch.cumsum(take, 0) - take
        head += int(take.sum())
        counts["refills"] += int(go.sum())
        more = torch.where(go, base + n_idle < R, more)
        j = (base[:, None] + torch.cumsum(idle.long(), 1) - 1).reshape(-1)
        new = (idle & go[:, None]).reshape(-1) & (j < R)
        if new.any():
            lane_of = torch.where(new, j, lane_of)
            bounce = torch.where(new, 0, bounce)
            jl = j.clamp(max=R - 1)
            state = tuple(torch.where(new, x[jl], y)
                          for x, y in zip(rays, state))
        held = lane_of >= 0
        if not held.any():
            break
        counts["rounds"] += 1
        run = held & (bounce < max_depth)
        counts["lane_bounces"] += int(run.sum())
        counts["issued_slots"] += 32 * int(
            held.reshape(n_warps, 32).any(1).sum())
        ids = lane_of.clamp(min=0)
        u5 = torch.zeros((5, S), dtype=torch.float32, device=dev)
        for b in bounce[run].unique().tolist():
            at = run & (bounce == b)
            u5[:, at] = (rng_u5[b][:, ids[at]] if rng_u5 is not None
                         else rng.philox_uniforms(seed, b, int(at.sum()), 5,
                                                  device=dev,
                                                  lanes=ids[at]))
        bt, bi = sweep_index_ref(planes, *state[0:6], tmin)
        state, hitm = _bounce(u5, bt, attrs_by_index(planes, bi), state, run)
        bounce = bounce + hitm.long()
        done = held & ~(hitm & (bounce < max_depth))
        out[lane_of[done]] = torch.stack(state[9:12], 1)[done]
        lane_of = torch.where(done, -1, lane_of)
    if stats is not None:
        stats.update(counts, live_share=(counts["lane_bounces"]
                                         / max(counts["issued_slots"], 1)))
    return out


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
    head = torch.zeros(1, dtype=torch.int32, device=dev)  # the lane queue
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_inline(
            rays.data_ptr(), planes.data_ptr(), rad.data_ptr(),
            None if rng_u5 is None else rng_u5.data_ptr(), head.data_ptr(),
            R, n_sph, int(max_depth), float(tmin), seed & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "trace_inline")
    launches += 1
    return rad.T


def occupancy(n_spheres: int, device=None) -> dict:
    """K8's registers, resident blocks per SM with ``n_spheres`` spheres
    staged, the card's SMs, and the resident warps the launch fills."""
    regs, per_sm, sms = (ctypes.c_int() for _ in range(3))
    with torch.cuda.device(device):
        build.check(build.load().rtw_inline_occupancy(
            int(n_spheres), ctypes.byref(regs), ctypes.byref(per_sm),
            ctypes.byref(sms)), "inline occupancy")
    return {"registers": regs.value, "blocks_per_sm": per_sm.value,
            "sms": sms.value, "threads": THREADS,
            "warps": per_sm.value * sms.value * THREADS // 32}
