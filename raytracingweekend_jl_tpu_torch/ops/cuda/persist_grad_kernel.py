"""K4 — the persistent record step —, K11 — the same step fused with its
masked sweep and winner fetch — and K5/K6 — the replay kernels —
(csrc/persist_record.cu, csrc/persist_replay.cu) with their plain versions.

Counterparts of ``raytracingweekend_jl_tpu/ops/pallas/persist_grad_kernel.py``:
``_advance_record_bank`` and ``_persist_record_kernel`` (K4),
``_persist_record_fused_kernel`` (K11, ``fused_step=True``),
``_replay_iter_core`` and ``_persist_replay_fused_kernel`` (K5),
``_persist_replay_kernel`` (K6).

Layout (every tensor contiguous, lanes last):

- ``sf`` float32 [9, W]: origin xyz, direction xyz, throughput rgb;
- ``si`` int32 [3, W]: bounce, strip, active;
- ``rad`` float32 [3S, W]: plane ``3*c + ch`` is channel ``ch`` of the
  radiance the lane's strip ``c`` banked;
- ``strips`` float32 [6S, W]: the camera ray (o xyz, d xyz) of each strip;
- a record slot float32 [21, W] (or [11, W], the lean form without the
  winner attributes): o, d, T, t, the packed flags
  ``act | hit<<1 | term<<2 | regen<<3 | strip<<4`` stored bit for bit
  (``slot[10].view(torch.int32)``), then the 10 winner attributes. A phase's
  record is [n_slots, 21, W], slot-major, beside its winner indices
  ``rec_idx`` int32 [n_slots, W]: K4 and K6 take the indices and the
  [N, 10] attribute table and read a winner's row themselves.

Draws: 5 uniforms per lane and iteration, Philox4x32-10 keyed by
``(seed, absolute iteration)`` with the lane as the counter
(:func:`rng.philox_uniforms`), in the record kernel and again in the replay
kernels; or injected (``u5`` [5, W], ``u5_all`` [n_slots, 5, W]).

Each wrapper runs its plain version on CPU tensors, and on CUDA tensors
launches its kernel or raises; each counts its launches.
"""

from __future__ import annotations

import torch

from ... import rng
from ..intersect import BIG
from . import build
from .grad_kernel import bounce_adjoint
from .intersect_kernel import sweep_masked_ref
from .shade_kernel import shade_core

#: Launches of K4, K11, K5 and K6 since the last reset (incremented only
#: where the kernel is launched).
record_launches = 0
record_fused_launches = 0
replay_fused_launches = 0
replay_step_launches = 0

#: Flag-plane bits (the record kernel writes, the replay kernels read).
F_ACT, F_HIT, F_TERM, F_REGEN = 1, 2, 4, 8
F_STRIP_SHIFT = 4

N_REC = 21
N_REC_LEAN = 11


def flags_of(slot: torch.Tensor) -> torch.Tensor:
    """The int32 flag plane of a record slot [n_rec, W]."""
    return slot[10].view(torch.int32)


# ---------------------------------------------------------------------------
# K4: one record iteration
# ---------------------------------------------------------------------------

def advance_record_bank(u5, t, attrs, strips, sf, si, rad, max_depth: int):
    """The persistent state machine of one record iteration, for every lane
    (``_advance_record_bank``): shade the swept bounce, bank a missing ray's
    ``T * sky(d)`` into its strip's radiance planes, advance continuing
    rays, refill terminated lanes from their next strip.

    Returns ``(rec10, flags, sf, si, rad)``: the record's o, d, T, t planes
    [10, W] and int32 flags [W] of this iteration's inputs, and the new
    state and radiance (new tensors)."""
    S = strips.shape[0] // 6
    ox, oy, oz, dx, dy, dz, tx, ty, tz = sf.unbind(0)
    bo, sp, act = si.unbind(0)
    active = act != 0
    zf = torch.zeros_like(t)
    bkr, bkg, bkb, hitm, miss, px, py, pz, ndx, ndy, ndz = shade_core(
        u5, t, attrs, ox, oy, oz, dx, dy, dz, tx, ty, tz, active, zf, zf, zf)

    newb = bo + 1
    cont = hitm & (newb < max_depth)
    exhausted = hitm & ~cont
    term = miss | exhausted
    nxt_s = sp + 1
    can = term & (nxt_s < S)

    i32 = torch.int32
    flags = (act + (hitm.to(i32) << 1) + (term.to(i32) << 2)
             + (can.to(i32) << 3) + (sp << F_STRIP_SHIFT))
    rec10 = torch.stack([ox, oy, oz, dx, dy, dz, tx, ty, tz, t])

    # Bank the terminating ray's radiance into its strip's planes.
    rad = rad.clone()
    bank = (bkr, bkg, bkb)
    for c in range(S):
        sel = miss & (sp == c)
        for j in range(3):
            rad[3 * c + j] = torch.where(sel, bank[j], rad[3 * c + j])

    # Advance on continue.
    ox = torch.where(cont, px, ox)
    oy = torch.where(cont, py, oy)
    oz = torch.where(cont, pz, oz)
    dx = torch.where(cont, ndx, dx)
    dy = torch.where(cont, ndy, dy)
    dz = torch.where(cont, ndz, dz)
    tx = torch.where(cont, tx * attrs[4], tx)
    ty = torch.where(cont, ty * attrs[5], ty)
    tz = torch.where(cont, tz * attrs[6], tz)
    bo = torch.where(cont, newb, bo)

    # Refill from the next strip's camera ray.
    o_d = [ox, oy, oz, dx, dy, dz]
    for c in range(1, S):
        sel = can & (nxt_s == c)
        o_d = [torch.where(sel, strips[6 * c + j], o_d[j]) for j in range(6)]
    one = torch.ones_like(t)
    tx = torch.where(can, one, tx)
    ty = torch.where(can, one, ty)
    tz = torch.where(can, one, tz)
    bo = torch.where(can, torch.zeros_like(bo), bo)
    sp = torch.where(can, nxt_s, sp)
    act = ((active & ~term) | can).to(i32)
    return (rec10, flags, torch.stack(o_d + [tx, ty, tz]),
            torch.stack([bo, sp, act]), rad)


def persist_record_step_ref(t, attrs, strips, sf, si, rad, rec_slot,
                            seed: int, iteration: int, max_depth: int,
                            u5: torch.Tensor | None = None) -> None:
    """Plain PyTorch K4: one record iteration, updating ``sf``, ``si`` and
    ``rad`` in place and writing ``rec_slot`` [21 or 11, W]. Inactive lanes
    keep their state and write a zero record. ``u5`` [5, W] injects the
    uniforms; without it they are :func:`rng.philox_uniforms` of
    ``(seed, iteration)``, the kernel's own draws."""
    n = t.shape[0]
    if u5 is None:
        u5 = rng.philox_uniforms(seed, iteration, n, 5, device=t.device)
    rec10, flags, sf2, si2, rad2 = advance_record_bank(
        u5, t, attrs, strips, sf, si, rad, max_depth)
    active = si[2] != 0
    zero = torch.zeros_like(t)
    rec_slot[0:10] = torch.where(active, rec10, zero)
    flags_of(rec_slot).copy_(torch.where(active, flags, torch.zeros_like(flags)))
    if rec_slot.shape[0] == N_REC:
        rec_slot[11:21] = torch.where(active, attrs, zero)
    sf.copy_(torch.where(active, sf2, sf))
    si.copy_(torch.where(active, si2, si))
    rad.copy_(torch.where(active, rad2, rad))


def persist_record_fetch_ref(t, idx, amat, strips, sf, si, rad, rec_slot,
                             seed: int, iteration: int, max_depth: int,
                             u5: torch.Tensor | None = None) -> None:
    """Plain PyTorch K4 as the record loop calls it: the winner fetch
    (``materials.fetch_attr_planes`` of the sweep's ``idx`` [W] into
    ``amat`` [N, 10]; sphere 0's row on a miss, where ``idx`` is 0), then
    :func:`persist_record_step_ref`."""
    from ..materials import fetch_attr_planes  # materials imports shade_kernel
    persist_record_step_ref(t, fetch_attr_planes(idx, amat), strips, sf, si,
                            rad, rec_slot, seed, iteration, max_depth, u5)


_check = build.check_arg


def persist_record_step(t, idx, amat, strips, sf, si, rad, rec_slot,
                        seed: int, iteration: int, max_depth: int,
                        u5: torch.Tensor | None = None) -> None:
    """K4: one record iteration with its winner fetch, in place (arguments
    as :func:`persist_record_fetch_ref`; ``idx`` int32). CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    global record_launches
    if sf.device.type == "cpu":
        return persist_record_fetch_ref(t, idx, amat, strips, sf, si, rad,
                                        rec_slot, seed, iteration, max_depth,
                                        u5)
    dev = sf.device
    if dev.type != "cuda":
        raise ValueError(f"persist_record_step: unsupported device {dev}")
    W = sf.shape[1]
    S = strips.shape[0] // 6
    n_rec = rec_slot.shape[0]
    f32, i32 = torch.float32, torch.int32
    if n_rec not in (N_REC, N_REC_LEAN) or strips.shape[0] != 6 * S or S < 1:
        raise ValueError(f"persist_record_step: record slot has {n_rec} "
                         f"planes, strips {strips.shape[0]}")
    for name, x, dt, shape in (
            ("t", t, f32, (W,)), ("idx", idx, i32, (W,)),
            ("amat", amat, f32,
             (amat.shape[0] if amat.dim() == 2 else -1, 10)),
            ("strips", strips, f32, (6 * S, W)), ("sf", sf, f32, (9, W)),
            ("si", si, i32, (3, W)), ("rad", rad, f32, (3 * S, W)),
            ("rec_slot", rec_slot, f32, (n_rec, W))):
        _check(f"persist_record_step: {name}", x, dt, shape, dev)
    if u5 is not None:
        _check("persist_record_step: u5", u5, f32, (5, W), dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_persist_record(
            t.data_ptr(), idx.data_ptr(), amat.data_ptr(), strips.data_ptr(),
            sf.data_ptr(),
            si.data_ptr(), rad.data_ptr(), rec_slot.data_ptr(), n_rec,
            None if u5 is None else u5.data_ptr(), W, S, int(max_depth),
            seed & 0xFFFFFFFF, iteration & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "persist_record_step")
    record_launches += 1


# ---------------------------------------------------------------------------
# K11: one record iteration in one launch (sweep, fetch, record)
# ---------------------------------------------------------------------------

def persist_record_fused_step_ref(strips, sf, si, rad, rec_slot, idx_out,
                                  spheres, amat, seed: int, iteration: int,
                                  max_depth: int, tmin: float,
                                  u5: torch.Tensor | None = None) -> None:
    """Plain PyTorch K11: the masked sweep of the lanes' current rays
    (``sweep_masked_ref`` against ``spheres`` [N, 4] from
    ``intersect_kernel.sphere_consts``), the winners' rows of ``amat``
    [N, 10] (zeros on a miss), then :func:`persist_record_step_ref`. Updates
    ``sf``, ``si`` and ``rad`` in place, writes the 21-plane ``rec_slot``
    and the winners to ``idx_out`` [W] int32 (0 on dead lanes and misses).
    On every hit lane the record equals that of the two-launch iteration
    (K3, then K4 with its fetch); a miss lane records zero attributes where
    K4 reads sphere 0's row, which nothing downstream reads."""
    t, idx = sweep_masked_ref(sf[0:6], si[2], spheres, tmin)
    rows = amat.T[:, idx.long()]
    attrs = torch.where(t < BIG, rows, torch.zeros_like(rows))
    persist_record_step_ref(t, attrs, strips, sf, si, rad, rec_slot, seed,
                            iteration, max_depth, u5)
    idx_out.copy_(idx)


#: K11's lanes (threads) per block.
FUSED_THREADS = 128


def persist_record_fused_compact_ref(strips, sf, si, rad, rec_slot, idx_out,
                                     spheres, amat, seed: int,
                                     iteration: int, max_depth: int,
                                     tmin: float,
                                     u5: torch.Tensor | None = None,
                                     block: int = FUSED_THREADS,
                                     parts: int = 0) -> None:
    """Plain mirror of K11's schedule, in place (arguments as
    :func:`persist_record_fused_step_ref`): dead lanes write a zero record
    and winner 0; each block of ``block`` lanes packs its live lanes in lane
    order and sweeps them with :func:`intersect_kernel.sweep_split_ref` at
    ``parts`` threads per lane, or with ``parts=0`` at the block's P
    (``mega_kernel.block_parts``, K3's rule); then the packed lanes read
    their winner's row by index (zeros on a miss), draw with their lane id
    as the Philox counter and take K4's state machine
    (:func:`advance_record_bank`) on their own columns. Bitwise
    :func:`persist_record_fused_step_ref`. For the tests and
    ``chip_smoke.py``; no route runs it."""
    from .intersect_kernel import _check_parts, _winner_rows, sweep_split_ref
    from .mega_kernel import block_parts
    _check_parts("persist_record_fused_compact_ref", parts, allow_zero=True)
    W = sf.shape[1]
    live = si[2] != 0
    rec_slot[:, ~live] = 0.0
    idx_out[~live] = 0
    ids = torch.nonzero(live)[:, 0]
    if ids.numel() == 0:
        return
    blk = ids // block
    if parts:
        p_lane = torch.full_like(ids, parts)
    else:
        n_live = torch.bincount(blk, minlength=-(-W // block))
        p_lane = block_parts(n_live, spheres.shape[0], block)[blk]
    t = torch.empty(ids.shape, dtype=sf.dtype, device=sf.device)
    idx = torch.empty(ids.shape, dtype=torch.int32, device=sf.device)
    for p in torch.unique(p_lane).tolist():
        sel = p_lane == p
        t[sel], idx[sel] = sweep_split_ref(sf[0:6, ids[sel]].contiguous(),
                                           spheres, p, tmin)
    u5 = (rng.philox_uniforms(seed, iteration, ids.numel(), 5,
                              device=sf.device, lanes=ids)
          if u5 is None else u5[:, ids])
    rec10, flags, sf2, si2, rad2 = advance_record_bank(
        u5, t, _winner_rows(t, idx, amat), strips[:, ids], sf[:, ids],
        si[:, ids], rad[:, ids], max_depth)
    rec_slot[0:10, ids] = rec10
    flags_of(rec_slot)[ids] = flags
    rec_slot[11:21, ids] = _winner_rows(t, idx, amat)
    sf[:, ids], si[:, ids], rad[:, ids] = sf2, si2, rad2
    idx_out[ids] = idx


def persist_record_fused_occupancy(n_spheres: int, device=None) -> dict:
    """``{"registers", "blocks_per_sm", "threads_per_block", "sm_count"}``
    of K11 on ``device`` (the current CUDA device by default), from the
    CUDA runtime, at its block size and shared memory for ``n_spheres``."""
    import ctypes
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = build.load().rtw_persist_record_fused_occupancy(
            n_spheres, *(ctypes.byref(x) for x in out))
    build.check(err, "persist_record_fused occupancy")
    regs, blocks, sms = (x.value for x in out)
    return {"registers": regs, "blocks_per_sm": blocks,
            "threads_per_block": FUSED_THREADS, "sm_count": sms}


def persist_record_fused_step(strips, sf, si, rad, rec_slot, idx_out,
                              spheres, amat, seed: int, iteration: int,
                              max_depth: int, tmin: float,
                              u5: torch.Tensor | None = None) -> None:
    """K11: one record iteration in one launch (arguments as
    :func:`persist_record_fused_step_ref`), each block's live lanes packed
    and swept by the P threads its block takes from its live count
    (:func:`persist_record_fused_compact_ref` mirrors the schedule at every
    P). CPU tensors run the plain version; CUDA tensors launch the kernel
    or raise."""
    global record_fused_launches
    if sf.device.type == "cpu":
        return persist_record_fused_step_ref(strips, sf, si, rad, rec_slot,
                                             idx_out, spheres, amat, seed,
                                             iteration, max_depth, tmin, u5)
    dev = sf.device
    if dev.type != "cuda":
        raise ValueError(f"persist_record_fused_step: unsupported device {dev}")
    W = sf.shape[1]
    S = strips.shape[0] // 6
    n_sph = spheres.shape[0]
    f32, i32 = torch.float32, torch.int32
    if strips.shape[0] != 6 * S or S < 1:
        raise ValueError(f"persist_record_fused_step: strips has "
                         f"{strips.shape[0]} planes, not 6S")
    for name, x, dt, shape in (
            ("strips", strips, f32, (6 * S, W)), ("sf", sf, f32, (9, W)),
            ("si", si, i32, (3, W)), ("rad", rad, f32, (3 * S, W)),
            ("rec_slot", rec_slot, f32, (N_REC, W)),
            ("idx_out", idx_out, i32, (W,)),
            ("spheres", spheres, f32, (n_sph, 4)),
            ("amat", amat, f32, (n_sph, 10))):
        _check(f"persist_record_fused_step: {name}", x, dt, shape, dev)
    if u5 is not None:
        _check("persist_record_fused_step: u5", u5, f32, (5, W), dev)
    # the packed lane ids, winners and warp offsets take the rest
    table = 227 * 1024 - 4 * (3 * FUSED_THREADS + FUSED_THREADS // 32 + 1)
    if n_sph * 16 > table:
        raise ValueError(f"persist_record_fused_step: {n_sph} spheres exceed "
                         f"the kernel's shared-memory table "
                         f"(max {table // 16})")
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_persist_record_fused(
            strips.data_ptr(), sf.data_ptr(), si.data_ptr(), rad.data_ptr(),
            rec_slot.data_ptr(), idx_out.data_ptr(), spheres.data_ptr(),
            amat.data_ptr(), n_sph, float(tmin),
            None if u5 is None else u5.data_ptr(), W, S, int(max_depth),
            seed & 0xFFFFFFFF, iteration & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "persist_record_fused_step")
    record_fused_launches += 1


# ---------------------------------------------------------------------------
# K5 / K6: replay
# ---------------------------------------------------------------------------

def replay_iter_core(u5, rec10, attrs, flags, cot, grad_strips, dep):
    """One reverse iteration for every lane (``_replay_iter_core``): decode
    the flags, deposit the carried (o, d) cotangent into the strip a
    regeneration started, cut the chain at terminations and inactive lanes,
    take the radiance cotangent of the lane's strip, run the bounce adjoint.

    ``rec10`` [10, W] (o, d, T, t), ``attrs`` [10, W], ``flags`` int32 [W],
    ``cot`` [9, W], ``grad_strips`` [3S, W], ``dep`` [6S, W]. Returns
    ``(cot9, dattr9, dep)`` as new [9, W], [9, W] and [6S, W] tensors."""
    S = grad_strips.shape[0] // 3
    act = (flags & F_ACT) != 0
    hit = (flags & F_HIT) != 0
    term = (flags & F_TERM) != 0
    regen = (flags & F_REGEN) != 0
    sp = flags >> F_STRIP_SHIFT

    dep = dep.clone()
    for c in range(1, S):
        sel = regen & (sp + 1 == c)
        dep[6 * c:6 * c + 6] = torch.where(sel, cot[0:6], dep[6 * c:6 * c + 6])
    czero = term | ~act
    cot = torch.where(czero, torch.zeros_like(cot), cot)
    g3 = torch.zeros_like(grad_strips[0:3])
    for c in range(S):
        g3 = torch.where(sp == c, grad_strips[3 * c:3 * c + 3], g3)
    adv = hit & ~term
    inject = act & ~hit
    cot9, dattr9 = bounce_adjoint(u5, tuple(rec10) + tuple(attrs), tuple(g3),
                                  tuple(cot), adv, inject)
    return torch.stack(cot9), torch.stack(dattr9), dep


def _replay_slot(u5, slot, attrs, cot, dep, grad_strips):
    """Plain reverse step of one record slot, in place on ``cot``/``dep``;
    returns the slot's dattr [9, W] (zero on inactive lanes)."""
    flags = flags_of(slot)
    act = (flags & F_ACT) != 0
    cot9, dattr9, dep2 = replay_iter_core(u5, slot[0:10], attrs, flags, cot,
                                          grad_strips, dep)
    cot.copy_(torch.where(act, cot9, cot))
    dep.copy_(torch.where(act, dep2, dep))
    return torch.where(act, dattr9, torch.zeros_like(dattr9))


def persist_replay_fused_ref(cot, dep, rec, grad_strips, i0: int, seed: int,
                             u5_all: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Plain PyTorch K5: the reverse walk of a whole record phase ``rec``
    [n_slots, 21, W] (slot ``s`` is absolute iteration ``i0 + s``), newest
    slot first, updating ``cot`` [9, W] and ``dep`` [6S, W] in place.
    Returns ``dattr`` [n_slots, 9, W]. ``u5_all`` [n_slots, 5, W] injects
    the uniforms; without it they are :func:`rng.philox_uniforms` of
    ``(seed, i0 + slot)``, the record kernel's own draws."""
    n_slots, W = rec.shape[0], rec.shape[2]
    dattr = torch.empty((n_slots, 9, W), dtype=torch.float32,
                        device=rec.device)
    for s in reversed(range(n_slots)):
        u5 = (u5_all[s] if u5_all is not None else
              rng.philox_uniforms(seed, i0 + s, W, 5, device=rec.device))
        dattr[s] = _replay_slot(u5, rec[s], rec[s, 11:21], cot, dep,
                                grad_strips)
    return dattr


def persist_replay_step_ref(cot, dep, rec_slot, grad_strips, seed: int,
                            iteration: int, u5: torch.Tensor | None = None,
                            attrs: torch.Tensor | None = None,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K6: one reverse slot, in place on ``cot``/``dep``.
    ``rec_slot`` is [21, W], or [11, W] with the winner attributes given as
    ``attrs`` [10, W]. Returns ``dattr`` [9, W] (written to ``out`` when
    given)."""
    W = rec_slot.shape[1]
    if u5 is None:
        u5 = rng.philox_uniforms(seed, iteration, W, 5, device=rec_slot.device)
    a = rec_slot[11:21] if attrs is None else attrs
    d = _replay_slot(u5, rec_slot, a, cot, dep, grad_strips)
    if out is None:
        return d
    out.copy_(d)
    return out


def persist_replay_step_fetch_ref(cot, dep, rec_slot, idx, amat, grad_strips,
                                  seed: int, iteration: int,
                                  u5: torch.Tensor | None = None,
                                  out: torch.Tensor | None = None
                                  ) -> torch.Tensor:
    """Plain PyTorch K6 as the lean replay calls it: the winner fetch
    (``materials.fetch_attr_planes`` of the slot's ``idx`` [W] int32 into
    ``amat`` [N, 10]; sphere 0's row on a miss), then
    :func:`persist_replay_step_ref` of the lean record's slot ``rec_slot``
    [11, W] (other arguments as there)."""
    from ..materials import fetch_attr_planes  # materials imports shade_kernel
    return persist_replay_step_ref(cot, dep, rec_slot, grad_strips, seed,
                                   iteration, u5,
                                   fetch_attr_planes(idx, amat), out)


def _check_replay(what, cot, dep, grad_strips, dev):
    W = cot.shape[1] if cot.dim() == 2 else -1
    S = grad_strips.shape[0] // 3
    if S < 1 or grad_strips.shape[0] != 3 * S:
        raise ValueError(f"{what}: grad_strips must be [3S, W]")
    f32 = torch.float32
    _check(f"{what}: cot", cot, f32, (9, W), dev)
    _check(f"{what}: dep", dep, f32, (6 * S, W), dev)
    _check(f"{what}: grad_strips", grad_strips, f32, (3 * S, W), dev)
    return W, S


def persist_replay_fused(cot, dep, rec, grad_strips, i0: int, seed: int,
                         u5_all: torch.Tensor | None = None) -> torch.Tensor:
    """K5: the whole reverse walk of one record phase in one launch
    (arguments as :func:`persist_replay_fused_ref`). CPU tensors run the
    plain version."""
    global replay_fused_launches
    if cot.device.type == "cpu":
        return persist_replay_fused_ref(cot, dep, rec, grad_strips, i0, seed,
                                        u5_all)
    dev = cot.device
    if dev.type != "cuda":
        raise ValueError(f"persist_replay_fused: unsupported device {dev}")
    W, S = _check_replay("persist_replay_fused", cot, dep, grad_strips, dev)
    n_slots = rec.shape[0] if rec.dim() == 3 else -1
    _check("persist_replay_fused: rec", rec, torch.float32,
           (n_slots, N_REC, W), dev)
    if u5_all is not None:
        _check("persist_replay_fused: u5_all", u5_all, torch.float32,
               (n_slots, 5, W), dev)
    dattr = torch.empty((n_slots, 9, W), dtype=torch.float32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_persist_replay_fused(
            cot.data_ptr(), dep.data_ptr(), rec.data_ptr(),
            grad_strips.data_ptr(), dattr.data_ptr(),
            None if u5_all is None else u5_all.data_ptr(), W, S, n_slots,
            seed & 0xFFFFFFFF, i0 & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "persist_replay_fused")
    replay_fused_launches += 1
    return dattr


def persist_replay_step(cot, dep, rec_slot, idx, amat, grad_strips,
                        seed: int, iteration: int,
                        u5: torch.Tensor | None = None,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """K6: one reverse slot with its winner fetch (arguments as
    :func:`persist_replay_step_fetch_ref`). CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise."""
    global replay_step_launches
    if cot.device.type == "cpu":
        return persist_replay_step_fetch_ref(cot, dep, rec_slot, idx, amat,
                                             grad_strips, seed, iteration,
                                             u5, out)
    dev = cot.device
    if dev.type != "cuda":
        raise ValueError(f"persist_replay_step: unsupported device {dev}")
    W, S = _check_replay("persist_replay_step", cot, dep, grad_strips, dev)
    f32 = torch.float32
    _check("persist_replay_step: rec_slot", rec_slot, f32, (N_REC_LEAN, W),
           dev)
    _check("persist_replay_step: idx", idx, torch.int32, (W,), dev)
    _check("persist_replay_step: amat", amat, f32,
           (amat.shape[0] if amat.dim() == 2 else -1, 10), dev)
    if u5 is not None:
        _check("persist_replay_step: u5", u5, f32, (5, W), dev)
    if out is None:
        out = torch.empty((9, W), dtype=f32, device=dev)
    _check("persist_replay_step: out", out, f32, (9, W), dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_persist_replay_step(
            cot.data_ptr(), dep.data_ptr(), rec_slot.data_ptr(),
            idx.data_ptr(), amat.data_ptr(), grad_strips.data_ptr(),
            out.data_ptr(), None if u5 is None else u5.data_ptr(), W, S,
            seed & 0xFFFFFFFF, iteration & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "persist_replay_step")
    replay_step_launches += 1
    return out
