"""The fixed-depth record/replay kernels (K7), the bounce adjoint and the
attribute contraction of the gradient path.

Counterparts of ``raytracingweekend_jl_tpu/ops/pallas/grad_kernel.py``:

- :func:`record_shade_step` is K7a, ``_record_shade_kernel``
  (csrc/record_shade.cu): one bounce of the fixed-depth record, which reads
  the sweep winner's row of the attribute table itself (its plain entry
  :func:`record_shade_fetch_ref` is the gather, then
  :func:`record_shade_step_ref`).
- :func:`replay_bwd_step` is K7b, ``_replay_bwd_kernel``, and
  :func:`replay_bwd_fused` is K7c, ``_replay_bwd_fused_kernel``
  (csrc/replay_bwd.cu): the replay of one recorded bounce, and of the whole
  reverse walk in one launch.
- :func:`bounce_adjoint` is ``_bounce_adjoint``, the hand-written adjoint of
  one recorded bounce that every replay kernel runs. Its CUDA form is the
  ``__device__`` function of ``csrc/bounce_adjoint.cuh``, which the replay
  kernels K5, K6, K7b and K7c call; this is its plain version, expression
  for expression.
- :func:`dattr_contract` is ``_dattr_contract``: it sums the per-lane
  attribute cotangent rows onto the spheres. The JAX package ran it as an
  exact bf16-split one-hot matrix product on the TPU's matrix unit. Here it
  is plain PyTorch and deterministic on every device: a stable sort by
  sphere index, then exact 64-bit fixed-point prefix sums, so two runs give
  the same bits whatever the order of the card's threads.
- :func:`base_seed` is ``_base_seed``: the 32-bit key word of the record
  and replay draws.

Layout of the fixed-depth record (every tensor contiguous, lanes last):

- the state ``st`` float32 [13, R]: origin xyz, direction xyz, throughput
  rgb, radiance rgb, and the alive flag stored bit for bit
  (``st[12].view(torch.int32)``, 1 or 0);
- a record slot float32 [21, R]: the bounce's o, d, T, t, the alive flag
  bit for bit (``slot[10].view(torch.int32)``), then the winner's 10
  attributes; the record is [max_depth, 21, R], bounce-major.

Draws: 5 uniforms per lane and bounce, Philox4x32-10 keyed by ``(seed,
bounce)`` with the lane as the counter (:func:`rng.philox_uniforms`), in the
record kernel and again in the replay kernels; or injected (``u5`` [5, R],
``u5_all`` [max_depth, 5, R]).

Each K7 wrapper runs its plain version on CPU tensors, and on CUDA tensors
launches its kernel or raises; each counts its launches.
"""

from __future__ import annotations

import math

import torch

from ... import rng
from ..intersect import BIG
from . import build
from ..vecmath import inv_length
from .shade_kernel import gauss3, shade_core

#: Launches of K7a, K7b and K7c since the last reset (incremented only where
#: the kernel is launched).
record_launches = 0
replay_step_launches = 0
replay_fused_launches = 0

#: Planes of the fixed-depth state and of one record slot.
N_STATE = 13
N_REC = 21


def base_seed(seed: int) -> int:
    """The 32-bit Philox key word of a trace's draws."""
    return int(seed) & 0xFFFFFFFF


def bounce_adjoint(u5, vals, g3, cots, hitm, missm):
    """Adjoint of one recorded bounce (the transpose of the shade core plus
    the masked state advance).

    ``u5``: the bounce's 5 uniforms; ``vals``: the record's ``(o3, d3, T3,
    t)`` as 10 planes followed by the winner's 10 attribute planes (any
    sequence of 20 tensors); ``g3``: the radiance cotangent of the lane's
    strip; ``cots``: the carried cotangent of the bounce's outputs (zero
    where the chain was cut). ``hitm`` marks lanes whose state advanced
    (hit and continued), ``missm`` lanes that banked ``T * sky(d)``.
    Returns ``(cot9, dattr9)``: the cotangents of the bounce's input
    (origin, direction, throughput) and the rows for (center, radius,
    albedo, fuzz, ir)."""
    (ox, oy, oz, dx, dy, dz, Tx, Ty, Tz, t) = vals[:10]
    (acx, acy, acz, arr, aar, aag, aab, afz, air, amt) = vals[10:20]
    grx, gry, grz = g3
    (gox_, goy_, goz_, gdx_, gdy_, gdz_, gTx_, gTy_, gTz_) = cots
    w = torch.where
    hf = hitm.to(torch.float32)
    mf = missm.to(torch.float32)
    zero = torch.zeros_like(t)
    one = torch.ones_like(t)

    # ---- recompute forward intermediates (mirror of the shade core) ----
    ts = w(hitm, t, one)
    px = ox + ts * dx
    py = oy + ts * dy
    pz = oz + ts * dz
    inv_r = w(arr == 0, zero, 1.0 / w(arr == 0, one, arr))
    nox = (px - acx) * inv_r
    noy = (py - acy) * inv_r
    noz = (pz - acz) * inv_r
    ddn = dx * nox + dy * noy + dz * noz
    front = ddn < 0
    sgn = w(front, one, -one)
    nx, ny, nz = nox * sgn, noy * sgn, noz * sgn
    g0, g1, g2 = gauss3(u5[0], u5[1], u5[2], u5[3])
    gnorm = inv_length(g0 * g0 + g1 * g1 + g2 * g2)
    ux, uy, uz = g0 * gnorm, g1 * gnorm, g2 * gnorm
    xi = u5[4]
    # lambert
    lx, ly, lz = nx + ux, ny + uy, nz + uz
    lsq = lx * lx + ly * ly + lz * lz
    degen = lsq < 1e-5
    lno = inv_length(lsq)
    lamx = w(degen, nx, lx * lno)
    lamy = w(degen, ny, ly * lno)
    lamz = w(degen, nz, lz * lno)
    # metal
    dn = dx * nx + dy * ny + dz * nz
    mxv = (dx - 2.0 * dn * nx) + afz * ux
    myv = (dy - 2.0 * dn * ny) + afz * uy
    mzv = (dz - 2.0 * dn * nz) + afz * uz
    mno = inv_length(mxv * mxv + myv * myv + mzv * mzv)
    metx, mety, metz = mxv * mno, myv * mno, mzv * mno
    # dielectric
    safe_ir = w(air == 0, one, air)
    eta = w(front, 1.0 / safe_ir, safe_ir)
    ct = torch.clamp(-dn, max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    cannot = eta * sin_t > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    omc = 1.0 - ct
    omc2 = omc * omc
    schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
    choose_ref = cannot | (schlick > xi)
    rpx = eta * (dx + ct * nx)
    rpy = eta * (dy + ct * ny)
    rpz = eta * (dz + ct * nz)
    S = 1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)
    par = -torch.sqrt(torch.abs(S))
    fx = rpx + par * nx
    fy = rpy + par * ny
    fz_ = rpz + par * nz
    fno = inv_length(fx * fx + fy * fy + fz_ * fz_)
    frx, fry, frz = fx * fno, fy * fno, fz_ * fno
    is_lam = amt == 0
    is_met = amt == 1
    is_diel = ~is_lam & ~is_met

    # ---- adjoint ----
    nhf = 1.0 - hf
    # o' = hitm ? p : o ; d' = hitm ? nd : d ; T' = hitm ? T*A : T
    gpx, gpy, gpz = hf * gox_, hf * goy_, hf * goz_
    go_x, go_y, go_z = nhf * gox_, nhf * goy_, nhf * goz_
    gndx, gndy, gndz = hf * gdx_, hf * gdy_, hf * gdz_
    gd_x, gd_y, gd_z = nhf * gdx_, nhf * gdy_, nhf * gdz_
    gTx = gTx_ * w(hitm, aar, one)
    gTy = gTy_ * w(hitm, aag, one)
    gTz = gTz_ * w(hitm, aab, one)
    gA_r, gA_g, gA_b = hf * gTx_ * Tx, hf * gTy_ * Ty, hf * gTz_ * Tz
    # miss lanes banked rad += T * sky(d); sky = (1-0.5s, 1-0.3s, 1), s=0.5(dy+1)
    sth = 0.5 * (dy + 1.0)
    gTx = gTx + mf * grx * (1.0 - 0.5 * sth)
    gTy = gTy + mf * gry * (1.0 - 0.3 * sth)
    gTz = gTz + mf * grz
    g_sth = mf * (grx * Tx * (-0.5) + gry * Ty * (-0.3))
    gd_y = gd_y + 0.5 * g_sth

    # route the nd cotangent to the selected material branch
    lamf = is_lam.to(torch.float32)
    metf = is_met.to(torch.float32)
    dief = is_diel.to(torch.float32)
    glx_r, gly_r, glz_r = lamf * gndx, lamf * gndy, lamf * gndz
    gmx_r, gmy_r, gmz_r = metf * gndx, metf * gndy, metf * gndz
    gqx, gqy, gqz = dief * gndx, dief * gndy, dief * gndz

    # lambert: lam = degen ? n : l * lno (u constant)
    dotl = lamx * glx_r + lamy * gly_r + lamz * glz_r
    ndegf = 1.0 - degen.to(torch.float32)
    glx = ndegf * lno * (glx_r - lamx * dotl)
    gly = ndegf * lno * (gly_r - lamy * dotl)
    glz = ndegf * lno * (glz_r - lamz * dotl)
    degf = degen.to(torch.float32)
    gn_x = glx + degf * glx_r
    gn_y = gly + degf * gly_r
    gn_z = glz + degf * glz_r

    # metal: met = m * mno; m = refl + fz * u
    dotm = metx * gmx_r + mety * gmy_r + metz * gmz_r
    gmx = mno * (gmx_r - metx * dotm)
    gmy = mno * (gmy_r - mety * dotm)
    gmz = mno * (gmz_r - metz * dotm)
    gfz = ux * gmx + uy * gmy + uz * gmz
    grefl_x, grefl_y, grefl_z = gmx, gmy, gmz

    # dielectric select (coin/TIR detached)
    crf = choose_ref.to(torch.float32)
    grefl_x = grefl_x + crf * gqx
    grefl_y = grefl_y + crf * gqy
    grefl_z = grefl_z + crf * gqz
    ncrf = 1.0 - crf
    gfr_x, gfr_y, gfr_z = ncrf * gqx, ncrf * gqy, ncrf * gqz
    # fr = f * fno
    dotf = frx * gfr_x + fry * gfr_y + frz * gfr_z
    gf_x = fno * (gfr_x - frx * dotf)
    gf_y = fno * (gfr_y - fry * dotf)
    gf_z = fno * (gfr_z - frz * dotf)
    # f = rp + par * n
    grp_x, grp_y, grp_z = gf_x, gf_y, gf_z
    gpar = nx * gf_x + ny * gf_y + nz * gf_z
    gn_x = gn_x + par * gf_x
    gn_y = gn_y + par * gf_y
    gn_z = gn_z + par * gf_z
    # par = -sqrt(|S|)
    sgnS = w(S >= 0, one, -one)
    gS = gpar * (-sgnS * 0.5
                 * inv_length(torch.clamp(torch.abs(S), min=1e-12)))
    # S = 1 - rp.rp
    grp_x = grp_x - 2.0 * rpx * gS
    grp_y = grp_y - 2.0 * rpy * gS
    grp_z = grp_z - 2.0 * rpz * gS
    # rp = eta * (d + ct * n)
    geta = ((dx + ct * nx) * grp_x + (dy + ct * ny) * grp_y
            + (dz + ct * nz) * grp_z)
    gd_x = gd_x + eta * grp_x
    gd_y = gd_y + eta * grp_y
    gd_z = gd_z + eta * grp_z
    gct = eta * (nx * grp_x + ny * grp_y + nz * grp_z)
    gn_x = gn_x + eta * ct * grp_x
    gn_y = gn_y + eta * ct * grp_y
    gn_z = gn_z + eta * ct * grp_z
    # ct = min(-dn, 1): pass-through where -dn < 1
    gdn = w(-dn < 1.0, -gct, zero)
    # eta = front ? 1/safe_ir : safe_ir
    gir = w(front, -geta / (safe_ir * safe_ir), geta)
    # refl = d - 2 dn n (metal + diel-reflect)
    gdn = gdn - 2.0 * (nx * grefl_x + ny * grefl_y + nz * grefl_z)
    gn_x = gn_x - 2.0 * dn * grefl_x
    gn_y = gn_y - 2.0 * dn * grefl_y
    gn_z = gn_z - 2.0 * dn * grefl_z
    gd_x = gd_x + grefl_x
    gd_y = gd_y + grefl_y
    gd_z = gd_z + grefl_z
    # dn = d . n
    gd_x = gd_x + gdn * nx
    gd_y = gd_y + gdn * ny
    gd_z = gd_z + gdn * nz
    gn_x = gn_x + gdn * dx
    gn_y = gn_y + gdn * dy
    gn_z = gn_z + gdn * dz
    # n = sgn * n_out; n_out = (p - c) * inv_r
    gno_x, gno_y, gno_z = sgn * gn_x, sgn * gn_y, sgn * gn_z
    gpx = gpx + gno_x * inv_r
    gpy = gpy + gno_y * inv_r
    gpz = gpz + gno_z * inv_r
    gc_x = -gno_x * inv_r
    gc_y = -gno_y * inv_r
    gc_z = -gno_z * inv_r
    gr = -(nox * gno_x + noy * gno_y + noz * gno_z) * inv_r
    # p = o + ts d
    go_x = go_x + gpx
    go_y = go_y + gpy
    go_z = go_z + gpz
    gd_x = gd_x + ts * gpx
    gd_y = gd_y + ts * gpy
    gd_z = gd_z + ts * gpz
    gt = dx * gpx + dy * gpy + dz * gpz
    # implicit hit distance at the recorded winner
    psx, psy, psz = px - acx, py - acy, pz - acz
    pd = psx * dx + psy * dy + psz * dz
    big_pd = torch.abs(pd) > 1e-12
    ok = hitm & big_pd
    scl = w(ok, gt / w(big_pd, pd, one), zero)
    go_x = go_x - scl * psx
    go_y = go_y - scl * psy
    go_z = go_z - scl * psz
    gd_x = gd_x - scl * ts * psx
    gd_y = gd_y - scl * ts * psy
    gd_z = gd_z - scl * ts * psz
    gc_x = gc_x + scl * psx
    gc_y = gc_y + scl * psy
    gc_z = gc_z + scl * psz
    gr = gr + scl * arr
    return ((go_x, go_y, go_z, gd_x, gd_y, gd_z, gTx, gTy, gTz),
            (gc_x, gc_y, gc_z, gr, gA_r, gA_g, gA_b, gfz, gir))


# ---------------------------------------------------------------------------
# K7a: one bounce of the fixed-depth record
# ---------------------------------------------------------------------------

def record_shade_step_ref(t, attrs, st, rec_slot, seed: int, bounce: int,
                          u5: torch.Tensor | None = None) -> None:
    """Plain PyTorch K7a: one bounce after the masked sweep, updating the
    state ``st`` [13, R] in place and writing ``rec_slot`` [21, R].

    A live lane records its inputs (o, d, T, t, alive, the winner's ``attrs``
    [10, R]), banks ``T * sky(d)`` on a miss and advances on a hit; its new
    alive flag is the hit mask. A dead lane keeps its state and writes a zero
    record. ``u5`` [5, R] injects the uniforms; without it they are
    :func:`rng.philox_uniforms` of ``(seed, bounce)``, the kernel's own
    draws."""
    if u5 is None:
        u5 = rng.philox_uniforms(seed, bounce, t.shape[0], 5, device=t.device)
    alive = st[12].view(torch.int32) != 0
    ox, oy, oz, dx, dy, dz, tx, ty, tz, rx, ry, rz = st[0:12].unbind(0)
    rx, ry, rz, hitm, _, px, py, pz, ndx, ndy, ndz = shade_core(
        u5, t, attrs, ox, oy, oz, dx, dy, dz, tx, ty, tz, alive, rx, ry, rz)
    zero = torch.zeros_like(t)
    rec10 = torch.stack([ox, oy, oz, dx, dy, dz, tx, ty, tz, t])
    rec_slot[0:10] = torch.where(alive, rec10, zero)
    rec_slot[10].view(torch.int32).copy_(alive.to(torch.int32))
    rec_slot[11:21] = torch.where(alive, attrs, zero)
    w = torch.where
    st[0:12] = torch.stack([
        w(hitm, px, ox), w(hitm, py, oy), w(hitm, pz, oz),
        w(hitm, ndx, dx), w(hitm, ndy, dy), w(hitm, ndz, dz),
        w(hitm, tx * attrs[4], tx), w(hitm, ty * attrs[5], ty),
        w(hitm, tz * attrs[6], tz), rx, ry, rz])
    st[12].view(torch.int32).copy_(hitm.to(torch.int32))


def record_shade_fetch_ref(t, idx, amat, st, rec_slot, seed: int,
                           bounce: int, u5: torch.Tensor | None = None) -> None:
    """Plain PyTorch K7a as the record loop calls it: the winner fetch
    (``materials.fetch_attr_planes`` of the sweep's ``idx`` [R] into
    ``amat`` [N, 10]; sphere 0's row on a live lane that missed, where
    ``idx`` is 0), then :func:`record_shade_step_ref`."""
    from ..materials import fetch_attr_planes  # materials imports shade_kernel
    record_shade_step_ref(t, fetch_attr_planes(idx, amat), st, rec_slot, seed,
                          bounce, u5)


def record_shade_step(t, idx, amat, st, rec_slot, seed: int, bounce: int,
                      u5: torch.Tensor | None = None) -> None:
    """K7a: one record bounce with its winner fetch, in place (arguments as
    :func:`record_shade_fetch_ref`; ``idx`` int32). CPU tensors run the
    plain version; CUDA tensors launch the kernel or raise."""
    global record_launches
    if st.device.type == "cpu":
        return record_shade_fetch_ref(t, idx, amat, st, rec_slot, seed,
                                      bounce, u5)
    dev = st.device
    if dev.type != "cuda":
        raise ValueError(f"record_shade_step: unsupported device {dev}")
    R = st.shape[1] if st.dim() == 2 else -1
    f32 = torch.float32
    for name, x, dtype, shape in (
            ("t", t, f32, (R,)), ("idx", idx, torch.int32, (R,)),
            ("amat", amat, f32,
             (amat.shape[0] if amat.dim() == 2 else -1, 10)),
            ("st", st, f32, (N_STATE, R)),
            ("rec_slot", rec_slot, f32, (N_REC, R))):
        build.check_arg(f"record_shade_step: {name}", x, dtype, shape, dev)
    if u5 is not None:
        build.check_arg("record_shade_step: u5", u5, f32, (5, R), dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_record_shade(
            t.data_ptr(), idx.data_ptr(), amat.data_ptr(), st.data_ptr(),
            rec_slot.data_ptr(), None if u5 is None else u5.data_ptr(), R,
            base_seed(seed), bounce & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "record_shade_step")
    record_launches += 1


# ---------------------------------------------------------------------------
# K7b / K7c: the fixed-depth replay
# ---------------------------------------------------------------------------

def replay_bwd_step_ref(rec_slot, g3, cot, seed: int, bounce: int,
                        u5: torch.Tensor | None = None,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K7b: the adjoint of one recorded bounce ``rec_slot``
    [21, R]. ``g3`` [3, R] is the radiance cotangent, ``cot`` [9, R] the
    carried cotangent of the bounce's outputs, replaced in place by that of
    its inputs. Returns the winner-attribute cotangent rows [9, R] (written
    to ``out`` when given). A dead slot (alive flag 0) passes the carry
    through and gives zero rows. ``u5`` as in :func:`record_shade_step_ref`.
    """
    if u5 is None:
        u5 = rng.philox_uniforms(seed, bounce, rec_slot.shape[1], 5,
                                 device=rec_slot.device)
    alive = rec_slot[10].view(torch.int32) != 0
    hit = rec_slot[9] < BIG
    cot9, dattr9 = bounce_adjoint(
        u5, tuple(rec_slot[0:10]) + tuple(rec_slot[11:21]), tuple(g3),
        tuple(cot), hit & alive, ~hit & alive)
    cot.copy_(torch.where(alive, torch.stack(cot9), cot))
    d = torch.where(alive, torch.stack(dattr9), torch.zeros_like(cot))
    if out is None:
        return d
    out.copy_(d)
    return out


def replay_bwd_fused_ref(rec, g3, cot, seed: int,
                         u5_all: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch K7c: the reverse walk of the whole record ``rec``
    [K, 21, R], newest bounce first, updating ``cot`` [9, R] in place (the
    carry before the newest bounce, then after bounce 0). Returns the rows
    [K, 9, R]. ``u5_all`` [K, 5, R] injects the uniforms."""
    dattr = torch.empty((rec.shape[0], 9, rec.shape[2]), dtype=torch.float32,
                        device=rec.device)
    for b in reversed(range(rec.shape[0])):
        replay_bwd_step_ref(rec[b], g3, cot, seed, b,
                            None if u5_all is None else u5_all[b],
                            out=dattr[b])
    return dattr


#: K7c's group sizes: the threads of a warp that take one lane. G = 1 is
#: one thread per lane walking every slot; G = 2 stages a lane's next two
#: live slots at once and orders a block's lanes by depth.
REPLAY_GROUPS = (1, 2)

#: K7c's chunk: the group reads the alive flags of 32 slots at once.
REPLAY_CHUNK = 32


def replay_group(n_lanes: int, resident: dict) -> int:
    """K7c's G: 2 while the ``n_lanes * 2`` threads of the staged walk fit
    in one wave of the card (``resident[2]``, the threads it holds at once:
    the walk is one chain per lane, and a second wave would wait for the
    first), else 1 (the one-thread walk, the faster where the lanes fill
    the card)."""
    return 2 if n_lanes * 2 <= resident[2] else 1


def _check_group(what: str, group) -> None:
    if group not in REPLAY_GROUPS:
        raise ValueError(f"{what}: group must be one of {REPLAY_GROUPS}, "
                         f"got {group!r}")


def replay_bwd_fused_group_ref(rec, g3, cot, seed: int,
                               u5_all: torch.Tensor | None = None,
                               group: int = 1) -> torch.Tensor:
    """Plain mirror of K7c's schedule (arguments as
    :func:`replay_bwd_fused_ref`): the slots in chunks of
    :data:`REPLAY_CHUNK` from the newest; in each, thread ``k`` of a lane's
    ``group`` reads the flags of slots ``hi - k, hi - k - group, ...`` and
    writes the zero rows of the dead ones; then the lane's live slots are
    replayed newest first on the live lanes alone (a dead slot leaves the
    carry as it is, with no blend), in batches of ``group`` (the kernel
    stages a batch's forward halves at once and transposes them in order,
    which changes no value; nor does the order in which a block walks its
    lanes). The rows start as NaN, so a row nobody writes shows. Bitwise
    :func:`replay_bwd_fused_ref`. For the tests and ``chip_smoke.py``; no
    route runs it."""
    _check_group("replay_bwd_fused_group_ref", group)
    K, R = rec.shape[0], rec.shape[2]
    dattr = torch.full((K, 9, R), float("nan"), dtype=torch.float32,
                       device=rec.device)
    alive = rec[:, 10].view(torch.int32) != 0
    for hi in range(K - 1, -1, -REPLAY_CHUNK):
        lo = max(hi - REPLAY_CHUNK + 1, 0)
        for k in range(group):
            for s in range(hi - k, lo - 1, -group):
                dattr[s][:, ~alive[s]] = 0.0
        for s in range(hi, lo - 1, -1):
            live = torch.nonzero(alive[s])[:, 0]
            if live.numel() == 0:
                continue
            slot = rec[s][:, live]
            u5 = (rng.philox_uniforms(seed, s, live.numel(), 5,
                                      device=rec.device, lanes=live)
                  if u5_all is None else u5_all[s][:, live])
            hit = slot[9] < BIG
            cot9, d9 = bounce_adjoint(
                u5, tuple(slot[0:10]) + tuple(slot[11:21]),
                tuple(g3[:, live]), tuple(cot[:, live]), hit, ~hit)
            cot[:, live] = torch.stack(cot9)
            dattr[s][:, live] = torch.stack(d9)
    return dattr


def replay_bwd_fused_occupancy(group: int, device=None) -> dict:
    """``{"registers", "blocks_per_sm", "threads_per_block", "sm_count"}``
    of K7c at group size ``group`` (Philox draws) on ``device``, from the
    CUDA runtime."""
    import ctypes
    _check_group("replay_bwd_fused_occupancy", group)
    out = [ctypes.c_int(0) for _ in range(4)]
    with torch.cuda.device(device):
        err = build.load().rtw_replay_bwd_fused_occupancy(
            group, *(ctypes.byref(x) for x in out))
    build.check(err, "replay_bwd_fused occupancy")
    regs, blocks, threads, sms = (x.value for x in out)
    return {"registers": regs, "blocks_per_sm": blocks,
            "threads_per_block": threads, "sm_count": sms}


_RESIDENT = {}


def _resident_threads(device) -> dict:
    """``{G: threads of K7c at group size G that device holds at once}``
    (cached)."""
    key = torch.device(device).index
    if key not in _RESIDENT:
        _RESIDENT[key] = {}
        for g in REPLAY_GROUPS:
            o = replay_bwd_fused_occupancy(g, device)
            _RESIDENT[key][g] = (o["blocks_per_sm"] * o["threads_per_block"]
                                 * o["sm_count"])
    return _RESIDENT[key]


def _check_replay(what, g3, cot, dev) -> int:
    R = cot.shape[1] if cot.dim() == 2 else -1
    build.check_arg(f"{what}: g3", g3, torch.float32, (3, R), dev)
    build.check_arg(f"{what}: cot", cot, torch.float32, (9, R), dev)
    return R


def _launch_replay_step(what, launcher, rec_slot, g3, cot, seed, bounce,
                        u5, out) -> torch.Tensor:
    dev = cot.device
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    R = _check_replay(what, g3, cot, dev)
    f32 = torch.float32
    build.check_arg(f"{what}: rec_slot", rec_slot, f32, (N_REC, R), dev)
    if u5 is not None:
        build.check_arg(f"{what}: u5", u5, f32, (5, R), dev)
    if out is None:
        out = torch.empty((9, R), dtype=f32, device=dev)
    build.check_arg(f"{what}: out", out, f32, (9, R), dev)
    with torch.cuda.device(dev):
        err = getattr(build.load(), launcher)(
            rec_slot.data_ptr(), g3.data_ptr(), cot.data_ptr(), out.data_ptr(),
            None if u5 is None else u5.data_ptr(), R, base_seed(seed),
            bounce & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
    build.check(err, what)
    return out


def replay_bwd_step(rec_slot, g3, cot, seed: int, bounce: int,
                    u5: torch.Tensor | None = None,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """K7b: one reverse bounce (arguments as :func:`replay_bwd_step_ref`).
    A lane issues every load at once, its alive flag with them: a dead
    one then writes its zero rows and stops. CPU tensors run the plain
    version."""
    global replay_step_launches
    if cot.device.type == "cpu":
        return replay_bwd_step_ref(rec_slot, g3, cot, seed, bounce, u5, out)
    out = _launch_replay_step("replay_bwd_step", "rtw_replay_bwd_step",
                              rec_slot, g3, cot, seed, bounce, u5, out)
    replay_step_launches += 1
    return out


def replay_bwd_step_previous(rec_slot, g3, cot, seed: int, bounce: int,
                             u5: torch.Tensor | None = None,
                             out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel K7b was before its redesign
    (``replay_bwd_step_previous_kernel``: the carry and radiance cotangent
    loaded with the flag, the record after it, 128-thread blocks), kept as
    the card's reference for K7b; no route runs it and its launches are not
    counted. CUDA tensors only."""
    return _launch_replay_step("replay_bwd_step_previous",
                               "rtw_replay_bwd_step_previous", rec_slot, g3,
                               cot, seed, bounce, u5, out)


def replay_bwd_step_occupancy(device=None) -> dict:
    """``{"registers", "blocks_per_sm", "threads_per_block"}`` of K7b
    (Philox draws) on ``device``, from the CUDA runtime."""
    import ctypes
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = build.load().rtw_replay_bwd_step_occupancy(
            *(ctypes.byref(x) for x in out))
    build.check(err, "replay_bwd_step occupancy")
    regs, blocks, threads = (x.value for x in out)
    return {"registers": regs, "blocks_per_sm": blocks,
            "threads_per_block": threads}


def replay_bwd_fused(rec, g3, cot, seed: int,
                     u5_all: torch.Tensor | None = None,
                     group: int | None = None) -> torch.Tensor:
    """K7c: the whole reverse walk in one launch (arguments as
    :func:`replay_bwd_fused_ref`), ``group`` threads per lane (by default
    :func:`replay_group`'s; :func:`replay_bwd_fused_group_ref` mirrors the
    schedule at every group size). CPU tensors run the plain version."""
    global replay_fused_launches
    if cot.device.type == "cpu":
        return replay_bwd_fused_ref(rec, g3, cot, seed, u5_all)
    dev = cot.device
    if dev.type != "cuda":
        raise ValueError(f"replay_bwd_fused: unsupported device {dev}")
    R = _check_replay("replay_bwd_fused", g3, cot, dev)
    K = rec.shape[0] if rec.dim() == 3 else -1
    f32 = torch.float32
    build.check_arg("replay_bwd_fused: rec", rec, f32, (K, N_REC, R), dev)
    if u5_all is not None:
        build.check_arg("replay_bwd_fused: u5_all", u5_all, f32, (K, 5, R),
                        dev)
    if group is None:
        group = replay_group(R, _resident_threads(dev))
    _check_group("replay_bwd_fused", group)
    dattr = torch.empty((K, 9, R), dtype=f32, device=dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_replay_bwd_fused(
            rec.data_ptr(), g3.data_ptr(), cot.data_ptr(), dattr.data_ptr(),
            None if u5_all is None else u5_all.data_ptr(), R, K,
            base_seed(seed), group, torch.cuda.current_stream().cuda_stream)
    build.check(err, "replay_bwd_fused")
    replay_fused_launches += 1
    return dattr


#: The most float64 values of a contraction taken in one block: fields are
#: summed together while fields x lanes stays within it (one set of launches
#: for the block, which matters where the lanes are few: a bounce of a
#: small trace), one field at a time beyond it (a flagship phase's 11.8M
#: lanes), so the working set stays that of one field. Every block size
#: gives the same bits.
CONTRACT_BLOCK = 1 << 24


def dattr_contract(dattr: torch.Tensor, idx: torch.Tensor,
                   n: int) -> torch.Tensor:
    """Sum per-lane attribute cotangent rows onto the spheres:
    ``out[s, j] = sum over (k, w) with idx[k, w] == s of dattr[k, j, w]``.

    ``dattr`` [K, F, W] float32 or float64 (K record slots, F fields: 9 for
    the attribute rows center, radius, albedo, fuzz, ir), ``idx`` [K, W]
    int32 winner indices; returns ``[n, F]`` in ``dattr``'s type.
    Deterministic on every device: lanes are stable-sorted by sphere, each
    field is scaled by a power of two so that every partial sum fits 62
    bits, rounded to int64 and prefix-summed exactly, and each sphere's
    segment is a difference of two prefix sums. A value's rounding error is
    at most the field's largest magnitude times 2^-(61 - ceil(log2(K*W +
    1))), 2^-37 at the flagship's ~1.2e7 lanes per phase. A field with a
    non-finite value comes out NaN for every sphere, as the JAX package's
    matrix product gives. The scales stay on the device: no host sync.
    Fields go in blocks of :data:`CONTRACT_BLOCK` values."""
    device = dattr.device
    n_f = dattr.shape[1]
    keys = idx.reshape(-1).to(torch.int64)
    m = keys.numel()
    out = torch.zeros((n_f, n), dtype=torch.float64, device=device)
    if m == 0:
        return out.T.to(dattr.dtype)
    keys, perm = torch.sort(keys, stable=True)
    bounds = torch.searchsorted(
        keys, torch.arange(n + 1, dtype=torch.int64, device=device))
    rows = dattr.transpose(0, 1).reshape(n_f, m)
    bits = 61 - math.ceil(math.log2(m + 1))
    step = max(1, CONTRACT_BLOCK // m)
    for j0 in range(0, n_f, step):
        v = rows[j0:j0 + step][:, perm].to(torch.float64)  # [F_block, m]
        finite = torch.isfinite(v)
        v = torch.where(finite, v, torch.zeros_like(v))
        _, e = torch.frexp(v.abs().amax(dim=1, keepdim=True))
        scale = torch.ldexp(torch.ones_like(e, dtype=torch.float64), bits - e)
        q = torch.round(v * scale).to(torch.int64)
        # One prefix sum per field: on an H100 a row-wise cumsum over a few
        # long rows runs as one slow kernel (13.5 ms for two rows of 7.3M
        # lanes; 0.12 ms for one row of 16.6M alone). Integer sums give the
        # same bits either way.
        cs = torch.zeros((q.shape[0], m + 1), dtype=torch.int64,
                         device=device)
        for j in range(q.shape[0]):
            torch.cumsum(q[j], 0, out=cs[j, 1:])
        seg = cs[:, bounds[1:]] - cs[:, bounds[:-1]]
        col = seg.to(torch.float64) / scale
        out[j0:j0 + step] = torch.where(finite.all(1, keepdim=True), col,
                                        torch.full_like(col, float("nan")))
    return out.T.to(dattr.dtype).contiguous()


def dattr_contract_stages(dattrs: list, idxs: list, n: int) -> torch.Tensor:
    """:func:`dattr_contract` of several records of different widths as
    one: ``dattrs[i]`` [K_i, F, W_i] with ``idxs[i]`` [K_i, W_i]. One record
    goes straight through (no copy); several are laid end to end in the
    order ``dattr_contract`` reads one, so a single sort and prefix sum
    covers them all. A lane whose index is negative adds nothing."""
    if len(dattrs) == 1:
        return dattr_contract(dattrs[0], idxs[0], n)
    n_f = dattrs[0].shape[1]
    rows = torch.cat([d.transpose(0, 1).reshape(n_f, -1) for d in dattrs], 1)
    keys = torch.cat([i.reshape(-1) for i in idxs])
    return dattr_contract(rows[None], keys[None], n)

