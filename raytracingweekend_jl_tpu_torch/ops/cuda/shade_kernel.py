"""K2 — one strided persistent iteration (csrc/shade_strided.cu) and its
plain version.

Counterpart of ``raytracingweekend_jl_tpu/ops/pallas/shade_kernel.py``
(``_shade_strided_kernel`` with ``_shade_core``, ``_uniforms``, ``_gauss3``
and ``_concentric``). :func:`shade_core` is the shading core that K2 and the
gradient path's record step share (csrc/shade_core.cuh). Each lane serves
``k`` pixels spaced ``n_lanes`` apart; when a pixel has all its samples the
lane folds its accumulator into that pixel's strip buffer and switches to
its next pixel in place.

State layout (all ``[planes, n_lanes]``, contiguous, updated in place):

- ``fstate`` float32 [12]: origin xyz, direction xyz, throughput rgb,
  current-pixel accumulator rgb;
- ``istate`` int32 [7]: bounce, sample, strip, px, py, active, lane_lim
  (the lane's last sample id);
- ``buf`` float32 [3k]: plane ``3*c + ch`` holds channel ``ch`` of the pixel
  the lane served in strip ``c``.

K2 takes the sweep's winner index and the [N, 10] attribute table and
fetches the winner's row itself: :func:`shade_strided_step` launches the
CUDA kernel on CUDA tensors and runs :func:`shade_strided_fetch_ref` (the
gather, then :func:`shade_strided_step_ref`) on CPU tensors; nothing else.
:func:`shade_strided_pass` is K2 as the strided loop's captured chunk runs
it, its per-call scalars read from a parameter block on the card, and
:func:`strided_chunk_end` the chunk's end (the any-lane-active flag).
K2m (``shade_strided_motion_kernel`` in csrc/shade_strided.cu, K2's lane
with a time), a moving scene's step, runs through
the same wrappers on a 13-plane ``fstate`` (plane 12 the ray's shutter
time) and a 13-column table (``materials.motion_attr_mat``): the winner's
centre moved to the ray's time, a new ray's time the 10th uniform
(:func:`shade_strided_step_ref`).

K9 — one pixel-pinned persistent iteration (csrc/shade_pinned.cu), the
counterpart of ``_shade_kernel`` with ``_shade_math`` — keeps one lane per
pixel. Its state (``[planes, R]``, contiguous, updated in place):
``fstate`` float32 [12] (origin, direction, throughput, the pixel's
radiance sum) and ``istate`` int32 [3] (bounce, sample, active). K9 takes
the sweep's winner index and the [N, 10] attribute table, fetches the
winner's row itself and touches only the active lanes:
:func:`shade_and_regen_fetch` launches it on CUDA tensors and runs
:func:`shade_and_regen_fetch_ref` (the gather, then
:func:`shade_and_regen_ref`) on CPU tensors. :func:`shade_and_regen`
launches the kernel before that redesign, which takes ten gathered
attribute planes and runs every lane; no route runs it, and the card
checks hold K9 and the megakernel K12 against it bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..intersect import BIG
from ..vecmath import inv_length
from ... import rng
from ...camera import film_point
from ...utils.profiling import sync
from . import build

#: Number of K2 launches since the last reset (incremented only where the
#: kernel is launched).
launches = 0

#: Number of K9 launches (:func:`shade_and_regen_fetch`) since the last
#: reset.
pinned_launches = 0

#: Number of K2m launches (:func:`shade_strided_step` on a moving scene's
#: state) since the last reset.
motion_launches = 0

N_FSTATE = 12
#: K2m's float state: K2's 12 planes, then the ray's shutter time.
N_FSTATE_MOTION = 13
N_ISTATE = 7
N_PINNED_ISTATE = 3

#: The strided loop's parameter block (int32 [N_PARAMS], csrc/shade_strided.cu
#: ``RTW_P_*``): the call's Philox seed (its bits), first sample and p_end,
#: the iteration of the chunk's first pass, and the loop's iteration limit.
PARAMS_SEED, PARAMS_FIRST_SAMPLE, PARAMS_END, PARAMS_BASE, PARAMS_LIMIT = \
    range(5)
N_PARAMS = 5

_TWO_PI = np.float32(2.0 * np.pi)
_QP = np.float32(np.pi / 4)
_HP = np.float32(np.pi / 2)


def pack_camera_consts(cam, image_width: int, image_height: int,
                       device=None) -> torch.Tensor:
    """``[21]`` float32: origin, lower_left, horizontal, vertical, u, v,
    lens_radius, 1/W, 1/H (reference camera frame, src/camera.jl:1-10)."""
    f32 = torch.float32
    device = cam.origin.device if device is None else device
    inv = torch.tensor([np.float32(1.0) / np.float32(image_width),
                        np.float32(1.0) / np.float32(image_height)], dtype=f32)
    parts = [cam.origin, cam.lower_left_corner, cam.horizontal, cam.vertical,
             cam.u, cam.v, cam.lens_radius.reshape(1)]
    host = []
    for p in parts:  # each copy between host and card waits for the card
        with sync("camera_consts"):
            host.append(p.to(f32).cpu())
    with sync("camera_consts"):
        return torch.cat(host + [inv]).to(device)


def _concentric(u: torch.Tensor, v: torch.Tensor):
    a = 2.0 * u - 1.0
    b = 2.0 * v - 1.0
    use_a = torch.abs(a) > torch.abs(b)
    r = torch.where(use_a, a, b)
    one = torch.ones_like(a)
    safe_a = torch.where(a == 0, one, a)
    safe_b = torch.where(b == 0, one, b)
    theta = torch.where(use_a, float(_QP) * (b / safe_a),
                        float(_HP) - float(_QP) * (a / safe_b))
    theta = torch.where((a == 0) & (b == 0), torch.zeros_like(theta), theta)
    return r * torch.cos(theta), r * torch.sin(theta)


def camera_ray(cam: torch.Tensor, fu, fv, centered, u9) -> tuple:
    """The thin-lens camera ray (src/camera.jl) of film point ``(fu, fv)``
    and the uniforms ``u9[5:9]`` (jitter, lens), built as
    ``camera.make_rays`` builds it: the jitter times 1/W and 1/H (none where
    ``centered``), ``make_rays``' sums, ``1 / sqrt`` of ``(x*x + y*y) +
    z*z``. Returns ``(ox, oy, oz, dx, dy, dz)``; the kernels'
    ``rtw_lens_disk`` and ``rtw_camera_ray`` (csrc/shade_core.cuh)."""
    zero = torch.zeros((), dtype=torch.float32, device=fu.device)
    s_f = fu + torch.where(centered, zero, u9[5] * cam[19])
    t_f = fv + torch.where(centered, zero, u9[6] * cam[20])
    da, db = _concentric(u9[7], u9[8])
    rdx, rdy = cam[18] * da, cam[18] * db
    offx = rdx * cam[12] + rdy * cam[15]
    offy = rdx * cam[13] + rdy * cam[16]
    offz = rdx * cam[14] + rdy * cam[17]
    gdx = cam[3] + s_f * cam[6] + t_f * cam[9] - cam[0] - offx
    gdy = cam[4] + s_f * cam[7] + t_f * cam[10] - cam[1] - offy
    gdz = cam[5] + s_f * cam[8] + t_f * cam[11] - cam[2] - offz
    inv = inv_length(gdx * gdx + gdy * gdy + gdz * gdz)
    return (cam[0] + offx, cam[1] + offy, cam[2] + offz, gdx * inv,
            gdy * inv, gdz * inv)


def gauss3(u0, u1, u2, u3):
    """Three standard normals by Box-Muller from four uniforms
    (``shade_kernel._gauss3``)."""
    r0g = torch.sqrt(-2.0 * torch.log(torch.clamp(u0, min=1e-12)))
    r1g = torch.sqrt(-2.0 * torch.log(torch.clamp(u2, min=1e-12)))
    a0 = float(_TWO_PI) * u1
    a1 = float(_TWO_PI) * u3
    return r0g * torch.cos(a0), r0g * torch.sin(a0), r1g * torch.cos(a1)


def shade_core(u, t, attrs, ox, oy, oz, dx, dy, dz, tx, ty, tz, active,
               rx, ry, rz):
    """Plain version of the shading core that K2 and K4 share
    (csrc/shade_core.cuh; the TPU's ``shade_kernel._shade_core``).

    ``u`` holds at least 5 uniform planes (4 for the unit vector, 1 for the
    Schlick coin); ``attrs`` the winner's [10, R] attributes. Returns
    ``(rx, ry, rz, hitm, miss, px, py, pz, ndx, ndy, ndz)``: the radiance
    accumulators with ``T * sky(d)`` banked on a miss, the hit and miss
    masks, the hit point and the material's scatter direction."""
    (acx, acy, acz, arr, _, _, _, afz, air, amt) = attrs.unbind(0)
    zero = torch.zeros_like(t)
    one = torch.ones_like(t)

    hitm = (t < BIG) & active
    miss = active & ~hitm

    # Sky on miss (src/ray_color.jl:1-6,35-37).
    st = 0.5 * (dy + 1.0)
    skyr = (1.0 - st) + st * 0.5
    skyg = (1.0 - st) + st * 0.7
    skyb = (1.0 - st) + st * 1.0
    rx = torch.where(miss, rx + tx * skyr, rx)
    ry = torch.where(miss, ry + ty * skyg, ry)
    rz = torch.where(miss, rz + tz * skyb, rz)

    # Hit point and facing normal (src/hit.jl:3,6-10,32-34).
    ts = torch.where(hitm, t, one)
    px = ox + ts * dx
    py = oy + ts * dy
    pz = oz + ts * dz
    inv_r = torch.where(arr == 0, zero, 1.0 / torch.where(arr == 0, one, arr))
    nx = (px - acx) * inv_r
    ny = (py - acy) * inv_r
    nz = (pz - acz) * inv_r
    front = (dx * nx + dy * ny + dz * nz) < 0
    sgn = torch.where(front, one, -one)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

    # Three normals by Box-Muller -> a uniform unit vector.
    g0, g1, g2 = gauss3(u[0], u[1], u[2], u[3])
    gn = inv_length(g0 * g0 + g1 * g1 + g2 * g2)
    ux, uy, uz = g0 * gn, g1 * gn, g2 * gn
    xi = u[4]

    # Lambertian (src/material.jl:13-23).
    lx, ly, lz = nx + ux, ny + uy, nz + uz
    lsq = lx * lx + ly * ly + lz * lz
    degen = lsq < 1e-5
    lno = inv_length(lsq)
    lamx = torch.where(degen, nx, lx * lno)
    lamy = torch.where(degen, ny, ly * lno)
    lamz = torch.where(degen, nz, lz * lno)

    # Metal (src/material.jl:25-34).
    dn = dx * nx + dy * ny + dz * nz
    refx = dx - 2.0 * dn * nx
    refy = dy - 2.0 * dn * ny
    refz = dz - 2.0 * dn * nz
    mx, my, mz = refx + afz * ux, refy + afz * uy, refz + afz * uz
    mno = inv_length(mx * mx + my * my + mz * mz)
    metx, mety, metz = mx * mno, my * mno, mz * mno

    # Dielectric (src/material.jl:41-53, src/light.jl:12-25).
    safe_ir = torch.where(air == 0, one, air)
    eta = torch.where(front, 1.0 / safe_ir, safe_ir)
    cos_t = torch.clamp(-(dx * nx + dy * ny + dz * nz), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = eta * sin_t > 1.0
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    schlick = r0 + (1.0 - r0) * omc2 * omc2 * omc
    choose_reflect = cannot | (schlick > xi)
    rpx = eta * (dx + cos_t * nx)
    rpy = eta * (dy + cos_t * ny)
    rpz = eta * (dz + cos_t * nz)
    par = -torch.sqrt(torch.abs(1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)))
    fx, fy, fz = rpx + par * nx, rpy + par * ny, rpz + par * nz
    fno = inv_length(fx * fx + fy * fy + fz * fz)
    dielx = torch.where(choose_reflect, refx, fx * fno)
    diely = torch.where(choose_reflect, refy, fy * fno)
    dielz = torch.where(choose_reflect, refz, fz * fno)

    # Material dispatch (0 lambert / 1 metal / 2 dielectric).
    is_lam = amt == 0
    is_met = amt == 1
    ndx = torch.where(is_lam, lamx, torch.where(is_met, metx, dielx))
    ndy = torch.where(is_lam, lamy, torch.where(is_met, mety, diely))
    ndz = torch.where(is_lam, lamz, torch.where(is_met, metz, dielz))
    return rx, ry, rz, hitm, miss, px, py, pz, ndx, ndy, ndz


def shade_strided_step_ref(fstate: torch.Tensor, istate: torch.Tensor,
                           buf: torch.Tensor, t: torch.Tensor,
                           attrs: torch.Tensor, cam: torch.Tensor,
                           geom: tuple, seed: int, iteration: int,
                           first_sample: int, max_depth: int,
                           u9: torch.Tensor | None = None) -> None:
    """Plain PyTorch K2, updating ``fstate``, ``istate`` and ``buf`` in place.

    ``t`` [R] and ``attrs`` [10, R] are the sweep's winner distance and
    attributes (``materials.attr_mat`` column order); ``cam`` the [21]
    camera constants; ``geom`` = (W, H, dpx, dpy, p_end) with
    ``dpx, dpy = n_lanes % W, n_lanes // W``. ``u9`` [9, R] injects the
    uniforms; without it they are :func:`rng.philox_uniforms` of
    ``(seed, iteration)``, the kernel's own draws.

    K2m, a moving scene's step (csrc/shade_strided.cu), is this step
    on a 13-plane ``fstate`` (plane 12 the ray's shutter time) with 13
    attribute rows (the last three the winner's motion) and 10 uniforms: the
    winner's centre is moved to ``c0 + time * m`` before shading, and a lane
    that starts a sample takes the 10th uniform as its new time."""
    n = t.shape[0]
    k = buf.shape[0] // 3
    W, H, dpx, dpy, p_end = (int(g) for g in geom)
    moving = fstate.shape[0] == N_FSTATE_MOTION
    if u9 is None:
        u9 = rng.philox_uniforms(seed, iteration, n, 10 if moving else 9,
                                 device=t.device)
    ox, oy, oz, dx, dy, dz, tx, ty, tz, cx, cy, cz = \
        fstate[:N_FSTATE].unbind(0)
    if moving:
        time = fstate[N_FSTATE]
        attrs = torch.cat([attrs[0:3] + time * attrs[10:13], attrs[3:10]])
    bo, sa, strip, pxi, pyi, ac, lane_lim = istate.unbind(0)
    aar, aag, aab = attrs[4], attrs[5], attrs[6]
    active = ac != 0
    zero = torch.zeros_like(t)
    one = torch.ones_like(t)

    cx, cy, cz, hitm, miss, px, py, pz, ndx, ndy, ndz = shade_core(
        u9, t, attrs, ox, oy, oz, dx, dy, dz, tx, ty, tz, active, cx, cy, cz)

    # Continue bouncing.
    newb = bo + 1
    cont = hitm & (newb < max_depth)
    ox = torch.where(cont, px, ox)
    oy = torch.where(cont, py, oy)
    oz = torch.where(cont, pz, oz)
    dx = torch.where(cont, ndx, dx)
    dy = torch.where(cont, ndy, dy)
    dz = torch.where(cont, ndz, dz)
    tx = torch.where(cont, tx * aar, tx)
    ty = torch.where(cont, ty * aag, ty)
    tz = torch.where(cont, tz * aab, tz)
    bo = torch.where(cont, newb, bo)

    # Ray finished: next sample of this pixel, or fold and switch pixels.
    need = miss | (hitm & ~cont)
    nxt = sa + 1
    same_pix = need & (nxt <= lane_lim)
    done_pix = need & ~same_pix
    fold = torch.nonzero(done_pix & (strip < k)).squeeze(1)
    if fold.numel():
        rows = 3 * strip[fold].long()
        for ch, acc in enumerate((cx, cy, cz)):
            buf[rows + ch, fold] += acc[fold]
    cx = torch.where(done_pix, zero, cx)
    cy = torch.where(done_pix, zero, cy)
    cz = torch.where(done_pix, zero, cz)

    # Advance pixel coordinates by n_lanes (one carry).
    npx = pxi + dpx
    carry = (npx >= W).to(torch.int32)
    npx = npx - W * carry
    npy = pyi + dpy + carry
    new_strip = strip + 1
    pxi = torch.where(done_pix, npx, pxi)
    pyi = torch.where(done_pix, npy, pyi)
    strip = torch.where(done_pix, new_strip, strip)
    sa = torch.where(done_pix, torch.full_like(sa, first_sample),
                     torch.where(same_pix, nxt, sa))
    valid_new = (npy * W + npx) < p_end
    start = same_pix | (done_pix & (new_strip < k) & valid_new)

    # Thin-lens camera ray for lanes that start a sample, built as
    # init_strided_state builds a strip-0 ray.
    ray = camera_ray(cam, film_point((pxi + 1).to(torch.float32), W),
                     film_point((H - 1 - pyi).to(torch.float32), H),
                     sa == 0, u9)
    ox, oy, oz, dx, dy, dz = (torch.where(start, r, x) for r, x in
                              zip(ray, (ox, oy, oz, dx, dy, dz)))
    tx = torch.where(start, one, tx)
    ty = torch.where(start, one, ty)
    tz = torch.where(start, one, tz)
    bo = torch.where(start, torch.zeros_like(bo), bo)
    active = (active & ~need) | start

    if moving:
        fstate[N_FSTATE].copy_(torch.where(start, u9[9], time))
    fstate[:N_FSTATE].copy_(torch.stack([ox, oy, oz, dx, dy, dz, tx, ty, tz,
                                         cx, cy, cz]))
    istate[:6].copy_(torch.stack([bo, sa, strip, pxi, pyi,
                                  active.to(torch.int32)]))


def shade_strided_fetch_ref(fstate: torch.Tensor, istate: torch.Tensor,
                            buf: torch.Tensor, t: torch.Tensor,
                            idx: torch.Tensor, amat: torch.Tensor,
                            cam: torch.Tensor, geom: tuple, seed: int,
                            iteration: int, first_sample: int, max_depth: int,
                            u9: torch.Tensor | None = None) -> None:
    """Plain PyTorch K2 as the strided loop calls it: the winner fetch
    (``materials.fetch_attr_planes`` of the sweep's ``idx`` [R] into
    ``amat`` [N, 10]), then :func:`shade_strided_step_ref`."""
    from ..materials import fetch_attr_planes  # materials imports this module
    shade_strided_step_ref(fstate, istate, buf, t,
                           fetch_attr_planes(idx, amat), cam, geom, seed,
                           iteration, first_sample, max_depth, u9)


def _check_planes(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"shade_strided_step: {name} on {x.device}, "
                         f"expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"shade_strided_step: {name} must be {dtype}, "
                        f"got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"shade_strided_step: {name} must be {shape}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"shade_strided_step: {name} must be contiguous")


def _check_strided(fstate, istate, buf, t, idx, amat, cam, dev) -> tuple:
    """``(n_lanes, k, moving)`` of K2's arguments on ``dev``, ``moving``
    for K2m's (a 13-plane ``fstate`` and a 13-column ``amat``); raises on
    anything the kernels do not take."""
    if dev.type != "cuda":
        raise ValueError(f"shade_strided_step: unsupported device {dev}")
    n = t.shape[0] if t.dim() == 1 else -1
    k = buf.shape[0] // 3 if buf.dim() == 2 else -1
    moving = fstate.dim() == 2 and fstate.shape[0] == N_FSTATE_MOTION
    f32, i32 = torch.float32, torch.int32
    _check_planes("fstate", fstate, f32,
                  (N_FSTATE_MOTION if moving else N_FSTATE, n), dev)
    _check_planes("istate", istate, i32, (N_ISTATE, n), dev)
    _check_planes("buf", buf, f32, (3 * k, n), dev)
    _check_planes("t", t, f32, (n,), dev)
    _check_planes("idx", idx, i32, (n,), dev)
    _check_planes("amat", amat, f32,
                  (amat.shape[0] if amat.dim() == 2 else -1,
                   13 if moving else 10), dev)
    _check_planes("cam", cam, f32, (21,), dev)
    if k < 1:
        raise ValueError("shade_strided_step: buf must hold 3k planes, k >= 1")
    return n, k, moving


def shade_strided_step(fstate: torch.Tensor, istate: torch.Tensor,
                       buf: torch.Tensor, t: torch.Tensor,
                       idx: torch.Tensor, amat: torch.Tensor,
                       cam: torch.Tensor, geom: tuple, seed: int,
                       iteration: int, first_sample: int, max_depth: int,
                       u9: torch.Tensor | None = None) -> None:
    """K2: one strided iteration with its winner fetch, in place
    (arguments as :func:`shade_strided_fetch_ref`; ``idx`` int32); K2m on a
    moving scene's 13-plane state and 13-column table, with ``u9`` [10, R].

    CPU tensors run :func:`shade_strided_fetch_ref`. CUDA tensors launch the
    kernel on the current stream, counted in :data:`launches` (K2) or
    :data:`motion_launches` (K2m); anything it does not take raises."""
    global launches, motion_launches
    if fstate.device.type == "cpu":
        return shade_strided_fetch_ref(fstate, istate, buf, t, idx, amat, cam,
                                       geom, seed, iteration, first_sample,
                                       max_depth, u9)
    dev = fstate.device
    n, k, moving = _check_strided(fstate, istate, buf, t, idx, amat, cam, dev)
    if u9 is not None:
        _check_planes("u9", u9, torch.float32, (10 if moving else 9, n), dev)
    W, H, dpx, dpy, p_end = (int(g) for g in geom)
    lib = build.load()
    launch = lib.rtw_shade_strided_motion if moving else lib.rtw_shade_strided
    with torch.cuda.device(dev):  # the launch uses the current device
        err = launch(
            fstate.data_ptr(), istate.data_ptr(), buf.data_ptr(), t.data_ptr(),
            idx.data_ptr(), amat.data_ptr(), cam.data_ptr(),
            None if u9 is None else u9.data_ptr(), n, k, W, H, dpx, dpy,
            p_end, int(first_sample), int(max_depth), seed & 0xFFFFFFFF,
            iteration & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
    build.check(err, "shade_strided_step")
    if moving:
        motion_launches += 1
    else:
        launches += 1


def shade_strided_pass(fstate: torch.Tensor, istate: torch.Tensor,
                       buf: torch.Tensor, t: torch.Tensor, idx: torch.Tensor,
                       amat: torch.Tensor, cam: torch.Tensor, geom: tuple,
                       params: torch.Tensor, j: int, max_depth: int) -> None:
    """K2 (K2m on a moving scene's state) as pass ``j`` of the strided
    loop's chunk, in place: iteration
    ``params[PARAMS_BASE] + j`` with the seed, first sample and p_end read
    from ``params`` [N_PARAMS] int32 (``geom``'s p_end is not read), the
    kernel's own draws; a pass at or past ``params[PARAMS_LIMIT]`` changes
    nothing. On the card the kernel reads ``params`` when it runs, so that
    a captured chunk serves every call.

    CPU tensors run :func:`shade_strided_fetch_ref` with those scalars.
    CUDA tensors launch the kernel on the current stream, not counted in
    :data:`launches` or :data:`motion_launches` (the loop counts its
    chunk's replays)."""
    if fstate.device.type == "cpu":
        seed, first, p_end, base, limit = params.tolist()
        if base + j < limit:
            shade_strided_fetch_ref(fstate, istate, buf, t, idx, amat, cam,
                                    (*geom[:4], p_end), seed & 0xFFFFFFFF,
                                    base + j, first, max_depth)
        return
    dev = fstate.device
    n, k, moving = _check_strided(fstate, istate, buf, t, idx, amat, cam, dev)
    _check_planes("params", params, torch.int32, (N_PARAMS,), dev)
    W, H, dpx, dpy = (int(g) for g in geom[:4])
    lib = build.load()
    launch = (lib.rtw_shade_strided_motion_pass if moving
              else lib.rtw_shade_strided_pass)
    with torch.cuda.device(dev):
        err = launch(
            fstate.data_ptr(), istate.data_ptr(), buf.data_ptr(), t.data_ptr(),
            idx.data_ptr(), amat.data_ptr(), cam.data_ptr(), params.data_ptr(),
            n, k, W, H, dpx, dpy, int(max_depth), j,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "shade_strided_pass")


def strided_chunk_end(istate: torch.Tensor, params: torch.Tensor,
                      flags: torch.Tensor, host_flags: torch.Tensor,
                      passes: int) -> None:
    """The end of the strided loop's chunk of ``passes`` passes, chunk ``c
    = params[PARAMS_BASE] // passes``: ``flags[c % 2] = c + 1`` if any lane
    of ``istate`` is active (else the slot is left as it is), then
    ``params[PARAMS_BASE] += passes`` and ``host_flags`` [2] int32 (pinned
    host memory on the card) gets a copy of ``flags`` [2] int32. Plain
    PyTorch on CPU tensors; on the card two kernels and a copy on the
    current stream (csrc/shade_strided.cu)."""
    if istate.device.type == "cpu":
        c = int(params[PARAMS_BASE]) // passes
        if bool(istate[5].any()):
            flags[c % 2] = c + 1
        params[PARAMS_BASE] += passes
        host_flags.copy_(flags)
        return
    dev, i32 = istate.device, torch.int32
    build.check_arg("strided_chunk_end: istate", istate, i32,
                    (N_ISTATE, istate.shape[1]), dev)
    build.check_arg("strided_chunk_end: params", params, i32, (N_PARAMS,),
                    dev)
    build.check_arg("strided_chunk_end: flags", flags, i32, (2,), dev)
    build.check_arg("strided_chunk_end: host_flags", host_flags, i32, (2,),
                    torch.device("cpu"))
    if not host_flags.is_pinned():
        raise ValueError("strided_chunk_end: host_flags must be pinned")
    with torch.cuda.device(dev):
        err = build.load().rtw_strided_chunk_end(
            istate[5].data_ptr(), istate.shape[1], params.data_ptr(), passes,
            flags.data_ptr(), host_flags.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "strided_chunk_end")


# ---------------------------------------------------------------------------
# K9: one pixel-pinned persistent iteration
# ---------------------------------------------------------------------------

def shade_and_regen_ref(fstate: torch.Tensor, istate: torch.Tensor,
                        t: torch.Tensor, attrs: torch.Tensor,
                        film_u: torch.Tensor, film_v: torch.Tensor,
                        cam: torch.Tensor, seed: int, iteration: int,
                        last_sample: int, max_depth: int,
                        u9: torch.Tensor | None = None) -> None:
    """Plain PyTorch K9, updating ``fstate`` [12, R] and ``istate`` [3, R]
    in place (reference: ``shade_and_regen`` / ``_shade_math``).

    ``t`` [R] and ``attrs`` [10, R] are the sweep's winner distance and
    attributes; ``film_u``/``film_v`` [R] the lanes' pixel coordinates;
    ``cam`` the [21] camera constants. A live hit continues while its bounce
    count stays below ``max_depth``; a lane whose ray missed or ran out of
    depth starts its pixel's next sample (jittered unless its id is 0,
    thin-lens origin) while the id stays ``<= last_sample``, else goes
    idle. ``u9`` [9, R] injects the uniforms; without it they are
    :func:`rng.philox_uniforms` of ``(seed, iteration)``, the kernel's own."""
    n = t.shape[0]
    if u9 is None:
        u9 = rng.philox_uniforms(seed, iteration, n, 9, device=t.device)
    ox, oy, oz, dx, dy, dz, tx, ty, tz, rx, ry, rz = fstate.unbind(0)
    bo, sa, ac = istate.unbind(0)
    active = ac != 0
    one = torch.ones_like(t)

    rx, ry, rz, hitm, miss, px, py, pz, ndx, ndy, ndz = shade_core(
        u9, t, attrs, ox, oy, oz, dx, dy, dz, tx, ty, tz, active, rx, ry, rz)

    # Continue bouncing: the reference's 0/1 blend of origin and direction.
    newb = bo + 1
    cont = hitm & (newb < max_depth)
    exhausted = hitm & ~cont
    cf = cont.to(torch.float32)
    ncf = 1.0 - cf
    ox, oy, oz = cf * px + ncf * ox, cf * py + ncf * oy, cf * pz + ncf * oz
    dx, dy, dz = cf * ndx + ncf * dx, cf * ndy + ncf * dy, cf * ndz + ncf * dz
    tx = torch.where(cont, tx * attrs[4], tx)
    ty = torch.where(cont, ty * attrs[5], ty)
    tz = torch.where(cont, tz * attrs[6], tz)
    bo = torch.where(cont, newb, bo)

    # Regenerate: the same pixel's next sample, in place, built as
    # pinned_start_rays builds the first.
    need = miss | exhausted
    nxt = sa + 1
    can = need & (nxt <= last_sample)
    gox, goy, goz, gdx, gdy, gdz = camera_ray(cam, film_u, film_v, nxt == 0,
                                              u9)
    canf = can.to(torch.float32)
    ncanf = 1.0 - canf
    ox, oy, oz = (canf * gox + ncanf * ox, canf * goy + ncanf * oy,
                  canf * goz + ncanf * oz)
    dx, dy, dz = (canf * gdx + ncanf * dx, canf * gdy + ncanf * dy,
                  canf * gdz + ncanf * dz)
    tx = torch.where(can, one, tx)
    ty = torch.where(can, one, ty)
    tz = torch.where(can, one, tz)
    bo = torch.where(can, torch.zeros_like(bo), bo)
    sa = torch.where(can, nxt, sa)
    active = (active & ~need) | can

    fstate.copy_(torch.stack([ox, oy, oz, dx, dy, dz, tx, ty, tz, rx, ry, rz]))
    istate.copy_(torch.stack([bo, sa, active.to(torch.int32)]))


def shade_and_regen_fetch_ref(fstate: torch.Tensor, istate: torch.Tensor,
                              t: torch.Tensor, idx: torch.Tensor,
                              amat: torch.Tensor, film_u: torch.Tensor,
                              film_v: torch.Tensor, cam: torch.Tensor,
                              seed: int, iteration: int, last_sample: int,
                              max_depth: int,
                              u9: torch.Tensor | None = None) -> None:
    """Plain PyTorch K9 as the pinned loop calls it: the winner fetch
    (``materials.fetch_attr_planes`` of the sweep's ``idx`` [R] into
    ``amat`` [N, 10]), then :func:`shade_and_regen_ref`, in place."""
    from ..materials import fetch_attr_planes  # materials imports this module
    shade_and_regen_ref(fstate, istate, t, fetch_attr_planes(idx, amat),
                        film_u, film_v, cam, seed, iteration, last_sample,
                        max_depth, u9)


def _check_pinned(what, fstate, istate, t, film_u, film_v, cam, u9, dev):
    n = t.shape[0] if t.dim() == 1 else -1
    f32, i32 = torch.float32, torch.int32
    for name, x, dtype, shape in (
            ("fstate", fstate, f32, (N_FSTATE, n)),
            ("istate", istate, i32, (N_PINNED_ISTATE, n)),
            ("t", t, f32, (n,)), ("film_u", film_u, f32, (n,)),
            ("film_v", film_v, f32, (n,)), ("cam", cam, f32, (21,))):
        build.check_arg(f"{what}: {name}", x, dtype, shape, dev)
    if u9 is not None:
        build.check_arg(f"{what}: u9", u9, f32, (9, n), dev)
    return n


def shade_and_regen_fetch(fstate: torch.Tensor, istate: torch.Tensor,
                          t: torch.Tensor, idx: torch.Tensor,
                          amat: torch.Tensor, film_u: torch.Tensor,
                          film_v: torch.Tensor, cam: torch.Tensor, seed: int,
                          iteration: int, last_sample: int, max_depth: int,
                          u9: torch.Tensor | None = None) -> None:
    """K9: one pixel-pinned iteration with its winner fetch, in place
    (arguments as :func:`shade_and_regen_fetch_ref`; ``idx`` int32). Only
    the active lanes are read, drawn for and written: the step leaves an
    idle lane's state as it is.

    CPU tensors run :func:`shade_and_regen_fetch_ref`. CUDA tensors launch
    the kernel on the current stream; anything it does not take raises."""
    global pinned_launches
    if fstate.device.type == "cpu":
        return shade_and_regen_fetch_ref(fstate, istate, t, idx, amat, film_u,
                                         film_v, cam, seed, iteration,
                                         last_sample, max_depth, u9)
    dev = fstate.device
    if dev.type != "cuda":
        raise ValueError(f"shade_and_regen_fetch: unsupported device {dev}")
    n = _check_pinned("shade_and_regen_fetch", fstate, istate, t, film_u,
                      film_v, cam, u9, dev)
    build.check_arg("shade_and_regen_fetch: idx", idx, torch.int32, (n,), dev)
    build.check_arg("shade_and_regen_fetch: amat", amat, torch.float32,
                    (amat.shape[0] if amat.dim() == 2 else -1, 10), dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_shade_pinned_fetch(
            fstate.data_ptr(), istate.data_ptr(), t.data_ptr(), idx.data_ptr(),
            amat.data_ptr(), film_u.data_ptr(), film_v.data_ptr(),
            cam.data_ptr(), None if u9 is None else u9.data_ptr(), n,
            int(last_sample), int(max_depth), seed & 0xFFFFFFFF,
            iteration & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
    build.check(err, "shade_and_regen_fetch")
    pinned_launches += 1


def shade_and_regen(fstate: torch.Tensor, istate: torch.Tensor,
                    t: torch.Tensor, attrs: torch.Tensor,
                    film_u: torch.Tensor, film_v: torch.Tensor,
                    cam: torch.Tensor, seed: int, iteration: int,
                    last_sample: int, max_depth: int,
                    u9: torch.Tensor | None = None) -> None:
    """The previous K9 (``shade_pinned_kernel``): one thread per lane over
    every lane, the winner's attributes from ten gathered planes, in place
    (arguments as :func:`shade_and_regen_ref`). The independent reference
    that the card checks hold K9 and K12 against bit for bit; no route runs
    it, and its launches are not counted.

    CPU tensors run :func:`shade_and_regen_ref`. CUDA tensors launch the
    kernel on the current stream; anything it does not take raises."""
    if fstate.device.type == "cpu":
        return shade_and_regen_ref(fstate, istate, t, attrs, film_u, film_v,
                                   cam, seed, iteration, last_sample,
                                   max_depth, u9)
    dev = fstate.device
    if dev.type != "cuda":
        raise ValueError(f"shade_and_regen: unsupported device {dev}")
    n = _check_pinned("shade_and_regen", fstate, istate, t, film_u, film_v,
                      cam, u9, dev)
    build.check_arg("shade_and_regen: attrs", attrs, torch.float32, (10, n),
                    dev)
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_shade_pinned(
            fstate.data_ptr(), istate.data_ptr(), t.data_ptr(),
            attrs.data_ptr(), film_u.data_ptr(), film_v.data_ptr(),
            cam.data_ptr(), None if u9 is None else u9.data_ptr(), n,
            int(last_sample), int(max_depth), seed & 0xFFFFFFFF,
            iteration & 0xFFFFFFFF, torch.cuda.current_stream().cuda_stream)
    build.check(err, "shade_and_regen")
