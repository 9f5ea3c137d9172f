"""Boundary-aware gradients: silhouette terms for geometry (counterpart of
``raytracingweekend_jl_tpu.ops.edge``).

The interior path derivative of :func:`integrator.trace` cannot see
visibility: the closest-hit choice makes radiance piecewise in the sphere
centers and radii, and the pieces' boundaries, the silhouettes, carry most
of a geometry fit's gradient. This module adds the boundary term with the
reference's straight-through finite-width edge blend:

1. per ray and bounce, a signed silhouette coordinate per sphere, ``s_j =
   disc_j / (2 |r_j|)``: to first order the distance of the ray's line from
   sphere j's silhouette, positive inside the silhouette cone;
2. one edge sphere ``e`` per ray: the relevant sphere (in front of the
   closest hit, or the hit itself) whose silhouette the ray passes nearest;
3. two path hypotheses continued to full depth with common random numbers:
   ``L_with`` (the ray interacts with ``e`` at this bounce) and
   ``L_without`` (``e`` deleted at this bounce), so that the hard bounce
   is ``select(winner == e, with, without)``;
4. a correction that is zero in value, ``(w - w.detach()) * (L_with -
   L_without)`` with ``w = smoothstep(s_e / sigma)`` of compact support
   ``[-sigma, sigma]``, whose gradient is a band-smeared estimate of the
   silhouette's boundary integral.

The reference computes this in XLA, outside any Pallas kernel; so does the
port, in plain PyTorch around the sphere sweep K1. Every bounce, the edge
bounces' hard result included, sweeps through the same intersector as
:func:`integrator.trace` (K1 and its implicit-differentiation backward on
the card, :func:`cuda.intersect_kernel.sweep_ref` on the CPU), so the
primal is :func:`integrator.trace` with ``keyed=True`` bit for bit. The
``[R, N]`` silhouette planes of an edge bounce are built under
``torch.no_grad`` with ``sweep_ref``'s expressions in its order (no matrix
product): they only choose ``e`` and the without-branch's winner. The
gradient flows through ``s_e``, ``t_e`` and ``r_eff`` of the chosen sphere
and ``t`` of the without-branch's winner, which are recomputed per ray from
the gathered rows with the same expressions, so their values are the
planes' bit for bit and their gradients those of the dense form.

Draws are the port's Philox streams (:func:`materials.slot_draws`: keyed by
``(seed, bounce)``, the ray's slot as the counter), not the reference's
threefry; both branches of an edge bounce draw the main path's slot draws.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import rng
from ..camera import sample_pass_rays
from ..scene import Scene, check_static, trim_scene
from .integrator import (DEFAULT_MAX_DEPTH, _pick_intersector, resolve_impl,
                         skycolor, wavefront_bounce)
from .intersect import BIG, DEFAULT_TMIN
from .materials import gather_sphere_attrs, scatter, slot_draws


def _quadratic(o, d, c, r):
    """``(half_b, disc)`` of rays ``o``, ``d`` against spheres ``c``, ``r``
    (any broadcastable shapes; ``o``, ``d``, ``c`` with xyz last), in
    :func:`cuda.intersect_kernel.sweep_ref`'s expanded form and order, with
    ``ck`` as :func:`cuda.intersect_kernel.sphere_consts` forms it."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    cx, cy, cz = c.unbind(-1)
    ck = cx * cx + cy * cy + cz * cz - r * r
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    cd = cx * dx + cy * dy + cz * dz
    oc = cx * ox + cy * oy + cz * oz
    hb = od - cd
    c_ = oo - 2.0 * oc + ck
    return hb, hb * hb - c_


def _interaction(hb, disc, tmin: float):
    """``(t_int, rooted)``: the sweep's root where it accepts one (``disc >
    0``, the near root if ``>= tmin`` else the far one, ``t >= tmin`` and
    ``t < BIG``), else the unclipped perpendicular foot ``-half_b``. The
    square root sees 1 where ``disc <= 0`` (the NaN-under-where guard)."""
    sq = torch.sqrt(torch.where(disc > 0, disc, torch.ones_like(disc)))
    r1 = -hb - sq
    t = torch.where(r1 >= tmin, r1, -hb + sq)
    rooted = (disc > 0) & (t >= tmin) & (t < BIG)
    return torch.where(rooted, t, -hb), rooted


def _silhouette(disc, r):
    """``disc / (2 |r|)``; padding spheres (``r == 0``) get -1e9, never an
    edge, with a guarded denominator."""
    pad = r == 0
    denom = torch.where(pad, torch.ones_like(r), 2.0 * torch.abs(r))
    return torch.where(pad, torch.full_like(disc, -1e9), disc / denom)


def silhouette_coords(origin: torch.Tensor, direction: torch.Tensor,
                      scene: Scene, tmin: float = DEFAULT_TMIN):
    """Per-(ray, sphere) silhouette geometry of rays ``origin``/``direction``
    [R, 3] (reference: ``edge.silhouette_coords``).

    Returns ``(t, idx, s, t_int, rooted)``: the hard closest hit ``t`` [R]
    and ``idx`` [R] int32, first index on ties (``sweep_ref`` bit for bit);
    ``s`` [R, N] the signed silhouette coordinate; ``t_int`` [R, N] the
    sweep's root where it accepts one, else the unclipped foot ``-half_b``
    (a sphere wholly behind the ray keeps its negative foot, so relevance
    tests reject it); ``rooted`` [R, N] where a root is accepted (``where(
    rooted, t_int, BIG)`` are the sweep's candidates). Differentiable."""
    c = scene.center.to(origin.dtype)
    r = scene.radius.to(origin.dtype)
    hb, disc = _quadratic(origin[:, None, :], direction[:, None, :],
                          c[None], r[None])
    t_int, rooted = _interaction(hb, disc, tmin)
    t_cand = torch.where(rooted, t_int, torch.full_like(t_int, BIG))
    t, idx = torch.min(t_cand, dim=1)
    return t, idx.to(torch.int32), _silhouette(disc, r[None]), t_int, rooted


def pixel_angle(cam, f32_h: float) -> torch.Tensor:
    """Angular height of one pixel (radians), the footprint scale of the
    automatic sigma: the film spans ``|vertical|`` at the focus plane, which
    sits ``|llc + h/2 + v/2 - origin|`` from the eye."""
    center = (cam.lower_left_corner + 0.5 * cam.horizontal
              + 0.5 * cam.vertical - cam.origin)
    focus = torch.sqrt(torch.sum(center * center))
    vh = torch.sqrt(torch.sum(cam.vertical * cam.vertical))
    return vh / (f32_h * focus)


def _smoothstep_band(s: torch.Tensor, sig) -> torch.Tensor:
    """C1 coverage weight with support exactly ``[-sig, sig]`` (a
    sigmoid's infinite tails bias the z gradient)."""
    x = torch.clamp((s / sig + 1.0) * 0.5, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


def row_terms(origin, direction, center, radius, tmin: float = DEFAULT_TMIN):
    """``(t_int, s)`` [R] of each ray against its own sphere (``center``
    [R, 3], ``radius`` [R]: rows gathered for the chosen spheres), with
    :func:`silhouette_coords`' expressions: the planes' values at those
    spheres bit for bit, differentiable, without the ``[R, N]`` planes."""
    hb, disc = _quadratic(origin, direction, center, radius)
    t_int, _ = _interaction(hb, disc, tmin)
    return t_int, _silhouette(disc, radius)


def _edge_bounce(scene, isect, tmin, sigma, sigma_px, pix_angle, u, xi, org,
                 d, thr, alive):
    """The edge bounce's choices and branch states: ``(winner_is_e,
    has_edge, w_soft, st_with, st_without, sky_wo)``."""
    dtype = org.dtype
    res, _ = isect(org, d, scene, tmin)
    with torch.no_grad():
        _, _, s_all, t_int, rooted = silhouette_coords(org, d, scene, tmin)
        # Relevant: can flip visibility here (in front of or at the hit;
        # the slack admits the hit itself).
        relevant = ((t_int >= tmin)
                    & (t_int <= res.t[:, None] * (1 + 1e-6) + 1e-6))
        closeness = torch.where(relevant, -torch.abs(s_all),
                                torch.full_like(s_all, -float("inf")))
        best, e = torch.max(closeness, dim=1)
        has_edge = torch.isfinite(best) & alive
        winner_is_e = res.hit & (res.index == e)
        # Without e: the sweep's candidates with e masked out.
        t_cand = torch.where(rooted, t_int, torch.full_like(t_int, BIG))
        t_cand.scatter_(1, e.long()[:, None], BIG)
        t_wo_p, idx_wo = torch.min(t_cand, dim=1)
        del s_all, t_int, rooted, relevant, closeness, t_cand
        # Where e is not the winner, the without-branch is the real bounce:
        # its winner is the sweep's, whatever the planes say.
        idx_wo = torch.where(winner_is_e, idx_wo.to(torch.int32), res.index)
        hit_wo = torch.where(winner_is_e, t_wo_p < BIG, res.hit)

    # The chosen sphere's s, t and radius, recomputed from its row.
    attrs_e = gather_sphere_attrs(scene, e, dtype)
    c_e, r_e = attrs_e[0], attrs_e[1]
    t_e, s_e = row_terms(org, d, c_e, r_e, tmin)
    t_e = torch.where(winner_is_e, res.t, t_e)  # the sweep's own t
    if sigma is None:
        sig = torch.clamp(sigma_px * pix_angle * t_e.detach(), min=1e-4)
    else:
        sig = torch.full((), sigma, dtype=dtype, device=org.device)
    w_soft = _smoothstep_band(s_e, sig)

    # WITH: interact with e at t_e. A graze (not a root) takes the signed
    # radius sign(r_e) |p - c_e|, so scatter's normal stays unit; the real
    # winner keeps its radius (the hard path's bits).
    p_w = org + t_e[:, None] * d
    dist = torch.sqrt(torch.clamp(((p_w - c_e) ** 2).sum(-1), min=1e-12))
    r_eff = torch.where(winner_is_e, r_e,
                        torch.where(r_e < 0, -dist, dist))
    sc_w = scatter(org, d, t_e, (c_e, r_eff) + attrs_e[2:], u, xi)
    st_with = (sc_w.origin, sc_w.direction, thr * sc_w.attenuation,
               torch.zeros_like(thr), alive)

    # WITHOUT: e deleted for this bounce.
    attrs_wo = gather_sphere_attrs(scene, idx_wo, dtype)
    t_wo, _ = row_terms(org, d, attrs_wo[0], attrs_wo[1], tmin)
    t_wo = torch.where(winner_is_e, t_wo, res.t)
    t_wo_safe = torch.where(hit_wo, t_wo, torch.ones_like(t_wo))
    sc_wo = scatter(org, d, t_wo_safe, attrs_wo, u, xi)
    sky_wo = torch.where((alive & ~hit_wo)[:, None], thr * skycolor(d),
                         torch.zeros_like(thr))
    h = hit_wo[:, None]
    st_without = (torch.where(h, sc_wo.origin, org),
                  torch.where(h, sc_wo.direction, d),
                  torch.where(h, thr * sc_wo.attenuation, thr), sky_wo,
                  alive & hit_wo)
    return winner_is_e, has_edge, w_soft, st_with, st_without, sky_wo


def trace_edge(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
               seed: int, max_depth: int = DEFAULT_MAX_DEPTH,
               tmin: float = DEFAULT_TMIN, sigma: float | None = None,
               sigma_px: float = 1.0, pix_angle: torch.Tensor | None = None,
               edge_bounces: int = 2, impl: str | None = None
               ) -> torch.Tensor:
    """Radiance ``[R, 3]`` of rays ``origin``/``direction`` [R, 3] with
    boundary-aware gradients at the first ``edge_bounces`` bounces
    (reference: ``edge.trace_edge``; the module docstring).

    The primal is :func:`integrator.trace` with ``keyed=True`` and the same
    ``seed`` bit for bit; the gradients also carry the straight-through
    silhouette terms. ``sigma`` is the edge band's half-width in scene
    units; ``None`` scales it per ray to ``sigma_px`` pixel footprints at
    the interaction distance (pass ``pix_angle`` from :func:`pixel_angle`).
    Each plain bounce, and each bounce of the branches' continuations, is
    recomputed in the backward (``torch.utils.checkpoint``)."""
    check_static(scene, "the edge estimator")
    if sigma is None and pix_angle is None:
        raise ValueError("sigma=None needs pix_angle (see pixel_angle()) "
                         "for the footprint scale")
    dtype, dev = origin.dtype, origin.device
    R = origin.shape[0]
    isect = _pick_intersector(dtype, False, resolve_impl(impl, dev))
    slots = torch.arange(R, dtype=torch.int32, device=dev)
    # Every bounce's slot draws at once (the bits of one call per bounce).
    u_all, xi_all = slot_draws(seed & 0xFFFFFFFF,
                               torch.arange(max_depth, device=dev)[:, None],
                               slots, dtype)

    def plain(b, state, pair: bool):
        u, xi = u_all[b], xi_all[b]
        if pair:  # the main path's draws on both halves
            u, xi = torch.cat([u, u]), torch.cat([xi, xi])
        return checkpoint(wavefront_bounce, scene, isect, tmin, u, xi,
                          *state, use_reentrant=False)

    org, d = origin, direction
    thr = torch.ones((R, 3), dtype=dtype, device=dev)
    rad = torch.zeros((R, 3), dtype=dtype, device=dev)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    corr = torch.zeros((R, 3), dtype=dtype, device=dev)
    n_edge = min(edge_bounces, max_depth)
    for b in range(n_edge):
        winner_is_e, has_edge, w_soft, st_with, st_without, sky_wo = \
            _edge_bounce(scene, isect, tmin, sigma, sigma_px, pix_angle,
                         u_all[b], xi_all[b], org, d, thr, alive)
        # Both branches to full depth: their radiance planes start at this
        # bounce's sky and end as the branch radiances.
        pair = tuple(torch.cat([a, c]) for a, c in zip(st_with, st_without))
        for b2 in range(b + 1, max_depth):
            pair = plain(b2, pair, True)
        l_with, l_without = pair[3][:R], pair[3][R:]
        w_st = (w_soft - w_soft.detach()) * has_edge
        corr = corr + w_st[:, None] * (l_with - l_without)
        # The main path advances by the hard select of the branch states.
        sel = winner_is_e[:, None]
        rad = rad + torch.where(sel, torch.zeros_like(sky_wo), sky_wo)
        org = torch.where(sel, st_with[0], st_without[0])
        d = torch.where(sel, st_with[1], st_without[1])
        thr = torch.where(sel, st_with[2], st_without[2])
        alive = torch.where(winner_is_e, st_with[4], st_without[4])

    state = (org, d, thr, rad, alive)
    for b in range(n_edge, max_depth):
        state = plain(b, state, False)
    return state[3] + corr


def render_radiance_edge(scene: Scene, cam, image_width: int,
                         n_samples: int = 1, *,
                         image_height: int | None = None,
                         max_depth: int = DEFAULT_MAX_DEPTH,
                         tmin: float = DEFAULT_TMIN, seed: int = 0,
                         sigma: float | None = None, sigma_px: float = 1.0,
                         edge_bounces: int = 2,
                         pixel_chunk: int | None = None,
                         remat_chunks: bool = False, device=None,
                         impl: str | None = None) -> torch.Tensor:
    """Boundary-aware differentiable render ``[H, W, 3]`` (linear radiance)
    on ``device``: the card unless ``device="cpu"`` (reference:
    ``edge.render_radiance_edge``).

    The sampling is the pass loop's (:func:`camera.sample_pass_rays`: global
    sample 0 centred, later ones jittered; one pass per sample), the trace
    :func:`trace_edge` keyed by ``purpose_seed(seed, SCATTER_DIR, sample)``.
    ``pixel_chunk`` bounds the ``[R, N]`` planes' working set: contiguous
    chunks of that many pixels, chunk ``c`` seeded by ``fold_in(seed, c)``
    (so chunked and whole renders agree statistically, not bitwise).
    ``remat_chunks`` checkpoints each chunk, one after another: the backward
    keeps each chunk's ``[chunk, 3]`` sum and recomputes one chunk at a
    time; it needs ``pixel_chunk < H * W`` above 2^16 pixels."""
    check_static(scene, "the edge estimator")
    from ..render import _resolve_device, image_height_for, pixel_coords
    device = _resolve_device(device)
    scene = trim_scene(scene.to(device))
    cam = cam.to(device)
    H = image_height if image_height is not None \
        else image_height_for(image_width)
    W = image_width
    n_pix = H * W
    dtype = cam.origin.dtype
    u, v = pixel_coords(W, H, dtype=dtype, device=device)
    fw, fh = float(np.float32(W)), float(np.float32(H))
    pa = None if sigma is not None else pixel_angle(cam, fh)

    if pixel_chunk is None or pixel_chunk >= n_pix:
        if remat_chunks and n_pix > (1 << 16):
            # One chunk is one checkpointed region holding the whole
            # forward: the flag would do nothing.
            raise ValueError(
                "remat_chunks=True needs pixel_chunk < n_pix to have any "
                f"effect (n_pix={n_pix}); pass e.g. pixel_chunk={1 << 16}")
        chunks = [(0, n_pix, seed)]
    else:
        chunks = [(st, min(pixel_chunk, n_pix - st), rng.fold_in(seed, c))
                  for c, st in enumerate(range(0, n_pix, pixel_chunk))]

    def chunk_sum(uc, vc, seed_c):
        acc = torch.zeros((uc.shape[0], 3), dtype=dtype, device=device)
        for s0 in range(n_samples):
            o, d = sample_pass_rays(cam, uc, vc, seed_c, s0, 1, fw, fh)
            acc = acc + trace_edge(
                scene, o, d,
                rng.purpose_seed(seed_c, rng.SCATTER_DIR, s0) & 0xFFFFFFFF,
                max_depth, tmin, sigma, sigma_px, pa, edge_bounces, impl)
        return acc

    remat = remat_chunks and len(chunks) > 1
    pieces = []
    for st, size, seed_c in chunks:
        uc, vc = u[st:st + size], v[st:st + size]
        pieces.append(checkpoint(chunk_sum, uc, vc, seed_c,
                                 use_reentrant=False) if remat
                      else chunk_sum(uc, vc, seed_c))
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
    return (out / n_samples).reshape(H, W, 3)
