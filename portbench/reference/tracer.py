"""The reference path tracer: a wavefront over the live rays, a closest-hit
sweep over every sphere, the three book-1 materials, the sky, and the
gradients of an image loss by autograd.

The sweep is the half-b quadratic with ``a = 1`` in the expanded form
``|o|^2 - 2 o.c + (|c|^2 - r^2)``, the near root, else the far root, in
``[tmin, inf)``, and the first sphere with the least root (src/hit.jl),
in float32 with every operation rounded on its own.
A ray that misses banks ``throughput * sky(d)`` and ends; a ray still
live after ``max_depth`` sweeps ends dark (src/ray_color.jl:14-27).
Gradients flow through the hit distance (the winner's root, recomputed
with autograd), the hit point, the normal, the scatter directions, the
attenuation and the sky; which sphere wins, the material, the coin and
the side are constants of the path, as in the program's estimator.
"""

from __future__ import annotations

import torch

from .camera import camera_rays
from .scene import FLOAT_FIELDS, LAMBERTIAN, METAL
from .vec import (NEAR_ZERO_EPS, dot, normalize, reflect, refract, safe_sqrt,
                  schlick, skycolor)

#: Stand-in for ``typemax(T)``: the distance of a miss.
BIG = 3.0e38


def _sweep(o: torch.Tensor, d: torch.Tensor, scene: dict, tmin: float
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(t, winner, far)`` of rays ``o``/``d`` [R, 3] over every sphere,
    in blocks of rays that keep a ``[rows, N]`` plane near 2^26 entries;
    ``far`` says the winner's far root was taken.

    Every product and sum is its own rounding, in the order src/hit.jl
    writes them (``o.d = (ox dx + oy dy) + oz dz``, no fused multiply-add):
    whether a ray leaving a surface hits it again at ``t >= tmin`` turns on
    how ``|o|^2 - 2 o.c + ck`` rounds, so a matrix product (other sums,
    fused) would change how often that happens."""
    c, r = scene["center"], scene["radius"]
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    ck = (cx * cx + cy * cy) + cz * cz - r * r
    rows = max(1024, (1 << 26) // c.shape[0])
    ts, ws, fs = [], [], []
    for a in range(0, o.shape[0], rows):
        ox, oy, oz = (o[a:a + rows, k:k + 1] for k in range(3))
        dx, dy, dz = (d[a:a + rows, k:k + 1] for k in range(3))
        od = (ox * dx + oy * dy) + oz * dz
        oo = (ox * ox + oy * oy) + oz * oz
        hb = od - ((cx * dx + cy * dy) + cz * dz)
        cc = (oo - 2.0 * ((cx * ox + cy * oy) + cz * oz)) + ck
        disc = hb * hb - cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        near = -hb - sq
        near_ok = near >= tmin
        t = torch.where(near_ok, near, -hb + sq)
        tc = torch.where((disc > 0) & (t >= tmin), t,
                         torch.full_like(t, BIG))
        t, w = tc.min(-1)
        ts.append(t)
        ws.append(w)
        fs.append(~near_ok.gather(1, w[:, None])[:, 0])
    return torch.cat(ts), torch.cat(ws), torch.cat(fs)


def _hit_t(o, d, c, r, far) -> torch.Tensor:
    """The winner's root, recomputed per ray so that autograd reaches the
    sphere's center and radius."""
    hb = dot(o, d) - dot(d, c)
    cc = dot(o, o) - 2.0 * dot(o, c) + (dot(c, c) - r * r)
    sq = torch.sqrt(torch.clamp(hb * hb - cc, min=1e-30))
    return torch.where(far, -hb + sq, -hb - sq)


def _scatter(o, d, t, c, r, albedo, fuzz, ir, mat, u, xi):
    """Next ``(origin, direction, attenuation)`` of rays that hit
    (src/material.jl:13-53); a negative radius flips the normal."""
    p = o + t[:, None] * d
    zero_r = r == 0
    inv_r = torch.where(zero_r, torch.zeros_like(r),
                        1.0 / torch.where(zero_r, torch.ones_like(r), r))
    n_out = (p - c) * inv_r[:, None]
    front = dot(d, n_out) < 0
    n = torch.where(front[:, None], n_out, -n_out)
    lam = n + u
    lam_dir = torch.where((dot(lam, lam) < NEAR_ZERO_EPS)[:, None], n,
                          normalize(lam))
    refl = reflect(d, n)
    metal_dir = normalize(refl + fuzz[:, None] * u)
    eta = torch.where(front, 1.0 / ir, ir)
    cos_t = torch.clamp(-dot(d, n), max=1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    choose_refl = (eta * sin_t > 1.0) | (schlick(cos_t, eta) > xi)
    diel_dir = torch.where(choose_refl[:, None], refl, refract(d, n, eta))
    new_d = torch.where((mat == LAMBERTIAN)[:, None], lam_dir,
                        torch.where((mat == METAL)[:, None], metal_dir,
                                    diel_dir))
    return p, new_d, albedo


def trace(scene: dict, o: torch.Tensor, d: torch.Tensor,
          gen: torch.Generator, max_depth: int, tmin: float,
          differentiable: bool = False, segments: list | None = None
          ) -> torch.Tensor:
    """Radiance ``[R, 3]`` of rays ``o``/``d`` (unit directions). Each
    sweep draws, for its rays that hit, a uniform unit vector (a normalised
    Gaussian triple) and a uniform coin from ``gen``. ``segments[0]`` (a
    one-element list) gains the number of sweeps."""
    dtype = o.dtype
    rad = torch.zeros_like(o)
    live = torch.arange(o.shape[0], device=o.device)
    thr = torch.ones_like(o)
    # One gather a sweep of every float field of the winners: its backward
    # is one index_add into the [N, 9] table.
    table = torch.cat([scene["center"], scene["radius"][:, None],
                       scene["albedo"], scene["fuzz"][:, None],
                       scene["ir"][:, None]], 1)
    for _ in range(max_depth):
        if live.numel() == 0:
            break
        if segments is not None:
            segments[0] += live.numel()
        with torch.no_grad():
            t, win, far = _sweep(o.detach(), d.detach(), scene, tmin)
        hit = t < BIG
        miss = ~hit
        rad = rad.index_add(0, live[miss], thr[miss] * skycolor(d[miss]))
        live, o, d, thr = live[hit], o[hit], d[hit], thr[hit]
        t, win, far = t[hit], win[hit], far[hit]
        rows = table.index_select(0, win)
        c, r = rows[:, 0:3], rows[:, 3]
        if differentiable:
            # The sweep's value, the recomputed root's gradient.
            t_rec = _hit_t(o, d, c, r, far)
            t = t + (t_rec - t_rec.detach())
        n = live.numel()
        g = torch.randn((n, 3), generator=gen, device=o.device)
        u = normalize(g).to(dtype)
        xi = torch.rand((n,), generator=gen, device=o.device).to(dtype)
        o, d, att = _scatter(o, d, t, c, r, rows[:, 4:7], rows[:, 7],
                             rows[:, 8], scene["mat"][win], u, xi)
        thr = thr * att
    return rad


def render_sum(scene: dict, cam: dict, W: int, H: int, gen: torch.Generator,
               first_sample: int, n_samples: int, max_depth: int,
               tmin: float) -> torch.Tensor:
    """Radiance sum ``[W*H, 3]`` of global samples ``first_sample ..
    first_sample + n_samples - 1`` of every pixel (sample 0 unjittered), in
    the scene's float type."""
    dtype = scene["center"].dtype
    pixels = torch.arange(W * H, device=scene["center"].device)
    acc = torch.zeros((W * H, 3), dtype=dtype, device=pixels.device)
    with torch.no_grad():
        for s in range(first_sample, first_sample + n_samples):
            o, d = camera_rays(cam, W, H, pixels, gen, s != 0, dtype)
            acc += trace(scene, o, d, gen, max_depth, tmin)
    return acc


def render_stats(scene: dict, cam: dict, W: int, H: int,
                 gen: torch.Generator, n_jittered: int, max_depth: int,
                 tmin: float) -> dict:
    """Per pixel, in float64: ``centered`` [P, 3], the radiance of one
    unjittered sample (global sample 0); ``mean`` and ``var`` [P, 3], the
    mean and the unbiased variance of ``n_jittered`` jittered samples; and
    ``segments``, the sweeps of all those paths."""
    if n_jittered < 2:
        raise ValueError("the variance needs two jittered samples or more")
    dtype = scene["center"].dtype
    pixels = torch.arange(W * H, device=scene["center"].device)
    seg = [0]
    f64 = torch.float64
    with torch.no_grad():
        o, d = camera_rays(cam, W, H, pixels, gen, False, dtype)
        centered = trace(scene, o, d, gen, max_depth, tmin,
                         segments=seg).to(f64)
        s1 = torch.zeros((W * H, 3), dtype=f64, device=pixels.device)
        s2 = torch.zeros_like(s1)
        # Several samples a wavefront on a small film, up to the rays of one
        # sample of a 1080p one, so that a small film is not launch-bound.
        per = max(1, (1 << 21) // (W * H))
        for a in range(0, n_jittered, per):
            b = min(per, n_jittered - a)
            o, d = camera_rays(cam, W, H, pixels.repeat(b), gen, True, dtype)
            x = trace(scene, o, d, gen, max_depth, tmin, segments=seg).to(f64)
            x = x.reshape(b, W * H, 3)
            s1 += x.sum(0)
            s2 += (x * x).sum(0)
    mean = s1 / n_jittered
    var = torch.clamp((s2 - n_jittered * mean * mean) / (n_jittered - 1),
                      min=0.0)
    return dict(centered=centered, mean=mean, var=var, segments=seg[0],
                paths=W * H * (n_jittered + 1))


def grad_step(scene: dict, cam: dict, W: int, H: int, target: torch.Tensor,
              gen: torch.Generator, max_depth: int, tmin: float
              ) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)``: the mean squared error of one unjittered sample
    per pixel (global sample 0) against ``target`` [H, W, 3], and its
    gradients with respect to every float field of ``scene``, computed in
    the scene's float type."""
    dtype = scene["center"].dtype
    leaves = {f: scene[f].detach().clone().requires_grad_(True)
              for f in FLOAT_FIELDS}
    sc = dict(leaves, mat=scene["mat"])
    pixels = torch.arange(W * H, device=scene["center"].device)
    with torch.no_grad():
        o, d = camera_rays(cam, W, H, pixels, gen, False, dtype)
    rad = trace(sc, o, d, gen, max_depth, tmin, differentiable=True)
    loss = ((rad - target.reshape(-1, 3).to(dtype)) ** 2).mean()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return loss.detach(), {f: (torch.zeros_like(leaves[f]) if g is None
                               else g.detach())
                           for f, g in zip(FLOAT_FIELDS, grads)}
