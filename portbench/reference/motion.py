"""The plain reference of a moving scene: book 2's motion blur (Shirley,
Black, Hollasch, *Ray Tracing: The Next Week* §2) in plain PyTorch.

Each camera ray draws a shutter time ``U[0, 1)``; a sphere with a motion
``m`` is centred at ``c0 + time * m`` for that ray, and every ray scattered
from it keeps its time (the book's ``ray(origin, direction, time)``, whose
``center(time)`` the hit test and the normal both use). The tracer follows
the book's recursion bounce by bounce over the live rays, as
:func:`tracer.trace` does: the closest hit at the ray's time, the sky on a
miss, the three book-1 materials (:func:`tracer._scatter`, at the moved
centre), dark after ``max_depth`` sweeps. Its random numbers are its own
(``torch.Generator`` draws). It imports nothing of the program under test,
nor JAX.

The hit test is :func:`tracer._sweep`'s expanded half-b quadratic, every
operation rounded on its own, with the centre and ``|c|^2 - r^2`` formed
per ray and sphere from the ray's time: whether a ray leaving a surface
hits it again turns on how that sum rounds, as there.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .camera import camera_rays
from .scene import FLOAT_FIELDS
from .tracer import BIG, _scatter
from .vec import normalize, skycolor


def motion_array(spec: dict) -> np.ndarray:
    """``[N, 3]`` float64: the motion of each sphere of the scene ``spec``
    names (its ``motion``, or zero for a sphere that does not move), in the
    order of :func:`scene.scene_arrays`."""
    mod = importlib.import_module(f"portbench.reference.scenes."
                                  f"{spec['module']}")
    spheres = mod.build(**spec.get("args", {}))
    return np.array([s.get("motion", (0.0, 0.0, 0.0)) for s in spheres],
                    dtype=np.float64).reshape(len(spheres), 3)


def moving_tensors(arrays: dict, motion: np.ndarray, dtype, device) -> dict:
    """:func:`scene.scene_tensors` of ``arrays`` with ``motion`` [N, 3]
    added, each float field cast once from float64 to ``dtype``."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    out = {f: torch.as_tensor(arrays[f].astype(np_dtype)).to(
        device=device, dtype=dtype) for f in FLOAT_FIELDS}
    out["mat"] = torch.as_tensor(arrays["mat"], dtype=torch.int32).to(device)
    out["motion"] = torch.as_tensor(motion.astype(np_dtype)).to(
        device=device, dtype=dtype)
    return out


def closest_hit(scene: dict, o: torch.Tensor, d: torch.Tensor,
                times: torch.Tensor, tmin: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(t [R], idx [R])`` of rays ``o``/``d`` [R, 3] (unit directions) at
    their shutter ``times`` [R] over every sphere of ``scene`` (its
    ``motion`` included): the least root in ``[tmin, inf)``, the near root
    where it is there, else the far one, and the first sphere with it;
    ``(BIG, 0)`` on a miss. In blocks of rays that keep each ``[rows, N]``
    plane near 2^26 entries."""
    c0, m, r = scene["center"], scene["motion"], scene["radius"]
    r2 = r * r
    rows = max(1024, (1 << 26) // c0.shape[0])
    ts, ws = [], []
    for a in range(0, o.shape[0], rows):
        ox, oy, oz = (o[a:a + rows, k:k + 1] for k in range(3))
        dx, dy, dz = (d[a:a + rows, k:k + 1] for k in range(3))
        tm = times[a:a + rows, None]
        cx = c0[:, 0] + tm * m[:, 0]
        cy = c0[:, 1] + tm * m[:, 1]
        cz = c0[:, 2] + tm * m[:, 2]
        ck = (cx * cx + cy * cy) + cz * cz - r2
        od = (ox * dx + oy * dy) + oz * dz
        oo = (ox * ox + oy * oy) + oz * oz
        hb = od - ((cx * dx + cy * dy) + cz * dz)
        cc = (oo - 2.0 * ((cx * ox + cy * oy) + cz * oz)) + ck
        disc = hb * hb - cc
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        near = -hb - sq
        t = torch.where(near >= tmin, near, -hb + sq)
        tc = torch.where((disc > 0) & (t >= tmin), t, torch.full_like(t, BIG))
        t, w = tc.min(-1)
        ts.append(t)
        ws.append(w)
    return torch.cat(ts), torch.cat(ws)


def trace(scene: dict, o: torch.Tensor, d: torch.Tensor,
          times: torch.Tensor, gen: torch.Generator, max_depth: int,
          tmin: float, segments: list | None = None) -> torch.Tensor:
    """Radiance ``[R, 3]`` of rays ``o``/``d`` at shutter ``times``. Each
    bounce sweeps the live rays at their times; a miss banks ``throughput
    * sky(d)`` and ends; a hit draws a uniform unit vector (a normalised
    Gaussian triple) and a uniform coin from ``gen`` and scatters off the
    winner at its centre at the ray's time, keeping the time.
    ``segments[0]`` (a one-element list) gains the number of sweeps."""
    dtype = o.dtype
    rad = torch.zeros_like(o)
    live = torch.arange(o.shape[0], device=o.device)
    thr = torch.ones_like(o)
    table = torch.cat([scene["center"], scene["motion"],
                       scene["radius"][:, None], scene["albedo"],
                       scene["fuzz"][:, None], scene["ir"][:, None]], 1)
    for _ in range(max_depth):
        if live.numel() == 0:
            break
        if segments is not None:
            segments[0] += live.numel()
        t, win = closest_hit(scene, o, d, times, tmin)
        hit = t < BIG
        miss = ~hit
        rad = rad.index_add(0, live[miss], thr[miss] * skycolor(d[miss]))
        live, o, d, thr = live[hit], o[hit], d[hit], thr[hit]
        t, win, times = t[hit], win[hit], times[hit]
        rows = table.index_select(0, win)
        c = rows[:, 0:3] + times[:, None] * rows[:, 3:6]
        n = live.numel()
        g = torch.randn((n, 3), generator=gen, device=o.device)
        u = normalize(g).to(dtype)
        xi = torch.rand((n,), generator=gen, device=o.device).to(dtype)
        o, d, att = _scatter(o, d, t, c, rows[:, 6], rows[:, 7:10],
                             rows[:, 10], rows[:, 11], scene["mat"][win], u,
                             xi)
        thr = thr * att
    return rad


def camera_rays_at(cam: dict, W: int, H: int, pixels: torch.Tensor,
                   gen: torch.Generator, jitter: bool, dtype) -> tuple:
    """``(origin, direction, time)`` of one camera ray per pixel:
    :func:`camera.camera_rays`, then a shutter time ``U[0, 1)`` each."""
    o, d = camera_rays(cam, W, H, pixels, gen, jitter, dtype)
    times = torch.rand((pixels.shape[0],), generator=gen,
                       device=pixels.device).to(dtype)
    return o, d, times


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
            o, d, tm = camera_rays_at(cam, W, H, pixels, gen, s != 0, dtype)
            acc += trace(scene, o, d, tm, gen, max_depth, tmin)
    return acc


def render_stats(scene: dict, cam: dict, W: int, H: int,
                 gen: torch.Generator, n_jittered: int, max_depth: int,
                 tmin: float) -> dict:
    """:func:`tracer.render_stats` of a moving scene: per pixel, in
    float64, ``centered`` [P, 3] (one unjittered sample, global sample 0),
    ``mean`` and ``var`` [P, 3] of ``n_jittered`` jittered samples,
    ``segments`` (the sweeps of all those paths) and ``paths``."""
    if n_jittered < 2:
        raise ValueError("the variance needs two jittered samples or more")
    dtype = scene["center"].dtype
    pixels = torch.arange(W * H, device=scene["center"].device)
    seg = [0]
    f64 = torch.float64
    with torch.no_grad():
        o, d, tm = camera_rays_at(cam, W, H, pixels, gen, False, dtype)
        centered = trace(scene, o, d, tm, gen, max_depth, tmin,
                         segments=seg).to(f64)
        s1 = torch.zeros((W * H, 3), dtype=f64, device=pixels.device)
        s2 = torch.zeros_like(s1)
        # Several samples a wavefront, up to the rays of one sample of a
        # 1080p film, so that a small film is not launch-bound.
        per = max(1, (1 << 21) // (W * H))
        for a in range(0, n_jittered, per):
            b = min(per, n_jittered - a)
            o, d, tm = camera_rays_at(cam, W, H, pixels.repeat(b), gen, True,
                                      dtype)
            x = trace(scene, o, d, tm, gen, max_depth, tmin,
                      segments=seg).to(f64).reshape(b, W * H, 3)
            s1 += x.sum(0)
            s2 += (x * x).sum(0)
    mean = s1 / n_jittered
    var = torch.clamp((s2 - n_jittered * mean * mean) / (n_jittered - 1),
                      min=0.0)
    return dict(centered=centered, mean=mean, var=var, segments=seg[0],
                paths=W * H * (n_jittered + 1))
