"""The reference's gradient step at several samples a pixel: the loss is the
mean squared error of each pixel's mean of ``spp`` samples against the
target, with global sample 0 unjittered and samples 1 .. spp - 1 jittered,
as the program draws them (src/render.jl:30-35), and its gradients by
autograd over every float field of the scene.

The loss is a sum over pixels, so the film is taken in blocks of pixels,
each block's part of the loss and its gradients computed alone and summed:
the same loss and gradients, in the memory of one block.

The gradients of the winners' fields are summed over the paths in float64
(:func:`trace`): in float32, as :func:`tracer.trace` sums them, the sum of
the big metal sphere's blue albedo over the 8.3 million paths of a 1080p
step of 4 samples came out 0.34% high, 47 to 50 standard errors of the
program's mean, on two seeds, and agreed with the program once summed in
float64 (an H100; PERF.md).
"""

from __future__ import annotations

import torch

from .camera import camera_rays
from .scene import FLOAT_FIELDS
from .tracer import BIG, _hit_t, _scatter, _sweep
from .vec import normalize, skycolor

#: Rays a block traces at most: a 1920x1080 film at one sample a pixel,
#: which :func:`tracer.grad_step` traces in one piece.
BLOCK_RAYS = 1920 * 1080


def trace(scene: dict, o: torch.Tensor, d: torch.Tensor,
          gen: torch.Generator, max_depth: int, tmin: float) -> torch.Tensor:
    """:func:`tracer.trace` with ``differentiable=True``, the same draws
    and the same radiance bit for bit, but with its gather table of the
    winners' fields in float64 and each gathered row cast to the rays' type:
    the gather's backward then sums every path's gradient into the table in
    float64, and each field's gradient is rounded to its type once."""
    dtype = o.dtype
    rad = torch.zeros_like(o)
    live = torch.arange(o.shape[0], device=o.device)
    thr = torch.ones_like(o)
    table = torch.cat([scene["center"], scene["radius"][:, None],
                       scene["albedo"], scene["fuzz"][:, None],
                       scene["ir"][:, None]], 1).double()
    for _ in range(max_depth):
        if live.numel() == 0:
            break
        with torch.no_grad():
            t, win, far = _sweep(o.detach(), d.detach(), scene, tmin)
        hit = t < BIG
        miss = ~hit
        rad = rad.index_add(0, live[miss], thr[miss] * skycolor(d[miss]))
        live, o, d, thr = live[hit], o[hit], d[hit], thr[hit]
        t, win, far = t[hit], win[hit], far[hit]
        rows = table.index_select(0, win).to(dtype)
        c, r = rows[:, 0:3], rows[:, 3]
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


def grad_step_spp(scene: dict, cam: dict, W: int, H: int,
                  target: torch.Tensor, gen: torch.Generator,
                  max_depth: int, tmin: float, spp: int,
                  block_rays: int = BLOCK_RAYS
                  ) -> tuple[torch.Tensor, dict]:
    """``(loss, grads)``: the mean squared error of each pixel's mean of
    ``spp`` samples against ``target`` [H, W, 3], and its gradients with
    respect to every float field of ``scene``, in the scene's float type.

    Blocks of ``block_rays // spp`` pixels, in order: each draws its
    unjittered sample 0, then its ``spp - 1`` jittered samples, traces them
    in one wavefront, and adds its share of the mean (a block of ``n`` of
    the film's ``P`` pixels: its own mean times ``n / P``) and that share's
    gradients. With one block and ``spp`` 1 this is
    :func:`tracer.grad_step` draw for draw, its loss bit for bit, its
    gradients summed in float64 (:func:`trace`)."""
    dtype = scene["center"].dtype
    dev = scene["center"].device
    leaves = {f: scene[f].detach().clone().requires_grad_(True)
              for f in FLOAT_FIELDS}
    sc = dict(leaves, mat=scene["mat"])
    n_pix = W * H
    rows = max(1, block_rays // spp)
    flat = target.reshape(-1, 3).to(dtype)
    loss, grads = None, dict.fromkeys(FLOAT_FIELDS)
    for a in range(0, n_pix, rows):
        pixels = torch.arange(a, min(a + rows, n_pix), device=dev)
        n = pixels.shape[0]
        with torch.no_grad():
            o, d = camera_rays(cam, W, H, pixels, gen, False, dtype)
            if spp > 1:
                oj, dj = camera_rays(cam, W, H, pixels.repeat(spp - 1), gen,
                                     True, dtype)
                o, d = torch.cat([o, oj]), torch.cat([d, dj])
        rad = trace(sc, o, d, gen, max_depth, tmin)
        img = rad.reshape(spp, n, 3).sum(0) / spp
        part = ((img - flat[a:a + n]) ** 2).mean() * (n / n_pix)
        block = torch.autograd.grad(part, list(leaves.values()),
                                    allow_unused=True)
        part = part.detach()
        loss = part if loss is None else loss + part
        for f, g in zip(FLOAT_FIELDS, block):
            if g is not None:
                grads[f] = g if grads[f] is None else grads[f] + g
    return loss, {f: torch.zeros_like(leaves[f]) if g is None else g
                  for f, g in grads.items()}
