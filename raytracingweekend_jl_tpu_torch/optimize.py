"""Inverse-rendering fit — the training entry point of the port (counterpart
of ``raytracingweekend_jl_tpu.optimize``).

:func:`fit_scene` recovers sphere centers and albedos so that a render of
the scene matches a target image, with the reference's hybrid estimator:

- **albedo** (and, with ``lr_fuzz > 0``, metal fuzz): exact interior
  gradients of the differentiable render (:func:`grad.render_loss`; on a
  small image the fixed-depth kernel pair, K3 and K7);
- **centers**: SPSA. Probe pairs ``loss(c +- eps * delta)`` with a shared
  Rademacher direction ``delta`` give ``(L+ - L-) / (2 eps) * delta``. The
  probes are forward renders (``persistent=True``; on a small image one
  launch of the inline kernel K8). Interior autodiff cannot see the
  silhouette terms that dominate a center's gradient, so the AD side
  detaches the centers.

The seed is fixed across steps and shared by both probes of a pair, so the
loss surface is deterministic. The SPSA directions come from
``np.random.default_rng(31 + seed)``, the reference package's own stream,
so both packages draw the same directions.

Adam runs per parameter group (``torch.optim.Adam`` with optax's defaults);
``cosine_decay`` anneals every rate to 0 over ``steps``. The clip of the
albedo to [0, 1] and of the fuzz to >= 0 pass half the cotangent where the
input lies exactly on a bound, as ``jnp.clip`` and ``jnp.maximum`` do.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .camera import Camera
from .grad import render_loss
from .render import _resolve_device, render_radiance
from .scene import METAL, Scene


@dataclass
class FitResult:
    scene: Scene                      #: fitted scene
    losses: list = field(default_factory=list)   #: per-step loss values
    step_seconds: list = field(default_factory=list)  #: per-step wall time


def movable_mask(scene: Scene, radius_cap: float = 10.0) -> np.ndarray:
    """Spheres the fit may move: real (non-padding) and not the ground
    sphere (the reference scenes model the ground as a huge sphere,
    src/scenes.jl:9-14)."""
    r = scene.radius.detach().cpu().numpy()
    return (r != 0) & (np.abs(r) < radius_cap)


class _TieClamp(torch.autograd.Function):
    """``torch.clamp`` whose gradient is ``jnp.clip``'s: 1 inside the
    bounds, 0 outside, 1/2 where the input equals a bound."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        w = torch.ones_like(x)
        zero = torch.zeros_like(x)
        for bound, outside in zip(ctx.bounds, (torch.lt, torch.gt)):
            if bound is not None:
                w = torch.where(outside(x, bound), zero,
                                torch.where(x == bound, 0.5 * w, w))
        return g * w, None, None


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient (half at a bound)."""
    return _TieClamp.apply(x, lo, hi)


def maximum(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)`` with its gradient (half at the bound)."""
    return _TieClamp.apply(x, lo, None)


def make_optimizer(params: dict, lrs: dict, steps: int,
                   cosine_decay: bool = False):
    """``(optimizer, scheduler|None)``: Adam with one group per entry of
    ``params`` (optax's defaults: betas (0.9, 0.999), eps 1e-8) at the rate
    ``lrs[name]``. With ``cosine_decay`` step ``i`` uses ``lr * (1 +
    cos(pi * min(i, steps) / steps)) / 2``, the closed form of
    ``optax.cosine_decay_schedule(lr, steps)``; call ``scheduler.step()``
    after each ``optimizer.step()``."""
    opt = torch.optim.Adam([{"params": [p], "lr": lrs[k]}
                            for k, p in params.items()],
                           betas=(0.9, 0.999), eps=1e-8)
    if not cosine_decay:
        return opt, None
    n = max(steps, 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda i: 0.5 * (1.0 + math.cos(math.pi * min(i, n) / n)))
    return opt, sched


def spsa_delta(gen: np.random.Generator, shape, movable: np.ndarray
               ) -> np.ndarray:
    """One Rademacher direction, zero on immovable spheres: the reference's
    ``(integers(0, 2, shape) * 2 - 1) * movable`` in float32."""
    ints = gen.integers(0, 2, shape)
    return ((ints * 2 - 1) * np.asarray(movable)[:, None]).astype(np.float32)


def fit_scene(scene0: Scene, cam: Camera, target, image_width: int,
              n_samples: int, *, steps: int = 100, seed: int = 0,
              lr_albedo: float = 2e-2, lr_center: float = 8e-3,
              lr_fuzz: float = 0.0, spsa_c: float = 2e-2,
              spsa_pairs: int = 2, movable: np.ndarray | None = None,
              render_kwargs: dict | None = None, geom: str = "spsa",
              edge_kwargs: dict | None = None, cosine_decay: bool = False,
              on_step=None, device=None) -> FitResult:
    """Fit the centers and albedos of ``scene0`` so that its render matches
    ``target`` ([H, W, 3] linear radiance); returns the fitted scene and the
    loss of each step. Runs on ``device``: the card unless ``"cpu"``.

    ``render_kwargs`` go to the differentiable render of the loss
    (:func:`grad.render_loss`: ``seed``, ``max_depth``, the path flags,
    ``replay_fused``); ``render_kwargs["impl"]`` (``"kernels"`` or
    ``"plain"``) also reaches the probes. ``spsa_pairs=0`` fits albedo
    only. ``on_step(i, loss, params)`` is called after each step.
    ``geom="edge"`` (the boundary-aware edge estimator) is not ported."""
    if geom == "edge":
        raise NotImplementedError(
            "geom='edge' needs the boundary-aware edge renderer (reference "
            "ops/edge.py, run on the fixed-depth XLA wavefront), not ported "
            "yet; use geom='spsa'")
    if geom != "spsa":
        raise ValueError(f"geom must be 'spsa' or 'edge', got {geom!r}")
    del edge_kwargs  # only read by geom="edge"
    tkw = dict(render_kwargs) if render_kwargs else {}
    seed = tkw.pop("seed", seed)
    device = _resolve_device(tkw.pop("device", device))
    impl = tkw.get("impl")
    H = target.shape[0]
    target = torch.as_tensor(target, dtype=torch.float32).to(device)
    scene0 = scene0.to(device)
    cam = cam.to(device)
    if movable is None:
        movable = movable_mask(scene0)
    movable = np.asarray(movable, dtype=bool)
    mov = torch.as_tensor(movable, device=device)[:, None]

    fit_fuzz = lr_fuzz > 0
    fuzz_mask = torch.as_tensor(
        movable & (scene0.mat.cpu().numpy() == METAL), dtype=torch.float32,
        device=device)
    params = {"center": scene0.center.detach().clone(),
              "albedo": scene0.albedo.detach().clone()}
    lrs = {"center": lr_center, "albedo": lr_albedo}
    if fit_fuzz:
        params["fuzz"] = scene0.fuzz.detach().clone()
        lrs["fuzz"] = lr_fuzz
    for p in params.values():
        p.requires_grad_(True)
    opt, sched = make_optimizer(params, lrs, steps, cosine_decay)

    def scene_of(center):
        s = scene0._replace(center=center,
                            albedo=clip(params["albedo"], 0.0, 1.0))
        if fit_fuzz:
            s = s._replace(fuzz=maximum(params["fuzz"], 0.0))
        return s

    def probe_loss(center):
        s = scene0._replace(center=center,
                            albedo=torch.clamp(params["albedo"], 0.0, 1.0),
                            fuzz=torch.clamp(params.get("fuzz", scene0.fuzz),
                                             min=0.0))
        img = render_radiance(s, cam, image_width, n_samples, image_height=H,
                              seed=seed, persistent=True, device=device,
                              impl=impl)
        return torch.mean((img - target) ** 2)

    spsa_rng = np.random.default_rng(31 + seed)

    def spsa_center_grad():
        g = torch.zeros_like(params["center"])
        if spsa_pairs == 0:
            return g
        with torch.no_grad():
            for _ in range(spsa_pairs):
                delta = torch.from_numpy(spsa_delta(
                    spsa_rng, tuple(scene0.center.shape), movable)).to(device)
                lp = probe_loss(params["center"] + spsa_c * delta)
                lm = probe_loss(params["center"] - spsa_c * delta)
                g = g + (lp - lm) / (2.0 * spsa_c) * delta
        return g / spsa_pairs

    result = FitResult(scene=scene0)
    for i in range(steps):
        t0 = time.perf_counter()
        # Centers come from SPSA: the AD side detaches them.
        loss = render_loss(scene_of(params["center"].detach()), cam, target,
                           image_width, n_samples, seed=seed, device=device,
                           **tkw)
        ad = [k for k in params if k != "center"]
        g_ad = dict(zip(ad, torch.autograd.grad(
            loss, [params[k] for k in ad], allow_unused=True)))
        grads = {"center": spsa_center_grad(),
                 "albedo": _or_zero(g_ad["albedo"], params["albedo"]) * mov}
        if fit_fuzz:
            grads["fuzz"] = _or_zero(g_ad["fuzz"], params["fuzz"]) * fuzz_mask
        for k, p in params.items():
            p.grad = grads[k]
        opt.step()
        if sched is not None:
            sched.step()
        loss = float(loss.detach())  # the step's one host sync
        result.losses.append(loss)
        result.step_seconds.append(time.perf_counter() - t0)
        if on_step is not None:
            on_step(i, loss, params)

    with torch.no_grad():
        result.scene = Scene(*(x.detach() for x in
                               scene_of(params["center"])))
    return result


def _or_zero(g, like):
    return torch.zeros_like(like) if g is None else g


def fit_scene_scan(*args, **kwargs) -> FitResult:
    """The reference runs the whole fit as one jitted ``lax.scan``; that
    form is not ported."""
    raise NotImplementedError(
        "fit_scene_scan (the reference's whole fit as one jitted lax.scan) "
        "is not ported yet; use fit_scene")
