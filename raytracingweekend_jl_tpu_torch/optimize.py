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

With ``geom="edge"`` the centers' gradient is autodiff of the
boundary-aware edge render (``ops/edge.py``) instead, in the same
value-and-grad as the albedo's, and no probes run.
:func:`fit_scene_scan` is the same fit with no host sync of its own per
step (the reference's whole-fit ``lax.scan``).

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


class _Fit:
    """One fit's state and step, shared by :func:`fit_scene` and
    :func:`fit_scene_scan` (the arguments are theirs)."""

    def __init__(self, scene0, cam, target, image_width, n_samples, *, steps,
                 seed, lr_albedo, lr_center, lr_fuzz, spsa_c, spsa_pairs,
                 movable, render_kwargs, geom, edge_kwargs, cosine_decay,
                 device):
        if geom not in ("spsa", "edge"):
            raise ValueError(f"geom must be 'spsa' or 'edge', got {geom!r}")
        tkw = dict(render_kwargs) if render_kwargs else {}
        self.seed = tkw.pop("seed", seed)
        self.device = device = _resolve_device(tkw.pop("device", device))
        if geom == "edge" and tkw:
            # The edge loss reads edge_kwargs only: dropping a caller's
            # render_kwargs silently would lose what they relied on.
            raise ValueError(
                f"render_kwargs {sorted(tkw)} have no effect with "
                "geom='edge': configure the edge loss via edge_kwargs "
                "(sigma/sigma_px/edge_bounces/pixel_chunk/remat_chunks)")
        self.tkw, self.geom = tkw, geom
        self.ekw = dict(edge_kwargs or {})
        self.impl = tkw.get("impl")
        self.H, self.W, self.spp = target.shape[0], image_width, n_samples
        self.scene0 = scene0 = scene0.to(device)
        self.cam = cam.to(device)
        # A float64 fit keeps its target in float64.
        self.target = torch.as_tensor(target, dtype=torch.promote_types(
            scene0.center.dtype, self.cam.origin.dtype)).to(device)
        if movable is None:
            movable = movable_mask(scene0)
        self.movable = movable = np.asarray(movable, dtype=bool)
        self.mov = torch.as_tensor(movable, device=device)[:, None]
        self.fit_fuzz = lr_fuzz > 0
        self.fuzz_mask = torch.as_tensor(
            movable & (scene0.mat.cpu().numpy() == METAL),
            dtype=torch.float32, device=device)
        self.params = {"center": scene0.center.detach().clone(),
                       "albedo": scene0.albedo.detach().clone()}
        lrs = {"center": lr_center, "albedo": lr_albedo}
        if self.fit_fuzz:
            self.params["fuzz"] = scene0.fuzz.detach().clone()
            lrs["fuzz"] = lr_fuzz
        for p in self.params.values():
            p.requires_grad_(True)
        self.opt, self.sched = make_optimizer(self.params, lrs, steps,
                                              cosine_decay)
        self.spsa_c, self.spsa_pairs = spsa_c, spsa_pairs

    def scene_of(self, center):
        p = self.params
        s = self.scene0._replace(center=center,
                                 albedo=clip(p["albedo"], 0.0, 1.0))
        if self.fit_fuzz:
            s = s._replace(fuzz=maximum(p["fuzz"], 0.0))
        return s

    def probe_loss(self, center):
        p = self.params
        s = self.scene0._replace(
            center=center, albedo=torch.clamp(p["albedo"], 0.0, 1.0),
            fuzz=torch.clamp(p.get("fuzz", self.scene0.fuzz), min=0.0))
        img = render_radiance(s, self.cam, self.W, self.spp,
                              image_height=self.H, seed=self.seed,
                              persistent=True, device=self.device,
                              impl=self.impl)
        return torch.mean((img - self.target) ** 2)

    def spsa_center_grad(self, delta_fn):
        """The SPSA center gradient, ``delta_fn()`` giving each pair's
        direction on the device."""
        center = self.params["center"]
        g = torch.zeros_like(center)
        if self.spsa_pairs == 0:
            return g
        with torch.no_grad():
            for _ in range(self.spsa_pairs):
                delta = delta_fn()
                lp = self.probe_loss(center + self.spsa_c * delta)
                lm = self.probe_loss(center - self.spsa_c * delta)
                g = g + (lp - lm) / (2.0 * self.spsa_c) * delta
        return g / self.spsa_pairs

    def step(self, delta_fn) -> torch.Tensor:
        """One Adam step; returns the step's loss on the device (no host
        sync here)."""
        p = self.params
        if self.geom == "edge":
            # Boundary-aware AD: one value-and-grad gives the albedo's
            # interior gradient and the centers' interior and silhouette
            # terms; no probes.
            from .ops.edge import render_radiance_edge
            img = render_radiance_edge(
                self.scene_of(p["center"]), self.cam, self.W, self.spp,
                image_height=self.H, seed=self.seed, device=self.device,
                **self.ekw)
            loss = torch.mean((img - self.target) ** 2)
            names = list(p)
        else:
            # Centers come from SPSA: the AD side detaches them.
            loss = render_loss(self.scene_of(p["center"].detach()), self.cam,
                               self.target, self.W, self.spp, seed=self.seed,
                               device=self.device, **self.tkw)
            names = [k for k in p if k != "center"]
        g_ad = dict(zip(names, torch.autograd.grad(
            loss, [p[k] for k in names], allow_unused=True)))
        grads = {"center": (_or_zero(g_ad["center"], p["center"]) * self.mov
                            if self.geom == "edge"
                            else self.spsa_center_grad(delta_fn)),
                 "albedo": _or_zero(g_ad["albedo"], p["albedo"]) * self.mov}
        if self.fit_fuzz:
            grads["fuzz"] = _or_zero(g_ad["fuzz"], p["fuzz"]) * self.fuzz_mask
        for k, x in p.items():
            x.grad = grads[k]
        self.opt.step()
        if self.sched is not None:
            self.sched.step()
        return loss.detach()

    def fitted_scene(self) -> Scene:
        with torch.no_grad():
            return Scene(*(x.detach() for x in
                           self.scene_of(self.params["center"])))


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

    ``geom`` picks the centers' gradient: ``"spsa"`` (the hybrid above) or
    ``"edge"``, autodiff of the boundary-aware edge render
    (:func:`ops.edge.render_radiance_edge`): one value-and-grad gives the
    albedo's and the centers' gradients, and no probes run.
    ``edge_kwargs`` go to that render (``sigma``, ``sigma_px``,
    ``edge_bounces``, ``pixel_chunk``, ``remat_chunks``, ``impl``);
    ``render_kwargs`` other than ``seed`` and ``device`` then raise."""
    fit = _Fit(scene0, cam, target, image_width, n_samples, steps=steps,
               seed=seed, lr_albedo=lr_albedo, lr_center=lr_center,
               lr_fuzz=lr_fuzz, spsa_c=spsa_c, spsa_pairs=spsa_pairs,
               movable=movable, render_kwargs=render_kwargs, geom=geom,
               edge_kwargs=edge_kwargs, cosine_decay=cosine_decay,
               device=device)
    spsa_rng = np.random.default_rng(31 + fit.seed)
    shape = tuple(fit.scene0.center.shape)
    delta_fn = lambda: torch.from_numpy(spsa_delta(
        spsa_rng, shape, fit.movable)).to(fit.device)

    result = FitResult(scene=fit.scene0)
    for i in range(steps):
        t0 = time.perf_counter()
        loss = float(fit.step(delta_fn))  # the step's one host sync
        result.losses.append(loss)
        result.step_seconds.append(time.perf_counter() - t0)
        if on_step is not None:
            on_step(i, loss, fit.params)
    result.scene = fit.fitted_scene()
    return result


def fit_scene_scan(scene0: Scene, cam: Camera, target, image_width: int,
                   n_samples: int, *, steps: int = 100, seed: int = 0,
                   lr_albedo: float = 2e-2, lr_center: float = 8e-3,
                   lr_fuzz: float = 0.0, spsa_c: float = 2e-2,
                   spsa_pairs: int = 2, movable: np.ndarray | None = None,
                   render_kwargs: dict | None = None, geom: str = "spsa",
                   edge_kwargs: dict | None = None,
                   cosine_decay: bool = False, device=None) -> FitResult:
    """:func:`fit_scene` with no host sync of its own per step (the
    reference runs the whole fit as one jitted ``lax.scan``): the losses
    stay on the device and are read once at the end, and every step's
    ``step_seconds`` is the wall time over ``steps``. The steps' routes may
    still sync inside (a render's active-lane checks). Differences from
    :func:`fit_scene`: the SPSA directions come from a generator on the
    device seeded from ``seed + 101`` (the reference draws them from
    ``jax.random``; statistically alike), and there is no per-step
    callback. Arguments as :func:`fit_scene`."""
    fit = _Fit(scene0, cam, target, image_width, n_samples, steps=steps,
               seed=seed, lr_albedo=lr_albedo, lr_center=lr_center,
               lr_fuzz=lr_fuzz, spsa_c=spsa_c, spsa_pairs=spsa_pairs,
               movable=movable, render_kwargs=render_kwargs, geom=geom,
               edge_kwargs=edge_kwargs, cosine_decay=cosine_decay,
               device=device)
    gen = torch.Generator(device=fit.device)
    gen.manual_seed(fit.seed + 101)
    shape = tuple(fit.scene0.center.shape)
    mov = fit.mov.to(torch.float32)
    delta_fn = lambda: (torch.randint(0, 2, shape, generator=gen,
                                      device=fit.device,
                                      dtype=torch.float32) * 2.0 - 1.0) * mov

    t0 = time.perf_counter()
    losses = torch.stack([fit.step(delta_fn) for _ in range(steps)]) \
        if steps else torch.zeros(0)
    losses = losses.cpu().tolist()
    wall = time.perf_counter() - t0
    return FitResult(scene=fit.fitted_scene(), losses=losses,
                     step_seconds=[wall / max(steps, 1)] * steps)


def _or_zero(g, like):
    return torch.zeros_like(like) if g is None else g
