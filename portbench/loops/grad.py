"""Gradient steps, closed loop: ``render_grads`` of a scene whose albedos
are all scaled down, against the true scene's image, one step after
another on one stream, each ending in a synchronise; the route is the one
``render_grads`` picks by itself.

The scene is held fixed and step ``i`` takes its own seed, drawn from the
run's seed, as an inverse-rendering fit's steps do. The target is the true
scene's image, rendered by the plain reference in set-up. Each step's loss
and gradients are summed, with their squares; once the window has closed,
their means are judged against the reference's steps on the same scene,
camera and target, element by element in standard errors
(:func:`harness.stats.welch_z`).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..harness import stats
from ..harness.seeds import derive, generator
from ..reference.camera import camera_arrays, camera_tensors
from ..reference.scene import (FLOAT_FIELDS, LAMBERTIAN, padded, scene_arrays,
                               scene_tensors)
from ..reference.tracer import grad_step, render_sum

#: Elements of each field per sphere, in :data:`FLOAT_FIELDS` order.
_WIDTH = {"center": 3, "radius": 1, "albedo": 3, "fuzz": 1, "ir": 1}


class Loop:
    """Set-up builds the inputs and the program's objects; :meth:`call` is
    one timed step; :meth:`check` judges the steps' means."""

    def __init__(self, cell, seed: int, device, variant: str = "port",
                 overrides: dict | None = None):
        t = dict(cell.traffic, **(overrides or {}))
        cfg = cell.config
        self.device = torch.device(device)
        self.seed = seed
        self.W, self.H = int(t["width"]), int(t["height"])
        self.n_pix = self.W * self.H
        self.spp = int(t["spp"])
        self.ref_steps = int(t["check"]["reference_steps"])
        self.depth, self.tmin = int(cfg["max_depth"]), float(cfg["tmin"])
        true = scene_arrays(cfg["scene"])
        self.n_spheres = true["radius"].shape[0]
        self.scene = dict(true, albedo=np.clip(
            true["albedo"] * float(t["albedo_scale"]), 0.0, 1.0))
        self.pad_to = int(cfg["pad_to"])
        self.cam = camera_arrays(cfg["camera"])
        self.segments_per_path = float(cfg["segments_per_path"]["value"])
        n_target = int(t["target_spp"])
        t_ref = time.perf_counter()
        self.target = (render_sum(
            scene_tensors(true, torch.float32, self.device),
            camera_tensors(self.cam, torch.float32, self.device), self.W,
            self.H, generator(seed, "target", self.device), 1, n_target,
            self.depth, self.tmin) / n_target).reshape(self.H, self.W, 3)
        _sync(self.device)
        #: Set-up seconds that the reference spent on the target, which
        #: ``setup_s`` leaves out.
        self.reference_s = time.perf_counter() - t_ref
        n_el = 9 * self.n_spheres
        f64 = torch.float64
        self.sums = [torch.zeros((), dtype=f64, device=self.device),
                     torch.zeros((n_el,), dtype=f64, device=self.device)]
        self.squares = [torch.zeros_like(x) for x in self.sums]
        self.calls = 0
        self.program = VARIANTS[variant](self)

    def warm(self) -> None:
        """One step at the cell's shape, not summed."""
        self.program(derive(self.seed, "warm"))
        _sync(self.device)

    def call(self) -> int:
        """One timed step; returns its paths (pixels x spp)."""
        loss, flat = self.program(derive(self.seed, "step", self.calls))
        for acc, sq, x in zip(self.sums, self.squares, (loss, flat)):
            x = x.to(torch.float64)
            acc += x
            sq += x * x
        _sync(self.device)
        self.calls += 1
        return self.n_pix * self.spp

    def free(self) -> None:
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """``nonfinite``, the program's sums and squares that are not
        finite; ``constant_mismatch``, the elements (the loss among them)
        that vary on neither side yet differ, whose z is infinite;
        ``loss_z``; and per field the mean square of the finite z of its
        elements that vary."""
        scene = scene_tensors(self.scene, torch.float32, self.device)
        cam = camera_tensors(self.cam, torch.float32, self.device)
        gen = generator(self.seed, "reference", self.device)
        f64 = torch.float64
        r_sum = [torch.zeros_like(x) for x in self.sums]
        r_sq = [torch.zeros_like(x) for x in self.sums]
        for _ in range(self.ref_steps):
            loss, grads = grad_step(scene, cam, self.W, self.H, self.target,
                                    gen, self.depth, self.tmin)
            for acc, sq, x in zip(r_sum, r_sq, (loss, flatten(grads))):
                x = x.to(f64)
                acc += x
                sq += x * x
        z = [stats.welch_z(a, b, self.calls, c, d, self.ref_steps)
             for a, b, c, d in zip(self.sums, self.squares, r_sum, r_sq)]
        out = {"nonfinite": float(sum(int((~torch.isfinite(x)).sum())
                                      for x in self.sums + self.squares)),
               "constant_mismatch": float(sum(int(torch.isinf(x).sum())
                                              for x in z)),
               "loss_z": float(z[0].abs())}
        a = 0
        notes = []
        for f in FLOAT_FIELDS:
            n = _WIDTH[f] * self.n_spheres
            cut = slice(a, a + n)
            zf = z[1][cut]
            moved = ((self.squares[1][cut] > 0) | (r_sq[1][cut] > 0)
                     | (zf != 0)) & torch.isfinite(zf)
            out[f"z2_{f}"] = (float((zf[moved] ** 2).mean()) if moved.any()
                              else 0.0)
            notes.append(f"{f} {int(moved.sum())} moved, variance ratio "
                         f"{_variance_ratio(self, r_sum, r_sq, cut):.3g}")
            a += n
        print("portbench: reference over program variance, median: "
              + "; ".join(notes), file=sys.stderr)
        return out


def _variance_ratio(loop, r_sum, r_sq, cut) -> float:
    """Median over the elements of ``cut`` that vary on both sides of the
    reference's per-step variance over the program's."""
    n, m = loop.calls, loop.ref_steps
    va = loop.squares[1][cut] / n - (loop.sums[1][cut] / n) ** 2
    vb = r_sq[1][cut] / m - (r_sum[1][cut] / m) ** 2
    both = (va > 0) & (vb > 0)
    return float((vb[both] / va[both]).median()) if both.any() else float("nan")


def flatten(grads, n: int | None = None) -> torch.Tensor:
    """The fields of ``grads`` (a mapping or the program's ``SceneGrads``),
    their first ``n`` spheres, as one vector in :data:`FLOAT_FIELDS`
    order."""
    get = grads.__getitem__ if isinstance(grads, dict) else (
        lambda f: getattr(grads, f))
    return torch.cat([get(f)[:n].reshape(-1) for f in FLOAT_FIELDS])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _port(loop: Loop, loss_fn=None):
    """The program: ``render_grads`` of the scaled scene, its route picked
    by ``render_grads`` itself."""
    from raytracingweekend_jl_tpu_torch.camera import Camera
    from raytracingweekend_jl_tpu_torch.grad import render_grads
    from raytracingweekend_jl_tpu_torch.scene import Scene

    scene = Scene(**scene_tensors(padded(loop.scene, loop.pad_to),
                                  torch.float32, loop.device))
    cam = Camera(**camera_tensors(loop.cam, torch.float32, loop.device))
    kw = {} if loss_fn is None else {"loss_fn": loss_fn}

    def run(seed: int):
        loss, grads = render_grads(scene, cam, loop.target, loop.W, loop.spp,
                                   seed=seed, device=loop.device,
                                   max_depth=loop.depth, **kw)
        return loss, flatten(grads, loop.n_spheres)
    return run


def _control(loop: Loop):
    """The reference in the program's place, in bfloat16: the nearest
    precision below the configuration's float32."""
    bf16 = torch.bfloat16
    scene = scene_tensors(loop.scene, bf16, loop.device)
    cam = camera_tensors(loop.cam, bf16, loop.device)
    gen = generator(loop.seed, "control", loop.device)

    def run(seed: int):
        loss, grads = grad_step(scene, cam, loop.W, loop.H, loop.target, gen,
                                loop.depth, loop.tmin)
        return loss.float(), flatten(grads).float()
    return run


def _unchanged(loop: Loop):
    port = _port(loop)

    def run(seed: int):
        loss, flat = port(seed)
        return torch.zeros_like(loss), torch.zeros_like(flat)
    return run


def _half_batch(loop: Loop):
    half = loop.H // 2
    return _port(loop, loss_fn=lambda img, target: torch.mean(
        (img[:half] - target[:half]) ** 2))


def _altered(loop: Loop):
    port = _port(loop)
    n = loop.n_spheres
    albedo = slice(4 * n, 7 * n)

    def run(seed: int):
        loss, flat = port(seed)
        flat[albedo] *= 2.0
        return loss, flat
    return run


def _constant(loop: Loop):
    """A constant added to a gradient that both sides hold at 0 on every
    step: the index of refraction of the first Lambertian sphere."""
    port = _port(loop)
    k = int(np.flatnonzero(loop.scene["mat"] == LAMBERTIAN)[0])
    ir = 8 * loop.n_spheres + k

    def run(seed: int):
        loss, flat = port(seed)
        flat[ir] += 1e-3
        return loss, flat
    return run


#: The program, its control and the faults the tests plant in it.
VARIANTS = {"port": _port, "control": _control, "unchanged": _unchanged,
            "half_batch": _half_batch, "altered": _altered,
            "constant": _constant}
