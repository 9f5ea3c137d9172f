"""Gradient steps at several samples a pixel, closed loop: :mod:`.grad`'s
loop (its set-up, steps, window and faults) with ``render_grads`` at the
traffic's ``spp``, on the route and under the record budget that the
program picks by itself, so the steps drive the pass loop.

The check is :mod:`.grad`'s, element by element in standard errors, with
the reference's step at the same samples a pixel
(:func:`reference.grad_spp.grad_step_spp`): the loss of a mean of ``spp``
samples has another expectation than that of one sample.
"""

from __future__ import annotations

import sys

import torch

from ..harness import stats
from ..harness.seeds import generator
from ..reference.camera import camera_tensors
from ..reference.grad_spp import grad_step_spp
from ..reference.scene import FLOAT_FIELDS, scene_tensors
from . import grad

#: The kind of run: the ``*.grad`` metrics and ``grad_mpaths_s`` read it.
KIND = "grad"


class Loop(grad.Loop):
    """:class:`.grad.Loop` with the reference's step at the cell's samples
    a pixel, in its check and in its control."""

    def __init__(self, cell, seed: int, device, variant: str = "port",
                 overrides: dict | None = None):
        super().__init__(cell, seed, device, variant, overrides)
        if variant == "control":
            self.program = _control(self)

    def check(self) -> dict:
        """:meth:`.grad.Loop.check`'s numbers, against
        :func:`grad_step_spp` at the cell's samples a pixel."""
        scene = scene_tensors(self.scene, torch.float32, self.device)
        cam = camera_tensors(self.cam, torch.float32, self.device)
        gen = generator(self.seed, "reference", self.device)
        f64 = torch.float64
        r_sum = [torch.zeros_like(x) for x in self.sums]
        r_sq = [torch.zeros_like(x) for x in self.sums]
        for _ in range(self.ref_steps):
            loss, grads = grad_step_spp(scene, cam, self.W, self.H,
                                        self.target, gen, self.depth,
                                        self.tmin, self.spp)
            for acc, sq, x in zip(r_sum, r_sq, (loss, grad.flatten(grads))):
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
            n = grad._WIDTH[f] * self.n_spheres
            cut = slice(a, a + n)
            zf = z[1][cut]
            moved = ((self.squares[1][cut] > 0) | (r_sq[1][cut] > 0)
                     | (zf != 0)) & torch.isfinite(zf)
            out[f"z2_{f}"] = (float((zf[moved] ** 2).mean()) if moved.any()
                              else 0.0)
            notes.append(f"{f} {int(moved.sum())} moved, variance ratio "
                         f"{grad._variance_ratio(self, r_sum, r_sq, cut):.3g}")
            a += n
        print("portbench: reference over program variance, median: "
              + "; ".join(notes), file=sys.stderr)
        return out


def _control(loop: Loop):
    """The reference's step at the cell's samples a pixel in the program's
    place, in bfloat16: the nearest precision below the configuration's
    float32."""
    bf16 = torch.bfloat16
    scene = scene_tensors(loop.scene, bf16, loop.device)
    cam = camera_tensors(loop.cam, bf16, loop.device)
    gen = generator(loop.seed, "control", loop.device)

    def run(seed: int):
        loss, grads = grad_step_spp(scene, cam, loop.W, loop.H, loop.target,
                                    gen, loop.depth, loop.tmin, loop.spp)
        return loss.float(), grad.flatten(grads).float()
    return run
