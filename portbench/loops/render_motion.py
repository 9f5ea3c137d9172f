"""Forward renders of a moving scene, closed loop: :mod:`.render`'s loop
(calls, images, accumulator, window) on a scene whose spheres move over the
shutter (book 2's motion blur). The program is
``render_tile_sum(persistent=True, inline=False)`` of a ``MovingScene``,
whose route is the strided loop with K1m and K2m in chunk graphs; the check
is :mod:`.render`'s, per block of pixels and channel in standard errors,
against the plain reference of moving scenes
(:func:`reference.motion.render_stats`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..harness import stats
from ..harness.seeds import generator
from ..reference.camera import camera_tensors
from ..reference.motion import motion_array, moving_tensors, render_sum
from ..reference.motion import render_stats
from ..reference.scene import padded
from . import render

#: The kind of run: the ``*.render`` metrics and ``render_mpaths_s`` read it.
KIND = "render"


class Loop(render.Loop):
    """:class:`.render.Loop` on the configuration's moving scene."""

    def __init__(self, cell, seed: int, device, variant: str = "port",
                 overrides: dict | None = None):
        # The render loop's inputs and accumulators; its program, a static
        # scene's, is replaced by this loop's.
        super().__init__(cell, seed, device, "port", overrides)
        self.motion = motion_array(cell.config["scene"])
        self.program = VARIANTS[variant](self)

    def check(self) -> dict:
        """The numbers compared, by name: :meth:`.render.Loop.check`'s,
        against the reference of moving scenes."""
        scene = moving_tensors(self.scene, self.motion, torch.float32,
                               self.device)
        cam = camera_tensors(self.cam, torch.float32, self.device)
        ref = render_stats(scene, cam, self.W, self.H,
                           generator(self.seed, "reference", self.device),
                           self.ref_spp, self.depth, self.tmin)
        z = stats.image_z(self.acc, self.acc_sq, self.calls,
                          self.spp * self.calls, self.unjittered, ref, self.W,
                          self.H, self.blocks)
        worst = int(z.abs().argmax())
        bx = self.blocks[0]
        print(f"portbench: largest |z| {float(z.flatten()[worst]):.3f} in "
              f"block row {worst // 3 // bx}, column {worst // 3 % bx}, "
              f"channel {worst % 3}", file=sys.stderr)
        return {"block_z_max": float(z.abs().max()),
                "block_z2_mean": float((z * z).mean())}


def _port(loop: Loop, frozen: bool = False):
    """The program: ``render_tile_sum(persistent=True, inline=False)`` of
    the film, the scene a ``MovingScene`` (with every motion zeroed when
    ``frozen``: each sphere stays at its centre at time 0)."""
    from raytracingweekend_jl_tpu_torch.camera import Camera
    from raytracingweekend_jl_tpu_torch.render import render_tile_sum
    from raytracingweekend_jl_tpu_torch.scene import scene_from_numpy

    arrays = padded(loop.scene, loop.pad_to)
    n = arrays["radius"].shape[0]
    motion = np.zeros((n, 3))
    if not frozen:
        motion[:loop.motion.shape[0]] = loop.motion
    # A MovingScene, each field cast once from float64 to float32 as
    # moving_tensors casts it.
    scene = scene_from_numpy({**arrays, "motion": motion},
                             device=loop.device)
    cam = Camera(**camera_tensors(loop.cam, torch.float32, loop.device))
    W, H = float(loop.W), float(loop.H)

    def run(seed: int, offset: int) -> torch.Tensor:
        return render_tile_sum(scene, cam, loop.n_pix, seed, loop.spp,
                               offset, loop.depth, loop.tmin, W, H,
                               persistent=True, inline=False)
    return run


def _control(loop: Loop):
    """The reference in the program's place, in bfloat16: the nearest
    precision below the configuration's float32."""
    bf16 = torch.bfloat16
    scene = moving_tensors(loop.scene, loop.motion, bf16, loop.device)
    cam = camera_tensors(loop.cam, bf16, loop.device)
    gen = generator(loop.seed, "control", loop.device)

    def run(seed: int, offset: int) -> torch.Tensor:
        return render_sum(scene, cam, loop.W, loop.H, gen, offset, loop.spp,
                          loop.depth, loop.tmin).float()
    return run


#: The program, its control and the fault the tests plant in it:
#: ``frozen``, the motion zeroed.
VARIANTS = {"port": _port, "control": _control,
            "frozen": lambda loop: _port(loop, frozen=True)}
