"""Forward renders, closed loop: ``render_tile_sum(persistent=True)`` of the
whole film, one call after another on one stream, each ending in a
synchronise.

Call ``i`` renders global samples ``spp * (i % calls_per_image)`` onward
of image ``i // calls_per_image``, whose seed is drawn from the run's
seed: an image of ``image_spp`` samples is ``image_spp / spp`` calls, and
the next call starts a new image. Every call's sum, and its square, is
added into one accumulator, which is judged once the window has closed:
per block of pixels and channel, its mean against the reference's, in
standard errors (:func:`harness.stats.image_z`).
"""

from __future__ import annotations

import sys

import torch

from ..harness import stats
from ..harness.seeds import derive, generator
from ..reference.camera import camera_arrays, camera_tensors
from ..reference.scene import padded, scene_arrays, scene_tensors
from ..reference.tracer import render_sum, render_stats


class Loop:
    """Set-up builds the inputs and the program's objects; :meth:`call` is
    one timed call; :meth:`check` judges the accumulated image."""

    def __init__(self, cell, seed: int, device, variant: str = "port",
                 overrides: dict | None = None):
        t = dict(cell.traffic, **(overrides or {}))
        cfg = cell.config
        self.device = torch.device(device)
        self.seed = seed
        self.W, self.H = int(t["width"]), int(t["height"])
        self.n_pix = self.W * self.H
        self.spp = int(t["spp_per_call"])
        self.per_image = int(t["image_spp"]) // self.spp
        self.blocks = tuple(t["check"]["blocks"])
        self.ref_spp = int(t["check"]["reference_jittered_spp"])
        self.depth, self.tmin = int(cfg["max_depth"]), float(cfg["tmin"])
        self.scene = scene_arrays(cfg["scene"])
        self.n_spheres = self.scene["radius"].shape[0]
        self.pad_to = int(cfg["pad_to"])
        self.cam = camera_arrays(cfg["camera"])
        self.segments_per_path = float(cfg["segments_per_path"]["value"])
        self.acc = torch.zeros((self.n_pix, 3), dtype=torch.float32,
                               device=self.device)
        self.acc_sq = torch.zeros_like(self.acc)
        self.calls = 0
        self.unjittered = 0
        self.program = VARIANTS[variant](self)

    def warm(self) -> None:
        """One call at the cell's shape, not accumulated."""
        self.program(derive(self.seed, "warm"), 0)
        _sync(self.device)

    def call(self) -> int:
        """One timed call; returns the paths it traced."""
        i = self.calls
        offset = self.spp * (i % self.per_image)
        self.unjittered += offset == 0
        out = self.program(derive(self.seed, "image", i // self.per_image),
                           offset)
        self.acc += out
        self.acc_sq.addcmul_(out, out)
        _sync(self.device)
        self.calls += 1
        return self.spp * self.n_pix

    def free(self) -> None:
        """Drop the program's objects; the accumulated image stays."""
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """The numbers compared, by name."""
        scene = scene_tensors(self.scene, torch.float32, self.device)
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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _port(loop: Loop):
    """The program: ``render_tile_sum(persistent=True)`` of the film."""
    from raytracingweekend_jl_tpu_torch.camera import Camera
    from raytracingweekend_jl_tpu_torch.render import render_tile_sum
    from raytracingweekend_jl_tpu_torch.scene import Scene

    scene = Scene(**scene_tensors(padded(loop.scene, loop.pad_to),
                                  torch.float32, loop.device))
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
    scene = scene_tensors(loop.scene, bf16, loop.device)
    cam = camera_tensors(loop.cam, bf16, loop.device)
    gen = generator(loop.seed, "control", loop.device)

    def run(seed: int, offset: int) -> torch.Tensor:
        return render_sum(scene, cam, loop.W, loop.H, gen, offset, loop.spp,
                          loop.depth, loop.tmin).float()
    return run


def _fault(kind: str):
    def make(loop: Loop):
        port = _port(loop)
        half = loop.n_pix // 2

        def run(seed: int, offset: int) -> torch.Tensor:
            out = port(seed, offset)
            if kind == "unchanged":
                return torch.zeros_like(out)
            if kind == "half_batch":
                out[half:] = out[:half].mean(0)
            if kind == "altered":
                out[:loop.n_pix // 16] *= 2.0
            return out
        return run
    return make


#: The program, its control and the faults the tests plant in it.
VARIANTS = {"port": _port, "control": _control,
            "unchanged": _fault("unchanged"),
            "half_batch": _fault("half_batch"),
            "altered": _fault("altered")}
