"""Render configuration — the config/flag system the reference lacks
(SURVEY.md §5: 'Config: None — function kwargs + script-edited globals').

The JAX package's ``RenderConfig`` field for field, with its defaults and
order, plus ``device`` (``None`` means the card, as every entry point of the
port reads it). The sharded fields (``mesh_tiles``, ``mesh_samples``,
``tile_size``, ``multihost``, ``strip_dir``) are kept so that configs compare
and serialise alike; the port's command line refuses values that would
shard.
"""

from __future__ import annotations

from dataclasses import dataclass, asdict

import torch


CAMERA_PRESETS = ("default", "cam1", "cam2", "hollow_glass")


@dataclass
class RenderConfig:
    scene: str = "random_spheres"       # key into models.scenes.ALL_SCENES
    camera: str = "cam1"                # one of CAMERA_PRESETS
    image_width: int = 400
    image_height: int | None = None     # None -> reference 16:9 formula
    n_samples: int = 32
    max_depth: int = 16                 # reference default (src/ray_color.jl:14)
    tmin: float = 1e-4                  # reference shadow-acne epsilon
    seed: int = 0
    precision: str = "f32"              # f32 | f64 (the elem_type switch)
    scene_seed: int = 1                 # for random_spheres

    # Execution knobs
    compact: bool = False               # forward-only compacting wavefront
    persistent: bool = True             # persistent integrators (fastest)
    rays_per_pass: int = 1 << 21        # wavefront size target
    mesh_tiles: int = 1                 # devices on the pixel-tile axis
    mesh_samples: int = 1               # devices on the sample axis
    tile_size: int = 8192               # pixels per shard tile

    # Multi-host (not ported: the port renders on one card)
    multihost: bool = False
    strip_dir: str | None = None        # default: "<output>.strips"

    # Checkpointing
    spp_chunk: int = 0                  # 0 = no chunking
    checkpoint_path: str | None = None

    output: str = "render.png"

    device: str | None = None           # None = the card; "cpu" for the CPU

    def dtype(self) -> torch.dtype:
        return {"f32": torch.float32, "f64": torch.float64}[self.precision]

    def build_scene(self):
        """The scene, built on the CPU (the entry points move it)."""
        from ..models.scenes import ALL_SCENES, scene_random_spheres
        if self.scene == "random_spheres":
            return scene_random_spheres(seed=self.scene_seed,
                                        dtype=self.dtype())
        if self.scene not in ALL_SCENES:
            raise ValueError(f"unknown scene {self.scene!r}; "
                             f"choose from {sorted(ALL_SCENES)}")
        return ALL_SCENES[self.scene](dtype=self.dtype())

    def build_camera(self):
        """The camera preset, built on the CPU (the entry points move it)."""
        from ..camera import t_default_cam, t_cam1, t_cam2, hollow_glass_cam
        cams = {"default": t_default_cam, "cam1": t_cam1, "cam2": t_cam2,
                "hollow_glass": hollow_glass_cam}
        if self.camera not in cams:
            raise ValueError(f"unknown camera {self.camera!r}; "
                             f"choose from {sorted(cams)}")
        return cams[self.camera](dtype=self.dtype())

    def to_dict(self) -> dict:
        return asdict(self)
