"""Thin-lens camera (src/camera.jl:1-48): the frame in float64 on the host,
cast once; camera rays on the device."""

from __future__ import annotations

import math

import numpy as np
import torch

from .vec import normalize

#: Camera fields, in the order the harness hands them to the program.
FIELDS = ("origin", "lower_left_corner", "horizontal", "vertical", "u", "v",
          "w", "lens_radius")


def camera_arrays(spec: dict) -> dict:
    """The camera of ``spec`` (``lookfrom``, ``lookat``, ``vup``, ``vfov``
    in degrees, ``aspect_ratio``, ``aperture``, and ``focus_dist`` or
    ``focus_on_lookat``) as float64 numpy arrays by field."""
    lookfrom = np.asarray(spec["lookfrom"], dtype=np.float64)
    lookat = np.asarray(spec["lookat"], dtype=np.float64)
    vup = np.asarray(spec["vup"], dtype=np.float64)
    focus = (float(np.linalg.norm(lookfrom - lookat))
             if spec.get("focus_on_lookat") else float(spec["focus_dist"]))
    height = 2.0 * math.tan(math.radians(spec["vfov"]) / 2.0)
    width = spec["aspect_ratio"] * height
    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    horizontal = focus * width * u
    vertical = focus * height * v
    llc = lookfrom - horizontal / 2.0 - vertical / 2.0 - focus * w
    return dict(zip(FIELDS, (lookfrom, llc, horizontal, vertical, u, v, w,
                             np.asarray(spec["aperture"] / 2.0))))


def camera_tensors(arrays: dict, dtype, device) -> dict:
    """The camera's fields as tensors, each cast once from float64."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return {f: torch.as_tensor(np.asarray(arrays[f]).astype(np_dtype)).to(
        device=device, dtype=dtype) for f in FIELDS}


def concentric_disk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Shirley's concentric map of ``(a, b)`` in [-1, 1]^2 to the unit
    disk, ``[R, 2]``."""
    use_a = a.abs() > b.abs()
    r = torch.where(use_a, a, b)
    one = torch.ones_like(a)
    theta = torch.where(
        use_a, (math.pi / 4) * (b / torch.where(a == 0, one, a)),
        math.pi / 2 - (math.pi / 4) * (a / torch.where(b == 0, one, b)))
    theta = torch.where((a == 0) & (b == 0), torch.zeros_like(theta), theta)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta)], -1)


def camera_rays(cam: dict, W: int, H: int, pixels: torch.Tensor,
                gen: torch.Generator, jitter: bool, dtype
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """One camera ray per pixel of ``pixels`` (row-major ids of a ``W x
    H`` film): film point ``u = (j + 1 + a) / W``, ``v = (H - 1 - i + b) /
    H``, with ``a, b`` uniform in [0, 1) when ``jitter`` and 0 for the
    unjittered global sample 0 (src/render.jl:30-35), and a uniform lens
    point (src/camera.jl:43-48). Draws are float32, cast to ``dtype``."""
    dev = pixels.device
    n = pixels.shape[0]
    j = (pixels % W).to(dtype)
    i = (pixels // W).to(dtype)
    ab = torch.rand((n, 2), generator=gen, device=dev).to(dtype)
    if not jitter:
        ab = torch.zeros_like(ab)
    su = (j + 1.0 + ab[:, 0]) / W
    sv = ((H - 1.0) - i + ab[:, 1]) / H
    lens = torch.rand((n, 2), generator=gen, device=dev).to(dtype) * 2 - 1
    rd = cam["lens_radius"] * concentric_disk(lens[:, 0], lens[:, 1])
    offset = rd[:, 0:1] * cam["u"] + rd[:, 1:2] * cam["v"]
    origin = cam["origin"] + offset
    direction = (cam["lower_left_corner"] + su[:, None] * cam["horizontal"]
                 + sv[:, None] * cam["vertical"] - cam["origin"] - offset)
    return origin, normalize(direction)
