"""Thin-lens camera with defocus blur — the counterpart of
``raytracingweekend_jl_tpu.camera`` (reference: src/camera.jl:1-48).

The frame is built in float64 on the host and cast once, exactly as in the
reference package, so both packages hold the same float32 camera.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import rng
from .ops.vecmath import normalize
from .ops.sampling import unit_disk_points
from .utils.profiling import sync

_FIELDS = ("origin", "lower_left_corner", "horizontal", "vertical", "u", "v",
           "w", "lens_radius")


class Camera(NamedTuple):
    """Precomputed camera frame (reference: struct Camera, src/camera.jl:1-10)."""

    origin: torch.Tensor             # [3]
    lower_left_corner: torch.Tensor  # [3]
    horizontal: torch.Tensor         # [3]
    vertical: torch.Tensor           # [3]
    u: torch.Tensor                  # [3]
    v: torch.Tensor                  # [3]
    w: torch.Tensor                  # [3]
    lens_radius: torch.Tensor        # [] scalar

    @property
    def device(self) -> torch.device:
        return self.origin.device

    def to(self, device) -> "Camera":
        return Camera(*(x.to(device) for x in self))


def camera_from_numpy(arrays, device="cpu", dtype=torch.float32) -> Camera:
    """Build a :class:`Camera` from numpy arrays keyed by field name (or any
    object with those attributes, e.g. the JAX package's ``Camera``)."""
    get = (arrays.__getitem__ if isinstance(arrays, dict)
           else lambda f: getattr(arrays, f))
    return Camera(*(torch.as_tensor(np.array(get(f)), dtype=dtype).to(device)
                    for f in _FIELDS))


def default_camera(lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 0.0, -1.0),
                   vup=(0.0, 1.0, 0.0), vfov=90.0, aspect_ratio=16.0 / 9.0,
                   aperture=0.0, focus_dist=1.0, dtype=torch.float32,
                   device="cpu") -> Camera:
    """Build a camera (reference: default_camera, src/camera.jl:18-36)."""
    lookfrom = np.asarray(lookfrom, dtype=np.float64)
    lookat = np.asarray(lookat, dtype=np.float64)
    vup = np.asarray(vup, dtype=np.float64)

    viewport_height = 2.0 * math.tan(math.radians(vfov) / 2.0)
    viewport_width = aspect_ratio * viewport_height

    w = lookfrom - lookat
    w = w / np.linalg.norm(w)
    u = np.cross(vup, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)

    origin = lookfrom
    horizontal = focus_dist * viewport_width * u
    vertical = focus_dist * viewport_height * v
    lower_left_corner = origin - horizontal / 2.0 - vertical / 2.0 - focus_dist * w
    lens_radius = np.asarray(aperture / 2.0)

    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    vals = (origin, lower_left_corner, horizontal, vertical, u, v, w,
            lens_radius)
    return camera_from_numpy(dict(zip(_FIELDS, (x.astype(np_dtype)
                                                for x in vals))),
                             device=device, dtype=dtype)


def film_point(x: torch.Tensor, size: int) -> torch.Tensor:
    """``x / size``, the film coordinate of pixel coordinate ``x`` on a film
    ``size`` pixels across, as a correctly rounded division on any device
    (PyTorch on CUDA multiplies by the reciprocal of a Python-number
    divisor); the kernels that rebuild a camera ray divide the same."""
    return x / torch.full((), float(size), dtype=x.dtype, device=x.device)


def make_rays(cam: Camera, s: torch.Tensor, t: torch.Tensor,
              disk_pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Film coords ``s``/``t`` [R] plus an explicit ``[R,2]`` unit-disk lens
    sample -> (origins [R,3], unit directions [R,3]) (src/camera.jl:43-48).
    The direction is normalised in one order on every device
    (:func:`ops.vecmath.normalize`), so the camera rays that K2, K9 and K12
    rebuild inside a step are these bit for bit."""
    rd = cam.lens_radius * disk_pts
    offset = rd[..., 0:1] * cam.u + rd[..., 1:2] * cam.v
    origin = cam.origin + offset
    direction = (cam.lower_left_corner
                 + s[..., None] * cam.horizontal
                 + t[..., None] * cam.vertical
                 - cam.origin - offset)
    return origin, normalize(direction)


def shutter_times(n: int, generator: torch.Generator | None = None,
                  device="cpu") -> torch.Tensor:
    """``[n]`` float32 shutter times in [0, 1), one a camera ray: the moment
    at which the ray sees a moving scene (*Ray Tracing: The Next Week* §2.2,
    ``ray(origin, direction, random_double())``). Every ray scattered from
    it keeps its time."""
    return torch.rand(n, generator=generator, device=device)


def get_rays(cam: Camera, s: torch.Tensor, t: torch.Tensor,
             generator: torch.Generator | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched ``get_ray`` with a lens sample drawn from ``generator``."""
    disk = unit_disk_points(s.shape, generator=generator, dtype=s.dtype,
                            device=s.device)
    return make_rays(cam, s, t, disk)


def sample_pass_rays(cam: Camera, u: torch.Tensor, v: torch.Tensor,
                     seed: int, s0: int, spp: int, f32_w: float,
                     f32_h: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Camera rays ``(origin, direction)`` [spp * n_pix, 3] of one sample
    pass: global samples ``s0 .. s0 + spp - 1`` of the pixels at film
    coordinates ``u``/``v`` [n_pix], sample-major. The jitter and lens draws
    come from generators keyed by ``(seed, purpose, s0)``; global sample 0
    is centered (src/render.jl:30-35)."""
    device = u.device
    n_pix = u.shape[0]
    sid = s0 + torch.arange(spp, device=device).repeat_interleave(n_pix)
    jit = torch.rand((spp * n_pix, 2), device=device,
                     generator=rng.generator(seed, rng.PIXEL_JITTER, s0,
                                             device=device))
    scale = torch.full((2,), 1.0 / f32_w, dtype=torch.float32, device=device)
    with sync("jitter_scale"):  # setting an item copies it from the host
        scale[1] = 1.0 / f32_h
    jit = torch.where((sid == 0)[:, None], torch.zeros_like(jit), jit * scale)
    return get_rays(cam, u.repeat(spp) + jit[:, 0], v.repeat(spp) + jit[:, 1],
                    generator=rng.generator(seed, rng.LENS, s0, device=device))


# Canonical camera fixtures (reference: src/proto/proto.jl:17-22).

def t_default_cam(dtype=torch.float32, device="cpu") -> Camera:
    """vfov 90, aspect 16/9, aperture 0 (src/proto/proto.jl:17)."""
    return default_camera(dtype=dtype, device=device)


def t_cam1(dtype=torch.float32, device="cpu") -> Camera:
    """Book-1 final camera (src/proto/proto.jl:19)."""
    return default_camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, 16.0 / 9.0,
                          0.1, 10.0, dtype=dtype, device=device)


def t_cam2(dtype=torch.float32, device="cpu") -> Camera:
    """Big-aperture defocus demo camera (src/proto/proto.jl:21-22)."""
    focus = float(np.linalg.norm(np.array([3.0, 3.0, 2.0])
                                 - np.array([0.0, 0.0, -1.0])))
    return default_camera((3, 3, 2), (0, 0, -1), (0, 1, 0), 20.0, 16.0 / 9.0,
                          2.0, focus, dtype=dtype, device=device)


def hollow_glass_cam(dtype=torch.float32, device="cpu") -> Camera:
    """Hollow-glass viewpoint (src/pluto_RayTracingWeekend.jl:748-750)."""
    return default_camera((-2, 2, 1), (0, 0, -1), (0, 1, 0), 20.0,
                          dtype=dtype, device=device)
