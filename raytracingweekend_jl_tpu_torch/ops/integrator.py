"""Strided persistent path integrator — the counterpart of
``raytracingweekend_jl_tpu.ops.integrator.persistent_render_sum_strided``.

Each lane serves ``k`` pixels spaced ``n_lanes`` apart and, when a ray ends
(sky or depth exhaustion), starts the next sample of its pixel in place, or
folds the pixel into its strip buffer and switches to its next pixel. Every
iteration is three steps:

1. the closest-hit sweep;
2. the winner-attribute fetch (a gather);
3. the strided shade / scatter / regenerate / pixel-switch step.

``impl`` picks how they run. ``"kernels"`` (the default for CUDA tensors)
runs K1 (``cuda/intersect_kernel.sweep``) and K2
(``cuda/shade_kernel.shade_strided_step``). ``"plain"`` (the default on the
CPU, and selectable on a card for comparison) runs the dot-form
``intersect_spheres`` and ``shade_strided_step_ref``, which is also what the
reference package's CPU strided driver runs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..camera import make_rays
from ..scene import Scene
from .. import rng
from .intersect import DEFAULT_TMIN, intersect_spheres
from .materials import attr_mat, fetch_attr_planes
from .sampling import concentric_disk_map, per_ray_uniforms
from .cuda import intersect_kernel, shade_kernel

#: Reference default bounce depth (src/ray_color.jl:14).
DEFAULT_MAX_DEPTH = 16

#: The loop asks the device whether any lane is still active once every this
#: many iterations. An iteration in which no lane is active changes nothing
#: (no lane shades, folds or starts), so running up to this many extra
#: iterations past the last active one leaves the result unchanged; it saves a
#: host-device synchronisation per iteration.
ACTIVE_CHECK_EVERY = 8

_WHITE = (1.0, 1.0, 1.0)
_SKYBLUE = (0.5, 0.7, 1.0)


def skycolor(direction: torch.Tensor) -> torch.Tensor:
    """Vertical white->skyblue lerp on dir.y (src/ray_color.jl:1-6)."""
    t = 0.5 * (direction[..., 1] + 1.0)
    white = torch.tensor(_WHITE, dtype=direction.dtype, device=direction.device)
    sky = torch.tensor(_SKYBLUE, dtype=direction.dtype, device=direction.device)
    return (1.0 - t)[..., None] * white + t[..., None] * sky


def _check_film(f32_w: float, f32_h: float) -> None:
    """Regenerated samples need the film size for jitter scaling; fail loudly
    on a missing one."""
    if not (f32_w > 0 and f32_h > 0):
        raise ValueError(
            f"f32_w/f32_h must be the positive film size in pixels, got "
            f"({f32_w}, {f32_h}) — pass float(image_width), "
            f"float(image_height)")


class StridedState(NamedTuple):
    """Mutable state of the strided loop (see ``cuda/shade_kernel.py``)."""

    fstate: torch.Tensor  # [12, n_lanes] f32
    istate: torch.Tensor  # [7, n_lanes] i32
    buf: torch.Tensor     # [3k, n_lanes] f32
    geom: tuple           # (W, H, dpx, dpy, p_end)
    n_pix: int
    k: int
    sample_groups: int
    iter_limit: int


def init_strided_state(cam, n_pix: int, W: int, H: int, seed: int,
                       n_samples: int, sample_offset: int, max_depth: int,
                       k: int, pixel_start: int = 0, sample_groups: int = 1,
                       generator: torch.Generator | None = None,
                       init_u4: torch.Tensor | None = None,
                       device=None) -> StridedState:
    """Lanes, pixel assignment and the strip-0 camera rays of a strided
    render of the contiguous pixel range ``[pixel_start, pixel_start +
    n_pix)`` of a ``W x H`` image.

    The strip-0 rays use 4 uniforms per lane: jitter (zero for global sample
    0) and a lens-disk point. They come from ``init_u4`` ([n_lanes, 4]) when
    given, else from ``generator``, else from a generator seeded by
    ``(seed, PIXEL_JITTER, sample_offset)``."""
    device = cam.origin.device if device is None else torch.device(device)
    m = sample_groups
    if m > 1 and k != 1:
        raise ValueError("sample_groups > 1 requires k == 1 (lanes own "
                         "(pixel, sample-slice) units, strips disabled)")
    if n_samples % m:
        raise ValueError(f"sample_groups={m} must divide n_samples={n_samples}")
    f32, i32 = torch.float32, torch.int32
    n_lanes = -(-n_pix // k) * m
    p_end = min(pixel_start + n_pix, W * H)

    lane = torch.arange(n_lanes, dtype=i32, device=device)
    if m > 1:
        # Sample-folded layout (small images): lane g*n_pix+p serves pixel p,
        # samples [offset + g*spg, +spg).
        spg = n_samples // m
        pid0 = pixel_start + lane % n_pix
        sample_ids = sample_offset + (lane // n_pix) * spg
        lane_lim = sample_ids + (spg - 1)
    else:
        spg = n_samples
        pid0 = pixel_start + lane
        sample_ids = torch.full((n_lanes,), sample_offset, dtype=i32,
                                device=device)
        lane_lim = torch.full((n_lanes,), sample_offset + n_samples - 1,
                              dtype=i32, device=device)
    px0 = pid0 % W
    py0 = pid0 // W
    active0 = (pid0 < p_end).to(i32)

    if init_u4 is None:
        if generator is None:
            generator = rng.generator(seed, rng.PIXEL_JITTER, sample_offset,
                                      device=device)
        init_u4 = per_ray_uniforms(n_lanes, 4, generator=generator,
                                   device=device)
    u4 = init_u4.to(device=device, dtype=f32)
    scale = torch.tensor([1.0 / W, 1.0 / H], dtype=f32, device=device)
    jit_uv = torch.where((sample_ids == 0)[:, None], torch.zeros_like(u4[:, :2]),
                         u4[:, 0:2] * scale)
    disk = concentric_disk_map(u4[:, 2:4] * 2.0 - 1.0)
    u_lane = (px0.to(f32) + 1.0) / float(W)
    v_lane = (float(H - 1) - py0.to(f32)) / float(H)
    org, d = make_rays(cam, u_lane + jit_uv[:, 0], v_lane + jit_uv[:, 1], disk)

    fstate = torch.zeros((12, n_lanes), dtype=f32, device=device)
    fstate[0:3] = org.T
    fstate[3:6] = d.T
    fstate[6:9] = 1.0
    istate = torch.stack([torch.zeros_like(lane), sample_ids.to(i32),
                          torch.zeros_like(lane), px0, py0, active0,
                          lane_lim.to(i32)]).contiguous()
    buf = torch.zeros((3 * k, n_lanes), dtype=f32, device=device)
    geom = (W, H, n_lanes % W, n_lanes // W, p_end)
    return StridedState(fstate, istate, buf, geom, n_pix, k, m,
                        k * spg * max_depth + max_depth)


def strided_step(scene_tables: tuple, st: StridedState, cam_consts, seed: int,
                 it: int, sample_offset: int, max_depth: int, tmin: float,
                 impl: str, u9: torch.Tensor | None = None) -> None:
    """One iteration (sweep, fetch, strided step) on ``st``, in place.
    ``scene_tables`` = (scene, sphere_consts [N,4], attr_mat [N,10])."""
    scene, spheres, attrs_tab = scene_tables
    if impl == "kernels":
        t, idx = intersect_kernel.sweep(st.fstate[0:6], spheres, tmin)
        step = shade_kernel.shade_strided_step
    else:
        hit = intersect_spheres(st.fstate[0:3].T, st.fstate[3:6].T, scene,
                                tmin=tmin)
        t, idx = hit.t.contiguous(), hit.index
        step = shade_kernel.shade_strided_step_ref
    attrs = fetch_attr_planes(idx, attrs_tab)
    step(st.fstate, st.istate, st.buf, t, attrs, cam_consts, st.geom, seed,
         it, sample_offset, max_depth, u9)


def resolve_impl(impl: str | None, device: torch.device) -> str:
    """``None`` -> ``"kernels"`` on CUDA, ``"plain"`` on the CPU."""
    if impl is None:
        impl = "kernels" if device.type == "cuda" else "plain"
    if impl not in ("kernels", "plain"):
        raise ValueError(f"impl must be 'kernels' or 'plain', got {impl!r}")
    if impl == "kernels" and device.type != "cuda":
        raise ValueError("impl='kernels' runs the CUDA kernels and needs "
                         f"tensors on a CUDA device, got {device}")
    return impl


def strided_result(st: StridedState) -> torch.Tensor:
    """Un-stride the strip buffers to radiance sums ``[n_pix, 3]``."""
    n_lanes = st.buf.shape[1]
    if st.sample_groups > 1:
        # Lane g*n_pix+p accumulated pixel p's group g into strip 0.
        return st.buf[0:3].reshape(3, st.sample_groups, st.n_pix).sum(1).T
    # Pixel p = j + c*n_lanes lives in strip c.
    planes = st.buf.reshape(st.k, 3, n_lanes).permute(1, 0, 2)
    return planes.reshape(3, st.k * n_lanes)[:, :st.n_pix].T.contiguous()


def persistent_render_sum_strided(
        scene: Scene, cam, n_pix: int, seed: int, n_samples: int,
        sample_offset: int = 0, max_depth: int = DEFAULT_MAX_DEPTH,
        tmin: float = DEFAULT_TMIN, f32_w: float = 0.0, f32_h: float = 0.0,
        k: int = 8, pixel_start: int = 0, sample_groups: int = 1,
        impl: str | None = None, generator: torch.Generator | None = None,
        init_u4: torch.Tensor | None = None,
        rng_u9_fn: Callable[[int], torch.Tensor] | None = None
) -> torch.Tensor:
    """Radiance sums ``[n_pix, 3]`` of the contiguous row-major pixel range
    ``[pixel_start, pixel_start + n_pix)`` of a ``f32_w x f32_h`` image, over
    ``n_samples`` samples with global ids from ``sample_offset``.

    ``scene`` and ``cam`` must be on one device, which is where it runs.
    Float32 only. Test hooks: ``init_u4`` [n_lanes, 4] replaces the
    strip-0 draws, ``rng_u9_fn(it)`` -> [9, n_lanes] the per-iteration ones
    (the in-kernel Philox stream otherwise)."""
    device = scene.device
    if cam.origin.device != device:
        raise ValueError(f"scene on {device} but camera on {cam.origin.device}")
    impl = resolve_impl(impl, device)
    if scene.center.dtype != torch.float32:
        raise NotImplementedError(
            "only float32 renders are ported (the kernels and the strided "
            f"state are float32); got {scene.center.dtype}")
    if max_depth <= 0 or n_samples <= 0:
        return torch.zeros((n_pix, 3), dtype=torch.float32, device=device)
    _check_film(f32_w, f32_h)
    W, H = int(f32_w), int(f32_h)

    st = init_strided_state(cam, n_pix, W, H, seed, n_samples, sample_offset,
                            max_depth, k, pixel_start, sample_groups,
                            generator=generator, init_u4=init_u4,
                            device=device)
    cam_consts = shade_kernel.pack_camera_consts(cam, W, H, device=device)
    tables = (scene, intersect_kernel.sphere_consts(scene), attr_mat(scene))
    seed32 = rng.persistent_seed(seed, sample_offset)

    for it in range(st.iter_limit):
        if it % ACTIVE_CHECK_EVERY == 0 and not bool(st.istate[5].any()):
            break
        u9 = None if rng_u9_fn is None else rng_u9_fn(it)
        strided_step(tables, st, cam_consts, seed32, it, sample_offset,
                     max_depth, tmin, impl, u9)
    return strided_result(st)
