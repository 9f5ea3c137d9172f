"""Path integrators — the counterparts of
``raytracingweekend_jl_tpu.ops.integrator``.

:func:`trace` is the fixed-depth wavefront: every bounce sweeps every ray of
the batch, banks the sky on a ray's first miss and scatters the rest; it is
differentiable (``remat=True`` recomputes each bounce in the backward). Its
sweep is K1 (``cuda/intersect_kernel.intersect_spheres_kernel``) or, with
``fused_attrs=True``, K10 (``intersect_fetch_kernel``), each with the
reference's implicit-differentiation backward; float64 rays take the dot-form
``intersect_spheres`` on any device. ``remat_policy="dots"`` keeps each
bounce's winner-attribute fetch for the backward instead of recomputing it;
``tile_skip`` draws per tile and sweeps only the live lanes (K3,
``sweep_masked``), so dead tiles cost no sweep. The recorded backward of the
same wavefront is ``ops/grad_trace.py``.

The persistent integrators pin lanes to pixels and start a pixel's next
sample in place when its ray ends (sky or depth exhaustion):

- :func:`persistent_render_sum_strided`: each lane serves ``k`` pixels
  spaced ``n_lanes`` apart and folds a finished pixel into its strip buffer;
  its step is K2 (``cuda/shade_kernel.shade_strided_step``). It is the one
  route that renders a ``MovingScene`` (book 2's motion blur): its rays
  carry a shutter time, swept by K1m and stepped by K2m; every other route
  here refuses one (``scene.check_static``);
- :func:`persistent_render_sum_fused`: one lane per pixel of any set of
  film coordinates (a non-contiguous tile); its step is K9
  (``cuda/shade_kernel.shade_and_regen_fetch``).

Every persistent iteration is the closest-hit sweep, the winner-attribute
fetch and the shade / scatter / regenerate step; both steps (K2, K9) fetch
the winner's row themselves.
``impl`` picks how they run. ``"kernels"`` (the default for CUDA
tensors) runs K1 and the kernel step. ``"plain"`` (the default on the CPU,
and selectable on a card for comparison) runs the dot-form
``intersect_spheres`` and the step's plain version, which is also what the
reference package's CPU persistent drivers run.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..camera import film_point, make_rays, shutter_times
from ..scene import Scene, check_static, moving_spheres, scene_moves
from ..utils.profiling import count, recording, span, sync
from .. import rng
from .intersect import BIG, DEFAULT_TMIN, HitResult, intersect_spheres
from .materials import (attr_mat, fetch_attr_planes, gather_sphere_attrs,
                        motion_attr_mat, positional_draws, scatter,
                        slot_draws)
from .sampling import concentric_disk_map, per_ray_uniforms
from .cuda import build, intersect_kernel, shade_kernel

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


#: ``(white, skyblue)`` tensors by (dtype, device): made once, since a copy
#: from the host to the card waits for the card's queue to drain.
_SKY_CONSTS = {}


def skycolor(direction: torch.Tensor) -> torch.Tensor:
    """Vertical white->skyblue lerp on dir.y (src/ray_color.jl:1-6)."""
    t = 0.5 * (direction[..., 1] + 1.0)
    key = (direction.dtype, direction.device)
    if key not in _SKY_CONSTS:
        _SKY_CONSTS[key] = tuple(torch.tensor(c, dtype=direction.dtype,
                                              device=direction.device)
                                 for c in (_WHITE, _SKYBLUE))
    white, sky = _SKY_CONSTS[key]
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

    fstate: torch.Tensor  # [12, n_lanes] f32; [13, n_lanes] moving
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
                       device=None, shutter: bool = False,
                       init_time: torch.Tensor | None = None
                       ) -> StridedState:
    """Lanes, pixel assignment and the strip-0 camera rays of a strided
    render of the contiguous pixel range ``[pixel_start, pixel_start +
    n_pix)`` of a ``W x H`` image.

    The strip-0 rays use 4 uniforms per lane: jitter (zero for global sample
    0) and a lens-disk point. They come from ``init_u4`` ([n_lanes, 4]) when
    given, else from ``generator``, else from a generator seeded by
    ``(seed, PIXEL_JITTER, sample_offset)``. With ``shutter`` (a moving
    scene) each strip-0 ray also has a shutter time, the state's 13th
    plane: ``init_time`` [n_lanes] when given, else drawn
    (:func:`camera.shutter_times`) from that generator after the 4."""
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

    if generator is None and (init_u4 is None
                              or (shutter and init_time is None)):
        generator = rng.generator(seed, rng.PIXEL_JITTER, sample_offset,
                                  device=device)
    if init_u4 is None:
        init_u4 = per_ray_uniforms(n_lanes, 4, generator=generator,
                                   device=device)
    if shutter and init_time is None:
        init_time = shutter_times(n_lanes, generator, device)
    u4 = init_u4.to(device=device, dtype=f32)
    with sync("film_scale"):  # a copy from the host waits for the card
        scale = torch.tensor([1.0 / W, 1.0 / H], dtype=f32, device=device)
    jit_uv = torch.where((sample_ids == 0)[:, None], torch.zeros_like(u4[:, :2]),
                         u4[:, 0:2] * scale)
    disk = concentric_disk_map(u4[:, 2:4] * 2.0 - 1.0)
    u_lane = film_point(px0.to(f32) + 1.0, W)
    v_lane = film_point(float(H - 1) - py0.to(f32), H)
    org, d = make_rays(cam, u_lane + jit_uv[:, 0], v_lane + jit_uv[:, 1], disk)

    fstate = torch.zeros((13 if shutter else 12, n_lanes), dtype=f32,
                         device=device)
    fstate[0:3] = org.T
    fstate[3:6] = d.T
    fstate[6:9] = 1.0
    if shutter:
        fstate[12] = init_time.to(device=device, dtype=f32)
    istate = torch.stack([torch.zeros_like(lane), sample_ids.to(i32),
                          torch.zeros_like(lane), px0, py0, active0,
                          lane_lim.to(i32)]).contiguous()
    buf = torch.zeros((3 * k, n_lanes), dtype=f32, device=device)
    geom = (W, H, n_lanes % W, n_lanes // W, p_end)
    return StridedState(fstate, istate, buf, geom, n_pix, k, m,
                        k * spg * max_depth + max_depth)


def sweep_hits(scene_tables: tuple, rays: torch.Tensor, tmin: float,
               impl: str, times: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sweep of one persistent iteration: ``(t [R], idx [R] int32)`` of
    ``rays`` [6, R] through K1 (``"kernels"``) or the dot-form sweep
    (``"plain"``). ``scene_tables`` = (scene, sphere_consts [N,4], attr_mat
    [N,10]); for a moving scene (scene, motion_sphere_table [N,8],
    motion_attr_mat [N,13]) with the rays' shutter ``times`` [R], swept by
    K1m or its plain version."""
    scene, spheres, _ = scene_tables
    if times is not None:
        sweep = (intersect_kernel.sweep_motion if impl == "kernels"
                 else intersect_kernel.sweep_motion_ref)
        return sweep(rays, times, spheres, tmin)
    if impl == "kernels":
        return intersect_kernel.sweep(rays, spheres, tmin)
    hit = intersect_spheres(rays[0:3].T, rays[3:6].T, scene, tmin=tmin)
    return hit.t.contiguous(), hit.index.to(torch.int32)


def sweep_attr_planes(scene_tables: tuple, rays: torch.Tensor, tmin: float,
                      impl: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The sweep and fetch of the pinned route's plain iteration: ``(t
    [R], attrs [10, R])``, :func:`sweep_hits` and a gather."""
    t, idx = sweep_hits(scene_tables, rays, tmin, impl)
    return t, fetch_attr_planes(idx, scene_tables[2])


def strided_step(scene_tables: tuple, st: StridedState, cam_consts, seed: int,
                 it: int, sample_offset: int, max_depth: int, tmin: float,
                 impl: str, u9: torch.Tensor | None = None) -> None:
    """One iteration (sweep, then the strided step with its winner fetch)
    on ``st``, in place. ``scene_tables`` as in :func:`sweep_hits`."""
    t, idx = sweep_hits(scene_tables, st.fstate[0:6], tmin, impl,
                        shutter_plane(st))
    step = (shade_kernel.shade_strided_step if impl == "kernels"
            else shade_kernel.shade_strided_fetch_ref)
    step(st.fstate, st.istate, st.buf, t, idx, scene_tables[2], cam_consts,
         st.geom, seed, it, sample_offset, max_depth, u9)


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


def shutter_plane(st: StridedState) -> torch.Tensor | None:
    """The rays' shutter times [n_lanes] of a moving scene's state (its
    13th plane), or None for a static scene's."""
    return (st.fstate[shade_kernel.N_FSTATE]
            if st.fstate.shape[0] == shade_kernel.N_FSTATE_MOTION else None)


def strided_result(st: StridedState) -> torch.Tensor:
    """Un-stride the strip buffers to radiance sums ``[n_pix, 3]``."""
    n_lanes = st.buf.shape[1]
    if st.sample_groups > 1:
        # Lane g*n_pix+p accumulated pixel p's group g into strip 0.
        return st.buf[0:3].reshape(3, st.sample_groups, st.n_pix).sum(1).T
    # Pixel p = j + c*n_lanes lives in strip c.
    planes = st.buf.reshape(st.k, 3, n_lanes).permute(1, 0, 2)
    return planes.reshape(3, st.k * n_lanes)[:, :st.n_pix].T.contiguous()


def strided_setup(scene: Scene, cam, n_pix: int, seed: int, n_samples: int,
                  sample_offset: int, max_depth: int, W: int, H: int, k: int,
                  pixel_start: int, sample_groups: int,
                  generator: torch.Generator | None,
                  init_u4: torch.Tensor | None) -> tuple:
    """``(st, cam_consts, tables, seed32)`` of a strided render on the
    scene's device: the state (:func:`init_strided_state`), the camera's
    constants, ``(scene, sphere_consts, attr_mat)`` and the key word of the
    in-kernel draws; what either strided loop starts from.

    A :class:`~..scene.MovingScene` gets a state with shutter times and the
    tables ``(scene, motion_sphere_table, motion_attr_mat)``, packed under
    the span ``rtw.render.motion_table``; the counter
    ``rtw.render.moving_spheres`` adds its spheres whose motion is not zero
    (:func:`~..scene.moving_spheres`, counted on the host where the scene
    was made)."""
    device = scene.device
    moving = scene_moves(scene)
    st = init_strided_state(cam, n_pix, W, H, seed, n_samples, sample_offset,
                            max_depth, k, pixel_start, sample_groups,
                            generator=generator, init_u4=init_u4,
                            device=device, shutter=moving)
    cam_consts = shade_kernel.pack_camera_consts(cam, W, H, device=device)
    if moving:
        with span("rtw.render.motion_table"):
            tables = (scene, intersect_kernel.motion_sphere_table(scene),
                      motion_attr_mat(scene))
        if recording():
            count("rtw.render.moving_spheres", moving_spheres(scene))
    else:
        tables = (scene, intersect_kernel.sphere_consts(scene),
                  attr_mat(scene))
    return st, cam_consts, tables, rng.persistent_seed(seed, sample_offset)


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
    Float32 only. A :class:`~..scene.MovingScene` runs K1m and K2m on a
    state whose rays carry shutter times (:func:`strided_setup`). Test
    hooks: ``init_u4`` [n_lanes, 4] replaces the strip-0 draws,
    ``rng_u9_fn(it)`` -> [9, n_lanes] ([10, n_lanes] moving) the
    per-iteration ones (the in-kernel Philox stream otherwise).

    With ``impl="kernels"`` and no ``rng_u9_fn`` the loop runs in chunks of
    ``ACTIVE_CHECK_EVERY`` passes, each a replay of one captured CUDA graph
    (:func:`_chunked_strided_sums`); otherwise pass by pass
    (:func:`_eager_strided_loop`). Both give the same sums, bit for bit.

    Spans ``rtw.render.loop`` and ``rtw.render.result``; the counter
    ``rtw.render.iters`` counts the loop's passes (the eager loop's last may
    be the active check that found no lane active)."""
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
    st, cam_consts, tables, seed32 = strided_setup(
        scene, cam, n_pix, seed, n_samples, sample_offset, max_depth,
        int(f32_w), int(f32_h), k, pixel_start, sample_groups, generator,
        init_u4)
    if impl == "kernels" and rng_u9_fn is None:
        return _chunked_strided_sums(tables, st, cam_consts, seed32,
                                     sample_offset, max_depth, tmin)
    with span("rtw.render.loop"):
        passes = _eager_strided_loop(tables, st, cam_consts, seed32,
                                     sample_offset, max_depth, tmin, impl,
                                     rng_u9_fn)
    count("rtw.render.iters", passes)
    with span("rtw.render.result"):
        return strided_result(st)


def _eager_strided_loop(tables: tuple, st: StridedState, cam_consts, seed32,
                        sample_offset: int, max_depth: int, tmin: float,
                        impl: str, rng_u9_fn=None) -> int:
    """The strided loop pass by pass on ``st``, in place, the active check
    before every ``ACTIVE_CHECK_EVERY``-th pass; returns the passes (the
    check that found no lane active counts as one). The route of the plain
    implementation and of the test hook ``rng_u9_fn``; the card checks hold
    the chunked loop against it."""
    for it in range(st.iter_limit):  # iter_limit >= 1
        if it % ACTIVE_CHECK_EVERY == 0:
            with sync("active_check"):
                if not bool(st.istate[5].any()):
                    break
        u9 = None if rng_u9_fn is None else rng_u9_fn(it)
        strided_step(tables, st, cam_consts, seed32, it, sample_offset,
                     max_depth, tmin, impl, u9)
    return it + 1


# ---------------------------------------------------------------------------
# The chunked strided loop: one CUDA graph per chunk of passes
# ---------------------------------------------------------------------------

#: The most chunk plans kept, least recently used out first: each holds its
#: loop shape's state (28 MB at the flagship's k = 64) and its captured chunk.
STRIDED_PLANS_KEPT = 4

_STRIDED_PLANS: OrderedDict = OrderedDict()


def strided_plan_key(st: StridedState, n_spheres: int, max_depth: int,
                     tmin: float, stream_id: int = 0,
                     library: str | None = None) -> tuple:
    """What a captured chunk holds fixed: the device, whether the scene
    moves (K1m and K2m on a 13-plane state), the lanes, ``k``, the sample
    groups, the (padded) sphere count, the film's ``W`` and ``H``,
    ``max_depth``, ``tmin``, the stream it runs on (its order keeps a
    call's copies behind the last call's chunks) and the kernel library
    loaded (a rebuilt one gets its own capture). A call's seed, first
    sample, ``p_end`` and iteration limit are read from the parameter block,
    so one plan serves every tile of one shape."""
    dev = st.fstate.device
    return (dev.type, dev.index, shutter_plane(st) is not None,
            st.fstate.shape[1], st.k, st.sample_groups, n_spheres,
            st.geom[0], st.geom[1], max_depth, float(tmin), stream_id,
            library)


def lru_get(cache: OrderedDict, key, make: Callable, capacity: int) -> tuple:
    """``(cache[key], dropped)``: the entry, made by ``make()`` if missing,
    now the most recently used, and the entries dropped to keep at most
    ``capacity``, least recently used first."""
    if key in cache:
        cache.move_to_end(key)
        return cache[key], []
    cache[key] = make()
    dropped = []
    while len(cache) > capacity:
        dropped.append(cache.popitem(last=False)[1])
    return cache[key], dropped


def run_chunks(n_chunks: int, queue: Callable[[int], None],
               active_after: Callable[[int], bool]) -> int:
    """The chunked loop's schedule: ``queue(0)``, then ``queue(c + 1)``
    before ``active_after(c)`` waits for chunk ``c`` and says whether a lane
    is still active after it, so one chunk is in flight while the host
    waits; it stops when a flag says no lane is active, or once all
    ``n_chunks`` (>= 1) are queued. Each wait is one ``active_check`` sync.
    Returns the chunks queued. A pass with no active lane changes nothing,
    so the chunks past the last active pass leave the sums as they are."""
    queue(0)
    queued = 1
    while queued < n_chunks:
        queue(queued)
        queued += 1
        with sync("active_check"):
            if not active_after(queued - 2):
                break
    return queued


def _strided_chunk(tables: tuple, st: StridedState, cam_consts, params,
                   flags, host_flags, hits: tuple, max_depth: int,
                   tmin: float, parts: int | None) -> None:
    """One chunk on ``st``, in place: ``ACTIVE_CHECK_EVERY`` passes of the
    sweep and K2 (:func:`shade_kernel.shade_strided_pass`, its scalars from
    ``params``), then :func:`shade_kernel.strided_chunk_end`. On the card
    K1 (K1m for a moving scene) writes ``hits`` (t, idx) and the chunk is
    what the graph captures; on the CPU the plain sweep and step run it as
    it stands."""
    times = shutter_plane(st)
    for j in range(ACTIVE_CHECK_EVERY):
        if st.fstate.is_cuda and times is not None:
            intersect_kernel.sweep_motion_into(st.fstate[0:6], times,
                                               tables[1], *hits, tmin, parts)
            t, idx = hits
        elif st.fstate.is_cuda:
            intersect_kernel.sweep_into(st.fstate[0:6], tables[1], *hits,
                                        tmin, parts)
            t, idx = hits
        else:
            t, idx = sweep_hits(tables, st.fstate[0:6], tmin, "plain", times)
        shade_kernel.shade_strided_pass(st.fstate, st.istate, st.buf, t, idx,
                                        tables[2], cam_consts, st.geom,
                                        params, j, max_depth)
    shade_kernel.strided_chunk_end(st.istate, params, flags, host_flags,
                                   ACTIVE_CHECK_EVERY)


class _StridedPlan:
    """The chunked loop's fixed-address tensors for one key of
    :func:`strided_plan_key`: the state, the sweep's ``t``/``idx``, the
    sphere and attribute tables, the camera's constants, the parameter
    block, the flags on the device and their copy on the host, and, on the
    card, the captured chunk. ``lock`` is held while a call uses it, from
    its copies to its result."""

    def __init__(self, st: StridedState, tables: tuple, cam_consts):
        dev = st.fstate.device
        n = st.fstate.shape[1]
        self.cuda = dev.type == "cuda"
        self.moving = shutter_plane(st) is not None  # K1m and K2m
        self.st = st._replace(fstate=torch.empty_like(st.fstate),
                              istate=torch.empty_like(st.istate),
                              buf=torch.empty_like(st.buf))
        self.hits = (torch.empty(n, dtype=torch.float32, device=dev),
                     torch.empty(n, dtype=torch.int32, device=dev))
        self.tables = (tables[0], torch.empty_like(tables[1]),
                       torch.empty_like(tables[2]))
        self.cam = torch.empty_like(cam_consts)
        self.params = torch.zeros(shade_kernel.N_PARAMS, dtype=torch.int32,
                                  device=dev)
        self.flags = torch.zeros(2, dtype=torch.int32, device=dev)
        self.host_flags = torch.zeros(2, dtype=torch.int32,
                                      pin_memory=self.cuda)
        self.host_view = self.host_flags.numpy()
        self.lock = threading.Lock()
        self.graph = None
        self.parts = self.events = self.done = None
        if self.cuda:
            n_sph = tables[1].shape[0]
            kernel = "sweep_motion" if self.moving else "sweep"
            self.parts = intersect_kernel.sweep_parts(
                n, n_sph, intersect_kernel._resident_threads(dev, n_sph,
                                                             kernel))
            self.events = [torch.cuda.Event(), torch.cuda.Event()]
            self.done = torch.cuda.Event()

    def load(self, st: StridedState, tables: tuple, cam_consts, seed32: int,
             first_sample: int) -> None:
        """Copy a call's fresh state, tables and camera in (device to
        device) and write its scalars into the parameter block: one copy
        from pinned memory, queued without a wait."""
        for dst, src in ((self.st.fstate, st.fstate),
                         (self.st.istate, st.istate),
                         (self.tables[1], tables[1]),
                         (self.tables[2], tables[2]), (self.cam, cam_consts)):
            dst.copy_(src)
        self.st.buf.zero_()
        self.flags.zero_()
        self.tables = (tables[0],) + self.tables[1:]  # the plain sweep's
        seed = seed32 & 0xFFFFFFFF
        scalars = torch.tensor(
            [seed - (1 << 32) if seed >= 1 << 31 else seed, first_sample,
             st.geom[4], 0, st.iter_limit], dtype=torch.int32,
            pin_memory=self.cuda)
        self.params.copy_(scalars, non_blocking=True)

    def chunk(self, max_depth: int, tmin: float) -> None:
        _strided_chunk(self.tables, self.st, self.cam, self.params,
                       self.flags, self.host_flags, self.hits, max_depth,
                       tmin, self.parts)

    def capture(self, max_depth: int, tmin: float) -> None:
        """Capture one chunk as a CUDA graph, on a side stream (a graph is
        not captured on the default stream); nothing runs until a
        replay."""
        stream = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.chunk(max_depth, tmin)
            finally:
                graph.capture_end()
        stream.wait_stream(side)
        self.graph = graph

    def queue(self, c: int, max_depth: int, tmin: float) -> None:
        """Chunk ``c``: a replay of the captured chunk on the card (counted
        as ``ACTIVE_CHECK_EVERY`` launches of K1 and of K2, or of K1m and
        K2m), the chunk itself on the CPU."""
        if not self.cuda:
            self.chunk(max_depth, tmin)
            return
        self.graph.replay()
        self.events[c % 2].record()
        if self.moving:
            intersect_kernel.motion_launches += ACTIVE_CHECK_EVERY
            shade_kernel.motion_launches += ACTIVE_CHECK_EVERY
        else:
            intersect_kernel.launches += ACTIVE_CHECK_EVERY
            shade_kernel.launches += ACTIVE_CHECK_EVERY

    def active_after(self, c: int) -> bool:
        """Whether chunk ``c`` left a lane active, once it has run (its
        flag slot is not written again before chunk ``c + 2``)."""
        if self.cuda:
            self.events[c % 2].synchronize()
        return int(self.host_view[c % 2]) == c + 1

    def retire(self) -> None:
        """Wait until the last call's work on the plan has run, before the
        plan (its graph, tensors and pinned flags) is dropped."""
        with self.lock:
            if self.cuda:
                self.done.synchronize()


def _chunked_strided_sums(tables: tuple, st: StridedState, cam_consts,
                          seed32: int, sample_offset: int, max_depth: int,
                          tmin: float) -> torch.Tensor:
    """The strided loop on ``st``'s device in chunks of
    ``ACTIVE_CHECK_EVERY`` passes, driven by :func:`run_chunks`, and its
    sums (:func:`strided_result`), under
    :func:`persistent_render_sum_strided`'s spans and counters.

    The call's state, tables and camera are copied into the plan of its
    shape (:func:`strided_plan_key`; at most :data:`STRIDED_PLANS_KEPT`,
    least recently used out first), whose chunk is captured as a CUDA graph
    once, on first use (counter ``rtw.render.graph_captures``), and replayed
    for every chunk of every call (``rtw.render.graph_replays``). CPU
    tensors (the tests) run the same plan, chunks and schedule, each chunk
    as it stands."""
    dev = st.fstate.device
    with torch.cuda.device(dev) if dev.type == "cuda" \
            else contextlib.nullcontext():
        cuda = dev.type == "cuda"
        key = strided_plan_key(
            st, tables[1].shape[0], max_depth, tmin,
            torch.cuda.current_stream().stream_id if cuda else 0,
            build.load()._name if cuda else None)
        with _PLANS_LOCK:
            plan, dropped = lru_get(
                _STRIDED_PLANS, key,
                lambda: _StridedPlan(st, tables, cam_consts),
                STRIDED_PLANS_KEPT)
        for old in dropped:
            old.retire()
        with plan.lock:
            with span("rtw.render.loop"):
                plan.load(st, tables, cam_consts, seed32, sample_offset)
                if plan.cuda and plan.graph is None:
                    plan.capture(max_depth, tmin)
                    count("rtw.render.graph_captures")
                chunks = run_chunks(
                    -(-st.iter_limit // ACTIVE_CHECK_EVERY),
                    lambda c: plan.queue(c, max_depth, tmin),
                    plan.active_after)
            if plan.cuda:
                count("rtw.render.graph_replays", chunks)
            count("rtw.render.iters",
                  min(chunks * ACTIVE_CHECK_EVERY, st.iter_limit))
            with span("rtw.render.result"):
                out = strided_result(st._replace(fstate=plan.st.fstate,
                                                 istate=plan.st.istate,
                                                 buf=plan.st.buf))
                if out.untyped_storage().data_ptr() == \
                        plan.st.buf.untyped_storage().data_ptr():
                    out = out.clone()  # a view of the plan's strips
                if plan.cuda:
                    plan.done.record()
                return out


#: Held while the plans are looked up, made or dropped.
_PLANS_LOCK = threading.Lock()


# ---------------------------------------------------------------------------
# The fixed-depth wavefront
# ---------------------------------------------------------------------------

def _pick_intersector(dtype, fused_attrs: bool, impl: str) -> Callable:
    """The sweep of :func:`trace` as ``isect(origin, direction, scene, tmin)
    -> (HitResult, attrs or None)`` (reference: ``_pick_intersector``):
    float64 rays take the dot-form ``intersect_spheres`` on any device;
    float32 rays K1 (or K10 with ``fused_attrs``), their plain versions with
    ``impl="plain"``. Every variant is differentiable."""
    if dtype == torch.float64:
        return lambda o, d, scene, tmin: (
            intersect_spheres(o, d, scene, tmin=tmin), None)
    plain = impl == "plain"
    if fused_attrs:
        return lambda o, d, scene, tmin: intersect_kernel.intersect_fetch_kernel(
            o, d, scene, tmin, plain)
    return lambda o, d, scene, tmin: (
        intersect_kernel.intersect_spheres_kernel(o, d, scene, tmin, plain),
        None)


def bounce_advance(scene: Scene, res, attrs, u: torch.Tensor,
                   xi: torch.Tensor, org: torch.Tensor, d: torch.Tensor,
                   thr: torch.Tensor, rad: torch.Tensor,
                   alive: torch.Tensor) -> tuple:
    """The bounce after its sweep ``res`` (with the winners' ``attrs``, or
    None to gather them): a ray that misses for the first time banks ``thr
    * sky(d)`` into ``rad`` and dies; a live hit scatters with the draws
    ``u`` [R, 3], ``xi`` [R] and multiplies its throughput. Returns the
    next ``(org, d, thr, rad, alive)``."""
    miss_now = alive & ~res.hit
    rad = rad + torch.where(miss_now[:, None], thr * skycolor(d),
                            torch.zeros_like(thr))
    # Finite t for every lane (the NaN-under-where guard).
    t_safe = torch.where(res.hit, res.t, torch.ones_like(res.t))
    if attrs is None:
        attrs = gather_sphere_attrs(scene, res.index, org.dtype)
    s = scatter(org, d, t_safe, attrs, u, xi)
    live_hit = (alive & res.hit)[:, None]
    return (torch.where(live_hit, s.origin, org),
            torch.where(live_hit, s.direction, d),
            torch.where(live_hit, thr * s.attenuation, thr), rad,
            alive & res.hit)


def wavefront_bounce(scene: Scene, isect: Callable, tmin: float,
                     u: torch.Tensor, xi: torch.Tensor, org: torch.Tensor,
                     d: torch.Tensor, thr: torch.Tensor, rad: torch.Tensor,
                     alive: torch.Tensor) -> tuple:
    """One bounce of the fixed-depth wavefront (:func:`trace`'s body) with
    the draws ``u`` [R, 3], ``xi`` [R] given: every ray is swept by
    ``isect`` (:func:`_pick_intersector`), then :func:`bounce_advance`.
    Returns the next ``(org, d, thr, rad, alive)``."""
    res, attrs = isect(org, d, scene, tmin)
    return bounce_advance(scene, res, attrs, u, xi, org, d, thr, rad, alive)


#: The ``remat_policy`` values :func:`trace` takes: ``None`` recomputes
#: every bounce in the backward; ``"dots"`` keeps each bounce's
#: winner-attribute fetch from the forward (the reference's policy saves
#: its matrix-unit products, which are that fetch there) and recomputes
#: the sweep and the scatter.
REMAT_POLICIES = (None, "dots")


def check_remat_policy(remat_policy) -> None:
    """Raise ``ValueError`` for a ``remat_policy`` that is not in
    :data:`REMAT_POLICIES`."""
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy must be one of {REMAT_POLICIES}, "
                         f"got {remat_policy!r}")


def tile_draws(seed: int, bounce: int, tile: int, n_tiles: int,
               dtype=torch.float32, device="cpu"
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Draws of one bounce of ``trace(tile_skip=tile)`` over ``n_tiles``
    tiles of ``tile`` rays: every tile its own stream, Philox keyed by
    ``(seed, bounce)`` with the counter (position in the tile, block, tile,
    0), so a ray's numbers depend on its tile and its place there, as the
    reference's ``fold_in(fold_in(key, bounce), tile)`` positional draws
    do. One call draws every tile."""
    lane = torch.arange(n_tiles * tile, dtype=torch.int64, device=device)
    return slot_draws(seed & 0xFFFFFFFF, bounce, lane % tile, dtype,
                      coords=(lane // tile, 0))


def trace(scene: Scene, origin: torch.Tensor, direction: torch.Tensor,
          seed: int, max_depth: int = DEFAULT_MAX_DEPTH,
          tmin: float = DEFAULT_TMIN, remat: bool = False,
          keyed: bool = False, fused_attrs: bool = False,
          impl: str | None = None, draws: Callable | None = None,
          remat_policy: str | None = None,
          tile_skip: int = 0) -> torch.Tensor:
    """Radiance ``[R, 3]`` of ``R`` rays ``origin``/``direction`` [R, 3]
    (unit directions), differentiable w.r.t. the rays and the scene's
    center, radius, albedo, fuzz and ir (reference: ``integrator.trace``).

    Every bounce ``b`` of ``max_depth`` sweeps every ray; a ray that misses
    for the first time banks ``T * sky(d)`` and dies; a live hit scatters
    and multiplies its throughput. Draws: one shaped draw per bounce keyed
    by ``(seed, bounce)`` (:func:`materials.positional_draws`), or with
    ``keyed=True`` per-ray Philox draws keyed by ``(seed, bounce)`` with the
    ray's slot as the counter (:func:`materials.slot_draws`, the draws of
    the fixed-depth record kernel); the test hook ``draws(b, R) -> (u [R, 3],
    xi [R])`` replaces both. ``remat=True`` checkpoints each bounce: the
    backward keeps one bounce's inputs per bounce and recomputes the rest
    (the draws are a pure function of ``(seed, bounce)``, so the recompute
    redraws them exactly); ``remat_policy="dots"`` keeps each bounce's
    winner-attribute fetch instead of recomputing it (the same gradients
    bit for bit), any other name but None raises ``ValueError``.

    ``tile_skip = T > 0`` pads the rays to whole tiles of ``T`` (padding
    lanes start dead, pointing up), draws each tile from its own stream
    (:func:`tile_draws`; the hook is then ``draws(b, R_padded)``) and
    sweeps only the live lanes (K3, ``sweep_masked``, for float32 rays
    without ``fused_attrs``): a tile with no live lane costs no sweep and
    no host synchronisation, and changes nothing, as in the reference's
    per-tile ``lax.cond``. ``keyed=True`` with it raises ``ValueError``."""
    check_static(scene, "the wavefront trace")
    if tile_skip and keyed:
        raise ValueError("tile_skip uses per-tile positional draws; "
                         "keyed=True is not supported together with it")
    if tile_skip < 0:
        raise ValueError(f"tile_skip must be >= 0, got {tile_skip}")
    check_remat_policy(remat_policy)
    dtype, dev = origin.dtype, origin.device
    R = origin.shape[0]
    impl = resolve_impl(impl, dev)
    isect = _pick_intersector(dtype, fused_attrs, impl)
    slots = torch.arange(R, dtype=torch.int32, device=dev) if keyed else None
    R_run, alive0 = R, torch.ones((R,), dtype=torch.bool, device=dev)
    masked = bool(tile_skip) and dtype == torch.float32 and not fused_attrs
    if tile_skip:
        n_tiles = -(-R // tile_skip)
        R_run = n_tiles * tile_skip
        pad = R_run - R
        up = torch.zeros((pad, 3), dtype=dtype, device=dev)
        up[:, 1] = 1.0
        origin = torch.cat([origin, torch.zeros_like(up)])
        direction = torch.cat([direction, up])
        alive0 = torch.arange(R_run, device=dev) < R

    def bounce_draws(b):
        if draws is not None:
            u, xi = draws(b, R_run)
            return u.to(device=dev, dtype=dtype), xi.to(device=dev,
                                                        dtype=dtype)
        if keyed:
            return slot_draws(seed & 0xFFFFFFFF, b, slots, dtype)
        if tile_skip:
            return tile_draws(seed, b, tile_skip, n_tiles, dtype, dev)
        return positional_draws(seed, b, R, dtype, dev)

    def sweep(org, d, alive):
        if masked:
            return intersect_kernel.intersect_spheres_kernel(
                org, d, scene, tmin, impl == "plain", alive=alive), None
        return isect(org, d, scene, tmin)

    def bounce(b, org, d, thr, rad, alive):
        res, attrs = sweep(org, d, alive)
        u, xi = bounce_draws(b)
        return bounce_advance(scene, res, attrs, u, xi, org, d, thr, rad,
                              alive)

    def sweep_only(org, d, alive):
        res, attrs = sweep(org, d, alive)
        return res.t, res.index, attrs

    def advance(b, t, idx, attrs, org, d, thr, rad, alive):
        u, xi = bounce_draws(b)
        return bounce_advance(scene, HitResult(t, idx, t < BIG), attrs, u,
                              xi, org, d, thr, rad, alive)

    state = (origin, direction,
             torch.ones((R_run, 3), dtype=dtype, device=dev),
             torch.zeros((R_run, 3), dtype=dtype, device=dev), alive0)
    for b in range(max_depth):
        if remat and remat_policy == "dots":
            # Two checkpoints around the winner fetch: the backward
            # recomputes the sweep and the scatter, and reads the fetched
            # rows kept between them.
            t, idx, attrs = checkpoint(sweep_only, *state[:2], state[4],
                                       use_reentrant=False)
            if attrs is None:
                attrs = gather_sphere_attrs(scene, idx, dtype)
            state = checkpoint(advance, b, t, idx, attrs, *state,
                               use_reentrant=False)
        elif remat:
            state = checkpoint(bounce, b, *state, use_reentrant=False)
        else:
            state = bounce(b, *state)
    # Rays still alive after max_depth contribute black
    # (src/ray_color.jl:15-17).
    return state[3][:R]


# ---------------------------------------------------------------------------
# The pixel-pinned persistent integrator (K9)
# ---------------------------------------------------------------------------

def pinned_start_rays(cam, u: torch.Tensor, v: torch.Tensor, seed: int,
                      sample_offset: int, f32_w: float, f32_h: float,
                      init_u4: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """The first camera rays ``(origin, direction)`` [R, 3] of the lanes at
    film coordinates ``u``/``v`` [R]: 4 uniforms per lane (jitter, zero for
    global sample 0, and a lens-disk point), Philox keyed by ``(seed's
    PIXEL_JITTER stream, sample_offset)`` with the lane's slot as the
    counter, i.e. keyed by (seed, slot, sample) as the reference keys them;
    ``init_u4`` [R, 4] replaces them."""
    R, dev = u.shape[0], u.device
    if init_u4 is None:
        key = rng.purpose_seed(seed, rng.PIXEL_JITTER) & 0xFFFFFFFF
        init_u4 = rng.philox_uniforms(key, sample_offset, R, 4, device=dev).T
    return _film_rays(cam, u, v, init_u4.to(device=dev, dtype=torch.float32),
                      sample_offset == 0, f32_w, f32_h)


def _film_rays(cam, u, v, u4, centred, f32_w: float, f32_h: float):
    """Camera rays through film coordinates ``u``/``v`` [R], jittered by
    ``u4[:, 0:2]`` pixels except where ``centred`` (a bool, or [R] bools),
    with lens points from ``u4[:, 2:4]``."""
    scale = torch.tensor([1.0 / f32_w, 1.0 / f32_h], dtype=u4.dtype,
                         device=u4.device)
    centred = torch.as_tensor(centred, device=u4.device).reshape(-1, 1)
    jit_uv = torch.where(centred, torch.zeros_like(u4[:, 0:2]),
                         u4[:, 0:2] * scale)
    disk = concentric_disk_map(u4[:, 2:4] * 2.0 - 1.0)
    return make_rays(cam, u + jit_uv[:, 0], v + jit_uv[:, 1], disk)


def pinned_render_loop(scene: Scene, cam, u: torch.Tensor, v: torch.Tensor,
                       seed: int, n_samples: int, sample_offset: int,
                       max_depth: int, tmin: float, f32_w: float,
                       f32_h: float, impl: str | None,
                       init_u4: torch.Tensor | None,
                       rng_u9_fn: Callable[[int], torch.Tensor] | None,
                       iteration: Callable) -> torch.Tensor:
    """The pixel-pinned persistent loop shared by
    :func:`persistent_render_sum_fused` and the megakernel renderer
    (``ops/experimental/mega.py``): the first rays, the state planes, the
    loop bound and the active check, with ``iteration(impl, tables, fstate,
    istate, u, v, cam_consts, seed32, it, last_sample, max_depth, tmin,
    u9)`` running one iteration in place (``tables`` = (scene,
    sphere_consts, attr_mat)). Arguments and result as
    :func:`persistent_render_sum_fused`."""
    device = scene.device
    if cam.origin.device != device or u.device != device:
        raise ValueError(f"scene on {device}, camera on {cam.origin.device}, "
                         f"film coordinates on {u.device}: one device")
    impl = resolve_impl(impl, device)
    if scene.center.dtype != torch.float32:
        raise NotImplementedError(
            "only float32 renders take the pixel-pinned routes (their "
            f"kernels and state are float32); got {scene.center.dtype}")
    R = u.shape[0]
    if max_depth <= 0 or n_samples <= 0:
        return torch.zeros((R, 3), dtype=torch.float32, device=device)
    _check_film(f32_w, f32_h)
    u = u.to(torch.float32).contiguous()
    v = v.to(torch.float32).contiguous()
    org, d = pinned_start_rays(cam, u, v, seed, sample_offset, f32_w, f32_h,
                               init_u4)
    fstate = torch.zeros((12, R), dtype=torch.float32, device=device)
    fstate[0:3] = org.T
    fstate[3:6] = d.T
    fstate[6:9] = 1.0
    istate = torch.zeros((3, R), dtype=torch.int32, device=device)
    istate[1] = sample_offset
    istate[2] = 1
    cam_consts = shade_kernel.pack_camera_consts(cam, int(f32_w), int(f32_h),
                                                 device=device)
    tables = (scene, intersect_kernel.sphere_consts(scene), attr_mat(scene))
    seed32 = rng.persistent_seed(seed, sample_offset)
    last_sample = sample_offset + n_samples - 1
    for it in range(n_samples * max_depth):
        if it % ACTIVE_CHECK_EVERY == 0 and not bool(istate[2].any()):
            break
        u9 = None if rng_u9_fn is None else rng_u9_fn(it)
        iteration(impl, tables, fstate, istate, u, v, cam_consts, seed32, it,
                  last_sample, max_depth, tmin, u9)
    return fstate[9:12].T.contiguous()


def _pinned_iteration(impl, tables, fstate, istate, u, v, cam_consts, seed32,
                      it, last_sample, max_depth, tmin, u9) -> None:
    """One iteration of the pinned route: K1, then K9 with its winner fetch
    (``"kernels"``: two launches); or the sweep, the gather and K9's plain
    version (``"plain"``)."""
    if impl == "kernels":
        t, idx = sweep_hits(tables, fstate[0:6], tmin, impl)
        shade_kernel.shade_and_regen_fetch(fstate, istate, t, idx, tables[2],
                                           u, v, cam_consts, seed32, it,
                                           last_sample, max_depth, u9)
        return
    t, attrs = sweep_attr_planes(tables, fstate[0:6], tmin, impl)
    shade_kernel.shade_and_regen_ref(fstate, istate, t, attrs, u, v,
                                     cam_consts, seed32, it, last_sample,
                                     max_depth, u9)


def persistent_render_sum_fused(
        scene: Scene, cam, u: torch.Tensor, v: torch.Tensor, seed: int,
        n_samples: int, sample_offset: int = 0,
        max_depth: int = DEFAULT_MAX_DEPTH, tmin: float = DEFAULT_TMIN,
        f32_w: float = 0.0, f32_h: float = 0.0, impl: str | None = None,
        init_u4: torch.Tensor | None = None,
        rng_u9_fn: Callable[[int], torch.Tensor] | None = None
) -> torch.Tensor:
    """Radiance sums ``[R, 3]`` of ``n_samples`` samples (global ids from
    ``sample_offset``) of the pixels at film coordinates ``u``/``v`` [R] of
    a ``f32_w x f32_h`` image: one lane pinned to each pixel, which starts
    its pixel's next sample in place when a ray ends (reference:
    ``persistent_render_sum_fused``, the route of tiles that are neither the
    whole image nor a contiguous pixel range).

    Each iteration: K1 and K9, which fetches the winner's row itself
    (``"kernels"``), or the dot-form sweep, the gather and K9's plain
    version (``"plain"``). The loop ends once no lane is active (checked every
    ``ACTIVE_CHECK_EVERY`` iterations) or after ``n_samples * max_depth``
    iterations. Float32 only. Draws: the first rays as
    :func:`pinned_start_rays` (``init_u4`` replaces them); later iterations
    Philox keyed by ``(persistent_seed(seed, sample_offset), iteration)``
    with the lane as the counter, in the kernel, or ``rng_u9_fn(it)`` ->
    [9, R]."""
    check_static(scene, "the pixel-pinned route (K9)")
    return pinned_render_loop(scene, cam, u, v, seed, n_samples,
                              sample_offset, max_depth, tmin, f32_w, f32_h,
                              impl, init_u4, rng_u9_fn, _pinned_iteration)


def _keyed_camera_rays(cam, u, v, key_cam: int, slots, sample_ids,
                       f32_w: float, f32_h: float):
    """Camera rays of samples ``sample_ids`` of the pixels at ``u``/``v``:
    4 Philox uniforms per ray, counter (slot, block, sample, 0)."""
    u4 = rng.philox_uniforms(key_cam, 0, slots.shape[0], 4, device=u.device,
                             lanes=slots, coords=(sample_ids, 0)).T
    return _film_rays(cam, u, v, u4.to(u.dtype), sample_ids == 0, f32_w,
                      f32_h)


@torch.no_grad()
def persistent_render_sum(
        scene: Scene, cam, u: torch.Tensor, v: torch.Tensor, seed: int,
        n_samples: int, sample_offset: int = 0,
        max_depth: int = DEFAULT_MAX_DEPTH, tmin: float = DEFAULT_TMIN,
        f32_w: float = 0.0, f32_h: float = 0.0,
        impl: str | None = None) -> torch.Tensor:
    """Radiance sums ``[R, 3]`` of the pixel-pinned persistent wavefront in
    plain PyTorch (reference: ``persistent_render_sum``, the XLA body that
    :func:`persistent_render_sum_fused` fuses into K9): the same semantics,
    with every draw keyed per ray so that it does not depend on how lanes
    interleave their samples. Camera draws: Philox counter (slot, block,
    sample, 0) under the seed's PIXEL_JITTER stream; scatter draws: counter
    (slot, block, sample, bounce) under its SCATTER_DIR stream, a unit
    vector by Box-Muller and a Schlick coin. The sweep is K1 on the card
    (``impl="kernels"``), the dot form otherwise; any float type."""
    check_static(scene, "the plain pixel-pinned body")
    _check_film(f32_w, f32_h)
    dtype, dev = u.dtype, u.device
    impl = resolve_impl(impl, dev)
    R = u.shape[0]
    if max_depth <= 0 or n_samples <= 0:
        return torch.zeros((R, 3), dtype=dtype, device=dev)
    isect = (_pick_intersector(dtype, False, impl) if impl == "kernels"
             else lambda o, d, sc, t: (intersect_spheres(o, d, sc, tmin=t),
                                       None))
    key_cam = rng.purpose_seed(seed, rng.PIXEL_JITTER) & 0xFFFFFFFF
    key_sc = rng.purpose_seed(seed, rng.SCATTER_DIR) & 0xFFFFFFFF
    slots = torch.arange(R, dtype=torch.int64, device=dev)
    sample_ids = torch.full((R,), sample_offset, dtype=torch.int64,
                            device=dev)
    org, d = _keyed_camera_rays(cam, u, v, key_cam, slots, sample_ids, f32_w,
                                f32_h)
    thr = torch.ones((R, 3), dtype=dtype, device=dev)
    rad = torch.zeros((R, 3), dtype=dtype, device=dev)
    bounces = torch.zeros((R,), dtype=torch.int64, device=dev)
    active = torch.ones((R,), dtype=torch.bool, device=dev)
    last_sample = sample_offset + n_samples - 1
    for it in range(n_samples * max_depth):
        if it % ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        res, _ = isect(org, d, scene, tmin)
        hit, miss = active & res.hit, active & ~res.hit
        rad = rad + torch.where(miss[:, None], thr * skycolor(d),
                                torch.zeros_like(thr))
        t_safe = torch.where(res.hit, res.t, torch.ones_like(res.t))
        un, xi = slot_draws(key_sc, 0, slots, dtype,
                            coords=(sample_ids, bounces))
        sc = scatter(org, d, t_safe, gather_sphere_attrs(scene, res.index,
                                                         dtype), un, xi)
        new_b = bounces + 1
        cont = hit & (new_b < max_depth)
        c1 = cont[:, None]
        org = torch.where(c1, sc.origin, org)
        d = torch.where(c1, sc.direction, d)
        thr = torch.where(c1, thr * sc.attenuation, thr)
        bounces = torch.where(cont, new_b, bounces)
        # Regenerate: the same pixel's next sample, in place.
        need = miss | (hit & ~cont)
        nxt = sample_ids + 1
        can = need & (nxt <= last_sample)
        norg, nd = _keyed_camera_rays(cam, u, v, key_cam, slots, nxt, f32_w,
                                      f32_h)
        c1 = can[:, None]
        org = torch.where(c1, norg, org)
        d = torch.where(c1, nd, d)
        thr = torch.where(c1, torch.ones_like(thr), thr)
        bounces = torch.where(can, torch.zeros_like(bounces), bounces)
        sample_ids = torch.where(can, nxt, sample_ids)
        active = (active & ~need) | can
    return rad


# ---------------------------------------------------------------------------
# The compacting wavefront (forward only) and its occupancy statistics
# ---------------------------------------------------------------------------

@torch.no_grad()
def trace_compacted(scene: Scene, origin: torch.Tensor,
                    direction: torch.Tensor, seed: int,
                    max_depth: int = DEFAULT_MAX_DEPTH,
                    tmin: float = DEFAULT_TMIN,
                    impl: str | None = None) -> torch.Tensor:
    """Forward-only radiance ``[R, 3]`` of :func:`trace` with ``keyed=True``,
    sweeping only the live rays (reference: ``trace_compacted``).

    Every bounce keeps the rays that hit (a boolean gather, in order) and
    ends once none is left; the draws are keyed by the ray's slot, so each
    ray follows the path it follows in ``trace(keyed=True)``. The reference
    skips dead tiles and re-sorts every fourth bounce because its loop has
    fixed shapes; eager PyTorch compacts every bounce for the price of the
    gather. No gradient: use :func:`trace`."""
    check_static(scene, "the compacting wavefront")
    dtype, dev = origin.dtype, origin.device
    R = origin.shape[0]
    isect = _pick_intersector(dtype, False, resolve_impl(impl, dev))
    rad = torch.zeros((R, 3), dtype=dtype, device=dev)
    slots = torch.arange(R, dtype=torch.int32, device=dev)
    org, d = origin, direction
    thr = torch.ones((R, 3), dtype=dtype, device=dev)
    for b in range(max_depth):
        if slots.numel() == 0:
            break
        res, _ = isect(org, d, scene, tmin)
        miss = ~res.hit
        gone = slots[miss].long()
        rad[gone] = rad[gone] + thr[miss] * skycolor(d[miss])
        keep = res.hit
        slots, org, d, thr = slots[keep], org[keep], d[keep], thr[keep]
        attrs = gather_sphere_attrs(scene, res.index[keep], dtype)
        u, xi = slot_draws(seed & 0xFFFFFFFF, b, slots, dtype)
        s = scatter(org, d, res.t[keep], attrs, u, xi)
        org, d, thr = s.origin, s.direction, thr * s.attenuation
    return rad


@torch.no_grad()
def trace_occupancy(scene: Scene, origin: torch.Tensor,
                    direction: torch.Tensor, seed: int,
                    max_depth: int = DEFAULT_MAX_DEPTH,
                    tmin: float = DEFAULT_TMIN, tile: int = 16384,
                    impl: str | None = None,
                    draws: Callable | None = None) -> tuple[list, list]:
    """Per-bounce occupancy of the fixed-depth wavefront (reference:
    ``trace_occupancy``): ``(alive_counts, active_tiles)``, each a list of
    ``max_depth`` ints, the live rays entering bounce ``b`` and the tiles of
    ``tile`` rays holding at least one of them. Positional draws, as
    :func:`trace`, or the test hook ``draws(b, R)``."""
    dtype, dev = origin.dtype, origin.device
    R = origin.shape[0]
    impl = resolve_impl(impl, dev)
    isect = _pick_intersector(dtype, False, impl)
    n_tiles = -(-R // tile)
    alive = torch.ones((R,), dtype=torch.bool, device=dev)
    org, d = origin, direction
    counts, tiles = [], []
    for b in range(max_depth):
        counts.append(alive.sum())
        padded = torch.zeros((n_tiles * tile,), dtype=torch.bool, device=dev)
        padded[:R] = alive
        tiles.append(padded.reshape(n_tiles, tile).any(1).sum())
        res, _ = isect(org, d, scene, tmin)
        t_safe = torch.where(res.hit, res.t, torch.ones_like(res.t))
        u, xi = (positional_draws(seed, b, R, dtype, dev) if draws is None
                 else draws(b, R))
        s = scatter(org, d, t_safe, gather_sphere_attrs(scene, res.index,
                                                        dtype), u, xi)
        live_hit = (alive & res.hit)[:, None]
        org = torch.where(live_hit, s.origin, org)
        d = torch.where(live_hit, s.direction, d)
        alive = alive & res.hit
    return ([int(c) for c in torch.stack(counts).tolist()],
            [int(c) for c in torch.stack(tiles).tolist()])
