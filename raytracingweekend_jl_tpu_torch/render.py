"""Render driver — the ``render`` entry point of the port (counterpart of
``raytracingweekend_jl_tpu.render``).

Reference semantics (src/render.jl:8-44): ``H = W * 9 // 16`` unless given;
film coordinates ``u = (j+1)/W``, ``v = (H-1-i)/H`` with row 0 at the top;
global sample 0 centered, later samples jittered by ``U[0,1)/W`` and
``U[0,1)/H``; radiance averaged over samples and gamma-2 encoded.

The entry points run on the card unless the caller passes ``device="cpu"``;
without CUDA they raise. On the CPU every route runs the kernels' plain
PyTorch versions.

The default route (``persistent=False``, as in the reference package) traces
sample passes through the fixed-depth wavefront ``ops/integrator.trace``:
every bounce sweeps every ray through K1 (or K10 with ``fused_attrs=True``),
and the image is differentiable (``remat=True`` recomputes each bounce in
the backward). Float64 scenes and cameras render here too, through the
dot-form sweep. The same pass loop runs the gradient kernel pairs that
``grad.render_loss`` picks: the fixed-depth record/replay pair
(``recorded_fused``, K3 and K7, ``ops/fused_grad.py``) or the
persistent-record pair (``recorded_persist``, K3-K6, ``ops/persist_grad.py``).

Forward-only routes (``persistent=True``), picked as the reference package
picks them on its device:

- a small image or tile without a ``pixel_start`` (at most 65 536 pixels,
  or 131 072 with at most 64 spheres) renders in one launch of the inline
  kernel (K8, ``ops/inline.py``);
- a full image or a contiguous chunk (``pixel_start``) takes the persistent
  strided integrator (K1 and K2);
- any other tile, given by its film coordinates ``u``/``v``, takes the
  pixel-pinned integrator (K1 and K9, ``persistent_render_sum_fused``).

Those kernels are float32. A float64 ``persistent=True`` render (film
coordinates, scene or camera in float64), whole image or tile, takes the
plain pixel-pinned body ``ops/integrator.persistent_render_sum`` instead,
which runs in any float type and sweeps float64 rays in the dot form on
the card too: the reference package sends float64 to its XLA body off the
TPU the same way. The route is chosen by the float type, not taken when a
kernel fails. An explicit request for a float32 kernel (``inline=True``,
``generator``, ``recorded_fused``, ``recorded_persist``) raises
``NotImplementedError`` in float64.

``compact=True`` swaps the wavefront for the forward-only compacting one
(``trace_compacted``: only live rays are swept, the draws keyed by slot).
The other gradient routes: ``recorded=True`` alone takes the recorded
wavefront (``ops/grad_trace.trace_recorded``: K1 and a sweep-free
backward), ``recorded_stage = (B, div)`` its staged form (the survivors of
bounce ``B`` compacted to ``R // div`` lanes), ``fused_stages`` the staged
fixed-depth pair (``ops/fused_grad.trace_recorded_fused_staged``, K3 and
K7), and the wavefront ``trace`` takes ``tile_skip`` and ``remat_policy``.
A staged route whose budget overflows warns once per render, after the
pass loop, and adds the count to ``stats["overflow"]``.
``remat_passes=True`` keeps only each pass's radiance sum and recomputes the
pass in the backward (:class:`_RecomputedPass`), the counterpart of the
reference's ``jax.checkpoint`` of the pass body.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import rng
from .camera import Camera, sample_pass_rays
from .ops.fused_grad import (check_stages, trace_recorded_fused,
                             trace_recorded_fused_staged, warn_overflow)
from .ops.grad_trace import trace_recorded, trace_recorded_staged
from .ops.inline import render_inline_sum
from .ops.integrator import (DEFAULT_MAX_DEPTH, check_remat_policy,
                             persistent_render_sum,
                             persistent_render_sum_fused,
                             persistent_render_sum_strided, trace,
                             trace_compacted)
from .ops.intersect import DEFAULT_TMIN
from .ops.persist_grad import trace_recorded_persist
from .ops.vecmath import gamma2_encode
from .scene import Scene, check_static, scene_moves, trim_scene
from .utils.profiling import span, spanned, sync


def image_height_for(image_width: int) -> int:
    """Reference: ``image_width ÷ (16//9)`` (src/render.jl:11-12)."""
    return image_width * 9 // 16


def pixel_coords(image_width: int, image_height: int, dtype=torch.float32,
                 device="cpu"):
    """Flattened ``[H*W]`` film coordinates (u, v) in reference convention,
    computed in float64 on the host and cast once."""
    j = np.arange(image_width, dtype=np.float64)
    i = np.arange(image_height, dtype=np.float64)
    u = (j + 1.0) / image_width
    v = (image_height - 1.0 - i) / image_height
    uu, vv = np.meshgrid(u, v)  # [H, W]
    out = []
    for x in (uu, vv):
        with sync("film_coords"):  # a copy from the host waits for the card
            out.append(torch.as_tensor(x.ravel(), dtype=dtype).to(device))
    return tuple(out)


def pick_samples_per_pass(n_pix: int, n_samples: int,
                          rays_per_pass: int = 1 << 21) -> int:
    """Largest divisor of ``n_samples`` whose merged wavefront stays under
    ``rays_per_pass`` rays."""
    best = 1
    for d in range(1, n_samples + 1):
        if n_samples % d == 0 and n_pix * d <= rays_per_pass:
            best = d
    return best


#: Lane-count floor for the strided path: below this many lanes k shrinks.
STRIDED_MIN_LANES = 32768


def strided_k_for(n_pix: int, k_full: int = 64) -> int:
    """Pixels per lane for a tile: full k while the tile still yields
    >= STRIDED_MIN_LANES lanes, else as many lanes as possible (k -> 1)."""
    return max(1, min(k_full, n_pix // STRIDED_MIN_LANES))


def strided_sample_groups_for(n_pix: int, n_samples: int) -> int:
    """Sample-group folding for small tiles: the largest divisor of
    ``n_samples`` keeping lanes <= ~4x the lane floor; 1 for big tiles."""
    if n_pix >= STRIDED_MIN_LANES:
        return 1
    cap = max(1, (4 * STRIDED_MIN_LANES) // max(n_pix, 1))
    best = 1
    for mm in range(1, n_samples + 1):
        if n_samples % mm == 0 and mm <= cap:
            best = mm
    return best


def inline_route_for(n_pix: int, n_spheres: int,
                     moving: bool = False) -> bool:
    """The reference's pick of the single-launch route for a full image: at
    most 65 536 pixels, or at most 131 072 with at most 64 spheres; never
    for a moving scene, which K8 cannot render (it has no time)."""
    return not moving and (n_pix <= 65536
                           or (n_pix <= 131072 and n_spheres <= 64))


def _resolve_device(device) -> torch.device:
    """``None`` means the card. Asking for CUDA without it raises: the port
    never falls back to the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port runs on a CUDA device unless "
                           "device='cpu' is passed, and CUDA is not "
                           "available; it does not fall back to the CPU")
    return device


def _check_route(fused_stages=None, remat_policy: str | None = None,
                 tile_skip: int = 0) -> None:
    """Raise ``ValueError`` for route options no route takes: a malformed
    stage schedule, an unknown ``remat_policy``, a negative ``tile_skip``."""
    if fused_stages is not None:
        check_stages(fused_stages)
    check_remat_policy(remat_policy)
    if tile_skip < 0:
        raise ValueError(f"tile_skip must be >= 0, got {tile_skip}")


def _pass_tracer(scene: Scene, max_depth: int, tmin: float,
                 impl: str | None, *, remat: bool = False,
                 fused_attrs: bool = False, compact: bool = False,
                 recorded: bool = False, recorded_fused: bool = False,
                 recorded_stage: tuple | None = None,
                 fused_stages: tuple | None = None,
                 recorded_persist: tuple | None = None,
                 persist_strict: bool = False, replay_fused: bool = True,
                 tile_skip: int = 0, remat_policy: str | None = None,
                 stats: dict | None = None,
                 overflow: list | None = None) -> Callable:
    """``trace(origin, direction, seed32) -> radiance [R, 3]`` of one sample
    pass through the route the flags pick, in the reference's order: the
    forward-only compacting wavefront with ``compact``; the
    persistent-record pair when ``recorded_persist = (n_strips,
    n_iters|None[, tail_compact[, rec_attrs]])`` is given; the fixed-depth
    pair with ``recorded_fused`` (staged with ``fused_stages``); the staged
    recorded wavefront with ``recorded_stage = (B, div)``; the recorded
    wavefront with ``recorded``; else the fixed-depth wavefront ``trace``
    (``remat``, ``fused_attrs``, ``remat_policy``, ``tile_skip``). The
    staged routes append the count of lanes their budgets dropped (a device
    tensor) to ``overflow`` when it is a list. None of them has a shutter
    time: a moving scene raises ``NotImplementedError``."""
    check_static(scene, "persistent=False (the wavefront and gradient routes)")
    if compact:
        return lambda o, d, s: trace_compacted(scene, o, d, s, max_depth,
                                               tmin, impl=impl)
    if recorded_persist is not None:
        p_strips, p_iters = recorded_persist[0], recorded_persist[1]
        p_tc = recorded_persist[2] if len(recorded_persist) > 2 else None
        p_rec_attrs = recorded_persist[3] if len(recorded_persist) > 3 \
            else True
        return lambda o, d, s: trace_recorded_persist(
            scene, o, d, s, max_depth, tmin, p_strips, p_iters,
            tail_compact=p_tc, rec_attrs=p_rec_attrs, strict=persist_strict,
            impl=impl, stats=stats)
    if recorded_fused and fused_stages is not None:
        def staged_pair(o, d, s):
            audit_pass = {}
            rad = trace_recorded_fused_staged(scene, o, d, s, max_depth, tmin,
                                              fused_stages, impl=impl,
                                              stats=audit_pass)
            if overflow is not None:
                overflow.append(audit_pass["n_over"])
            return rad
        return staged_pair
    if recorded_fused:
        return lambda o, d, s: trace_recorded_fused(
            scene, o, d, s, max_depth, tmin, replay_fused=replay_fused,
            impl=impl)
    if recorded_stage is not None:
        stage_b, stage_div = recorded_stage

        def staged(o, d, s):
            width = max(o.shape[0] // stage_div, 1)
            rad, count = trace_recorded_staged(scene, o, d, s, max_depth,
                                               tmin, stage_b, width,
                                               impl=impl)
            if overflow is not None:
                overflow.append(torch.clamp(count - width, min=0))
            return rad
        return staged
    if recorded:
        return lambda o, d, s: trace_recorded(scene, o, d, s, max_depth, tmin,
                                              impl=impl)
    return lambda o, d, s: trace(scene, o, d, s, max_depth, tmin, remat=remat,
                                 fused_attrs=fused_attrs, impl=impl,
                                 remat_policy=remat_policy,
                                 tile_skip=tile_skip)


def _report_overflow(overflow: list, stats: dict | None) -> None:
    """After a render's pass loop: the lanes the staged routes' budgets
    dropped, summed on the device and added to ``stats["overflow"]`` (when
    ``stats`` is a dict), then one host read and one ``RuntimeWarning``
    when any was dropped."""
    if not overflow:
        return
    total = torch.stack([x.to(torch.int64) for x in overflow]).sum()
    if stats is not None:
        stats["overflow"] = stats.get("overflow", 0) + total
    warn_overflow(total, "render (fused_stages or recorded_stage)")


def _pass_sum(cam: Camera, u: torch.Tensor, v: torch.Tensor, seed: int,
              s0: int, spp: int, f32_w: float, f32_h: float,
              trace_fn: Callable) -> torch.Tensor:
    """Radiance sum ``[n_pix, 3]`` of one sample pass: global samples ``s0
    .. s0 + spp - 1`` of the pixels at ``u``/``v``, traced in one wavefront
    by ``trace_fn``. The rays are span ``rtw.rays``."""
    with span("rtw.rays"):
        origin, direction = sample_pass_rays(cam, u, v, seed, s0, spp, f32_w,
                                             f32_h)
    radiance = trace_fn(origin, direction,
                        rng.purpose_seed(seed, rng.SCATTER_DIR, s0)
                        & 0xFFFFFFFF)
    return radiance.reshape(spp, u.shape[0], 3).sum(0)


class _RecomputedPass(torch.autograd.Function):
    """One sample pass whose records are not kept (``remat_passes``): the
    forward runs the pass without building a graph and keeps only its
    inputs; the backward runs it again from detached copies of them, with
    the graph, and takes the gradients of the pass's sum. The draws are
    keyed by (seed, purpose, pass) and by (seed, bounce or iteration) with
    the lane as the counter, so the recomputed record is the first one bit
    for bit. A tensor the pass reads once (each scene field, on the
    recorded pairs) gets the same gradient bit for bit; one it reads more
    than once (the camera's origin; the scene on the default wavefront)
    gets its terms of the pass summed before the passes' sums, which can
    move its last bits.

    ``tensors`` are every tensor the pass reads that may need a gradient:
    the scene's six fields, then the camera's eight. ``run(scene, cam,
    audit)`` returns the pass's sum; the forward calls it with ``audit``
    True, the backward with False (the ``stats`` hook off, so a pass is
    counted once)."""

    @staticmethod
    def forward(ctx, run, *tensors):
        ctx.run = run
        ctx.save_for_backward(*tensors)
        return run(Scene(*tensors[:6]), Camera(*tensors[6:]), True)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[1:]
        inputs = [x.detach().requires_grad_(n)
                  for x, n in zip(ctx.saved_tensors, need)]
        wanted = [x for x in inputs if x.requires_grad]
        with torch.enable_grad():
            out = ctx.run(Scene(*inputs[:6]), Camera(*inputs[6:]), False)
        grads = iter(torch.autograd.grad(out, wanted, g, allow_unused=True))
        return (None,) + tuple(next(grads) if x.requires_grad else None
                               for x in inputs)


#: The route flags :func:`_pass_tracer` takes.
_TRACER_FLAGS = ("remat", "fused_attrs", "compact", "recorded",
                 "recorded_fused", "recorded_stage", "fused_stages",
                 "recorded_persist", "persist_strict", "replay_fused",
                 "tile_skip", "remat_policy", "stats", "overflow")


def _retracer(max_depth: int, tmin: float, impl: str | None,
              flags: dict) -> Callable:
    """``retrace(scene, audit)`` for :func:`render_tile_sum_traced`: the
    pass tracer of ``scene`` with the route ``flags``, its ``stats`` and
    ``overflow`` hooks kept only when ``audit``."""
    def retrace(scene, audit):
        return _pass_tracer(scene, max_depth, tmin, impl, **{
            **flags, "stats": flags.get("stats") if audit else None,
            "overflow": flags.get("overflow") if audit else None})
    return retrace


def render_tile_sum_traced(scene: Scene, cam: Camera, u: torch.Tensor,
                           v: torch.Tensor, seed: int, n_samples: int,
                           sample_offset: int, f32_w: float, f32_h: float,
                           samples_per_pass: int, trace_fn: Callable,
                           retrace: Callable | None = None) -> torch.Tensor:
    """Radiance *sum* ``[n_pix, 3]`` of the pixels at film coordinates
    ``u``/``v`` [n_pix]: the reference's pass loop.

    Pass ``p`` traces ``samples_per_pass`` samples of every pixel in one
    wavefront, global samples from ``s0 = sample_offset + p *
    samples_per_pass``, with the camera rays of
    :func:`camera.sample_pass_rays`, through ``trace_fn(origin, direction,
    seed32)`` (:func:`_pass_tracer`), whose draws are keyed by
    ``purpose_seed(seed, SCATTER_DIR, s0)`` cut to 32 bits.

    ``retrace(scene, audit)`` (``remat_passes``) returns the pass tracer of
    ``scene``, with its audit hook (``stats``) on or off: with it and more
    than one pass, each pass runs as a :class:`_RecomputedPass`, which keeps
    only the pass's sum and recomputes the pass in the backward (the
    reference's ``jax.checkpoint`` of the pass body). The sums, and the
    gradients of the tensors a pass reads once, are bit for bit those of
    the loop that keeps every pass (:class:`_RecomputedPass`)."""
    spp = samples_per_pass
    if n_samples % spp:
        raise ValueError(f"samples_per_pass={spp} must divide "
                         f"n_samples={n_samples}")
    n_pass = n_samples // spp
    acc = torch.zeros((u.shape[0], 3), dtype=u.dtype, device=u.device)
    for p in range(n_pass):
        s0 = sample_offset + p * spp
        if retrace is None or n_pass == 1:
            acc = acc + _pass_sum(cam, u, v, seed, s0, spp, f32_w, f32_h,
                                  trace_fn)
            continue

        def run(sc, cm, audit, s0=s0):
            return _pass_sum(cm, u, v, seed, s0, spp, f32_w, f32_h,
                             retrace(sc, audit))

        acc = acc + _RecomputedPass.apply(run, *scene, *cam)
    return acc


@spanned("rtw.render.call", root=True)
def render_tile_sum(scene: Scene, cam: Camera, n_pix: int, seed: int,
                    n_samples: int, sample_offset: int, max_depth: int,
                    tmin: float, f32_w: float, f32_h: float,
                    persistent: bool = False, pixel_start: int | None = None,
                    impl: str | None = None,
                    generator: torch.Generator | None = None,
                    inline: bool | None = None, *,
                    u: torch.Tensor | None = None,
                    v: torch.Tensor | None = None,
                    samples_per_pass: int = 1, **route) -> torch.Tensor:
    """Radiance *sum* ``[n_pix, 3]`` of ``n_samples`` samples of one tile,
    on the scene's device (reference: ``render.render_tile_sum``).

    The tile is the contiguous pixel range from ``pixel_start``, or the
    whole image (``pixel_start=None``, ``n_pix == W * H``), or any set of
    pixels given by their film coordinates ``u``/``v`` [n_pix].

    ``persistent=False`` runs the pass loop (:func:`render_tile_sum_traced`)
    with the route flags in ``route`` (``remat``, ``fused_attrs``,
    ``recorded_fused``, ``recorded_persist``, ...). ``persistent=True``
    routes as the reference package does: ``inline=None`` sends a small
    tile without ``pixel_start`` to the single-launch inline kernel; a full
    image or a ``pixel_start`` range takes the strided integrator, with
    ``k`` and the sample-group fold picked as the reference picks them; any
    other tile the pixel-pinned integrator (K9). ``inline=False`` skips the
    inline route, ``inline=True`` forces it. ``generator`` feeds the
    strided route's strip-0 draws and is refused elsewhere. In float64
    (``u``, the camera or the scene) every ``persistent=True`` tile takes
    the plain pixel-pinned body ``persistent_render_sum`` (module
    docstring); ``inline=True`` and ``generator`` raise there. Each call
    is the span ``rtw.render.call``, a new call id."""
    W, H = int(f32_w), int(f32_h)
    full_image = n_pix == W * H
    if u is None:
        if pixel_start is None and not full_image:
            raise ValueError(
                f"a tile of {n_pix} of {W * H} pixels needs pixel_start "
                "(a contiguous range) or its film coordinates u, v")
        start = 0 if pixel_start is None else pixel_start
        u, v = pixel_coords(W, H, dtype=cam.origin.dtype, device=scene.device)
        u, v = u[start:start + n_pix], v[start:start + n_pix]
    if persistent and any(x.dtype != torch.float32
                          for x in (u, cam.origin, scene.center)):
        if inline or generator is not None:
            raise NotImplementedError(
                "float64 persistent renders take the plain pixel-pinned "
                "body; the inline kernel K8 and the strided route's "
                "generator are float32")
        return persistent_render_sum(scene, cam, u, v, seed, n_samples,
                                     sample_offset, max_depth, tmin, f32_w,
                                     f32_h, impl=impl)
    if inline is None:
        inline = pixel_start is None and inline_route_for(
            n_pix, scene.n_spheres, scene_moves(scene))
    strided = full_image or pixel_start is not None
    if generator is not None and not (persistent and strided and not inline):
        raise ValueError(
            "generator feeds the strided route's strip-0 draws; the other "
            "routes draw their camera rays from generators keyed by (seed, "
            "purpose, sample): pass persistent=True, inline=False to use one")
    if not persistent:
        _check_route(**{k: route[k] for k in (
            "fused_stages", "remat_policy", "tile_skip") if k in route})
        flags = {k: route[k] for k in _TRACER_FLAGS if k in route}
        flags["overflow"] = []
        out = render_tile_sum_traced(
            scene, cam, u, v, seed, n_samples, sample_offset, f32_w, f32_h,
            samples_per_pass, _pass_tracer(scene, max_depth, tmin, impl,
                                           **flags),
            _retracer(max_depth, tmin, impl, flags)
            if route.get("remat_passes") else None)
        _report_overflow(flags["overflow"], route.get("stats"))
        return out
    if inline:
        return render_inline_sum(scene, cam, u, v, seed, n_samples,
                                 sample_offset, max_depth, tmin, f32_w,
                                 f32_h, impl)
    if not strided:
        return persistent_render_sum_fused(scene, cam, u, v, seed, n_samples,
                                           sample_offset, max_depth, tmin,
                                           f32_w, f32_h, impl=impl)
    m = strided_sample_groups_for(n_pix, n_samples)
    k = (1 if m > 1 else
         (64 if n_pix >= 48 * STRIDED_MIN_LANES else strided_k_for(n_pix)))
    return persistent_render_sum_strided(
        scene, cam, n_pix, seed, n_samples, sample_offset, max_depth, tmin,
        f32_w, f32_h, k=k, pixel_start=0 if pixel_start is None else pixel_start,
        sample_groups=m, impl=impl, generator=generator)


def render_radiance(scene: Scene, cam: Camera, image_width: int = 400,
                    n_samples: int = 1, *, image_height: int | None = None,
                    max_depth: int = DEFAULT_MAX_DEPTH,
                    tmin: float = DEFAULT_TMIN, seed: int = 0, dtype=None,
                    pixel_chunk: int | None = None, persistent: bool = False,
                    device=None, impl: str | None = None,
                    generator: torch.Generator | None = None,
                    inline: bool | None = None,
                    remat: bool = False, fused_attrs: bool = False,
                    compact: bool = False,
                    recorded: bool = False, recorded_fused: bool = False,
                    recorded_stage: tuple | None = None,
                    fused_stages: tuple | None = None,
                    recorded_persist: tuple | None = None,
                    rays_per_pass: int | None = None,
                    remat_passes: bool = False,
                    persist_strict: bool = False,
                    replay_fused: bool = True,
                    tile_skip: int = 0, remat_policy: str | None = None,
                    stats: dict | None = None) -> torch.Tensor:
    """Linear mean radiance ``[H, W, 3]`` (no gamma) on ``device``: the card
    unless ``device="cpu"`` (the scene and camera move there), in the float
    type ``dtype`` (the reference's ``elem_type`` switch: the film
    coordinates' type, the camera's by default; float64 runs everywhere
    but on the float32 gradient kernel pairs, ``persistent=True`` through
    the plain pixel-pinned body). Differentiable w.r.t. the scene on the
    default route. ``pixel_chunk`` renders contiguous chunks of that many pixels one
    after another, chunk ``c`` with seed ``fold_in(seed, c)``.

    ``persistent=False`` (the default) traces sample passes, ``rays_per_pass``
    samples merged per wavefront (see :func:`pick_samples_per_pass`),
    through the fixed-depth wavefront ``trace`` (``remat``,
    ``fused_attrs``; ``compact`` for the forward-only compacting
    wavefront), or through a gradient kernel pair: ``recorded_fused``,
    or ``recorded_persist`` with ``persist_strict`` (NaN-poisons the image
    and its gradients if the pair drops a path) and ``stats`` (a dict
    collecting its dropped count and occupancy); ``replay_fused=False``
    replays the fixed-depth pair bounce by bounce; ``remat_passes=True``
    recomputes each pass in the backward instead of keeping its records
    (:func:`render_tile_sum_traced`). ``persistent=True`` takes
    the forward-only routes of :func:`render_tile_sum` (``inline``;
    ``generator``, single-chunk strided renders only, supplies the strip-0
    draws). The other gradient routes: ``recorded`` alone (the recorded
    wavefront), ``recorded_stage = (B, div)`` (its staged form),
    ``fused_stages`` (with ``recorded_fused``: the staged fixed-depth
    pair); ``trace`` takes ``tile_skip`` and ``remat_policy`` (module
    docstring). A staged budget that overflows warns once per call and adds
    its count (a device tensor) to ``stats["overflow"]``. The film
    coordinates, like each pass's camera rays, are span ``rtw.rays``."""
    if not persistent:
        _check_route(fused_stages, remat_policy, tile_skip)
    dtype = cam.origin.dtype if dtype is None else dtype
    if dtype != torch.float32 and not persistent and (
            recorded_fused or recorded_persist is not None):
        raise NotImplementedError(
            f"the gradient kernel pairs are float32; a {dtype} render runs "
            "on the wavefront routes or persistent=True")
    device = _resolve_device(device)
    scene = trim_scene(scene.to(device))
    cam = cam.to(device)
    H = image_height if image_height is not None else image_height_for(image_width)
    W = image_width
    n_pix = H * W
    fw, fh = float(np.float32(W)), float(np.float32(H))
    chunks = ([(0, n_pix)] if pixel_chunk is None or pixel_chunk >= n_pix
              else [(st, min(pixel_chunk, n_pix - st))
                    for st in range(0, n_pix, pixel_chunk)])
    if len(chunks) > 1 and generator is not None:
        raise ValueError("generator is for single-chunk renders; chunked "
                         "renders seed each chunk from fold_in(seed, c)")
    with span("rtw.rays"):
        u_all, v_all = pixel_coords(W, H, dtype=dtype, device=device)
    if not persistent:
        if generator is not None:
            raise ValueError(
                "generator feeds the strided route's strip-0 draws; pass "
                "persistent=True, inline=False to use one")
        flags = dict(remat=remat, fused_attrs=fused_attrs, compact=compact,
                     recorded=recorded, recorded_fused=recorded_fused,
                     recorded_stage=recorded_stage, fused_stages=fused_stages,
                     recorded_persist=recorded_persist,
                     persist_strict=persist_strict, replay_fused=replay_fused,
                     tile_skip=tile_skip, remat_policy=remat_policy,
                     stats=stats, overflow=[])
        tracer = _pass_tracer(scene, max_depth, tmin, impl, **flags)
        retrace = (_retracer(max_depth, tmin, impl, flags) if remat_passes
                   else None)
    pieces = []
    for c, (start, size) in enumerate(chunks):
        seed_c = seed if len(chunks) == 1 else rng.fold_in(seed, c)
        if persistent:
            pieces.append(render_tile_sum(
                scene, cam, size, seed_c, n_samples, 0, max_depth, tmin, fw,
                fh, True, None if len(chunks) == 1 else start, impl,
                generator, inline, u=u_all[start:start + size],
                v=v_all[start:start + size]))
        else:
            spp_pass = 1 if rays_per_pass is None else \
                pick_samples_per_pass(size, n_samples, rays_per_pass)
            pieces.append(render_tile_sum_traced(
                scene, cam, u_all[start:start + size],
                v_all[start:start + size], seed_c, n_samples, 0, fw, fh,
                spp_pass, tracer, retrace))
    if not persistent:
        _report_overflow(flags["overflow"], stats)
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)
    return (out / n_samples).reshape(H, W, 3)


def render(scene: Scene, cam: Camera, image_width: int = 400,
           n_samples: int = 1, **kwargs) -> torch.Tensor:
    """Gamma-2 encoded image ``[H, W, 3]`` in [0, 1] (src/render.jl:8-9), on
    the card unless ``device="cpu"`` is passed."""
    return gamma2_encode(render_radiance(scene, cam, image_width, n_samples,
                                         **kwargs))
