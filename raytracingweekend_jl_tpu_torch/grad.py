"""Differentiable rendering — gradients of image losses w.r.t. scene
parameters (the counterpart of ``raytracingweekend_jl_tpu.grad``).

Gradients flow through every continuous quantity (hit distance, hit point,
normal, attenuation products, Schlick reflectance, sky lerp); the discrete
events (closest-hit winner, material, reflect-or-refract coin, front face)
are replayed as constants. Silhouette terms are not estimated (interior
gradients only).

The port runs the reference's two device defaults, on every device, for
float32: images of 2^17 pixels or more take the persistent-record kernel
pair with tail compaction at (44, 16) and strict NaN-poisoning of dropped
paths (``ops/persist_grad.py``), smaller ones the fixed-depth record/replay
pair (``ops/fused_grad.py``). Those pairs are float32, so a float64 scene
or camera with no path flag takes the reference's default off its device,
the recorded wavefront (``recorded=True`` alone, ``ops/grad_trace.py``),
which sweeps float64 in the dot form: a route chosen by the float type.
``recorded=False, remat=True`` (or ``recorded=False``
alone) takes the remat twin instead: autograd through the fixed-depth
wavefront ``ops/integrator.trace`` with each bounce recomputed in the
backward (``remat=False`` keeps every bounce; ``fused_attrs=True`` sweeps
through K10). A card runs the CUDA kernels, the CPU (only when asked for
with ``device="cpu"``) their plain versions.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from .camera import Camera
from .ops.persist_grad import default_n_iters, persist_record_bytes
from .render import _resolve_device, render_radiance
from .scene import Scene
from .utils.profiling import span, spanned

#: Fields of :class:`Scene` that are differentiable parameters.
DIFF_FIELDS = ("center", "radius", "albedo", "fuzz", "ir")

#: Explicit budget (bytes) for the recorded path's records. ``None`` (the
#: default) resolves from the device at first use (:func:`record_hbm_budget`);
#: RTW_RECORD_HBM_GB pins it, and tests set this attribute directly.
RECORD_HBM_BUDGET = (int(float(os.environ["RTW_RECORD_HBM_GB"]) * 2**30)
                     if "RTW_RECORD_HBM_GB" in os.environ else None)

#: Device memory kept back from the records for everything else: state
#: planes, replay carries, the attribute contraction's scratch, allocator
#: slack (the reference's reserve).
_HBM_RESERVE_BYTES = int(4.5 * 2**30)

_RESOLVED_HBM_BUDGET: dict = {}

#: Per-ray-per-bounce record cost of the XLA recorded path, doubled for the
#: reverse scan's cotangent buffers (the reference's pricing).
_RECORD_BYTES_PER_RAY_BOUNCE = 12 * 4 * 2 + 8

#: Fixed-depth kernel pair: 21 record planes + 1 winner index per ray per
#: bounce.
_FUSED_BYTES_PER_RAY_BOUNCE = 21 * 4 + 4


def record_hbm_budget(device=None) -> int:
    """Bytes of device memory the recorded gradient path may spend on path
    records. ``RECORD_HBM_BUDGET`` wins; on a CUDA device it is the card's
    memory (``torch.cuda.mem_get_info``) minus a fixed reserve; the CPU
    keeps the reference's 8 GiB default (the number only steers chunking
    there)."""
    if RECORD_HBM_BUDGET is not None:
        return RECORD_HBM_BUDGET
    device = torch.device("cpu" if device is None else device)
    if device.type != "cuda":
        return 8 * 2**30
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _RESOLVED_HBM_BUDGET:
        total = torch.cuda.mem_get_info(index)[1]
        _RESOLVED_HBM_BUDGET[index] = max(total - _HBM_RESERVE_BYTES, 1 << 31)
    return _RESOLVED_HBM_BUDGET[index]


def auto_pixel_chunk(n_pix: int, max_depth: int, budget: int | None = None,
                     bytes_per_ray_bounce: int | None = None,
                     soft_cap: int = 1 << 20) -> int | None:
    """Pixel chunk that keeps the recorded path's records inside the budget
    (the reference's rule): ``None`` when the whole image fits, else the
    fewest equal chunks, lane-aligned to 8192, never below 8192."""
    budget = record_hbm_budget() if budget is None else budget
    if bytes_per_ray_bounce is None:
        bytes_per_ray_bounce = _RECORD_BYTES_PER_RAY_BOUNCE
    r_max = budget // (bytes_per_ray_bounce * max(max_depth, 1))
    r_max = max(min(r_max, soft_cap), 8192)
    if n_pix <= r_max:
        return None
    n_chunks = -(-n_pix // r_max)
    chunk = -(-n_pix // n_chunks)
    return max(8192, -(-chunk // 8192) * 8192)


class SceneGrads(NamedTuple):
    """Gradients of the differentiable fields of :class:`Scene`."""

    center: torch.Tensor
    radius: torch.Tensor
    albedo: torch.Tensor
    fuzz: torch.Tensor
    ir: torch.Tensor


def resolve_grad_path(kwargs: dict, n_pix: int, backend: str) -> dict:
    """Resolve the gradient-integrator flags in place (and return them), as
    the reference does: explicit flags win; with none, a device backend
    (``"tpu"`` or ``"cuda"``) takes the persistent-record pair with tail
    compaction ``(44 * depth / 16, 16)`` and strict poisoning for images of
    2^17 pixels or more and the fixed-depth pair below; the CPU takes the
    XLA recorded path."""
    for fwd_only in ("persistent", "compact"):
        if kwargs.get(fwd_only):
            raise ValueError(
                f"{fwd_only}=True is a forward-only rendering flag; the "
                "gradient integrators are selected via recorded/"
                "recorded_fused/recorded_persist (or left to the default)")
    rp = kwargs.get("recorded_persist")
    if rp is not None and (isinstance(rp, bool)
                           or not isinstance(rp, (tuple, list))
                           or len(rp) < 2):
        raise ValueError(
            "recorded_persist must be (n_strips, n_iters|None[, "
            "tail_compact]) — e.g. (8, None) or (8, None, (44, 16)); "
            f"got {rp!r}")
    path_chosen = (any(kwargs.get(k) for k in
                       ("remat", "recorded", "recorded_fused",
                        "recorded_persist", "recorded_stage"))
                   or kwargs.get("recorded") is False)
    if kwargs.get("recorded_fused") or kwargs.get("recorded_persist"):
        kwargs["recorded"] = True
    kwargs.setdefault("recorded", not kwargs.get("remat", False))
    kwargs.setdefault("remat", not kwargs["recorded"])
    if not path_chosen and backend in ("tpu", "cuda"):
        if n_pix >= (1 << 17):
            depth = kwargs.get("max_depth", 16)
            b1 = max(-(-44 * depth // 16), 8)
            kwargs["recorded_persist"] = (8, None, (b1, 16))
            kwargs.setdefault("persist_strict", True)
        else:
            kwargs["recorded_fused"] = True
    return kwargs


def default_grad_backend(*dtypes) -> str:
    """The backend whose default gradient route :func:`resolve_grad_path`
    takes for a render in ``dtypes`` (the ``dtype`` argument, the camera's,
    the scene's; ``None`` entries are skipped): ``"cuda"``, the reference's
    device default, on every device in float32 (the CPU runs the same pairs
    through the kernels' plain versions); ``"cpu"``, the recorded wavefront,
    when any is float64, since the kernel pairs are float32."""
    return ("cpu" if any(d is not None and d != torch.float32
                         for d in dtypes) else "cuda")


def plan_pass_memory(kwargs: dict, n_pix: int, n_samples: int,
                     device=None) -> dict:
    """Decide how the recorded pass loop fits the budget (in place; returns
    kwargs), as the reference does: keep every pass's records if they fit,
    else (persistent path) drop the recorded attribute planes
    (``rec_attrs=False``, replay refetches them), else set
    ``remat_passes=True``: the pass loop then keeps only each pass's
    radiance sum and recomputes the pass's record in the backward."""
    if not kwargs.get("recorded") or "remat_passes" in kwargs \
            or n_samples <= 1:
        return kwargs
    chunk = kwargs.get("pixel_chunk") or n_pix
    persist = kwargs.get("recorded_persist")
    budget = record_hbm_budget(device)
    if persist:
        n_chunks = -(-n_pix // chunk)

        def total_bytes(rec_attrs):
            return n_samples * n_chunks * persist_record_bytes(
                min(chunk, n_pix), persist[0], persist[1],
                persist[2] if len(persist) > 2 else None,
                kwargs.get("max_depth", 16), rec_attrs)

        total = total_bytes(persist[3] if len(persist) > 3 else True)
        if total > budget and len(persist) <= 3 \
                and total_bytes(False) <= budget:
            kwargs["recorded_persist"] = (
                tuple(persist) + (None,) * (3 - len(persist)) + (False,))
            total = total_bytes(False)
    else:
        bpr = (_FUSED_BYTES_PER_RAY_BOUNCE
               if kwargs.get("recorded_fused")
               else _RECORD_BYTES_PER_RAY_BOUNCE)
        total = n_pix * n_samples * bpr * kwargs.get("max_depth", 16)
    kwargs["remat_passes"] = total > budget
    return kwargs


def render_loss(scene: Scene, cam: Camera, target: torch.Tensor,
                image_width: int, n_samples: int,
                loss_fn: Callable | None = None, **kwargs) -> torch.Tensor:
    """Scalar loss of a differentiable render against ``target`` [H, W, 3]
    (linear radiance): the mean squared error unless ``loss_fn(img,
    target)`` is given. Gradients reach every scene tensor that requires
    them. ``kwargs`` go to :func:`render.render_radiance` (``device``, the
    card unless ``"cpu"``; ``seed``, ``max_depth``, ``impl``, ``stats``, the
    path flags); ``pixel_chunk`` is picked to keep the records inside the
    device's memory. Spans ``rtw.grad.plan`` (the route and the memory
    plan) and ``rtw.grad.loss``."""
    ih = kwargs.pop("image_height", None)
    if ih is not None and ih != target.shape[0]:
        raise ValueError(f"image_height={ih} conflicts with "
                         f"target height {target.shape[0]}")
    n_pix = target.shape[0] * image_width
    with span("rtw.grad.plan"):
        resolve_grad_path(kwargs, n_pix, default_grad_backend(
            kwargs.get("dtype"), cam.origin.dtype, scene.center.dtype))
        device = _resolve_device(kwargs.get("device"))
        persist = kwargs.get("recorded_persist")
        depth = kwargs.get("max_depth", 16)
        if kwargs["recorded"] and "pixel_chunk" not in kwargs:
            if persist:
                s_p, n_it = persist[0], persist[1]
                n_it = default_n_iters(s_p, depth) if n_it is None else n_it
                bprb = max((21 * 4 + 4) * n_it // (s_p * depth), 1)
                soft_cap = 1 << 21
            else:
                bprb = (_FUSED_BYTES_PER_RAY_BOUNCE
                        if kwargs.get("recorded_fused") else None)
                soft_cap = 1 << 20
            kwargs["pixel_chunk"] = auto_pixel_chunk(
                n_pix, depth, budget=record_hbm_budget(device),
                bytes_per_ray_bounce=bprb, soft_cap=soft_cap)
        plan_pass_memory(kwargs, n_pix, n_samples, device=device)
    img = render_radiance(scene, cam, image_width, n_samples,
                          image_height=target.shape[0], persistent=False,
                          **kwargs)
    with span("rtw.grad.loss"):
        target = torch.as_tensor(target, dtype=img.dtype).to(img.device)
        if loss_fn is None:
            return torch.mean((img - target) ** 2)
        return loss_fn(img, target)


@spanned("rtw.grad.step", root=True)
def render_grads(scene: Scene, cam: Camera, target: torch.Tensor,
                 image_width: int, n_samples: int, **kwargs
                 ) -> tuple[torch.Tensor, SceneGrads]:
    """``(loss, SceneGrads)``: the loss of :func:`render_loss` and its
    gradients w.r.t. every differentiable scene field, in the caller's
    shapes and on the caller's device (padding spheres get zeros). Each
    call is the span ``rtw.grad.step`` (a new step id); the backward is
    ``rtw.grad.backward``, on the calling thread."""
    leaves = {f: getattr(scene, f).detach().requires_grad_(True)
              for f in DIFF_FIELDS}
    loss = render_loss(scene._replace(**leaves), cam, target, image_width,
                       n_samples, **kwargs)
    with span("rtw.grad.backward"):
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g
             for x, g in zip(leaves.values(), grads)]
    return loss.detach(), SceneGrads(*grads)


class GradSanityError(RuntimeError):
    """A gradient failed the sanity tripwire (non-finite values or an absurd
    magnitude)."""


def check_grads_sane(grads: SceneGrads, loss=None,
                     max_abs: float = 1e3) -> None:
    """Host-side tripwire: the loss (when given) and every field of
    ``grads`` must be finite, and each field's |sum| and max |element|
    below ``max_abs`` (the book scenes' gradient sums are O(0.05)). Raises
    :class:`GradSanityError` naming the field as ``grad[<field>]``."""
    if loss is not None:
        lv = float(torch.as_tensor(loss).detach().cpu())
        if not np.isfinite(lv):
            raise GradSanityError(f"loss is not finite: {lv}")
    for name in SceneGrads._fields:
        a = getattr(grads, name).detach().cpu().to(torch.float64).numpy()
        if not np.isfinite(a).all():
            raise GradSanityError(f"grad[{name}] contains non-finite values "
                                  f"({np.count_nonzero(~np.isfinite(a))} of "
                                  f"{a.size})")
        s, m = abs(float(a.sum())), float(np.abs(a).max(initial=0.0))
        if s > max_abs or m > max_abs:
            raise GradSanityError(
                f"grad[{name}] magnitude implausible: |sum|={s:.4g}, "
                f"max|elem|={m:.4g} (bound {max_abs:g}) — likely kernel "
                "corruption; re-run and audit before recording")


def twin_ad_canary(scene: Scene, cam: Camera, width: int = 256,
                   n_samples: int = 8, **kwargs) -> None:
    """Cheap corruption cross-check (reference: ``grad.twin_ad_canary``):
    the gradients of the default (kernel-pair) route and of the remat twin
    (``recorded=False, remat=True``: autograd through the fixed-depth
    wavefront) on a small configuration. The two share no backward code
    and draw different numbers, so the check is noise-robust: per-field L2
    norms within 4x and the albedo cosine above 0.5. ``kwargs`` (``device``,
    ``max_depth``, ...) reach both twins; the path flags and the seed only
    the first. Raises :class:`GradSanityError` on disagreement."""
    target = render_radiance(scene, cam, width, 1, seed=123,
                             device=kwargs.get("device"))
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.8, 0, 1))
    shared = {k: v for k, v in kwargs.items()
              if k not in ("recorded", "remat", "recorded_fused",
                           "recorded_persist", "recorded_stage", "seed")}
    rec_kw = {k: v for k, v in kwargs.items() if k != "seed"}
    _, g_rec = render_grads(bad, cam, target, width, n_samples, seed=5,
                            **rec_kw)
    _, g_ref = render_grads(bad, cam, target, width, n_samples, seed=5,
                            recorded=False, remat=True, **shared)
    check_grads_sane(g_rec)
    check_grads_sane(g_ref)
    for name in SceneGrads._fields:
        a = getattr(g_rec, name).detach().cpu().to(torch.float64).ravel()
        b = getattr(g_ref, name).detach().cpu().to(torch.float64).ravel()
        na, nb = float(a.norm()), float(b.norm())
        if nb < 1e-9 and na < 1e-9:
            continue
        ratio = na / max(nb, 1e-12)
        if not (0.25 < ratio < 4.0):
            raise GradSanityError(
                f"twin-AD canary: grad[{name}] recorded-vs-remat norm ratio "
                f"{ratio:.3g} (want 0.25-4) — kernel-pair gradients look "
                "corrupted")
        if name == "albedo":
            # Direction only where the loss has signal (the canary perturbs
            # albedo); the other fields are noise at canary spp.
            cos = float(a @ b) / max(na * nb, 1e-24)
            if cos < 0.5:
                raise GradSanityError(
                    f"twin-AD canary: grad[albedo] recorded-vs-remat cosine "
                    f"{cos:.3f} (want >0.5) — kernel-pair gradients look "
                    "corrupted")


def sgd_inverse_render_step(scene: Scene, cam: Camera, target: torch.Tensor,
                            image_width: int, n_samples: int,
                            lr: float = 0.01, **kwargs
                            ) -> tuple[torch.Tensor, Scene]:
    """One gradient-descent step fitting the differentiable scene fields to
    a target image; returns ``(loss, new scene)``."""
    loss, grads = render_grads(scene, cam, target, image_width, n_samples,
                               **kwargs)
    with torch.no_grad():
        new = {f: getattr(scene, f) - lr * getattr(grads, f)
               for f in DIFF_FIELDS}
    return loss, scene._replace(**new)
