"""Checkpoint and resume for long renders on one device.

The reference renders monolithically in memory — a crash loses everything
(reference: src/render.jl:15-43; SURVEY.md §5 'Checkpoint: None'). Here the
sample dimension is chunked: after every chunk the accumulated *radiance sum*
and the number of completed samples are written to ``.npz``, and a resume
continues from the next chunk. Each chunk's draws are keyed by its first
global sample (``sample_offset``) and its passes start at multiples of
``samples_per_pass``, so a resumed render is sample-exact: interrupted at
any chunk boundary and resumed with the same settings, the image is the
uninterrupted chunked run's bit for bit.

The file records every setting the image depends on besides the sample
count: the film, the seed, ``spp_chunk``, ``max_depth``, ``tmin``, the route
(``persistent``, ``compact``, ``rays_per_pass``), a digest of the scene's and
the camera's arrays, and the port's random streams (``rng="philox"``). A
resume that differs in any of them, or asks for fewer samples than the file
holds, raises ``ValueError``. A file the JAX package wrote (threefry streams,
no ``rng`` key) loads with :func:`load_state` but is refused for resume: the
port cannot continue its streams.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, fields

import numpy as np
import torch

from ..camera import Camera
from ..render import (_resolve_device, image_height_for,
                      pick_samples_per_pass, render_tile_sum)
from ..scene import Scene, trim_scene
from .metrics import PhaseTimer

#: The random streams the port's renders draw (``rng.py``: keyed
#: ``torch.Generator`` draws and Philox4x32-10 in the kernels).
RNG = "philox"

#: Settings a resume must match, besides the film, the seed and ``rng``.
RESUME_KEYS = ("spp_chunk", "max_depth", "tmin", "persistent", "compact",
               "rays_per_pass", "scene_digest")


@dataclass
class RenderState:
    """Accumulated render progress: the sum of per-sample radiance, the
    count, and the settings it was rendered with (``None`` where the file
    does not say: a JAX-written one)."""

    radiance_sum: np.ndarray  # [H, W, 3] float64 accumulation on the host
    samples_done: int
    image_width: int
    image_height: int
    seed: int
    spp_chunk: int | None = None
    max_depth: int | None = None
    tmin: float | None = None
    persistent: bool | None = None
    compact: bool | None = None
    rays_per_pass: int | None = None
    scene_digest: str | None = None
    rng: str | None = None

    @property
    def image(self) -> np.ndarray:
        """Current mean-radiance estimate (linear)."""
        return self.radiance_sum / max(self.samples_done, 1)


def save_state(state: RenderState, path: str) -> None:
    """Write ``state`` to ``path`` atomically: a temporary file, flushed to
    disk, then renamed over ``path``."""
    arrays = {f.name: getattr(state, f.name) for f in fields(state)
              if getattr(state, f.name) is not None}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_state(path: str) -> RenderState:
    """Read a state written by :func:`save_state` or by the JAX package's
    ``save_state`` (whose files lack the settings: they load as ``None``)."""
    casts = {"spp_chunk": int, "max_depth": int, "tmin": float,
             "persistent": bool, "compact": bool, "rays_per_pass": int,
             "scene_digest": str, "rng": str}
    with np.load(path) as z:
        opt = {k: cast(z[k][()]) for k, cast in casts.items() if k in z.files}
        return RenderState(radiance_sum=z["radiance_sum"],
                           samples_done=int(z["samples_done"]),
                           image_width=int(z["image_width"]),
                           image_height=int(z["image_height"]),
                           seed=int(z["seed"]), **opt)


def scene_digest(scene: Scene, cam: Camera) -> str:
    """SHA-256 of the scene's and the camera's arrays: names, dtypes,
    shapes and bytes."""
    h = hashlib.sha256()
    for prefix, tup in (("scene", scene), ("camera", cam)):
        for name, x in zip(tup._fields, tup):
            a = np.ascontiguousarray(x.detach().cpu().numpy())
            h.update(f"{prefix}.{name}:{a.dtype.str}:{a.shape}".encode())
            h.update(a.tobytes())
    return h.hexdigest()


def _check_resume(state: RenderState, want: RenderState,
                  n_samples: int) -> None:
    """Raise ``ValueError`` unless ``state`` can be continued as ``want``
    to ``n_samples`` samples."""
    have = (state.image_width, state.image_height, state.seed)
    if have != (want.image_width, want.image_height, want.seed):
        raise ValueError(
            "checkpoint does not match render configuration: (width, "
            f"height, seed) {have} in the file, "
            f"{(want.image_width, want.image_height, want.seed)} asked")
    if state.rng != RNG:
        raise ValueError(
            "checkpoint does not match render configuration: its samples "
            f"were drawn from rng={state.rng!r} (None: a JAX-written file, "
            f"threefry streams), this render draws {RNG!r}; it cannot be "
            "continued")
    for key in RESUME_KEYS:
        if getattr(state, key) != getattr(want, key):
            raise ValueError(
                f"checkpoint does not match render configuration: {key}="
                f"{getattr(state, key)!r} in the file, "
                f"{getattr(want, key)!r} asked (sample-exact resume needs "
                "the same settings)")
    if state.samples_done > n_samples:
        raise ValueError(
            f"checkpoint holds {state.samples_done} samples, more than the "
            f"{n_samples} asked")


def render_checkpointed(scene: Scene, cam: Camera, image_width: int,
                        n_samples: int, *, image_height: int | None = None,
                        seed: int = 0, spp_chunk: int = 50,
                        checkpoint_path: str | None = None,
                        max_depth: int = 16, tmin: float = 1e-4,
                        compact: bool = False, persistent: bool = True,
                        rays_per_pass: int = 1 << 21,
                        progress: bool = False, max_retries: int = 2,
                        timer: PhaseTimer | None = None,
                        device=None) -> RenderState:
    """Render ``n_samples`` in chunks of ``spp_chunk`` on ``device`` (the
    card unless ``"cpu"``), writing ``checkpoint_path`` after each.

    If ``checkpoint_path`` exists, resumes from it (see the module
    docstring for what must match). Chunk ``c`` renders global samples
    ``[c * spp_chunk, ...)`` through :func:`render.render_tile_sum` of the
    whole film, its draws keyed by the chunk's first sample, so the union
    over chunks equals one uninterrupted chunked render. Each chunk's
    radiance sum is fetched to the host (the ``fetch`` phase is the sync)
    and accumulated there in float64.

    Failure handling (the reference has none): a chunk that raises a
    ``RuntimeError`` (a device fault) is retried on the same device and
    route up to ``max_retries`` times, then the error is raised; committed
    chunks are already on disk. ``timer`` accumulates the ``trace``,
    ``fetch`` and ``checkpoint`` phases; ``progress`` prints one JSON line
    per chunk with the running totals.

    Float64 (a float64 camera) renders only with ``persistent=False``, as
    in :func:`render.render_radiance`."""
    if spp_chunk <= 0:
        raise ValueError(f"spp_chunk={spp_chunk} must be positive")
    if cam.origin.dtype != torch.float32 and persistent:
        raise NotImplementedError(
            f"{cam.origin.dtype} renders run on the fixed-depth wavefront "
            "only (persistent=False); the persistent routes are float32")
    device = _resolve_device(device)
    scene = trim_scene(scene.to(device))
    cam = cam.to(device)
    H = image_height if image_height is not None else image_height_for(
        image_width)
    W = image_width
    fresh = RenderState(np.zeros((H, W, 3)), 0, W, H, seed,
                        spp_chunk=spp_chunk, max_depth=max_depth,
                        tmin=float(tmin), persistent=bool(persistent),
                        compact=bool(compact), rays_per_pass=rays_per_pass,
                        scene_digest=scene_digest(scene, cam), rng=RNG)
    if checkpoint_path and os.path.exists(checkpoint_path):
        state = load_state(checkpoint_path)
        _check_resume(state, fresh, n_samples)
    else:
        state = fresh
    f32_w, f32_h = float(np.float32(W)), float(np.float32(H))

    if timer is None:
        timer = PhaseTimer()
    while state.samples_done < n_samples:
        todo = min(spp_chunk, n_samples - state.samples_done)
        spp_pass = pick_samples_per_pass(W * H, todo, rays_per_pass)
        t0 = time.time()
        for attempt in range(max_retries + 1):
            try:
                timer.start("trace")
                with torch.no_grad():
                    acc = render_tile_sum(
                        scene, cam, W * H, seed, todo, state.samples_done,
                        max_depth, tmin, f32_w, f32_h, persistent,
                        samples_per_pass=spp_pass, compact=compact)
                timer.stop("trace")
                timer.start("fetch")  # the copy to the host is the sync
                acc = acc.cpu().numpy().astype(np.float64).reshape(H, W, 3)
                timer.stop("fetch")
                break
            except NotImplementedError:
                raise
            except RuntimeError as e:  # device faults are opaque
                for ph in ("trace", "fetch"):
                    timer.discard(ph)  # drop the failed attempt's timer
                if attempt >= max_retries:
                    raise
                if progress:
                    print(json.dumps({"retry": attempt + 1,
                                      "chunk_offset": state.samples_done,
                                      "error": repr(e)[:200]}), flush=True)
        dt = time.time() - t0
        state.radiance_sum = state.radiance_sum + acc
        state.samples_done += todo
        if checkpoint_path:
            timer.start("checkpoint")
            save_state(state, checkpoint_path)
            timer.stop("checkpoint")
        if progress:
            print(json.dumps({"samples_done": state.samples_done,
                              "chunk_s": round(dt, 3),
                              "paths_per_s": round(W * H * todo / dt, 1),
                              "phases": timer.as_dict()}), flush=True)
    return state
