"""Checkpoint and resume for long renders, on one device or sharded over a
mesh of ranks.

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

The sharded driver (:func:`render_checkpointed_sharded`) keeps, on each
rank, only its tile shard's strip of the sum (:class:`StripState`), in a
file of its own (rank 0 the given path, rank ``r`` a ``.pNNNNN`` suffix).
It records and checks the same settings, plus ``tile_size`` and the strip's
range; the ranks agree on ``samples_done`` before they resume and wait for
each other after every save.
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

#: The same for the sharded driver (which has no ``compact``).
STRIP_RESUME_KEYS = ("spp_chunk", "tile_size", "max_depth", "tmin",
                     "persistent", "rays_per_pass", "scene_digest")

#: How :func:`load_state` and :func:`load_strip_state` read the settings.
_SETTING_CASTS = {"spp_chunk": int, "tile_size": int, "max_depth": int,
                  "tmin": float, "persistent": bool, "compact": bool,
                  "rays_per_pass": int, "scene_digest": str, "rng": str}


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


def save_state(state, path: str) -> None:
    """Write ``state`` (a :class:`RenderState` or :class:`StripState`) to
    ``path`` atomically: a temporary file, flushed to disk, then renamed
    over ``path``. ``None`` settings are left out."""
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
    with np.load(path) as z:
        return RenderState(radiance_sum=z["radiance_sum"],
                           samples_done=int(z["samples_done"]),
                           image_width=int(z["image_width"]),
                           image_height=int(z["image_height"]),
                           seed=int(z["seed"]), **_settings(z, RenderState))


def _settings(z, cls) -> dict:
    """The settings of ``cls`` that the open ``.npz`` ``z`` holds."""
    names = {f.name for f in fields(cls)}
    return {k: cast(z[k][()]) for k, cast in _SETTING_CASTS.items()
            if k in z.files and k in names}


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


def _check_resume(state, want, n_samples: int,
                  keys: tuple = RESUME_KEYS) -> None:
    """Raise ``ValueError`` unless ``state`` can be continued as ``want``
    to ``n_samples`` samples: the film, the seed, ``rng`` and ``keys``
    must match."""
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
    for key in keys:
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


def _render_chunks(state, sum_field: str, n_samples: int, spp_chunk: int,
                   render_chunk, save, max_retries: int,
                   timer: PhaseTimer | None, progress: bool,
                   progress_fields) -> None:
    """The chunk loop of both checkpointed drivers, on ``state`` in place.

    While ``state`` holds fewer than ``n_samples`` samples: render the next
    ``todo <= spp_chunk`` (``render_chunk(done, todo)``, their radiance
    sums on the device), fetch them to the host (the ``fetch`` phase is the
    sync), add them in float64 to ``state.<sum_field>``, count them and
    ``save(state)`` (``save=None``: no checkpoint). A chunk that raises a
    ``RuntimeError`` (a device fault) is retried up to ``max_retries``
    times, then the error is raised; a refused route
    (``NotImplementedError``) raises at once. ``timer`` accumulates the
    ``trace``, ``fetch`` and ``checkpoint`` phases; ``progress`` prints one
    JSON line per chunk (and per retry), with ``progress_fields(todo,
    seconds)``."""
    if timer is None:
        timer = PhaseTimer()
    while state.samples_done < n_samples:
        done = state.samples_done
        todo = min(spp_chunk, n_samples - done)
        t0 = time.time()
        for attempt in range(max_retries + 1):
            try:
                timer.start("trace")
                with torch.no_grad():
                    acc = render_chunk(done, todo)
                timer.stop("trace")
                timer.start("fetch")  # the copy to the host is the sync
                acc = acc.cpu().numpy().astype(np.float64)
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
                                      "chunk_offset": done,
                                      "error": repr(e)[:200]}), flush=True)
        dt = time.time() - t0
        setattr(state, sum_field, getattr(state, sum_field) + acc)
        state.samples_done = done + todo
        if save is not None:
            timer.start("checkpoint")
            save(state)
            timer.stop("checkpoint")
        if progress:
            print(json.dumps({"samples_done": state.samples_done,
                              "chunk_s": round(dt, 3),
                              **progress_fields(todo, dt),
                              "phases": timer.as_dict()}), flush=True)


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

    A float64 camera or scene renders in float64 on either route
    (``persistent=True`` through the plain pixel-pinned body, as in
    :func:`render.render_tile_sum`)."""
    if spp_chunk <= 0:
        raise ValueError(f"spp_chunk={spp_chunk} must be positive")
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

    def render_chunk(done, todo):
        spp_pass = pick_samples_per_pass(W * H, todo, rays_per_pass)
        return render_tile_sum(
            scene, cam, W * H, seed, todo, done, max_depth, tmin, f32_w,
            f32_h, persistent, samples_per_pass=spp_pass,
            compact=compact).reshape(H, W, 3)

    def save(st):
        save_state(st, checkpoint_path)

    _render_chunks(state, "radiance_sum", n_samples, spp_chunk, render_chunk,
                   save if checkpoint_path else None, max_retries, timer,
                   progress, lambda todo, dt: {
                       "paths_per_s": round(W * H * todo / dt, 1)})
    return state


@dataclass
class StripState:
    """One rank's progress in a sharded checkpointed render: its pixel
    strip ``[start, stop)`` of the radiance sum, the count, and the
    settings it was rendered with (``None`` where the file does not say: a
    JAX-written one). A mesh of one holds the whole image."""

    strip_sum: np.ndarray  # [stop - start, 3] float64 accumulation on host
    start: int             # first global pixel of the strip
    stop: int              # one past its last
    samples_done: int
    image_width: int
    image_height: int
    seed: int
    spp_chunk: int | None = None
    tile_size: int | None = None
    max_depth: int | None = None
    tmin: float | None = None
    persistent: bool | None = None
    rays_per_pass: int | None = None
    scene_digest: str | None = None
    rng: str | None = None

    @property
    def strip_image(self) -> np.ndarray:
        """This rank's strip of the current mean-radiance estimate."""
        return self.strip_sum / max(self.samples_done, 1)

    @property
    def image(self) -> np.ndarray:
        """The whole ``[H, W, 3]`` mean radiance, when this rank holds the
        whole image (a mesh of one tile shard)."""
        n_pix = self.image_height * self.image_width
        if (self.start, self.stop) != (0, n_pix):
            raise ValueError(
                f"this rank holds pixels [{self.start}, {self.stop}) of "
                f"{n_pix}; assemble the ranks' strips instead (see "
                "parallel.multihost.write_host_strip/assemble_strips)")
        return self.strip_image.reshape(self.image_height, self.image_width,
                                        3)


def _strip_ckpt_path(path: str) -> str:
    """This rank's checkpoint file: rank 0 keeps ``path`` (a single rank
    writes one file), rank ``r`` appends ``.pNNNNN``."""
    import torch.distributed as dist
    idx = dist.get_rank() if dist.is_initialized() else 0
    return path if idx == 0 else f"{path}.p{idx:05d}"


def save_strip_state(state: StripState, path: str) -> None:
    """Write ``state`` to ``path`` atomically (:func:`save_state`)."""
    save_state(state, path)


def load_strip_state(path: str) -> StripState:
    """Read a state written by :func:`save_strip_state` or by the JAX
    package's (whose files lack most settings: they load as ``None``, and
    its ``spp_chunk``/``tile_size`` of 0 as ``None``)."""
    with np.load(path) as z:
        opt = _settings(z, StripState)
        for k in ("spp_chunk", "tile_size"):
            if opt.get(k) == 0:
                opt[k] = None
        return StripState(strip_sum=z["strip_sum"], start=int(z["start"]),
                          stop=int(z["stop"]),
                          samples_done=int(z["samples_done"]),
                          image_width=int(z["image_width"]),
                          image_height=int(z["image_height"]),
                          seed=int(z["seed"]), **opt)


def render_checkpointed_sharded(scene: Scene, cam: Camera, image_width: int,
                                n_samples: int, *, mesh,
                                image_height: int | None = None,
                                seed: int = 0, spp_chunk: int = 50,
                                checkpoint_path: str | None = None,
                                tile_size: int | None = None,
                                max_depth: int = 16, tmin: float = 1e-4,
                                persistent: bool = True,
                                rays_per_pass: int | None = None,
                                progress: bool = False, max_retries: int = 2,
                                timer: PhaseTimer | None = None,
                                impl: str | None = None) -> StripState:
    """Checkpoint and resume composed with the mesh-sharded render.

    Renders ``n_samples`` in chunks of ``spp_chunk`` through
    ``parallel.shard.render_strip_sharded`` over ``mesh`` (on
    ``mesh.device``), each rank accumulating its tile shard's strip of the
    radiance sum on the host in float64 and writing its own file
    (:func:`_strip_ckpt_path`) after every chunk, then waiting for every
    rank. Chunk ``c`` renders global samples ``[c * spp_chunk, ...)``, so
    an interrupted and resumed render is the uninterrupted chunked one bit
    for bit. ``spp_chunk`` and ``n_samples`` must be multiples of the
    ``samples`` axis.

    A resume must match the film, the seed, ``rng``, ``spp_chunk``,
    ``tile_size``, ``max_depth``, ``tmin``, ``persistent``,
    ``rays_per_pass``, the scene's and camera's digest and the strip's
    range, and may not hold more samples than asked; the ranks' files must
    agree on ``samples_done`` (checked by an all-gather before the first
    chunk). A failed chunk is retried ``max_retries`` times on a mesh of
    one rank; on a larger mesh it raises at once, since a retry on one rank
    alone would leave the others in a different collective.
    ``persistent`` defaults to True, as in :func:`render_checkpointed`."""
    from ..parallel.mesh import SAMPLES_AXIS
    from ..parallel.shard import (DEFAULT_TILE, render_strip_sharded,
                                  shard_rows)

    if spp_chunk <= 0:
        raise ValueError(f"spp_chunk={spp_chunk} must be positive")
    H = (image_height if image_height is not None
         else image_height_for(image_width))
    W = image_width
    tile_size = DEFAULT_TILE if tile_size is None else tile_size
    n_sample_shards = mesh.shape[SAMPLES_AXIS]
    if spp_chunk % n_sample_shards or n_samples % n_sample_shards:
        raise ValueError(
            f"spp_chunk={spp_chunk} and n_samples={n_samples} must both be "
            f"multiples of the mesh sample axis ({n_sample_shards})")
    scene = trim_scene(scene.to(mesh.device))
    cam = cam.to(mesh.device)
    start, stop = shard_rows(mesh.shape, mesh.tile_index, W, H, tile_size)
    fresh = StripState(np.zeros((stop - start, 3)), start, stop, 0, W, H,
                       seed, spp_chunk=spp_chunk, tile_size=tile_size,
                       max_depth=max_depth, tmin=float(tmin),
                       persistent=bool(persistent),
                       rays_per_pass=rays_per_pass,
                       scene_digest=scene_digest(scene, cam), rng=RNG)
    ckpt = _strip_ckpt_path(checkpoint_path) if checkpoint_path else None
    if ckpt and os.path.exists(ckpt):
        state = load_strip_state(ckpt)
        _check_resume(state, fresh, n_samples, STRIP_RESUME_KEYS)
        if (state.start, state.stop) != (start, stop):
            raise ValueError(
                f"checkpoint does not match render configuration: it holds "
                f"pixels [{state.start}, {state.stop}), this rank renders "
                f"[{start}, {stop}) (keep the mesh and tile_size)")
    else:
        state = fresh
    # A job stopped between two ranks' saves, or a lost file, leaves the
    # counts apart; rendering on would offset the ranks' samples and hang in
    # a collective, so stop here with the counts.
    done_all = [int(x) for x in mesh.gather(torch.tensor(
        [state.samples_done], dtype=torch.int64, device=mesh.device))]
    if len(set(done_all)) > 1:
        raise ValueError(
            f"the ranks' checkpoints disagree on samples_done: {done_all} "
            "(delete the ahead ranks' files down to the least count and "
            "resume)")

    def render_chunk(done, todo):
        return render_strip_sharded(
            scene, cam, W, todo, mesh=mesh, image_height=H,
            tile_size=tile_size, max_depth=max_depth, tmin=tmin, seed=seed,
            persistent=persistent, rays_per_pass=rays_per_pass,
            sample_offset=done, impl=impl)[2]

    def save(st):
        save_strip_state(st, ckpt)
        mesh.barrier()

    # A retry on one rank alone would leave the others in another collective.
    retries = max_retries if mesh.size == 1 else 0
    _render_chunks(state, "strip_sum", n_samples, spp_chunk, render_chunk,
                   save if ckpt else None, retries, timer, progress,
                   lambda todo, dt: {
                       "strip": [state.start, state.stop], "rank": mesh.rank})
    return state
