"""Elastic tile scheduler: concurrent per-device dispatch, retry and
quarantine — the counterpart of ``raytracingweekend_jl_tpu.parallel.elastic``.

The reference dies with its process on any fault (SURVEY.md §5 "Failure
detection: None"). Here the image is cut into independent pixel tiles and
one worker thread per entry of ``devices`` pulls tiles from a shared queue:
N healthy workers render N tiles at once (at most one tile in flight per
worker), a tile whose worker fails is queued again for whichever worker
takes it next, and a worker that fails ``DEVICE_FAILURE_LIMIT`` times in a
row is quarantined (it exits; the survivors drain its tiles). The render
completes while one worker stays healthy.

Fault streaks and quarantine are kept per worker slot, the index into
``devices``, not per device: ``devices`` may name one device twice (two
workers on one card, or ``["cpu"] * n``), and equal devices must not share a
streak. Tiles are keyed by their global id exactly as in
``parallel/shard.py`` (:func:`shard.tile_sum`), so the image is bit for bit
the same whichever worker renders which tile and however many retries
happen, and the training step's loss and scene are bit for bit
``sharded_train_step``'s at the same ``tile_size``, seed and route (the same
per-tile rows, reduced on the host in global tile order). Every retry and
quarantine is reported through ``progress`` and counted in ``stats``; a
tile that exhausts its retries on a healthy worker raises.

Contrast with ``parallel/shard.py``: that driver is one program per rank
with collectives, where one fault ends the step; this one trades some
dispatch overhead for fault isolation inside one process.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import torch

from ..camera import Camera
from ..ops.integrator import DEFAULT_MAX_DEPTH
from ..ops.intersect import DEFAULT_TMIN
from ..render import _resolve_device, image_height_for, pixel_coords
from ..scene import Scene, trim_scene
from .shard import (DEFAULT_TILE, _auto_grad_mode, grad_route,
                    reduce_tile_rows, tile_loss_grads, tile_sum)

#: Consecutive failures of one worker before it is quarantined.
DEVICE_FAILURE_LIMIT = 2


def _devices(devices) -> list:
    """The workers' devices: every CUDA device by default (raising without
    CUDA), else ``devices`` as given (``"cpu"`` entries for the CPU)."""
    if devices is None:
        _resolve_device(None)
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [_resolve_device(d) for d in devices]


def _run_tile(scene, cam, u, v, t_id, tile_size, n_pix, seed, n_samples,
              max_depth, tmin, f32_w, f32_h, device, worker):
    """Tile ``t_id``'s radiance sum ``[tile_size, 3]`` rendered on
    ``device`` by worker slot ``worker``, fetched to the host (the fetch
    surfaces a device fault here)."""
    with torch.no_grad():
        acc = tile_sum(scene.to(device), cam.to(device), u, v, t_id,
                       tile_size, n_pix, seed, n_samples, 0, max_depth, tmin,
                       f32_w, f32_h)
    return acc.cpu().numpy()


def _elastic_schedule(devices, n_tiles: int, run_tile, on_result,
                      max_retries: int, emit, stats: dict | None = None
                      ) -> None:
    """The scheduler shared by the render and the training step.

    One worker thread per entry of ``devices`` pulls tile ids from a shared
    queue; ``run_tile(t_id, slot)`` does the work on ``devices[slot]``
    (raising on a fault) and ``on_result(t_id, result)`` commits it
    (tile-indexed sinks need no lock). A failure queues the tile again for
    any healthy worker; ``DEVICE_FAILURE_LIMIT`` consecutive failures
    quarantine the worker slot. Raises the error when a tile exhausts
    ``max_retries`` on a healthy worker, or ``RuntimeError`` when no
    healthy worker remains. ``stats`` (a dict) gets ``retries`` and
    ``quarantined`` (the slots)."""
    queue = list(range(n_tiles))
    attempts: dict[int, int] = {}
    fail_streak = [0] * len(devices)
    quarantined: list[int] = []
    fatal: list[BaseException] = []
    retries = 0
    in_progress = 0
    cond = threading.Condition()

    def worker(slot: int) -> None:
        nonlocal in_progress, retries
        while True:
            with cond:
                while not queue and in_progress > 0 and not fatal:
                    cond.wait(0.05)
                if fatal or not queue:
                    return  # done, or another worker hit a fatal error
                t_id = queue.pop(0)
                in_progress += 1
            t0 = time.time()
            try:
                result = run_tile(t_id, slot)
            except Exception as e:  # noqa: BLE001 — device faults are opaque
                with cond:
                    in_progress -= 1
                    attempts[t_id] = attempts.get(t_id, 0) + 1
                    fail_streak[slot] += 1
                    out = fail_streak[slot] >= DEVICE_FAILURE_LIMIT
                    if not out and attempts[t_id] > max_retries:
                        fatal.append(e)  # retries exhausted, healthy worker
                    else:
                        queue.append(t_id)  # again, for any healthy worker
                        retries += 1
                        emit({"tile": t_id, "retry": attempts[t_id],
                              "worker": slot, "error": repr(e)[:120]})
                    if out:
                        quarantined.append(slot)
                    cond.notify_all()
                if out:
                    emit({"quarantined": slot,
                          "device": str(devices[slot])})
                    return
                if fatal:
                    return
                continue
            on_result(t_id, result)
            with cond:
                in_progress -= 1
                fail_streak[slot] = 0
                cond.notify_all()
            emit({"tile": t_id, "worker": slot,
                  "device": str(devices[slot]),
                  "s": round(time.time() - t0, 3)})

    threads = [threading.Thread(target=worker, args=(s,), daemon=True,
                                name=f"rtw-elastic-{s}")
               for s in range(len(devices))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if stats is not None:
        stats["retries"] = stats.get("retries", 0) + retries
        stats["quarantined"] = stats.get("quarantined", []) + quarantined
    if fatal:
        raise fatal[0]
    if queue:
        raise RuntimeError("no healthy workers left for the elastic run "
                           f"(quarantined slots {quarantined})")


def _emitter(progress: bool):
    def emit(rec: dict) -> None:
        if progress:
            print(json.dumps(rec), flush=True)
    return emit


def render_radiance_elastic(scene: Scene, cam: Camera, image_width: int = 400,
                            n_samples: int = 1, *,
                            image_height: int | None = None,
                            tile_size: int = DEFAULT_TILE, seed: int = 0,
                            max_depth: int = DEFAULT_MAX_DEPTH,
                            tmin: float = DEFAULT_TMIN, devices=None,
                            max_retries: int = 2, progress: bool = False,
                            stats: dict | None = None) -> torch.Tensor:
    """Fault-isolated mean radiance ``[H, W, 3]`` (on the CPU, in the
    camera's float type), its tiles fanned out over one worker per entry
    of ``devices`` (default: every CUDA device). Each tile renders through
    ``trace`` (K1 on a card), keyed by its global id. A tile is retried up
    to ``max_retries`` times; a worker that fails ``DEVICE_FAILURE_LIMIT``
    times in a row is dropped. Raises when no worker stays healthy or a
    tile exhausts its retries on a healthy one. ``stats`` gets the retry
    and quarantine counts."""
    devices = _devices(devices)
    scene = trim_scene(scene)
    H = image_height if image_height is not None else image_height_for(
        image_width)
    W = image_width
    n_pix = W * H
    u, v = pixel_coords(W, H, dtype=cam.origin.dtype)
    n_tiles = -(-n_pix // tile_size)
    out = np.zeros((n_tiles * tile_size, 3), np.float64)

    def run_tile(t_id, slot):
        return _run_tile(scene, cam, u, v, t_id, tile_size, n_pix, seed,
                         n_samples, max_depth, tmin, float(W), float(H),
                         devices[slot], slot)

    def on_result(t_id, acc):
        out[t_id * tile_size:(t_id + 1) * tile_size] = acc  # disjoint

    _elastic_schedule(devices, n_tiles, run_tile, on_result, max_retries,
                      _emitter(progress), stats)
    return torch.as_tensor((out[:n_pix] / n_samples).reshape(H, W, 3),
                           dtype=cam.origin.dtype)


def _run_tile_grad(scene, cam, u, v, t_id, target, tile_size, n_pix, seed,
                   n_samples, max_depth, tmin, f32_w, f32_h, device, worker,
                   grad_kwargs):
    """Tile ``t_id``'s row (SSE, then the flattened scene gradients; see
    ``shard.tile_loss_grads``) on ``device`` by worker slot ``worker``,
    fetched to the host. ``grad_kwargs``: the route flags; by default the
    fixed-depth kernel pair in float32 and the recorded wavefront in
    float64 (``shard._auto_grad_mode`` at this tile size)."""
    if grad_kwargs is None:
        grad_kwargs = grad_route(_auto_grad_mode(cam.origin.dtype,
                                                 tile_size))
    row = tile_loss_grads(scene.to(device), cam.to(device), u, v, t_id,
                          target, tile_size, n_pix, seed, n_samples, 0,
                          n_samples, max_depth, tmin, f32_w, f32_h,
                          **grad_kwargs)
    return row.cpu()


def elastic_train_step(scene: Scene, cam: Camera, target, image_width: int,
                       n_samples: int, *, lr: float = 0.01,
                       tile_size: int = DEFAULT_TILE, seed: int = 0,
                       max_depth: int = DEFAULT_MAX_DEPTH,
                       tmin: float = DEFAULT_TMIN, devices=None,
                       max_retries: int = 2,
                       grad_kwargs: dict | None = None,
                       progress: bool = False, stats: dict | None = None
                       ) -> tuple[torch.Tensor, Scene]:
    """Fault-isolated inverse-rendering SGD step: ``(loss, updated scene)``
    as ``sharded_train_step`` returns them (the scene trimmed, on its own
    device).

    The image loss decomposes over pixel tiles (``mean((img - target)^2) =
    sum_tiles SSE_tile / (3 * n_pix)``), so each tile's row (SSE and scene
    gradients) is an independent work item on the elastic scheduler. The
    rows land in tile-indexed slots and are reduced in global tile order on
    the host, so the loss and the scene are bit for bit the same whichever
    worker took which tile, and ``sharded_train_step``'s at the same
    ``tile_size``, seed and route."""
    devices = _devices(devices)
    scene = trim_scene(scene)
    target = torch.as_tensor(target)
    H = target.shape[0] if target.ndim == 3 else image_height_for(image_width)
    W = image_width
    n_pix = W * H
    target = target.cpu().reshape(n_pix, 3)
    u, v = pixel_coords(W, H, dtype=cam.origin.dtype)
    n_tiles = -(-n_pix // tile_size)
    rows: list = [None] * n_tiles

    def run_tile(t_id, slot):
        return _run_tile_grad(scene, cam, u, v, t_id, target, tile_size,
                              n_pix, seed, n_samples, max_depth, tmin,
                              float(W), float(H), devices[slot], slot,
                              grad_kwargs)

    def on_result(t_id, row):
        rows[t_id] = row  # tile-indexed slots

    _elastic_schedule(devices, n_tiles, run_tile, on_result, max_retries,
                      _emitter(progress), stats)
    return reduce_tile_rows(rows, scene, n_pix, lr)
