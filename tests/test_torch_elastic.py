"""The port's elastic tile scheduler (``parallel/elastic.py``) on the CPU,
the counterparts of ``tests/test_elastic.py``: faults injected through a
monkeypatched ``_run_tile`` keyed by worker slot (``devices=["cpu"] * n``
names one device several times), quarantine, a transient retry, every
worker dead, a tile out of retries, the scheduler's concurrency, and the
training step bit for bit across placements and faults."""

import threading
import time

import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch.parallel import elastic, shard
from raytracingweekend_jl_tpu_torch.parallel.mesh import make_render_mesh
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

W, TILE = 48, 256  # 48 x 27 pixels: 6 tiles of 256
WS = 32  # the training steps' film: 32 x 18 pixels, 3 tiles of 256
FIELDS = ("center", "radius", "albedo", "fuzz", "ir")


def _render(n_workers=2, tile_size=TILE, **kw):
    return elastic.render_radiance_elastic(
        pt.scene_2_spheres(), pt.t_default_cam(), W, 2, tile_size=tile_size,
        seed=4, devices=["cpu"] * n_workers, **kw)


def test_elastic_clean_run_matches_plain_and_sharded():
    # Tile-keyed streams: statistically the single-chunk render, and bit for
    # bit the sharded render of the same route (trace) and tile size.
    img = _render()
    ref = pt.render_radiance(pt.scene_2_spheres(), pt.t_default_cam(), W, 2,
                             seed=4, device="cpu")
    assert img.shape == ref.shape == (27, W, 3)
    assert abs(float(img.mean()) - float(ref.mean())) < 0.02
    sharded = shard.render_radiance_sharded(
        pt.scene_2_spheres(), pt.t_default_cam(), W, 2,
        mesh=make_render_mesh(device="cpu"), tile_size=TILE, seed=4)
    assert torch.equal(img, sharded)


def test_elastic_survives_persistent_worker_fault(monkeypatch):
    # Worker slot 1 of two on the same device always fails: it is
    # quarantined after DEVICE_FAILURE_LIMIT faults (keyed by slot, not by
    # the equal devices) and its tiles drain through slot 0; the image is
    # the clean run's bit for bit.
    clean = _render(tile_size=64)
    real = elastic._run_tile
    faults = []

    def flaky(*args):
        if args[-1] == 1:  # the worker slot is the last argument
            faults.append(args[4])
            raise RuntimeError("injected device fault")
        return real(*args)

    monkeypatch.setattr(elastic, "_run_tile", flaky)
    stats = {}
    img = _render(tile_size=64, stats=stats)
    assert len(faults) >= elastic.DEVICE_FAILURE_LIMIT
    assert stats["quarantined"] == [1]
    assert stats["retries"] == len(faults)
    assert torch.equal(img, clean)


def test_elastic_transient_fault_is_retried(monkeypatch, capsys):
    clean = _render()
    real = elastic._run_tile
    state = {"failed": False}

    def once_flaky(*args):
        if not state["failed"]:
            state["failed"] = True
            raise RuntimeError("transient fault")
        return real(*args)

    monkeypatch.setattr(elastic, "_run_tile", once_flaky)
    stats = {}
    img = _render(stats=stats, progress=True)
    assert torch.equal(img, clean)
    assert stats == {"retries": 1, "quarantined": []}
    assert '"retry": 1' in capsys.readouterr().out  # reported, not hidden


def test_elastic_workers_run_concurrently_same_bits(monkeypatch):
    # One worker against four: the same image bit for bit; and the
    # scheduler itself runs tiles concurrently (a sleeping tile stands in
    # for device work).
    assert torch.equal(_render(1), _render(4))

    def sleepy(*args):
        time.sleep(0.15)
        return np.zeros((args[5], 3))

    monkeypatch.setattr(elastic, "_run_tile", sleepy)
    t0 = time.time()
    _render(1)  # 6 tiles one after another: ~0.9 s
    wall1 = time.time() - t0
    t0 = time.time()
    _render(4)  # two waves: ~0.3 s
    wall4 = time.time() - t0
    assert wall4 < wall1 / 1.8, (wall1, wall4)


def test_elastic_all_workers_dead_raises(monkeypatch):
    def always_fail(*args):
        raise RuntimeError("injected")

    monkeypatch.setattr(elastic, "_run_tile", always_fail)
    stats = {}
    with pytest.raises(RuntimeError, match="no healthy workers"):
        _render(max_retries=1, stats=stats)
    assert sorted(stats["quarantined"]) == [0, 1]


def test_elastic_tile_out_of_retries_raises(monkeypatch):
    # One worker, one tile that always fails: between its two failures the
    # worker succeeds on the other tiles (so it stays healthy), and the
    # second failure exceeds max_retries=1 and raises the tile's own error.
    real = elastic._run_tile

    def bad_tile(*args):
        if args[4] == 0:
            raise RuntimeError("tile 0 is bad")
        return real(*args)

    monkeypatch.setattr(elastic, "_run_tile", bad_tile)
    with pytest.raises(RuntimeError, match="tile 0 is bad"):
        _render(n_workers=1, tile_size=64, max_retries=1)


def test_elastic_workers_are_threads_one_per_slot(monkeypatch):
    # One thread per entry of devices, named by slot, each passing its slot.
    seen = set()
    lock = threading.Lock()

    def record(*args):
        with lock:
            seen.add((threading.current_thread().name, args[-1],
                      str(args[-2])))
        time.sleep(0.05)
        return np.zeros((args[5], 3))

    monkeypatch.setattr(elastic, "_run_tile", record)
    _render(3)
    assert {s for _, s, _ in seen} <= {0, 1, 2} and len(seen) >= 2
    assert all(name == f"rtw-elastic-{s}" and dev == "cpu"
               for name, s, dev in seen)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            elastic.render_radiance_elastic(pt.scene_2_spheres(),
                                            pt.t_default_cam(), W, 1)


def _train_setup():
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    target = pt.render_radiance(scene, cam, WS, 2, seed=4, device="cpu")
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.6, 0, 1))
    return bad, cam, target


def _step(scene, cam, target, n_workers=2, tile_size=TILE, lr=0.5, **kw):
    return elastic.elastic_train_step(scene, cam, target, WS, 2, lr=lr,
                                      tile_size=tile_size, seed=4,
                                      devices=["cpu"] * n_workers, **kw)


def test_elastic_step_descends():
    bad, cam, target = _train_setup()
    losses, s = [], bad
    for _ in range(3):
        loss, s = _step(s, cam, target, lr=0.9)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_elastic_step_bitwise_across_worker_counts():
    bad, cam, target = _train_setup()
    l1, s1 = _step(bad, cam, target, n_workers=1)
    l4, s4 = _step(bad, cam, target, n_workers=4)
    assert torch.equal(l1, l4)
    for f in FIELDS:
        assert torch.equal(getattr(s1, f), getattr(s4, f)), f


def test_elastic_step_survives_worker_fault(monkeypatch):
    bad, cam, target = _train_setup()
    l_clean, s_clean = _step(bad, cam, target, tile_size=128)
    real = elastic._run_tile_grad
    faults = []

    def flaky(*args):
        if args[-2] == 1:  # the worker slot is second to last
            faults.append(args[4])
            raise RuntimeError("injected device fault")
        return real(*args)

    monkeypatch.setattr(elastic, "_run_tile_grad", flaky)
    stats = {}
    l_f, s_f = _step(bad, cam, target, tile_size=128, stats=stats)
    assert len(faults) >= elastic.DEVICE_FAILURE_LIMIT
    assert stats["quarantined"] == [1]
    assert torch.equal(l_clean, l_f)
    for f in FIELDS:
        assert torch.equal(getattr(s_clean, f), getattr(s_f, f)), f


def test_elastic_step_float64_takes_the_recorded_wavefront(
        monkeypatch):
    # The default per-tile route: the fixed-depth pair in float32, the
    # recorded wavefront (recorded=True alone) in float64.
    routes = []
    real = shard.tile_loss_grads

    def logged(*args, **kw):
        routes.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(elastic, "tile_loss_grads", logged)
    for dtype in (torch.float32, torch.float64):
        scene = pt.scene_2_spheres(dtype=dtype)
        cam = pt.t_default_cam(dtype=dtype)
        target = pt.render_radiance(scene, cam, 32, 1, seed=1, device="cpu")
        loss, new = elastic.elastic_train_step(
            scene._replace(albedo=scene.albedo * 0.8), cam, target, 32, 1,
            lr=0.5, tile_size=TILE, seed=1, devices=["cpu"])
        assert loss.dtype == dtype and new.albedo.dtype == dtype
        assert np.isfinite(float(loss))
    assert routes[0]["recorded_fused"] and routes[-1] == dict(
        recorded=True, recorded_fused=False, recorded_persist=None)
