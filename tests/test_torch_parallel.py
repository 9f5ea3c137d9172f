"""The port's mesh-sharded render and training step
(``raytracingweekend_jl_tpu_torch.parallel``) on the CPU, the counterparts
of ``tests/test_parallel.py``: every rank's body run in one process (the
image and the step bit for bit across tiles-axis sizes), the ``samples``
reduction, the mesh and the multihost helpers in a single process, the
per-tile routes, a padded layout, and the JAX package's
``render_radiance_sharded`` and ``sharded_train_step`` on its 8-device
virtual CPU mesh (``tests/conftest.py``). The real two-process run is
``tests/test_torch_multiprocess.py``."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.parallel.mesh import make_render_mesh as jmesh
from raytracingweekend_jl_tpu.parallel.shard import (
    render_radiance_sharded as jsharded, sharded_train_step as jstep)
from raytracingweekend_jl_tpu_torch.parallel import elastic, multihost
from raytracingweekend_jl_tpu_torch.parallel import shard
from raytracingweekend_jl_tpu_torch.parallel.mesh import (
    SAMPLES_AXIS, TILES_AXIS, make_render_mesh)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

# The module (the package exports a function of the same name).
prender = importlib.import_module("raytracingweekend_jl_tpu_torch.render")

W, H, TILE = 64, 36, 256
FIELDS = ("center", "radius", "albedo", "fuzz", "ir")


@pytest.fixture
def mesh1():
    return make_render_mesh(1, 1, device="cpu")


def _bodies(scene, cam, n_tiles, n_samples, spp, h=H, **kw):
    """The image [h, W, 3] (sums) from every rank's body of an ``n_tiles x
    n_samples`` mesh, run in this process, each tile shard's sample shards
    added in shard order as render_strip_sharded adds them."""
    shape = {TILES_AXIS: n_tiles, SAMPLES_AXIS: n_samples}
    scene = pt.trim_scene(scene)
    strips = [shard.ordered_sum([shard.shard_radiance_sums(
        scene, cam, W, h, spp, mesh_shape=shape, tile_index=t,
        sample_index=s, tile_size=TILE, **kw) for s in range(n_samples)])
        for t in range(n_tiles)]
    return torch.cat(strips)[:W * h].reshape(h, W, 3)


@pytest.mark.parametrize("persistent", [False, True])
def test_sharded_image_bitwise_across_tile_axis_sizes(persistent, mesh1):
    # Same tile size: the image of 1, 2, 4 and 8 tile shards is the mesh of
    # one's bit for bit (each tile keyed by its global id).
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    kw = dict(seed=11, persistent=persistent)
    ref = shard.render_radiance_sharded(scene, cam, W, 2, mesh=mesh1,
                                        tile_size=TILE, reduce_mean=False,
                                        **kw)
    assert ref.shape == (H, W, 3) and torch.isfinite(ref).all()
    for n in (1, 2, 4, 8):
        assert torch.equal(_bodies(scene, cam, n, 1, 2, **kw), ref), n


def test_sample_axis_matches_tiles_only():
    # (4 tiles x 2 samples) against (8 tiles x 1 sample): the sample shards
    # render the same global samples, summed in another order.
    scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
    a = _bodies(scene, cam, 8, 1, 4, seed=5)
    b = _bodies(scene, cam, 4, 2, 4, seed=5)
    np.testing.assert_allclose(b.numpy() / 4, a.numpy() / 4, atol=1e-5)
    assert not torch.equal(_bodies(scene, cam, 4, 2, 4, seed=6), b)


def test_sharded_spp_indivisible_raises(mesh1):
    with pytest.raises(ValueError, match="divide evenly"):
        shard.shard_radiance_sums(
            pt.scene_2_spheres(), pt.t_default_cam(), W, H, 3,
            mesh_shape={TILES_AXIS: 4, SAMPLES_AXIS: 2}, tile_index=0,
            sample_index=0, tile_size=TILE)
    with pytest.raises(ValueError, match="divide evenly"):
        shard._local_spp(3, 2)


def test_mesh_validation():
    # A mesh of one needs no process group; anything larger raises without
    # one, naming the mesh and the ranks.
    m = make_render_mesh(device="cpu")
    assert m.shape == {"tiles": 1, "samples": 1} and m.size == 1
    assert (m.rank, m.tile_index, m.sample_index) == (0, 0, 0)
    assert m.device == torch.device("cpu") and not m.distributed
    x = torch.arange(3.0)
    assert m.gather(x)[0] is x and m.gather(x, SAMPLES_AXIS)[0] is x
    m.barrier()
    with pytest.raises(ValueError, match=r"mesh 3x2 != 1 ranks"):
        make_render_mesh(n_tiles=3, n_samples=2, device="cpu")
    with pytest.raises(ValueError, match="no process group"):
        make_render_mesh(n_tiles=2, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_render_mesh(n_tiles=1, n_samples=0, device="cpu")
    with pytest.raises(ValueError, match="axis"):
        m.gather(x, "pixels")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_render_mesh()


def test_multihost_helpers_single_process(tmp_path, monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False  # a single process: a no-op
    hint = multihost.cluster_env_hint
    assert not hint({})
    assert not hint({"WORLD_SIZE": "1", "RANK": "0",
                     "MASTER_ADDR": "localhost"})  # single-rank torchrun
    assert hint({"WORLD_SIZE": "2", "RANK": "1"})
    assert hint({"SLURM_NTASKS": "4", "SLURM_PROCID": "0"})
    assert hint({"OMPI_COMM_WORLD_SIZE": "3", "OMPI_COMM_WORLD_RANK": "2"})
    assert not hint({"SLURM_NTASKS": "x"})
    mesh = multihost.make_multihost_mesh(1, device="cpu")
    assert mesh.shape == {"tiles": 1, "samples": 1}
    with pytest.raises(ValueError, match="not divisible"):
        multihost.make_multihost_mesh(n_samples_axis=3, device="cpu")
    assert multihost.host_local_rows(H, W, TILE) == (0, H * W)
    assert multihost.strip_path(str(tmp_path)).endswith("strip_00000.npz")
    img = torch.rand((H, W, 3))
    start, stop, data = multihost.local_strip(img, H, W, TILE)
    assert (start, stop) == (0, H * W) and np.array_equal(
        data, img.numpy().reshape(-1, 3))
    d = str(tmp_path / "strips")
    assert multihost.write_host_strip(img, H, W, TILE, d) == (0, H * W)
    assert np.array_equal(multihost.assemble_strips(d), img.numpy())
    # Two strips that leave a gap, that overlap, or fall short all raise.
    flat = img.numpy().reshape(-1, 3)
    for parts, msg in (([(0, 1000), (1200, H * W)], "gap"),
                       ([(0, 1300), (1200, H * W)], "overlap"),
                       ([(0, 1000), (1000, 2000)], "cover")):
        bad = tmp_path / msg
        bad.mkdir()
        for r, (a, b) in enumerate(parts):
            np.savez(multihost.strip_path(str(bad), r), start=a, stop=b,
                     strip=flat[a:b], image_height=H, image_width=W)
        with pytest.raises(ValueError, match=msg):
            multihost.assemble_strips(str(bad))
    with pytest.raises(FileNotFoundError):
        multihost.assemble_strips(str(tmp_path))


def test_persistent_tiles_take_the_strided_route(monkeypatch, mesh1):
    # A persistent float32 tile has a pixel_start, so it runs the strided
    # integrator (K1 and K2 on a card) at that start, never the inline or
    # the pinned route.
    ref = pt.render_radiance(pt.scene_2_spheres(), pt.t_default_cam(), 48, 4,
                             seed=2, persistent=True, device="cpu")
    calls = []
    real = prender.persistent_render_sum_strided

    def logged(scene, cam, n_pix, *args, pixel_start=0, **kw):
        calls.append((n_pix, pixel_start))
        return real(scene, cam, n_pix, *args, pixel_start=pixel_start, **kw)

    def refused(*args, **kw):
        raise AssertionError("a sharded tile left the strided route")

    monkeypatch.setattr(prender, "persistent_render_sum_strided", logged)
    monkeypatch.setattr(prender, "render_inline_sum", refused)
    monkeypatch.setattr(prender, "persistent_render_sum_fused", refused)
    img = shard.render_radiance_sharded(pt.scene_2_spheres(),
                                        pt.t_default_cam(), 48, 4,
                                        mesh=mesh1, tile_size=TILE, seed=2,
                                        persistent=True)
    n_pix = 48 * 27
    assert calls == [(min(TILE, n_pix - t * TILE), t * TILE)
                     for t in range(-(-n_pix // TILE))]
    assert torch.isfinite(img).all()
    assert abs(float(img.mean()) - float(ref.mean())) < 0.02


def test_auto_grad_mode_decision_table():
    # Float32: the fixed-depth pair below 2^17 pixels, the persistent-record
    # pair from there, on every device; float64: the recorded wavefront.
    f32, f64 = torch.float32, torch.float64
    assert shard._auto_grad_mode(f32, 8192) == "fused"
    assert shard._auto_grad_mode(f32, (1 << 17) - 1) == "fused"
    assert shard._auto_grad_mode(f32, 1 << 17) == "persist"
    assert shard._auto_grad_mode(f32, 1 << 21) == "persist"
    assert shard._auto_grad_mode(f64, 8192) == "recorded"
    assert shard._auto_grad_mode(f64, 1 << 20) == "recorded"
    assert shard.grad_route("persist")["recorded_persist"] == (8, None)
    assert shard.grad_route("fused")["recorded_fused"] is True
    assert shard.grad_route("recorded") == dict(
        recorded=True, recorded_fused=False, recorded_persist=None)
    with pytest.raises(ValueError, match="grad_mode"):
        shard.grad_route("remat")


@pytest.mark.parametrize("h", [36, 35])
def test_padded_layout_with_whole_padding_tiles(h, monkeypatch, mesh1):
    # 64x36 in 256-pixel tiles over 4 tile shards: 9 real tiles padded to
    # 12, 3 wholly past the end (64x35 also cuts the last real tile short).
    # No tile renders a pixel past the film, no real pixel changes.
    u, v, total, pad = shard._padded_coords(W, h, TILE, 4)
    n_pix = W * h
    assert total == 12 and pad == 12 * TILE - n_pix and u.shape == (12 * TILE,)
    starts = [shard.shard_rows({TILES_AXIS: 4}, i, W, h, TILE)
              for i in range(4)]
    assert starts == [(0, 768), (768, 1536), (1536, min(2304, n_pix)),
                      (n_pix, n_pix)]
    calls = []
    real = shard.render_tile_sum

    def logged(scene, cam, n, *args, pixel_start=None, **kw):
        assert pixel_start + n <= n_pix
        calls.append(pixel_start)
        return real(scene, cam, n, *args, pixel_start=pixel_start, **kw)

    monkeypatch.setattr(shard, "render_tile_sum", logged)
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    img = _bodies(scene, cam, 4, 1, 2, h=h, seed=4, persistent=True)
    assert calls == [t * TILE for t in range(-(-n_pix // TILE))]
    ref = shard.render_radiance_sharded(scene, cam, W, 2, mesh=mesh1,
                                        image_height=h, tile_size=TILE,
                                        seed=4, persistent=True,
                                        reduce_mean=False)
    assert torch.equal(img, ref)
    empty = shard.shard_radiance_sums(
        pt.trim_scene(scene), cam, W, h, 2,
        mesh_shape={TILES_AXIS: 4, SAMPLES_AXIS: 1}, tile_index=3,
        sample_index=0, tile_size=TILE)
    assert empty.shape == (3 * TILE, 3) and not empty.any()


def _mirror():
    return (rtw.make_scene([rtw.metal((0, -100.0, 0), 99.0,
                                      (0.8, 0.6, 0.4), 0.0)]),
            rtw.default_camera((0, 2, 0), (1, 1, 0)))


DRAW_FREE = {  # name: (scene, camera, depth)
    "mirror": lambda: (*_mirror(), 16),
    "sky_only": lambda: (rtw.make_scene([]), rtw.t_default_cam(), 16),
    "depth_1": lambda: (rtw.scene_2_spheres(), rtw.t_default_cam(), 1),
}


@pytest.mark.parametrize("case", sorted(DRAW_FREE))
def test_matches_jax_sharded_on_draw_free_cases(case, mesh1):
    # At spp 1 (sample 0 centred, aperture 0) on a fuzz-0 mirror, the sky
    # and one bounce no draw reaches the image: the port's sharded render,
    # both routes, within 1e-6 of the JAX package's on 4 virtual devices.
    scene_j, cam_j, depth = DRAW_FREE[case]()
    jm = jmesh(n_tiles=4, devices=jax.devices()[:4])
    ref = np.asarray(jsharded(scene_j, cam_j, W, 1, mesh=jm, tile_size=TILE,
                              seed=3, max_depth=depth))
    for persistent in (False, True):
        out = shard.render_radiance_sharded(
            pt.scene_from_numpy(scene_j), pt.camera_from_numpy(cam_j), W, 1,
            mesh=mesh1, tile_size=TILE, seed=3, max_depth=depth,
            persistent=persistent).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-6)
    assert ref.mean() > 0


def test_matches_jax_sharded_statistically(mesh1):
    # Independent streams (threefry against the port's keyed streams) on
    # 4_spheres at spp 16: each channel's mean difference within 3 standard
    # errors of the per-pixel difference.
    jm = jmesh(n_tiles=4, devices=jax.devices()[:4])
    ref = np.asarray(jsharded(rtw.scene_4_spheres(), rtw.t_default_cam(), W,
                              16, mesh=jm, tile_size=TILE, seed=3))
    out = shard.render_radiance_sharded(pt.scene_4_spheres(),
                                        pt.t_default_cam(), W, 16,
                                        mesh=mesh1, tile_size=TILE,
                                        seed=3).numpy()
    d = (out - ref).reshape(-1, 3)
    se = d.std(0) / np.sqrt(d.shape[0])
    assert (np.abs(d.mean(0)) < 3 * se).all(), (d.mean(0), se)


def test_train_step_matches_jax_on_a_draw_free_scene(mesh1):
    # The fuzz-0 mirror at spp 1: the image and the gradients of center,
    # radius and albedo take no draw, so the port's step (the fixed-depth
    # pair's plain versions) and the JAX package's (the XLA recorded path)
    # agree: the loss within 2e-6 relative, the updated fields within 1e-6.
    # Fuzz's gradient follows the scatter draws and is not compared.
    scene_j, cam_j = _mirror()
    target = np.asarray(rtw.render_radiance(scene_j, cam_j, W, 1,
                                            image_height=H))
    bad = scene_j._replace(albedo=scene_j.albedo * 0.7,
                           center=scene_j.center + jnp.asarray([0, 0.01, 0]))
    jm = jmesh(n_tiles=4, devices=jax.devices()[:4])
    jl, js = jstep(bad, cam_j, jnp.asarray(target), W, 1, mesh=jm, lr=0.5,
                   tile_size=TILE, seed=3)
    pl, ps = shard.sharded_train_step(
        pt.scene_from_numpy(bad), pt.camera_from_numpy(cam_j),
        torch.tensor(target), W, 1, mesh=mesh1, lr=0.5, tile_size=TILE,
        seed=3)
    assert float(pl) == pytest.approx(float(jl), rel=2e-6)
    n = ps.n_spheres
    for f in ("center", "radius", "albedo", "ir"):
        want = np.asarray(getattr(js, f))[:n]
        np.testing.assert_allclose(getattr(ps, f).numpy(), want, atol=1e-6)
    moved = np.abs(ps.albedo.numpy() - np.asarray(bad.albedo)[:n]).max()
    assert moved > 1e-3  # the step did move the albedo


def _train_setup():
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    target = pt.render_radiance(scene, cam, W, 2, seed=3, device="cpu")
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.5, 0, 1))
    return bad, cam, target


def test_train_step_descends(mesh1):
    bad, cam, target = _train_setup()
    losses, s = [], bad
    for _ in range(3):
        loss, s = shard.sharded_train_step(s, cam, target, W, 2, mesh=mesh1,
                                           lr=2.0, tile_size=TILE, seed=3)
        losses.append(float(loss))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_train_step_bitwise_across_tile_axis_sizes_and_elastic(mesh1):
    # Every rank's rows of 1, 2 and 4 tile shards, ordered and reduced as
    # sharded_train_step does: the loss and the updated scene bit for bit
    # the mesh of one's, and elastic_train_step's at the same tile size and
    # seed.
    bad, cam, target = _train_setup()
    loss, new = shard.sharded_train_step(bad, cam, target, W, 2, mesh=mesh1,
                                         lr=0.5, tile_size=TILE, seed=3)
    scene = pt.trim_scene(bad)
    flat = target.reshape(-1, 3)
    for n in (2, 4):
        shape = {TILES_AXIS: n, SAMPLES_AXIS: 1}
        rows = [shard.shard_tile_rows(scene, cam, flat, W, 2,
                                      mesh_shape=shape, tile_index=i,
                                      sample_index=0, tile_size=TILE, seed=3)
                for i in range(n)]
        ln, sn = shard.reduce_tile_rows(
            shard.order_rows(rows, shape, W * H, TILE), scene, W * H, 0.5)
        assert torch.equal(ln, loss), n
        for f in FIELDS:
            assert torch.equal(getattr(sn, f), getattr(new, f)), (n, f)
    le, se = elastic.elastic_train_step(bad, cam, target, W, 2, lr=0.5,
                                        tile_size=TILE, seed=3,
                                        devices=["cpu", "cpu"])
    assert torch.equal(le, loss)
    for f in FIELDS:
        assert torch.equal(getattr(se, f), getattr(new, f)), f
    assert not torch.equal(new.albedo, scene.albedo)


def test_sharded_float64(mesh1):
    # Float64 runs sharded on both routes (the persistent tiles through the
    # plain pixel-pinned body), and its step takes the recorded wavefront.
    f64 = torch.float64
    scene = pt.scene_2_spheres(dtype=f64)
    cam = pt.t_default_cam(dtype=f64)
    for persistent in (False, True):
        img = shard.render_radiance_sharded(scene, cam, 32, 2, mesh=mesh1,
                                            tile_size=TILE, seed=1,
                                            persistent=persistent)
        assert img.dtype == f64 and img.shape == (18, 32, 3)
        assert torch.isfinite(img).all()
    target = pt.render_radiance(scene, cam, 32, 1, seed=2, device="cpu")
    loss, new = shard.sharded_train_step(
        scene._replace(albedo=scene.albedo * 0.8), cam, target, 32, 1,
        mesh=mesh1, lr=0.5, tile_size=TILE, seed=2)
    assert loss.dtype == f64 and new.albedo.dtype == f64
    assert np.isfinite(float(loss))
