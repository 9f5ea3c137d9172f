"""The port's checkpointed render composed with the mesh
(``utils/checkpoint.render_checkpointed_sharded``) on the CPU, the
counterparts of ``tests/test_checkpoint_sharded.py``: an interrupted and
resumed render bit for bit the uninterrupted one (both routes, float64
too), equal to the direct sharded render, every refused setting (the ones
the reference does not check among them), the CLI's ``--multihost
--spp-chunk`` in a world of one, and the JAX package's sharded
checkpointed render statistically."""

import os

import jax
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.parallel.mesh import make_render_mesh as jmesh
from raytracingweekend_jl_tpu.utils.checkpoint import (
    render_checkpointed_sharded as jrender)
from raytracingweekend_jl_tpu_torch import cli
from raytracingweekend_jl_tpu_torch.parallel.mesh import (RenderMesh,
                                                          make_render_mesh)
from raytracingweekend_jl_tpu_torch.parallel import shard as shard_mod
from raytracingweekend_jl_tpu_torch.parallel.shard import (
    render_radiance_sharded)
from raytracingweekend_jl_tpu_torch.utils import checkpoint as ck
from raytracingweekend_jl_tpu_torch.utils.image import read_png
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

W, H, TILE = 64, 32, 256


def _render(n, path=None, **kw):
    args = dict(seed=5, spp_chunk=2, tile_size=TILE, image_height=H,
                mesh=make_render_mesh(device="cpu"))
    args.update(kw)
    scene = args.pop("scene", pt.scene_4_spheres())
    cam = args.pop("cam", pt.t_default_cam())
    return ck.render_checkpointed_sharded(scene, cam, args.pop("width", W),
                                          n, checkpoint_path=path, **args)


@pytest.mark.parametrize("route", ["persistent", "trace", "float64"])
def test_sharded_resume_bitwise(route, tmp_path):
    # Interrupt + resume == one uninterrupted chunked run, bit for bit; the
    # file holds what was returned.
    kw = {"persistent": route != "trace"}
    if route == "float64":
        kw.update(scene=pt.scene_4_spheres(dtype=torch.float64),
                  cam=pt.t_default_cam(dtype=torch.float64))
    p = str(tmp_path / "ck.npz")
    full = _render(8, **kw)
    part = _render(2, p, **kw)
    assert part.samples_done == 2 and os.path.exists(p)
    resumed = _render(8, p, **kw)
    assert resumed.samples_done == full.samples_done == 8
    assert (resumed.start, resumed.stop) == (0, W * H)
    assert np.array_equal(resumed.strip_sum, full.strip_sum)
    assert np.array_equal(resumed.image, full.image)
    assert resumed.image.shape == (H, W, 3) and np.isfinite(full.image).all()
    disk = ck.load_strip_state(p)
    assert np.array_equal(disk.strip_sum, resumed.strip_sum)
    assert disk.samples_done == 8 and disk.rng == "philox"
    assert disk.persistent is kw["persistent"] and disk.tile_size == TILE
    # A finished render resumes to itself and renders nothing more.
    again = _render(8, p, **kw)
    assert np.array_equal(again.strip_sum, full.strip_sum)


def test_sharded_checkpoint_matches_direct_render():
    # On the trace route every sample's draws are keyed by its global
    # index, so chunks add up to the one-shot sharded render (up to the
    # order of the float sums). (The strided route keys each chunk's draws
    # by its first sample, so there chunking changes the draws.)
    state = _render(4, scene=pt.scene_2_spheres(), seed=3, persistent=False)
    direct = render_radiance_sharded(
        pt.scene_2_spheres(), pt.t_default_cam(), W, 4,
        mesh=make_render_mesh(device="cpu"), image_height=H,
        tile_size=TILE, seed=3).numpy()
    np.testing.assert_allclose(state.image, direct, atol=5e-7)


MISMATCH = {
    "seed": dict(seed=6),
    "width": dict(width=48),
    "spp_chunk": dict(spp_chunk=4),
    "tile_size": dict(tile_size=128),
    "max_depth": dict(max_depth=8),
    "tmin": dict(tmin=1e-3),
    "persistent": dict(persistent=False),
    "rays_per_pass": dict(rays_per_pass=1 << 20),
    "scene": dict(scene=pt.scene_2_spheres()),
    "camera": dict(cam=pt.t_cam1()),
}


@pytest.mark.parametrize("case", sorted(MISMATCH))
def test_sharded_checkpoint_rejects_mismatched_config(case, tmp_path):
    # Every setting the image depends on is checked on resume, up front
    # (the reference checks the film, the seed, spp_chunk and tile_size).
    p = str(tmp_path / "ck.npz")
    _render(2, p)
    with pytest.raises(ValueError, match="does not match"):
        _render(4, p, **MISMATCH[case])


def test_sharded_checkpoint_refusals(tmp_path):
    p = str(tmp_path / "ck.npz")
    _render(4, p)
    # More samples on disk than asked.
    with pytest.raises(ValueError, match="holds 4 samples"):
        _render(2, p)
    # Another strip range (another mesh layout).
    st = ck.load_strip_state(p)
    st.start, st.stop = 0, 1024
    st.strip_sum = st.strip_sum[:1024]
    ck.save_strip_state(st, p)
    with pytest.raises(ValueError, match="pixels"):
        _render(6, p)
    # A JAX-written file (threefry streams, no rng key) is not continued.
    jp = str(tmp_path / "jax.npz")
    jm = jmesh(n_tiles=1, n_samples=1, devices=jax.devices()[:1])
    jrender(rtw.scene_4_spheres(), rtw.t_default_cam(), W, 2, mesh=jm,
            image_height=H, spp_chunk=2, tile_size=TILE, seed=5,
            checkpoint_path=jp)
    assert ck.load_strip_state(jp).rng is None
    with pytest.raises(ValueError, match="rng"):
        _render(4, jp)
    # spp_chunk and n_samples must be multiples of the samples axis.
    two = RenderMesh(1, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="multiples of the mesh sample"):
        _render(4, mesh=two, spp_chunk=3)
    with pytest.raises(ValueError, match="positive"):
        _render(4, spp_chunk=0)


@pytest.mark.parametrize("error,calls", [(NotImplementedError, 1),
                                         (RuntimeError, 3)])
def test_sharded_chunk_retries_only_device_faults(error, calls, monkeypatch):
    # The chunk loop the two drivers share: a refused route raises at once,
    # a device fault is retried max_retries times on a mesh of one.
    seen = []

    def broken(*a, **k):
        seen.append(1)
        raise error("simulated")

    monkeypatch.setattr(shard_mod, "render_strip_sharded", broken)
    with pytest.raises(error, match="simulated"):
        _render(4, max_retries=2)
    assert len(seen) == calls


def test_sharded_checkpoint_defaults_to_persistent(tmp_path):
    # As the single-device driver (the reference's sharded one defaults to
    # the trace route).
    p = str(tmp_path / "ck.npz")
    ck.render_checkpointed_sharded(pt.scene_2_spheres(), pt.t_default_cam(),
                                   32, 2, mesh=make_render_mesh(device="cpu"),
                                   spp_chunk=2, tile_size=TILE,
                                   checkpoint_path=p)
    assert ck.load_strip_state(p).persistent is True


def test_cli_multihost_spp_chunk_resumes_bitwise(tmp_path, monkeypatch):
    # --multihost --spp-chunk --checkpoint in a world of one: 2 samples,
    # then a resume to 4, equal to an uninterrupted run of 4 bit for bit;
    # a satisfied checkpoint writes the same image again.
    monkeypatch.chdir(tmp_path)
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    base = ["--scene", "2_spheres", "--camera", "default", "--width", "64",
            "--height", "32", "--device", "cpu", "--multihost",
            "--spp-chunk", "2", "--tile-size", str(TILE)]
    cli.main(base + ["--spp", "4", "--checkpoint", "full.npz",
                     "-o", "full.png"])
    cli.main(base + ["--spp", "2", "--checkpoint", "ck.npz", "-o", "a.png"])
    cli.main(base + ["--spp", "4", "--checkpoint", "ck.npz", "-o", "b.png"])
    a, b = ck.load_strip_state("full.npz"), ck.load_strip_state("ck.npz")
    assert a.samples_done == b.samples_done == 4
    assert np.array_equal(a.strip_sum, b.strip_sum)
    assert np.array_equal(read_png("full.png"), read_png("b.png"))
    cli.main(base + ["--spp", "4", "--checkpoint", "ck.npz", "-o", "c.png"])
    assert np.array_equal(read_png("b.png"), read_png("c.png"))


def test_matches_jax_sharded_checkpoint_statistically():
    # Independent streams on 4_spheres at spp 8 in chunks of 2, JAX on a
    # (4 tiles x 2 samples) virtual mesh: each channel's mean difference
    # within 3 standard errors of the per-pixel difference.
    jm = jmesh(n_tiles=4, n_samples=2, devices=jax.devices()[:8])
    ref = jrender(rtw.scene_4_spheres(), rtw.t_default_cam(), W, 8, mesh=jm,
                  image_height=H, spp_chunk=2, tile_size=TILE, seed=5).image
    out = _render(8).image
    d = (out - ref).reshape(-1, 3)
    se = d.std(0) / np.sqrt(d.shape[0])
    assert (np.abs(d.mean(0)) < 3 * se).all(), (d.mean(0), se)
