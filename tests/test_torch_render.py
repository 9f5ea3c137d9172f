"""The port's whole forward slice on the CPU: the strided integrator against
the JAX package's committed strided goldens, the public ``render`` against
the JAX package's ``render_radiance``, and the port's import hygiene.
Card-only: the kernel path against the plain path."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu import rng as jrng
from raytracingweekend_jl_tpu.ops.integrator import (
    persistent_render_sum as jpersistent_sum)
from raytracingweekend_jl_tpu.ops.sampling import per_ray_uniforms
from raytracingweekend_jl_tpu.render import (
    strided_k_for as jk_for, strided_sample_groups_for as jgroups_for)
from raytracingweekend_jl_tpu_torch.ops.integrator import (
    persistent_render_sum, persistent_render_sum_strided)
from raytracingweekend_jl_tpu_torch.render import (strided_k_for,
                                                   strided_sample_groups_for)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens",
                      "persistent_interpret_64x36_spp4.npz")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax_uniform_hooks(n_pix, k, key=jax.random.PRNGKey(0), sample_offset=0):
    """The JAX strided interpret path's draws for a full image at
    pixel_start 0: strip-0 u4 keyed by (pixel, sample) and per-iteration u9
    over its padded (rows, 128) layout, sliced to the port's [9, n_lanes]."""
    n_lanes = -(-n_pix // k)
    rows = -(-(-(-n_lanes // 128)) // 64) * 64
    key_cam = jrng.purpose_key(key, jrng.PIXEL_JITTER)
    pid = jnp.arange(n_lanes, dtype=jnp.int32)
    keys0 = jax.vmap(jax.random.fold_in)(
        jax.vmap(jax.random.fold_in, (None, 0))(key_cam, pid),
        jnp.full((n_lanes,), sample_offset, jnp.int32))
    u4 = torch.from_numpy(np.array(per_ray_uniforms(keys0, 4)))
    k0 = jax.random.fold_in(key, sample_offset)
    u9 = jax.jit(lambda it: jax.random.uniform(
        jax.random.fold_in(k0, it), (9, rows, 128)).reshape(9, -1)[:, :n_lanes])
    return u4, lambda it: torch.from_numpy(np.array(u9(it)))


GOLDEN_CASES = {
    # name: (JAX builder, camera, share of pixels within 1e-4)
    "4_spheres": (rtw.scene_4_spheres, "t_default_cam", 0.99),
    "diel_spheres_hollow": (rtw.scene_diel_spheres_hollow, "hollow_glass_cam",
                            0.99),
    "random_spheres": (lambda: rtw.scene_random_spheres(seed=1), "t_cam1",
                       0.60),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_strided_slice_matches_goldens(name):
    # The port's CPU strided path (dot-form sweep, gather, plain K2), fed the
    # JAX path's own uniforms, against the committed interpret-mode goldens:
    # 64x36, 4 spp, k = 4. Per pixel only where paths do not diverge: the
    # draws are positional per (iteration, lane), so one last-bit difference
    # that changes a path's length shifts every later draw of its lane. The
    # golden's jitted loop contracts a*b+c into FMA throughout (its sweep
    # equals the eager dot form on 66% of hits), eager PyTorch does not.
    # Measured within 1e-4: 4_spheres 99.70%, diel_spheres_hollow 99.83%,
    # random_spheres 67.06%. Every channel mean within 1% (measured <= 0.36%).
    scene_fn, cam_name, share = GOLDEN_CASES[name]
    W, H, spp, k = 64, 36, 4, 4
    u4, u9_fn = _jax_uniform_hooks(W * H, k)
    out = persistent_render_sum_strided(
        pt.scene_from_numpy(scene_fn()), getattr(pt, cam_name)(), W * H, 0,
        spp, 0, 16, 1e-4, float(W), float(H), k=k, init_u4=u4,
        rng_u9_fn=u9_fn).numpy()
    ref = np.load(GOLDEN)[f"{name}/strided"]
    assert out.shape == ref.shape and np.isfinite(out).all()
    close = (np.abs(out - ref) <= 1e-4).all(-1)
    assert close.mean() >= share, close.mean()
    np.testing.assert_allclose(out.mean(0), ref.mean(0), rtol=0.01)


def test_render_matches_jax_statistically():
    # Independent streams (torch.Generator + Philox vs threefry) on the same
    # scene: the per-pixel difference has zero mean, so each channel's mean
    # difference must be within 3 standard errors of that difference.
    W, spp = 64, 8
    a = np.asarray(rtw.render_radiance(rtw.scene_4_spheres(), rtw.t_default_cam(),
                                       W, spp, seed=0, persistent=True))
    b = pt.render_radiance(pt.scene_4_spheres(), pt.t_default_cam(), W, spp,
                           seed=11, generator=torch.Generator().manual_seed(5),
                           device="cpu", persistent=True, inline=False)
    d = (b.numpy() - a).reshape(-1, 3)
    se = d.std(0) / np.sqrt(d.shape[0])
    assert (np.abs(d.mean(0)) < 3 * se).all(), (d.mean(0), se)
    small = dict(seed=11, generator=torch.Generator().manual_seed(5),
                 device="cpu", persistent=True, inline=False)
    img = pt.render(pt.scene_4_spheres(), pt.t_default_cam(), 16, 2, **small)
    small["generator"] = torch.Generator().manual_seed(5)
    lin = pt.render_radiance(pt.scene_4_spheres(), pt.t_default_cam(), 16, 2,
                             **small)
    assert torch.equal(img, pt.gamma2_encode(lin))


def test_chunked_and_sample_grouped_renders_agree():
    # pixel_chunk tiles run the strided path per contiguous chunk and a small
    # image pinned to the strided route folds samples into groups (k = 1);
    # both estimate the same image.
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    full = pt.render_radiance(scene, cam, 64, 8, seed=1, device="cpu",
                              persistent=True, inline=False)
    chunked = pt.render_radiance(scene, cam, 64, 8, seed=1, pixel_chunk=1000,
                                 device="cpu", persistent=True)
    assert strided_sample_groups_for(64 * 36, 8) == 8
    assert full.shape == chunked.shape == (36, 64, 3)
    d = (full - chunked).reshape(-1, 3)
    se = d.std(0) / d.shape[0] ** 0.5
    assert (d.mean(0).abs() < 3 * se).all()
    assert torch.isfinite(full).all() and torch.isfinite(chunked).all()


def test_strided_dispatch_helpers_match_jax():
    for n_pix, spp in ((1920 * 1080, 4), (256 * 144, 64), (64 * 36, 4),
                       (8192, 8), (20000, 8), (1, 1)):
        assert strided_k_for(n_pix) == jk_for(n_pix)
        assert strided_sample_groups_for(n_pix, spp) == jgroups_for(n_pix, spp)


@pytest.mark.parametrize("route", ["inline", "non_contiguous", "fixed_depth",
                                   "remat_passes", "recorded_stage",
                                   "fused_stages"])
def test_unported_routes_raise(route):
    # Every route renders through render_tile_sum: the inline route (K8), a
    # non-contiguous tile given by its film coordinates (the pixel-pinned
    # route, K9), the fixed-depth wavefront (trace), pass recomputation
    # (two passes, each recomputed in the backward) and the two staged
    # recorded routes, which once raised NotImplementedError.
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    u, v = pt.pixel_coords(64, 36)
    kw = {"inline": dict(persistent=True, inline=True),
          "non_contiguous": dict(persistent=True, inline=False,
                                 u=u[:2300:23], v=v[:2300:23]),
          "fixed_depth": dict(persistent=False),
          "remat_passes": dict(persistent=False, recorded_fused=True,
                               remat_passes=True),
          "recorded_stage": dict(persistent=False,
                                 recorded_stage=(4, 8)),
          "fused_stages": dict(persistent=False, recorded_fused=True,
                               fused_stages=((0, 1), (4, 8)))}[route]
    n_pix = 100 if route == "non_contiguous" else 64 * 36
    n_samples = 2 if route == "remat_passes" else 1
    out = pt.render_tile_sum(scene, cam, n_pix, 0, n_samples, 0, 16,
                             1e-4, 64.0, 36.0, **kw)
    assert out.shape == (n_pix, 3) and torch.isfinite(out).all()
    assert (out > 0).any()


def test_cuda_request_without_cuda_raises(monkeypatch):
    # No path carries on on the CPU when a card is asked for and missing.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.render(pt.scene_2_spheres(), pt.t_default_cam(), 16, 1,
                  device="cuda")


def test_default_device_is_the_card(monkeypatch):
    # With no device argument every entry point asks for the card: without
    # CUDA it raises instead of rendering on the CPU.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.render(scene, cam, 16, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.render_grads(scene, cam, torch.zeros((9, 16, 3)), 16, 1)
    assert torch.isfinite(pt.render(scene, cam, 16, 1, device="cpu")).all()


def test_float64_render_raises():
    # A float64 persistent render runs (as the JAX package runs it off the
    # TPU), through the plain pixel-pinned body in float64, whatever the
    # tile: the whole image, a pixel_start range, film coordinates. Only an
    # explicit request for a float32 kernel raises: the inline kernel K8
    # and the strided route's generator.
    f64 = torch.float64
    scene, cam = pt.scene_2_spheres(dtype=f64), pt.t_default_cam(dtype=f64)
    img = pt.render(scene, cam, 16, 1, device="cpu", persistent=True,
                    inline=False)
    assert img.dtype == f64 and img.shape == (9, 16, 3)
    whole = pt.render_radiance(scene, cam, 16, 2, device="cpu",
                               persistent=True)
    direct = persistent_render_sum(scene, cam, *pt.pixel_coords(
        16, 9, dtype=f64), 0, 2, 0, 16, 1e-4, 16.0, 9.0) / 2
    assert torch.equal(whole, direct.reshape(9, 16, 3))
    u, v = pt.pixel_coords(16, 9, dtype=f64)
    by_start = pt.render_tile_sum(scene, cam, 50, 7, 2, 0, 16, 1e-4, 16.0,
                                  9.0, True, pixel_start=40)
    by_uv = pt.render_tile_sum(scene, cam, 50, 7, 2, 0, 16, 1e-4, 16.0, 9.0,
                               True, u=u[40:90], v=v[40:90])
    assert by_start.dtype == f64 and torch.equal(by_start, by_uv)
    with pytest.raises(NotImplementedError, match="float32"):
        pt.render(scene, cam, 16, 1, device="cpu", persistent=True,
                  inline=True)
    with pytest.raises(NotImplementedError, match="float32"):
        pt.render(scene, cam, 16, 1, device="cpu", persistent=True,
                  inline=False, generator=torch.Generator())


def _f64_cases():
    mirror = (rtw.make_scene([rtw.metal((0, -100.0, 0), 99.0,
                                        (0.8, 0.6, 0.4), 0.0)],
                             dtype=jnp.float64),
              rtw.default_camera((0, 2, 0), (1, 1, 0), dtype=jnp.float64), 16)
    return {"mirror": mirror,
            "sky_only": (rtw.make_scene([], dtype=jnp.float64),
                         rtw.t_default_cam(jnp.float64), 16),
            "depth_1": (rtw.scene_2_spheres(jnp.float64),
                        rtw.t_default_cam(jnp.float64), 1)}


def _f64_pair(scene_j, cam_j, spp, depth, W=48, H=27, start=None, n=None):
    """The JAX package's float64 ``persistent_render_sum`` and the port's
    float64 persistent route (``render_tile_sum``: the whole image, or the
    ``pixel_start`` tile of ``n`` pixels) on the same film."""
    u, v = rtw.pixel_coords(W, H, dtype=jnp.float64)
    a, b = (0, W * H) if start is None else (start, start + n)
    ref = np.asarray(jpersistent_sum(scene_j, cam_j, u[a:b], v[a:b],
                                     jax.random.PRNGKey(3), spp, 0, depth,
                                     1e-4, float(W), float(H)))
    out = pt.render_tile_sum(
        pt.scene_from_numpy(scene_j, dtype=torch.float64),
        pt.camera_from_numpy(cam_j, dtype=torch.float64), b - a, 5, spp, 0,
        depth, 1e-4, float(W), float(H), True, pixel_start=start)
    assert ref.dtype == np.float64 and out.dtype == torch.float64
    return out.numpy(), ref


@pytest.mark.parametrize("case", ["mirror", "sky_only", "depth_1"])
def test_float64_persistent_matches_jax_exact(case):
    # The draw-free cases (spp 1: sample 0 centred, aperture 0; fuzz-0
    # mirror, sky, one bounce): the port's float64 persistent render and a
    # pixel_start tile of it against the JAX package's float64 XLA body,
    # within 1e-12.
    with jax.enable_x64(True):
        scene_j, cam_j, depth = _f64_cases()[case]
        out, ref = _f64_pair(scene_j, cam_j, 1, depth)
        np.testing.assert_allclose(out, ref, atol=1e-12)
        tile, ref_t = _f64_pair(scene_j, cam_j, 1, depth, start=300, n=500)
        np.testing.assert_allclose(tile, ref_t, atol=1e-12)
        np.testing.assert_array_equal(tile, out[300:800])
    assert out.mean() > 0


def test_float64_persistent_matches_jax_statistically():
    # Independent streams on 4_spheres at spp 16 in float64: each channel's
    # mean difference within 3 standard errors of the per-pixel difference,
    # for the whole image and for a pixel_start tile.
    with jax.enable_x64(True):
        s, c = rtw.scene_4_spheres(jnp.float64), rtw.t_default_cam(
            jnp.float64)
        for start, n in ((None, None), (200, 1000)):
            out, ref = _f64_pair(s, c, 16, 16, start=start, n=n)
            d = (out - ref).reshape(-1, 3) / 16
            se = d.std(0) / np.sqrt(d.shape[0])
            assert (np.abs(d.mean(0)) < 3 * se).all(), (d.mean(0), se)


def test_port_imports_no_jax():
    # A fresh interpreter: importing every module of the port, the gradient
    # slice's and the parallel layer's among them, leaves JAX out.
    code = ("import sys, pkgutil, importlib, raytracingweekend_jl_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "for m in ('grad', 'ops.persist_grad', 'ops.cuda.grad_kernel',\n"
            "          'ops.cuda.persist_grad_kernel', 'optimize',\n"
            "          'ops.fused_grad', 'ops.grad_trace', 'ops.inline',\n"
            "          'ops.cuda.inline_kernel',\n"
            "          'ops.materials', 'ops.integrator', 'cli',\n"
            "          'utils.config', 'utils.checkpoint', 'utils.metrics',\n"
            "          'utils.profiling', 'utils.xoroshiro', 'utils.image',\n"
            "          'parallel.mesh', 'parallel.shard', 'parallel.multihost',\n"
            "          'parallel.elastic'):\n"
            "    assert p.__name__ + '.' + m in sys.modules, m\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m.startswith('raytracingweekend_jl_tpu.')]\n"
            "assert not bad, bad\nprint('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.cuda
def test_render_kernels_match_plain_on_card(cuda_device):
    # The public entry point on the card through K1 and K2 (the strided
    # route pinned: 256x144 would take the inline route), against the same
    # render through the plain versions: both counters move and every
    # channel mean agrees within 1%.
    from raytracingweekend_jl_tpu_torch.ops.cuda import (intersect_kernel,
                                                          shade_kernel)
    scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
    intersect_kernel.launches = shade_kernel.launches = 0
    a = pt.render_radiance(scene, cam, 256, 16, device=cuda_device, seed=3,
                           persistent=True, inline=False)
    assert intersect_kernel.launches > 0 and shade_kernel.launches > 0
    b = pt.render_radiance(scene, cam, 256, 16, device=cuda_device, seed=3,
                           impl="plain", persistent=True, inline=False)
    assert torch.isfinite(a).all()
    ma, mb = a.mean((0, 1)), b.mean((0, 1))
    assert ((ma - mb).abs() <= 0.01 * mb).all()
