"""Float64 where the JAX package runs it, on the CPU: the gradient step
with no path flag (the recorded wavefront, the JAX package's default off
its device, since the port's kernel pairs are float32) against the JAX
package's ``render_grads`` on a draw-free scene and against central
differences, float32's defaults unchanged bit for bit, a float64
``fit_scene`` step with each geom against the JAX package's first loss,
and the float32 flagship image's gap to the float64 one against the JAX
package's (``PYTHONPATH=. python tests/test_torch_float64.py [SPP]``
prints both gaps).
The float64 renders are in ``test_torch_render.py``, the checkpointed
render in ``test_torch_checkpoint.py``, the CLI in ``test_torch_cli.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.optimize import fit_scene as jfit_scene
from raytracingweekend_jl_tpu_torch import grad as G
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

F64 = torch.float64


def test_default_grad_backend_by_float_type():
    f32 = torch.float32
    assert G.default_grad_backend(None, f32, f32) == "cuda"
    for dts in ((F64, f32, f32), (None, F64, f32), (None, f32, F64)):
        assert G.default_grad_backend(*dts) == "cpu"
    kw = G.resolve_grad_path({}, 1 << 20, G.default_grad_backend(None, F64,
                                                                   F64))
    assert kw == {"recorded": True, "remat": False}
    assert "recorded_persist" in G.resolve_grad_path(
        {}, 1 << 20, G.default_grad_backend(None, f32, f32))


def _scene(dtype):
    return pt.make_scene([
        pt.lambertian((0, 0, -1), 0.5, (0.1, 0.2, 0.5)),
        pt.lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0)),
        pt.metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.0)], dtype=dtype)


def test_default_render_grads_routes_by_float_type():
    # With no path flag: float64 is the recorded wavefront bit for bit,
    # float32 the fixed-depth pair (the card's default below 2^17 pixels)
    # bit for bit, as before.
    for dtype, route in ((F64, dict(recorded=True, remat=False)),
                         (torch.float32, dict(recorded_fused=True))):
        scene, cam = _scene(dtype), pt.default_camera(dtype=dtype)
        target = torch.zeros((18, 32, 3), dtype=dtype)
        kw = dict(device="cpu", seed=7)
        loss, g = pt.render_grads(scene, cam, target, 32, 2, **kw)
        l_r, g_r = pt.render_grads(scene, cam, target, 32, 2, **route, **kw)
        assert loss.dtype == dtype and torch.equal(loss, l_r)
        for f in pt.DIFF_FIELDS:
            assert torch.equal(getattr(g, f), getattr(g_r, f)), (dtype, f)


def test_default_float64_render_grads_matches_fd():
    # The JAX package's FD rule (test_grad.py:139): the albedo of sphere 0
    # against central differences of render_loss at eps 1e-4, rtol 1e-4.
    scene, cam = _scene(F64), pt.default_camera(dtype=F64)
    target = torch.zeros((18, 32, 3), dtype=F64)
    kw = dict(device="cpu", seed=7)
    loss, g = pt.render_grads(scene, cam, target, 32, 2, **kw)
    vals = []
    for eps in (1e-4, -1e-4):
        alb = scene.albedo.clone()
        alb[0, 0] += eps
        with torch.no_grad():
            vals.append(float(pt.render_loss(scene._replace(albedo=alb), cam,
                                             target, 32, 2, **kw)))
    fd = (vals[0] - vals[1]) / 2e-4
    assert g.albedo.dtype == F64 and abs(fd) > 0
    np.testing.assert_allclose(float(g.albedo[0, 0]), fd, rtol=1e-4,
                               atol=1e-9)


def test_default_float64_render_grads_matches_jax():
    # A fuzz-0 mirror at spp 1 (sample 0 centred, aperture 0): the loss
    # and the gradients of center, radius and albedo take no draw, so the
    # port's default float64 step agrees with the JAX package's within
    # 1e-12 relative (fuzz's gradient follows the scatter draws).
    with jax.enable_x64(True):
        f = jnp.float64
        scene_j = rtw.make_scene([rtw.metal((0, -100.0, 0), 99.0,
                                            (0.8, 0.6, 0.4), 0.0)], dtype=f)
        cam_j = rtw.default_camera((0, 2, 0), (1, 1, 0), dtype=f)
        target = np.asarray(rtw.render_radiance(scene_j, cam_j, 32, 1))
        bad = scene_j._replace(albedo=scene_j.albedo * 0.7,
                               center=scene_j.center
                               + jnp.asarray([0, 0.01, 0], f))
        jl, jg = rtw.render_grads(bad, cam_j, jnp.asarray(target), 32, 1)
        pl, pg = pt.render_grads(pt.scene_from_numpy(bad, dtype=F64),
                                 pt.camera_from_numpy(cam_j, dtype=F64),
                                 torch.tensor(target), 32, 1, device="cpu")
        assert pl.dtype == F64 and np.asarray(jl).dtype == np.float64
        assert float(pl) == pytest.approx(float(jl), rel=1e-12)
        for name in ("center", "radius", "albedo"):
            want = np.asarray(getattr(jg, name))
            got = getattr(pg, name).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("geom", ["spsa", "edge"])
def test_float64_fit_scene_each_geom(geom):
    # One float64 fit step with each geom: the fitted scene stays float64
    # and moves, and the step's loss (the same image against the same
    # target, drawn from other streams) is within 5% of the JAX package's.
    with jax.enable_x64(True):
        f = jnp.float64
        s_j, c_j = rtw.scene_4_spheres(f), rtw.t_default_cam(f)
        target = np.asarray(rtw.render_radiance(s_j, c_j, 32, 4, seed=1))
        bad = s_j._replace(albedo=s_j.albedo * 0.7,
                           center=s_j.center + 0.02)
        ref = jfit_scene(bad, c_j, jnp.asarray(target), 32, 2, steps=1,
                         geom=geom)
    scene0 = pt.scene_from_numpy(bad, dtype=F64)
    out = pt.fit_scene(scene0, pt.camera_from_numpy(c_j, dtype=F64),
                       torch.tensor(target), 32, 2, steps=1, geom=geom,
                       device="cpu")
    assert out.scene.center.dtype == out.scene.albedo.dtype == F64
    assert np.isfinite(out.losses).all()
    assert out.losses[0] == pytest.approx(float(ref.losses[0]), rel=0.05)
    assert not torch.equal(out.scene.albedo, scene0.albedo)


def f32_minus_f64(spp: int, width: int = 64) -> dict:
    """Per package (``"jax"``, ``"port"``): each channel's mean of the
    float32 image minus the float64 image of the flagship scene
    (``scene_random_spheres(seed=1)``, ``t_cam1``, the ``trace`` route that
    both packages render in either float type; seeds 1 and 2), and its
    standard error, on the CPU."""
    def gap(a, b):
        d = (np.asarray(a, np.float64) - np.asarray(b, np.float64))
        d = d.reshape(-1, 3)
        return d.mean(0), d.std(0) / np.sqrt(d.shape[0])

    with jax.enable_x64(True):
        jax_imgs = [rtw.render_radiance(
            rtw.scene_random_spheres(seed=1, dtype=f), rtw.t_cam1(dtype=f),
            width, spp, seed=s, dtype=f)
            for f, s in ((jnp.float32, 1), (jnp.float64, 2))]
    port_imgs = [pt.render_radiance(
        pt.scene_random_spheres(seed=1, dtype=f), pt.t_cam1(dtype=f), width,
        spp, seed=s, device="cpu").numpy()
        for f, s in ((torch.float32, 1), (F64, 2))]
    return {"jax": gap(*jax_imgs), "port": gap(*port_imgs)}


def test_float32_flagship_is_darker_as_in_the_jax_package():
    # Float32 renders the flagship scene darker than float64; the JAX
    # package does too, and the port's gap matches the JAX package's
    # within 4 standard errors in every channel.
    gaps = f32_minus_f64(8)
    (g_j, se_j), (g_p, se_p) = gaps["jax"], gaps["port"]
    assert (np.abs(g_p - g_j) <= 4 * np.hypot(se_p, se_j)).all(), gaps
    assert g_j.mean() < 0 and g_p.mean() < 0, gaps


if __name__ == "__main__":
    import sys
    spp = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    for name, (g, se) in f32_minus_f64(spp).items():
        print(name, "spp", spp, "float32 - float64 mean gap", g.tolist(),
              "standard error", se.tolist(), flush=True)
