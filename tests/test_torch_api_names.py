"""Arguments and public names of the JAX package that the port now takes:
``near_zero``, ``color_vec3_in_rgb``, ``uniform_between`` and
``resolve_grad_path`` in the package namespace, every public name of the
JAX package's ``rng`` (``purpose_key`` last) in the port's,
``render_radiance(dtype=)``
(the reference's ``elem_type`` switch) and ``fused_stages=`` (the staged
fixed-depth pair), which runs and refuses a malformed schedule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch import grad as G
from raytracingweekend_jl_tpu_torch.ops.integrator import persistent_render_sum
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401


def v(*xs):
    return torch.tensor(xs, dtype=torch.float32)


def test_near_zero_cases_and_jax():
    # tests/test_vecmath.py's cases, then 4 096 vectors around the 1e-5
    # threshold: the same booleans as the JAX package's near_zero (exact).
    assert bool(pt.near_zero(v(1e-3, 1e-3, 1e-3)))
    assert not bool(pt.near_zero(v(0.1, 0.0, 0.0)))
    x = np.random.default_rng(0).normal(0, 2e-3, (4096, 3)).astype(np.float32)
    np.testing.assert_array_equal(pt.near_zero(torch.as_tensor(x)).numpy(),
                                  np.asarray(rtw.near_zero(jnp.asarray(x))))


def test_color_vec3_in_rgb_cases_and_jax():
    # tests/test_vecmath.py's case (unit +y -> (0.5, 1, 0.5), atol 1e-6),
    # the zero vector (0.5 grey, finite), and 1 024 random vectors against
    # the JAX package (atol 1e-6).
    np.testing.assert_allclose(pt.color_vec3_in_rgb(v(0.0, 2.0, 0.0)),
                               [0.5, 1.0, 0.5], atol=1e-6)
    np.testing.assert_array_equal(pt.color_vec3_in_rgb(v(0.0, 0.0, 0.0)),
                                  [0.5, 0.5, 0.5])
    x = np.random.default_rng(1).normal(0, 3, (1024, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pt.color_vec3_in_rgb(torch.as_tensor(x)).numpy(),
        np.asarray(rtw.color_vec3_in_rgb(jnp.asarray(x))), atol=1e-6)


def test_uniform_between_cases_and_jax_transform():
    # tests/test_sampling.py's case: 10 000 draws in [0.5, 1.0), mean within
    # 0.01 of 0.75. Then the transform: given the same U[0,1) draws the
    # result is bit for bit the JAX package's max(lo, u * (hi - lo) + lo),
    # float32 and float64.
    g = torch.Generator().manual_seed(2)
    x = pt.uniform_between(g, (10000,), 0.5, 1.0).numpy()
    assert x.dtype == np.float32
    assert x.min() >= 0.5 and x.max() < 1.0
    assert abs(x.mean() - 0.75) < 0.01
    for dtype, lo, hi in ((torch.float32, -2.5, 0.75),
                          (torch.float64, 0.1, 7.0)):
        got = pt.uniform_between(torch.Generator().manual_seed(5), (333,),
                                 lo, hi, dtype=dtype)
        u = torch.rand((333,), generator=torch.Generator().manual_seed(5),
                       dtype=dtype).numpy()
        if dtype == torch.float32:
            # The JAX package's own arithmetic (lax.max(minval, floats *
            # (maxval - minval) + minval) in float32).
            lo_j, hi_j = jnp.float32(lo), jnp.float32(hi)
            want = np.asarray(jax.lax.max(lo_j, jnp.asarray(u) * (hi_j - lo_j)
                                          + lo_j))
        else:
            want = np.maximum(lo, u * (np.float64(hi) - lo) + lo)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_rng_names_and_purpose_key():
    # Every public name of the JAX package's rng module (the purpose tags
    # and purpose_key) exists in the port's with the same value; the port's
    # purpose_key derives the JAX package's key data.
    from raytracingweekend_jl_tpu import rng as jrng
    from raytracingweekend_jl_tpu_torch import rng
    names = [n for n in vars(jrng) if not n.startswith("_")
             and n not in ("annotations", "jax")]
    assert "purpose_key" in names
    for n in names:
        assert hasattr(rng, n), n
        if isinstance(getattr(jrng, n), int):
            assert getattr(rng, n) == getattr(jrng, n), n
    want = jrng.purpose_key(jax.random.PRNGKey(7), jrng.LENS, 2, 9)
    np.testing.assert_array_equal(
        rng.purpose_key(rng.threefry_key(7), rng.LENS, 2, 9).numpy(),
        np.asarray(jax.random.key_data(want)).astype(np.int64))


def test_resolve_grad_path_exported():
    # The package exports grad.resolve_grad_path itself, which resolves as
    # the JAX package's.
    assert pt.resolve_grad_path is G.resolve_grad_path
    for n_pix in (1920 * 1080, 64 * 36):
        assert pt.resolve_grad_path({}, n_pix, "cuda") == \
            rtw.resolve_grad_path({}, n_pix, "tpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_render_dtype_on_fixed_depth_route(dtype):
    # dtype sets the film coordinates' type and so the image's: the camera's
    # by default, float32 or float64 on the fixed-depth wavefront. With the
    # scene and camera in that type the image is the default render's bit
    # for bit; a float32 scene and camera rendered at float64 promote the
    # rays and agree with the float64 render to 1e-5 (atol).
    s64, c64 = (pt.scene_4_spheres(dtype=torch.float64),
                pt.t_default_cam(dtype=torch.float64))
    s, c = pt.scene_4_spheres(dtype=dtype), pt.t_default_cam(dtype=dtype)
    img = pt.render_radiance(s, c, 32, 2, device="cpu", dtype=dtype)
    assert img.dtype == dtype and img.shape == (18, 32, 3)
    assert torch.equal(img, pt.render_radiance(s, c, 32, 2, device="cpu"))
    ref64 = pt.render_radiance(s64, c64, 32, 2, device="cpu")
    mixed = pt.render_radiance(pt.scene_4_spheres(), pt.t_default_cam(), 32,
                               2, device="cpu", dtype=torch.float64)
    assert mixed.dtype == torch.float64
    np.testing.assert_allclose(mixed.numpy(), ref64.numpy(), atol=1e-5)
    assert torch.isfinite(pt.render(s, c, 32, 2, device="cpu",
                                    dtype=dtype)).all()
    u, vv = pt.pixel_coords(32, 18, dtype=torch.float32)
    ju, jv = rtw.pixel_coords(32, 18, dtype=jnp.float32)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(vv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("route", [dict(persistent=True),
                                   dict(recorded_fused=True),
                                   dict(recorded_persist=(4, None))])
def test_render_float64_off_fixed_depth_raises(route):
    # A float64 dtype runs persistent=True (the plain pixel-pinned body in
    # float64, as the JAX package runs it off the TPU) and matches the body
    # called directly; the gradient kernel pairs, asked for by name, are
    # float32 and raise instead of running in float32 or on another route.
    args = (pt.scene_4_spheres(), pt.t_default_cam(), 32, 2)
    if not route.get("persistent"):
        with pytest.raises(NotImplementedError, match="float64"):
            pt.render_radiance(*args, device="cpu", dtype=torch.float64,
                               **route)
        return
    img = pt.render_radiance(*args, device="cpu", dtype=torch.float64,
                             **route)
    u, v = pt.pixel_coords(32, 18, dtype=torch.float64)
    ref = persistent_render_sum(pt.trim_scene(args[0]), args[1], u, v, 0, 2,
                                0, 16, 1e-4, 32.0, 18.0) / 2
    assert img.dtype == torch.float64
    assert torch.equal(img, ref.reshape(18, 32, 3))


def test_fused_stages_raises_not_implemented():
    # The JAX package's opt-in staged fixed-depth pair, which once raised
    # NotImplementedError, now runs from render_radiance, render and the
    # gradient step (a finite image, a finite and sane gradient), and a
    # schedule that is not ((first_bounce, divisor), ...) from bounce 0
    # raises ValueError naming the argument (not TypeError).
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    stages = ((0, 1), (4, 8))
    for fn in (pt.render_radiance, pt.render):
        img = fn(scene, cam, 32, 1, device="cpu", recorded_fused=True,
                 fused_stages=stages)
        assert img.shape == (18, 32, 3) and torch.isfinite(img).all()
    loss, g = pt.render_grads(scene, cam, torch.zeros((18, 32, 3)), 32, 1,
                              device="cpu", recorded_fused=True,
                              fused_stages=stages)
    pt.check_grads_sane(g, loss)
    for bad in ((4, 8), ((4, 8),), ((0, 4), (2, 1))):
        with pytest.raises(ValueError, match="fused_stages"):
            pt.render_radiance(scene, cam, 32, 1, device="cpu",
                               recorded_fused=True, fused_stages=bad)
