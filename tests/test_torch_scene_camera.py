"""The port's scenes, cameras, vector math, samplers and small helpers against
the JAX package, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops import vecmath as jvm
from raytracingweekend_jl_tpu.ops.sampling import concentric_disk_map as jdisk
from raytracingweekend_jl_tpu.ops.materials import attr_mat as jattr_mat
from raytracingweekend_jl_tpu.ops.integrator import skycolor as jsky
from raytracingweekend_jl_tpu.utils.image import to_uint8 as jto_uint8
from raytracingweekend_jl_tpu_torch.ops import vecmath as tvm
from raytracingweekend_jl_tpu_torch.ops.materials import (attr_mat,
                                                          fetch_attr_planes)
from raytracingweekend_jl_tpu_torch.render import (pixel_coords,
                                                   image_height_for)
from raytracingweekend_jl_tpu_torch.utils.image import to_uint8, write_png

SCENES = ["2_spheres", "4_spheres", "diel_spheres", "diel_spheres_hollow",
          "blue_red_spheres", "random_spheres"]
CAMERAS = ["t_default_cam", "t_cam1", "t_cam2", "hollow_glass_cam"]
FIELDS = ("center", "radius", "albedo", "fuzz", "ir", "mat")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs in several processes at once and these tensors are
    small: one intra-op thread per process avoids oversubscribing the
    cores (measured 4x faster for this suite under six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.mark.parametrize("name", SCENES)
def test_scene_builders_bit_equal(name):
    # Both builders draw the same seeded numpy stream and cast float64 ->
    # float32 once on the host: equal bit for bit.
    a = rtw.ALL_SCENES[name]()
    b = pt.ALL_SCENES[name]()
    c = pt.scene_from_numpy(a)
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)),
                                      err_msg=f"{name}.{f}")
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(c, f)))
    assert b.mat.dtype == torch.int32 and b.center.dtype == torch.float32


def test_trim_scene_matches():
    a = rtw.scene.trim_scene(rtw.scene_random_spheres(seed=1))
    b = pt.trim_scene(pt.scene_random_spheres(seed=1))
    assert b.n_spheres == a.n_spheres == 488
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)))


@pytest.mark.parametrize("name", CAMERAS)
def test_cameras_bit_equal(name):
    a = getattr(rtw, name)()
    b = getattr(pt, name)()
    c = pt.camera_from_numpy(a)
    for f in a._fields:
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(b, f)),
                                      err_msg=f"{name}.{f}")
        np.testing.assert_array_equal(_np(getattr(a, f)), _np(getattr(c, f)))


@pytest.mark.parametrize("name", ["t_cam1", "t_cam2"])
def test_make_rays_injected_disk(name):
    # Same film coords and disk points; the only differences are the order
    # of three-term sums: 1e-7 absolute plus relative (an ulp of a
    # component near 1 is 6e-8 to 1.2e-7).
    from raytracingweekend_jl_tpu.camera import make_rays as jmake
    g = np.random.default_rng(1)
    s = g.random(512, dtype=np.float32)
    t = g.random(512, dtype=np.float32)
    disk = g.uniform(-0.7, 0.7, (512, 2)).astype(np.float32)
    oj, dj = jmake(getattr(rtw, name)(), jnp.asarray(s), jnp.asarray(t),
                   jnp.asarray(disk))
    ot, dt = pt.make_rays(getattr(pt, name)(), torch.from_numpy(s),
                          torch.from_numpy(t), torch.from_numpy(disk))
    np.testing.assert_allclose(_np(ot), _np(oj), atol=1e-7, rtol=1e-7)
    np.testing.assert_allclose(_np(dt), _np(dj), atol=1e-7, rtol=1e-7)


def _vec_inputs():
    g = np.random.default_rng(2)
    v = g.normal(size=(256, 3)).astype(np.float32)
    n = g.normal(size=(256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    d = g.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    eta = g.uniform(0.6, 1.6, 256).astype(np.float32)
    cos = g.uniform(0, 1, 256).astype(np.float32)
    return v, n, d, eta, cos


@pytest.mark.parametrize("fn", ["dot", "normalize", "reflect", "refract",
                                "reflectance", "gamma2_encode"])
def test_vecmath_matches(fn):
    # Elementwise float32 on the same inputs; 1e-6 covers the order of the
    # three-term sums and pow vs repeated products in Schlick.
    v, n, d, eta, cos = _vec_inputs()
    args = {"dot": (v, n), "normalize": (v,), "reflect": (d, n),
            "refract": (d, n, eta), "reflectance": (cos, eta),
            "gamma2_encode": (np.abs(v),)}[fn]
    a = getattr(jvm, fn)(*(jnp.asarray(x) for x in args))
    b = getattr(tvm, fn)(*(torch.from_numpy(x) for x in args))
    np.testing.assert_allclose(_np(b), _np(a), atol=1e-6, rtol=1e-6)
    assert tvm.NEAR_ZERO_EPS == jvm.NEAR_ZERO_EPS


def test_concentric_disk_map_matches():
    g = np.random.default_rng(3)
    uv = g.uniform(-1, 1, (1024, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [0, 0.5], [0.5, 0], [-1, 1]]  # branch edges
    a = jdisk(jnp.asarray(uv))
    b = pt.concentric_disk_map(torch.from_numpy(uv))
    # sin/cos from two libraries: a couple of ulps.
    np.testing.assert_allclose(_np(b), _np(a), atol=2e-7, rtol=0)
    assert (np.linalg.norm(_np(b), axis=-1) <= 1 + 1e-6).all()


def test_pixel_coords_and_height():
    for w in (64, 400, 1920):
        assert image_height_for(w) == rtw.image_height_for(w)
    uj, vj = rtw.pixel_coords(64, 36)
    ut, vt = pixel_coords(64, 36)
    np.testing.assert_array_equal(_np(ut), _np(uj))
    np.testing.assert_array_equal(_np(vt), _np(vj))


def test_skycolor_matches():
    g = np.random.default_rng(4)
    d = g.normal(size=(300, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(pt.skycolor(torch.from_numpy(d))),
                               _np(jsky(jnp.asarray(d))), atol=1e-7, rtol=0)


def test_attr_mat_and_gather_fetch():
    # The [N,10] column order is the interface the kernels share; the fetch
    # is a plain gather, exact.
    sj = rtw.scene_random_spheres(seed=1)
    am = attr_mat(pt.scene_from_numpy(sj))
    np.testing.assert_array_equal(_np(am), _np(jattr_mat(sj)))
    idx = torch.from_numpy(np.random.default_rng(5).integers(
        0, am.shape[0], 777).astype(np.int32))
    planes = fetch_attr_planes(idx, am)
    assert planes.shape == (10, 777) and planes.is_contiguous()
    np.testing.assert_array_equal(_np(planes), _np(am)[_np(idx)].T)


def test_image_output(tmp_path):
    g = np.random.default_rng(6)
    img = g.uniform(-0.1, 1.1, (9, 16, 3)).astype(np.float32)
    np.testing.assert_array_equal(to_uint8(torch.from_numpy(img)),
                                  jto_uint8(img))
    path = tmp_path / "x.png"
    write_png(torch.from_numpy(img), str(path))
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and b"IHDR" in data
