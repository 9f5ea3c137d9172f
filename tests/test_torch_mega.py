"""The port's megakernel forward renderer (K12's plain version,
``ops/experimental/mega.py``) against the JAX package's
``ops/pallas/experimental/mega_kernel.py`` in interpret mode: the exact
cases of the JAX package's own mega tests, and pixel for pixel with the
JAX draws injected; the megakernel against the pinned route with the same
draws, bitwise. Card-only: K12 against its plain version and the pinned
route."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.pallas.experimental.mega_kernel import (
    persistent_render_sum_mega as jmega, plane_rows)
from raytracingweekend_jl_tpu.scene import trim_scene as jtrim
from raytracingweekend_jl_tpu_torch.ops import integrator as I
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
from raytracingweekend_jl_tpu_torch.ops.cuda import mega_kernel as K12
from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
from raytracingweekend_jl_tpu_torch.ops.materials import (attr_mat,
                                                          fetch_attr_planes)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
from test_torch_pinned import SCENES, _jax_hooks

M = importlib.import_module("raytracingweekend_jl_tpu_torch.ops.experimental"
                            ".mega")

KEY = jax.random.PRNGKey(3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax_mega(scene_j, cam_j, W=48, H=27, spp=4, max_depth=16):
    u, v = rtw.pixel_coords(W, H)
    return np.asarray(jmega(scene_j, cam_j, u, v, KEY, spp, 0, max_depth,
                            1e-4, float(np.float32(W)), float(np.float32(H)),
                            interpret=True))


def _port_mega(scene_j, cam, W=48, H=27, spp=4, max_depth=16, seed=5,
               **hooks):
    u, v = pt.pixel_coords(W, H)
    return M.persistent_render_sum_mega(
        pt.scene_from_numpy(scene_j), cam, u, v, seed, spp, 0, max_depth,
        1e-4, float(W), float(H), **hooks).numpy()


def _jax_mega_hooks(R):
    """The JAX megakernel's draws in interpret mode as port hooks: the
    first rays' u4 (keyed by slot and sample, as the fused route's) and the
    per-iteration u9, drawn as ``(9, rows, 128)`` planes over the padded
    lanes, of which lane ``l`` is flat position ``l``."""
    u4, _ = _jax_hooks(R, KEY)
    rows = plane_rows(R)
    k0 = jax.random.fold_in(KEY, 0)
    u9 = jax.jit(lambda it: jax.random.uniform(jax.random.fold_in(k0, it),
                                               (9, rows, 128)))
    return u4, lambda it: torch.from_numpy(
        np.array(u9(it)).reshape(9, -1)[:, :R].copy())


@pytest.mark.parametrize("case", ["mirror", "sky", "depth_1"])
def test_mega_exact_cases_match_jax(case):
    # The JAX package's draw-free mega cases (tests/test_shade_kernel.py
    # test_mega_mirror_exact, _sky_exact, _depth_semantics; spp 1, sample 0
    # centred, aperture 0): the port's megakernel render with its own Philox
    # draws within the same atol of the JAX megakernel's, 1e-5 for the
    # fuzz-0 mirror and 1e-6 for the sky and depth 1.
    if case == "mirror":
        scene = rtw.make_scene([rtw.metal((0, -100.0, 0), 99.0,
                                          (0.8, 0.6, 0.4), 0.0)])
        cam_j = rtw.default_camera((0, 2, 0), (1, 1, 0))
        depth, atol = 16, 1e-5
    else:
        scene = rtw.make_scene([]) if case == "sky" else rtw.scene_2_spheres()
        cam_j = rtw.t_default_cam()
        depth, atol = (16, 1e-6) if case == "sky" else (1, 1e-6)
    ref = _jax_mega(scene, cam_j, spp=1, max_depth=depth)
    out = _port_mega(scene, pt.camera_from_numpy(cam_j), spp=1,
                     max_depth=depth)
    np.testing.assert_allclose(out, ref, atol=atol)
    assert out.mean() > 0


@pytest.mark.parametrize("name,share", [("4_spheres", 0.98),
                                        ("diel_spheres_hollow", 0.98)])
def test_mega_matches_jax_pixel_for_pixel(name, share):
    # 48x27 spp 4 with the JAX megakernel's u4 and u9 injected: every
    # channel mean within 0.5% (measured at most 0.038%) and pixels within
    # 1e-5 * max(1, |x|) on >= 98% (measured: 99.0% and 99.4%), the pinned
    # route's test bounds: the draws are positional per (iteration, lane),
    # so a last-bit change of t (the JAX interpret mode contracts FMA,
    # eager PyTorch does not) that alters a path's length shifts every
    # later draw of its lane.
    scene_fn, cam_name = SCENES[name]
    scene_j = scene_fn()
    ref = _jax_mega(scene_j, getattr(rtw, cam_name)())
    u4, u9_fn = _jax_mega_hooks(48 * 27)
    out = _port_mega(scene_j, getattr(pt, cam_name)(), init_u4=u4,
                     rng_u9_fn=u9_fn)
    assert np.isfinite(out).all()
    close = (np.abs(out - ref) <= 1e-5 * np.maximum(1, np.abs(ref))).all(-1)
    assert close.mean() >= share, close.mean()
    np.testing.assert_allclose(out.mean(0), ref.mean(0), rtol=5e-3)


def _k1_sweep_attr_planes(tables, rays, tmin, impl):
    """The pinned route's sweep and fetch as the card runs them (K1 and a
    gather), here through K1's plain version."""
    _, spheres, amat = tables
    t, idx = K1.sweep_ref(rays, spheres, tmin)
    return t, fetch_attr_planes(idx, amat)


@pytest.mark.parametrize("name", ["4_spheres", "random_spheres"])
def test_mega_equals_pinned_route_bitwise(monkeypatch, name):
    # With the same draws (Philox), the megakernel's plain version renders
    # bitwise the image of the pinned route that the card runs: K1, the
    # gather, K9. On the CPU that route's impl="plain" sweeps in the dot
    # form; here it sweeps through K1's plain version, as on the card.
    scene_fn, cam_name = SCENES[name]
    sc = pt.scene_from_numpy(jtrim(scene_fn()))
    cam = getattr(pt, cam_name)()
    u, v = pt.pixel_coords(32, 18)
    mega = M.persistent_render_sum_mega(sc, cam, u, v, 7, 2, 0, 16, 1e-4,
                                        32.0, 18.0)
    monkeypatch.setattr(I, "sweep_attr_planes", _k1_sweep_attr_planes)
    pinned = I.persistent_render_sum_fused(sc, cam, u, v, 7, 2, 0, 16, 1e-4,
                                           32.0, 18.0)
    assert torch.equal(mega, pinned)
    assert mega.sum() > 0


def test_mega_wrapper_on_cpu_runs_plain_version():
    # On CPU tensors mega_step runs its plain version (the sweep with the
    # fetch, then K9's plain version, in place) and counts no launch; the
    # renderer refuses float64 and a device that is neither the CPU nor
    # CUDA raises.
    sc = pt.trim_scene(pt.scene_4_spheres())
    cam = pt.t_default_cam()
    u, v = pt.pixel_coords(16, 9)
    n = u.shape[0]
    org, d = I.pinned_start_rays(cam, u, v, 1, 0, 16.0, 9.0)
    fs = torch.zeros((12, n))
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=torch.int32)
    ist[2] = 1
    cc = K2.pack_camera_consts(cam, 16, 9)
    spheres, amat = K1.sphere_consts(sc), attr_mat(sc)
    a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
    before = K12.launches
    K12.mega_step(*a, spheres, amat, u, v, cc, 3, 0, 1, 16, 1e-4)
    t, _, attrs = K1.sweep_fetch_ref(b[0][0:6], spheres, amat)
    K2.shade_and_regen_ref(*b, t, attrs, u, v, cc, 3, 0, 1, 16)
    assert K12.launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], fs)
    with pytest.raises(ValueError):
        K12.mega_step(fs.to("meta"), ist, spheres, amat, u, v, cc, 3, 0, 1,
                      16, 1e-4)
    with pytest.raises(NotImplementedError):
        M.persistent_render_sum_mega(pt.scene_4_spheres(dtype=torch.float64),
                                     cam, u, v, 1, 1, 0, 16, 1e-4, 16.0, 9.0)


@pytest.mark.cuda
def test_mega_kernel_matches_plain_on_card(cuda_device):
    # K12 on the card against its plain version at a mid-render state of
    # the flagship scene at 512x288, with injected and with Philox draws:
    # integer planes identical, float planes within 1e-6 * max(1, |x|) on
    # >= 99.99% of lanes; one launch per call. The megakernel render is
    # bitwise the pinned route's (K1, the gather, K9).
    dev = cuda_device
    sc = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    cam = pt.t_cam1(device=dev)
    W, H = 512, 288
    u, v = pt.pixel_coords(W, H, device=dev)
    n = u.shape[0]
    org, d = I.pinned_start_rays(cam, u, v, 0, 0, float(W), float(H))
    fs = torch.zeros((12, n), device=dev)
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=torch.int32, device=dev)
    ist[2] = 1
    cc = K2.pack_camera_consts(cam, W, H)
    spheres, amat = K1.sphere_consts(sc), attr_mat(sc)
    for it in range(12):
        K12.mega_step(fs, ist, spheres, amat, u, v, cc, 5, it, 3, 16, 1e-4)
    g = torch.Generator(device=dev).manual_seed(1)
    for u9 in (torch.rand((9, n), generator=g, device=dev), None):
        a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
        before = K12.launches
        K12.mega_step(*a, spheres, amat, u, v, cc, 5, 12, 3, 16, 1e-4, u9)
        torch.cuda.synchronize()
        assert K12.launches == before + 1
        K12.mega_step_ref(*b, spheres, amat, u, v, cc, 5, 12, 3, 16, 1e-4,
                          u9)
        ok = (a[1] == b[1]).all(0) & (
            (a[0] - b[0]).abs() <= 1e-6 * b[0].abs().clamp(min=1)).all(0)
        assert ok.float().mean() >= 0.9999
    mega = M.persistent_render_sum_mega(sc, cam, u, v, 9, 2, 0, 16, 1e-4,
                                        float(W), float(H))
    pinned = I.persistent_render_sum_fused(sc, cam, u, v, 9, 2, 0, 16, 1e-4,
                                           float(W), float(H))
    assert torch.equal(mega, pinned)
