"""The port's single-launch small-image render (K8, ``ops/inline.py``)
against the JAX package.

- The plain K8 (``trace_inline_ref``) against the JAX package's
  ``trace_inline(interpret=True)`` on the same rays and injected uniforms.
- ``render_inline_sum`` against the JAX package's at spp 1 with its own
  uniforms injected; depth semantics; the centered rule of global sample 0;
  sample grouping past the lane budget.
- The route pick of ``render_tile_sum`` and the inline route against the
  strided one.
- Card-only: the CUDA kernel K8 against its plain version.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu import rng as jrng
from raytracingweekend_jl_tpu.camera import get_rays as jget_rays
from raytracingweekend_jl_tpu.ops.pallas import inline_kernel as JI
from raytracingweekend_jl_tpu.render import pixel_coords as jpixel_coords
from raytracingweekend_jl_tpu.scene import trim_scene as jtrim
from raytracingweekend_jl_tpu_torch.camera import sample_pass_rays
from raytracingweekend_jl_tpu_torch.ops import inline as IN
from raytracingweekend_jl_tpu_torch.ops.cuda import inline_kernel as K8
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

# The module (the package's ``render`` attribute is the function).
R = importlib.import_module("raytracingweekend_jl_tpu_torch.render")

KEY = jax.random.PRNGKey(3)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mirror():
    """A fuzz-0 metal ground under an aperture-0 camera: no draw reaches
    the render."""
    return (rtw.make_scene([rtw.metal((0, -100.0, 0), 99.0, (0.8, 0.6, 0.4),
                                      0.0)]),
            rtw.default_camera((0, 2, 0), (1, 1, 0)))


CASES = {
    # name: (JAX scene and camera, depth, share of lanes within tolerance)
    "sky_only": (lambda: (rtw.make_scene([]), rtw.t_default_cam()), 16, 1.0),
    "mirror": (_mirror, 16, 1.0),
    "4_spheres": (lambda: (rtw.scene_4_spheres(), rtw.t_default_cam()), 16,
                  0.99),
    "diel_spheres_hollow": (lambda: (rtw.scene_diel_spheres_hollow(),
                                     rtw.hollow_glass_cam()), 16, 0.99),
}


def _rays(cam, W=32, H=18):
    u, v = jpixel_coords(W, H)
    o, d = jget_rays(cam, u, v, jrng.purpose_key(KEY, jrng.LENS))
    return np.array(o), np.array(d)


@pytest.mark.parametrize("name", sorted(CASES))
def test_trace_inline_ref_matches_jax(name):
    # The plain K8 (the running select of _sweep_select written out, then
    # the shade core) against the JAX kernel in interpret mode on the same
    # 32x18 camera rays and uniforms [16, 5, R] from a numpy seed. Sky-only
    # and the fuzz-0 mirror: every lane within 1e-6 (no draw reaches them).
    # 4_spheres and hollow glass: within 1e-5 * max(1, |x|) on >= 99% of
    # lanes (measured: 100% and 100%, max difference 4.8e-6 and 6.1e-6;
    # XLA contracts FMA, so a last-bit difference can change a path).
    make, depth, share = CASES[name]
    scene_j, cam_j = make()
    scene_j = jtrim(scene_j)
    o, d = _rays(cam_j)
    u5 = np.random.default_rng(2).random((depth, 5, o.shape[0]),
                                         dtype=np.float32)
    ref = np.asarray(JI.trace_inline(scene_j, jnp.asarray(o), jnp.asarray(d),
                                     0, depth, 1e-4, interpret=True,
                                     rng_u5=jnp.asarray(u5)))
    out = K8.trace_inline_ref(pt.scene_from_numpy(scene_j),
                              torch.from_numpy(o), torch.from_numpy(d), 0,
                              depth, 1e-4, torch.from_numpy(u5)).numpy()
    assert out.shape == ref.shape and np.isfinite(out).all()
    if share == 1.0:
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    else:
        ok = (np.abs(out - ref) <= 1e-5 * np.maximum(1, np.abs(ref))).all(1)
        assert ok.mean() >= share, ok.mean()


def _jax_scatter_u5(n_pix, depth, s0=0):
    """The JAX inline driver's own interpret-mode scatter draws of the pass
    starting at global sample ``s0``."""
    key_p = jax.random.fold_in(KEY, s0)
    return torch.from_numpy(np.array(jax.random.uniform(
        jrng.purpose_key(key_p, jrng.SCATTER_DIR), (depth, 5, n_pix),
        dtype=jnp.float32)))


def _both_sums(scene_j, cam_j, W, H, spp, depth, inject=True, offset=0):
    u, v = jpixel_coords(W, H)
    fw, fh = float(np.float32(W)), float(np.float32(H))
    a = np.asarray(JI.render_inline_sum(scene_j, cam_j, u, v, KEY, spp,
                                        offset, depth, 1e-4, fw, fh,
                                        interpret=True))
    hook = (lambda p: _jax_scatter_u5(W * H, depth)) if inject else None
    b = IN.render_inline_sum(
        pt.trim_scene(pt.scene_from_numpy(scene_j)),
        pt.camera_from_numpy(cam_j), torch.from_numpy(np.array(u)),
        torch.from_numpy(np.array(v)), 0, spp, offset, depth, 1e-4, fw, fh,
        rng_u5_fn=hook).numpy()
    return a, b


def test_render_inline_sum_matches_jax_at_spp_1():
    # Global sample 0 is centered and the camera has no aperture, so both
    # drivers trace the same camera rays; the port is fed the JAX driver's
    # own scatter draws. Per pixel within 1e-5 * max(1, |x|) on >= 99% of
    # the 32x18 pixels of 4_spheres (measured: 100%, max difference
    # 8.4e-6).
    a, b = _both_sums(rtw.scene_4_spheres(), rtw.t_default_cam(), 32, 18, 1,
                      16)
    ok = (np.abs(b - a) <= 1e-5 * np.maximum(1, np.abs(a))).all(1)
    assert ok.mean() >= 0.99, ok.mean()


@pytest.mark.parametrize("depth", [0, 1])
def test_inline_depth_semantics(depth):
    # max_depth 1: a miss banks the sky, a hit scatters once and its path
    # ends black, so no draw reaches the image and the port's own Philox
    # draws give the JAX image within 1e-6; max_depth 0 renders black (the
    # JAX driver cannot trace zero bounces).
    if depth == 0:
        u, v = pt.pixel_coords(32, 18)
        out = IN.render_inline_sum(pt.trim_scene(pt.scene_2_spheres()),
                                   pt.t_default_cam(), u, v, 0, 1, 0, 0,
                                   1e-4, 32.0, 18.0)
        assert out.shape == (32 * 18, 3) and (out == 0).all()
        return
    a, b = _both_sums(rtw.scene_2_spheres(), rtw.t_default_cam(), 32, 18, 1,
                      depth, inject=False)
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
    assert (a > 0).any()


def test_centered_rule_for_global_sample_0():
    # Only global sample 0 is centered: its rays are the pixel-center rays
    # exactly, the next sample's are jittered; an offset render differs.
    cam = pt.t_default_cam()
    u, v = pt.pixel_coords(16, 9)
    o, d = sample_pass_rays(cam, u, v, 5, 0, 2, 16.0, 9.0)
    o0, d0 = pt.make_rays(cam, u, v, torch.zeros((u.shape[0], 2)))
    n = u.shape[0]
    assert torch.equal(o[:n], o0) and torch.equal(d[:n], d0)
    assert not torch.allclose(d[n:], d0)
    scene = pt.trim_scene(pt.scene_2_spheres())
    a = IN.render_inline_sum(scene, cam, u, v, 1, 2, 0, 8, 1e-4, 16.0, 9.0)
    b = IN.render_inline_sum(scene, cam, u, v, 1, 2, 2, 8, 1e-4, 16.0, 9.0)
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    assert not torch.equal(a, b)


def test_sample_grouping_past_the_lane_budget(monkeypatch):
    # With the lane budget cut to two images' worth, spp 4 runs as two
    # launches of two samples each (the largest divisor that fits, as the
    # JAX driver picks), keyed by each group's first sample; the image
    # agrees statistically with the one-launch render on the mirror scene
    # (sample 0 is jitter-free in both).
    scene_j, cam_j = _mirror()
    scene = pt.trim_scene(pt.scene_from_numpy(scene_j))
    cam = pt.camera_from_numpy(cam_j)
    W, H, spp = 32, 18, 4
    u, v = pt.pixel_coords(W, H)
    full = IN.render_inline_sum(scene, cam, u, v, 0, spp, 0, 16, 1e-4,
                                float(W), float(H))
    launches = []
    real = K8.trace_inline_ref

    def spy(sc, o, d, seed, *a):
        launches.append((o.shape[0], seed))
        return real(sc, o, d, seed, *a)

    monkeypatch.setattr(K8, "trace_inline_ref", spy)
    monkeypatch.setattr(IN, "INLINE_MAX_LANES", W * H * 2)
    assert [IN.inline_samples_per_pass(W * H, s) for s in (1, 2, 3, 4, 6)] \
        == [1, 2, 1, 2, 2]
    grouped = IN.render_inline_sum(scene, cam, u, v, 0, spp, 0, 16, 1e-4,
                                   float(W), float(H))
    assert [n for n, _ in launches] == [2 * W * H] * 2
    assert launches[0][1] != launches[1][1]
    assert torch.isfinite(grouped).all()
    assert abs(float(grouped.mean() - full.mean())) < 0.01 * spp
    assert float((grouped - full).abs().mean()) / spp < 0.06


@pytest.mark.parametrize("W,H,scene_name,kw,route", [
    (64, 36, "4_spheres", {}, "inline"),
    (256, 256, "4_spheres", {}, "inline"),              # 65 536 pixels
    (400, 225, "4_spheres", {}, "inline"),              # 8 spheres <= 64
    (400, 225, "random_spheres", {}, "strided"),        # 488 spheres
    (512, 288, "4_spheres", {}, "strided"),             # > 131 072 pixels
    (64, 36, "4_spheres", {"pixel_chunk": 1000}, "strided"),
    (64, 36, "4_spheres", {"inline": False}, "strided"),
    (512, 288, "4_spheres", {"inline": True}, "inline"),
])
def test_forward_route_pick(monkeypatch, W, H, scene_name, kw, route):
    # The reference's pick: a full image of at most 65 536 pixels, or at
    # most 131 072 with at most 64 spheres, renders inline; a chunk, a
    # larger image or inline=False takes the strided integrator.
    taken = []

    def stub(name):
        def run(scene, cam, n_pix_or_u, *a, **k):
            n = n_pix_or_u if isinstance(n_pix_or_u, int) \
                else n_pix_or_u.shape[0]
            taken.append(name)
            return torch.zeros((n, 3))
        return run

    monkeypatch.setattr(R, "render_inline_sum", stub("inline"))
    monkeypatch.setattr(R, "persistent_render_sum_strided", stub("strided"))
    scene = (pt.scene_4_spheres() if scene_name == "4_spheres"
             else pt.scene_random_spheres(seed=1))
    img = pt.render_radiance(scene, pt.t_default_cam(), W, 1,
                             image_height=H, device="cpu", persistent=True,
                             **kw)
    assert img.shape == (H, W, 3)
    assert set(taken) == {route}


def test_inline_refuses_a_generator():
    # The generator feeds the strided route's strip-0 draws; the inline
    # route draws its camera rays per pass and says so.
    g = torch.Generator().manual_seed(1)
    with pytest.raises(ValueError, match="inline=False"):
        pt.render_radiance(pt.scene_2_spheres(), pt.t_default_cam(), 16, 1,
                           device="cpu", generator=g, persistent=True)
    img = pt.render_radiance(pt.scene_2_spheres(), pt.t_default_cam(), 16, 1,
                             device="cpu", generator=g, persistent=True,
                             inline=False)
    assert torch.isfinite(img).all()


def test_inline_render_agrees_with_the_strided_route():
    # The same image through both routes at spp 8 (independent draws):
    # every channel mean within 1% (measured: within 0.14%; 0.22% and
    # 0.30% at seeds 5 and 7).
    scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
    a = pt.render_radiance(scene, cam, 64, 8, seed=3, device="cpu",
                           persistent=True)
    b = pt.render_radiance(scene, cam, 64, 8, seed=3, device="cpu",
                           persistent=True, inline=False)
    ma, mb = a.mean((0, 1)), b.mean((0, 1))
    assert ((ma - mb).abs() <= 0.01 * mb).all(), (ma, mb)


def test_trace_inline_wrapper_runs_plain_on_the_cpu():
    scene = pt.trim_scene(pt.scene_4_spheres())
    o, d = _rays(rtw.t_default_cam(), 16, 9)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    before = K8.launches
    assert torch.equal(pt.trace_inline(scene, o, d, 4, 8),
                       K8.trace_inline_ref(scene, o, d, 4, 8))
    assert K8.launches == before


@pytest.mark.cuda
def test_inline_kernel_matches_plain_on_card(cuda_device):
    # K8 against trace_inline_ref on the card, 4_spheres and hollow glass at
    # 256x144 camera rays, with injected and with Philox draws: bit for bit
    # on every lane, whatever order the work queue handed the lanes out in;
    # one launch per call.
    dev = cuda_device
    for scene_j, cam_j in ((rtw.scene_4_spheres(), rtw.t_default_cam()),
                           (rtw.scene_diel_spheres_hollow(),
                            rtw.hollow_glass_cam())):
        scene = pt.trim_scene(pt.scene_from_numpy(scene_j, device=dev))
        o, d = _rays(cam_j, 256, 144)
        o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        g = torch.Generator(device=dev).manual_seed(2)
        for u5 in (torch.rand((16, 5, o.shape[0]), generator=g, device=dev),
                   None):
            before = K8.launches
            a = K8.trace_inline(scene, o, d, 9, 16, 1e-4, u5)
            assert K8.launches == before + 1
            b = K8.trace_inline_ref(scene, o, d, 9, 16, 1e-4, u5)
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
