"""The pixel-pinned persistent route of the port (K9's plain version
``shade_and_regen_ref``, ``persistent_render_sum_fused`` and the
non-contiguous-tile route of ``render_tile_sum``) against the JAX package's
``shade_and_regen`` and ``persistent_render_sum_fused`` in interpret mode,
fed the same uniforms, and the plain pinned body ``persistent_render_sum``
against the JAX package's. Card-only: K9 against its plain version
(``test_torch_pinned_fetch.py`` holds K9 with its fetch inside)."""

import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu import rng as jrng
from raytracingweekend_jl_tpu.ops.integrator import (
    persistent_render_sum as jpersistent,
    persistent_render_sum_fused as jfused)
from raytracingweekend_jl_tpu.ops.pallas.shade_kernel import (
    shade_and_regen as jshade_and_regen)
from raytracingweekend_jl_tpu.ops.sampling import per_ray_uniforms
from raytracingweekend_jl_tpu.scene import trim_scene as jtrim
from raytracingweekend_jl_tpu_torch.ops import integrator as I
from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

R = importlib.import_module("raytracingweekend_jl_tpu_torch.render")

KEY = jax.random.PRNGKey(3)

SCENES = {"4_spheres": (rtw.scene_4_spheres, "t_default_cam"),
          "diel_spheres_hollow": (rtw.scene_diel_spheres_hollow,
                                  "hollow_glass_cam"),
          "random_spheres": (lambda: rtw.scene_random_spheres(seed=1),
                             "t_cam1")}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _jax_hooks(R_, key=KEY, sample_offset=0):
    """The JAX fused route's draws in interpret mode: the first rays' u4
    keyed by (slot, sample) and the per-iteration u9 [9, R], as port
    hooks."""
    key_cam = jrng.purpose_key(key, jrng.PIXEL_JITTER)
    slots = jnp.arange(R_, dtype=jnp.int32)
    keys0 = jax.vmap(jax.random.fold_in)(
        jax.vmap(jax.random.fold_in, (None, 0))(key_cam, slots),
        jnp.full((R_,), sample_offset, jnp.int32))
    u4 = torch.from_numpy(np.array(per_ray_uniforms(keys0, 4)))
    k0 = jax.random.fold_in(key, sample_offset)
    u9 = jax.jit(lambda it: jax.random.uniform(jax.random.fold_in(k0, it),
                                               (9, R_)))
    return u4, lambda it: torch.from_numpy(np.array(u9(it)))


def _both(scene_j, cam_name, W=48, H=27, spp=4, max_depth=16, rows=None):
    """(port, JAX) radiance sums of persistent_render_sum_fused on the
    pixels ``rows`` (all by default) with the JAX draws injected."""
    u, v = rtw.pixel_coords(W, H)
    sel = np.arange(W * H) if rows is None else rows
    u, v = np.asarray(u)[sel], np.asarray(v)[sel]
    cam_j = getattr(rtw, cam_name)()
    ref = np.asarray(jfused(scene_j, cam_j, jnp.asarray(u), jnp.asarray(v),
                            KEY, spp, 0, max_depth, 1e-4, float(W), float(H),
                            interpret=True))
    u4, u9_fn = _jax_hooks(len(sel))
    out = I.persistent_render_sum_fused(
        pt.scene_from_numpy(scene_j), getattr(pt, cam_name)(),
        torch.from_numpy(u), torch.from_numpy(v), 0, spp, 0, max_depth, 1e-4,
        float(W), float(H), init_u4=u4, rng_u9_fn=u9_fn).numpy()
    return out, ref


@pytest.mark.parametrize("name", sorted(SCENES))
def test_pinned_step_matches_jax(name):
    # K9's plain version against shade_and_regen(interpret=True, rng_u9=...)
    # from the same mid-render states (iterations 6-8 of a 48x27 spp 4
    # render, last sample 3) on the same sweep results and uniforms: integer
    # planes identical, float planes within 1e-5 * max(1, |x|) on >= 99.9%
    # of lanes (measured: 100%, 100% and 99.92% of lanes, largest gaps
    # 1.3e-6, 4.6e-6, 1.1e-5; the JAX package's jitted interpret mode
    # contracts a*b+c into FMA, eager PyTorch does not).
    scene_fn, cam_name = SCENES[name]
    sj = jtrim(scene_fn())
    scene, cam = pt.scene_from_numpy(sj), getattr(pt, cam_name)()
    W, H, last, depth = 48, 27, 3, 16
    u, v = pt.pixel_coords(W, H)
    n = u.shape[0]
    org, d = I.pinned_start_rays(cam, u, v, 1, 0, float(W), float(H))
    fs = torch.zeros((12, n))
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=torch.int32)
    ist[2] = 1
    cc = K2.pack_camera_consts(cam, W, H)
    cc_j = jnp.asarray(cc.numpy())
    tables = (scene, I.intersect_kernel.sphere_consts(scene), attr_mat(scene))
    g = np.random.default_rng(0)
    for it in range(9):
        t, attrs = I.sweep_attr_planes(tables, fs[0:6], 1e-4, "plain")
        u9 = torch.from_numpy(g.random((9, n), dtype=np.float32))
        if it >= 6:
            state = tuple(jnp.asarray(x) for x in fs.numpy()) + tuple(
                jnp.asarray(x) for x in ist.numpy())
            ref = jshade_and_regen(state, jnp.asarray(t.numpy()),
                                   jnp.asarray(attrs.numpy()),
                                   jnp.asarray(u.numpy()),
                                   jnp.asarray(v.numpy()), cc_j, it, last,
                                   depth, 1e-4, interpret=True,
                                   rng_u9=jnp.asarray(u9.numpy()))
        K2.shade_and_regen_ref(fs, ist, t, attrs, u, v, cc, 0, it, last, depth,
                               u9)
        if it >= 6:
            rf = np.stack([np.asarray(x) for x in ref[:12]])
            ri = np.stack([np.asarray(x) for x in ref[12:]])
            np.testing.assert_array_equal(ist.numpy(), ri)
            ok = (np.abs(fs.numpy() - rf)
                  <= 1e-5 * np.maximum(1, np.abs(rf))).all(0)
            assert ok.mean() >= 0.999, (it, ok.mean())
    assert 0 < ist[2].sum() < n


def test_pinned_mirror_exact():
    # Draw-free paths (fuzz-0 metal, aperture 0, spp 1): the port's pinned
    # route equals the JAX package's within 1e-6 on every pixel (as the JAX
    # package's test_fused_mirror_exact holds its own two routes).
    scene = rtw.make_scene([rtw.metal((0, -100.0, 0), 99.0, (0.8, 0.6, 0.4),
                                      0.0)])
    cam = rtw.default_camera((0, 2, 0), (1, 1, 0))
    u, v = rtw.pixel_coords(48, 27)
    ref = np.asarray(jfused(scene, cam, u, v, KEY, 1, 0, 16, 1e-4, 48.0, 27.0,
                            interpret=True))
    out = I.persistent_render_sum_fused(
        pt.scene_from_numpy(scene), pt.camera_from_numpy(cam),
        torch.from_numpy(np.asarray(u)), torch.from_numpy(np.asarray(v)), 5,
        1, 0, 16, 1e-4, 48.0, 27.0).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert out.mean() > 0


def test_pinned_sky_only_exact():
    # An empty scene: every pixel is its centred ray's sky (spp 1).
    out, ref = _both(rtw.make_scene([]), "t_default_cam", spp=1)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_pinned_depth_semantics():
    # max_depth = 1: a hit dies black after one scatter, a miss banks the
    # sky; draw-free at spp 1, so the two routes agree within 1e-6.
    out, ref = _both(rtw.scene_2_spheres(), "t_default_cam", spp=1,
                     max_depth=1)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert (out == 0).all(-1).any() and (out > 0).all(-1).any()


@pytest.mark.parametrize("name,share", [("4_spheres", 0.99),
                                        ("diel_spheres_hollow", 0.98),
                                        ("random_spheres", 0.70)])
def test_pinned_route_matches_jax(name, share):
    # The whole K9 route (dot-form sweep, gather, K9's plain version) against
    # the JAX package's persistent_render_sum_fused(interpret=True) with its
    # u4 and u9 injected, 48x27 spp 4: every channel mean within 0.5%
    # (measured at most 0.21%); pixels within 1e-5 * max(1, |x|) on the
    # stated share (measured: 4_spheres 99.4%, diel_spheres_hollow 99.0%,
    # random_spheres 77.2%: the draws are positional per (iteration, lane),
    # so one last-bit change that alters a path's length shifts every later
    # draw of its lane).
    scene_fn, cam_name = SCENES[name]
    out, ref = _both(scene_fn(), cam_name)
    assert np.isfinite(out).all()
    close = (np.abs(out - ref) <= 1e-5 * np.maximum(1, np.abs(ref))).all(-1)
    assert close.mean() >= share, close.mean()
    np.testing.assert_allclose(out.mean(0), ref.mean(0), rtol=5e-3)


def _even_rows(W, H):
    return torch.arange(W * H).reshape(H, W)[::2].reshape(-1)


def test_non_contiguous_tile_takes_the_pinned_route(monkeypatch):
    # render_tile_sum routes as the reference package does: a tile given by
    # film coordinates that is neither the whole image nor a pixel_start
    # range takes the pixel-pinned integrator (the inline route when it is
    # small and inline is left to the pick); a pixel_start range and the
    # whole image the strided one.
    taken = []

    def stub(name):
        def run(scene, cam, n_or_u, *a, **k):
            taken.append(name)
            n = n_or_u if isinstance(n_or_u, int) else n_or_u.shape[0]
            return torch.zeros((n, 3))
        return run

    for fn, name in ((R.render_inline_sum, "inline"),
                     (R.persistent_render_sum_fused, "pinned"),
                     (R.persistent_render_sum_strided, "strided")):
        monkeypatch.setattr(R, fn.__name__, stub(name))
    scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
    W, H = 64, 36
    u, v = pt.pixel_coords(W, H)
    rows = _even_rows(W, H)
    n = rows.numel()
    cases = [(n, dict(u=u[rows], v=v[rows], inline=False), "pinned"),
             (n, dict(u=u[rows], v=v[rows]), "inline"),
             (n, dict(pixel_start=64, inline=False), "strided"),
             (W * H, dict(inline=False), "strided")]
    for n, kw, want in cases:
        pt.render_tile_sum(scene, cam, n, 0, 2, 0, 16, 1e-4, float(W),
                           float(H), persistent=True, **kw)
        assert taken[-1] == want, (kw, taken)
    with pytest.raises(ValueError, match="film coordinates"):
        pt.render_tile_sum(scene, cam, 100, 0, 1, 0, 16, 1e-4, float(W),
                           float(H), persistent=True)


def test_pinned_tile_estimates_the_strided_image():
    # The even rows of a 64x36 image through the K9 route on the CPU (the
    # plain versions) against the same rows of the strided render (other
    # draws): every channel mean within 3 standard errors of the per-pixel
    # difference.
    scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
    W, H, spp = 64, 36, 8
    u, v = pt.pixel_coords(W, H)
    rows = _even_rows(W, H)
    tile = pt.render_tile_sum(scene, cam, rows.numel(), 3, spp, 0, 16, 1e-4,
                              float(W), float(H), persistent=True,
                              u=u[rows], v=v[rows], inline=False) / spp
    full = pt.render_radiance(scene, cam, W, spp, seed=4, device="cpu",
                              persistent=True, inline=False).reshape(-1, 3)
    d = tile - full[rows]
    se = d.std(0) / d.shape[0] ** 0.5
    assert torch.isfinite(tile).all()
    assert (d.mean(0).abs() < 3 * se).all(), (d.mean(0), se)


def test_pinned_wrapper_on_cpu_runs_plain_version():
    # shade_and_regen (the previous K9, kept as the card's reference) on
    # CPU tensors runs its plain version (the same bits, in place, Philox
    # draws of (seed, iteration)) and counts no launch; the start rays'
    # draws are keyed by slot.
    n = 300
    g = torch.Generator().manual_seed(0)
    fs = torch.rand((12, n), generator=g)
    ist = torch.stack([torch.randint(0, 3, (n,), generator=g),
                       torch.randint(0, 2, (n,), generator=g),
                       torch.ones(n, dtype=torch.int64)]).to(torch.int32)
    t = torch.where(torch.rand(n, generator=g) < 0.5,
                    torch.rand(n, generator=g) + 0.1, torch.full((n,), 3e38))
    attrs = torch.rand((10, n), generator=g)
    attrs[9] = torch.randint(0, 3, (n,), generator=g).float()
    uv = torch.rand((2, n), generator=g)
    cc = K2.pack_camera_consts(pt.t_cam1(), 64, 36)
    a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
    before = K2.pinned_launches
    K2.shade_and_regen(*a, t, attrs, uv[0], uv[1], cc, 9, 4, 1, 16)
    K2.shade_and_regen_ref(*b, t, attrs, uv[0], uv[1], cc, 9, 4, 1, 16)
    assert K2.pinned_launches == before
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], fs)
    cam = pt.t_cam1()
    o1, d1 = I.pinned_start_rays(cam, uv[0], uv[1], 2, 1, 64.0, 36.0)
    o2, d2 = I.pinned_start_rays(cam, uv[0, :7], uv[1, :7], 2, 1, 64.0, 36.0)
    assert torch.equal(d1[:7], d2) and torch.equal(o1[:7], o2)


@pytest.mark.cuda
def test_pinned_kernel_matches_plain_on_card(cuda_device):
    # K9 (the winner's row fetched by index inside) against its plain
    # version on the card at a mid-render state of the even rows of a
    # 512x288 image, with injected and with Philox draws: integer planes
    # identical, float planes within 1e-6 * max(1, |x|) on >= 99.99% of
    # lanes; one launch per call.
    dev = cuda_device
    torch.backends.cuda.matmul.allow_tf32 = False
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    cam = pt.t_cam1(device=dev)
    W, H = 512, 288
    u, v = pt.pixel_coords(W, H, device=dev)
    rows = _even_rows(W, H).to(dev)
    u, v = u[rows].contiguous(), v[rows].contiguous()
    n = u.shape[0]
    org, d = I.pinned_start_rays(cam, u, v, 0, 0, float(W), float(H))
    fs = torch.zeros((12, n), device=dev)
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=torch.int32, device=dev)
    ist[2] = 1
    cc = K2.pack_camera_consts(cam, W, H)
    tables = (scene, I.intersect_kernel.sphere_consts(scene), attr_mat(scene))
    for it in range(12):
        t, idx = I.sweep_hits(tables, fs[0:6], 1e-4, "kernels")
        K2.shade_and_regen_fetch(fs, ist, t, idx, tables[2], u, v, cc, 5, it,
                                 3, 16)
    t, idx = I.sweep_hits(tables, fs[0:6], 1e-4, "kernels")
    g = torch.Generator(device=dev).manual_seed(1)
    for u9 in (torch.rand((9, n), generator=g, device=dev), None):
        a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
        before = K2.pinned_launches
        K2.shade_and_regen_fetch(*a, t, idx, tables[2], u, v, cc, 5, 12, 3, 16,
                                 u9)
        torch.cuda.synchronize()
        assert K2.pinned_launches == before + 1
        K2.shade_and_regen_fetch_ref(*b, t, idx, tables[2], u, v, cc, 5, 12,
                                     3, 16, u9)
        ok = (a[1] == b[1]).all(0) & (
            (a[0] - b[0]).abs() <= 1e-6 * b[0].abs().clamp(min=1)).all(0)
        assert ok.float().mean() >= 0.9999


def _jax_xla_pinned(scene_j, cam_name, W=48, H=27, spp=1, max_depth=16):
    u, v = rtw.pixel_coords(W, H)
    return np.asarray(jpersistent(scene_j, getattr(rtw, cam_name)(), u, v,
                                  KEY, spp, 0, max_depth, 1e-4, float(W),
                                  float(H)))


def _port_xla_pinned(scene_j, cam_name, W=48, H=27, spp=1, max_depth=16,
                     seed=5):
    u, v = pt.pixel_coords(W, H)
    return I.persistent_render_sum(pt.scene_from_numpy(scene_j),
                                   getattr(pt, cam_name)(), u, v, seed, spp,
                                   0, max_depth, 1e-4, float(W),
                                   float(H)).numpy()


@pytest.mark.parametrize("case", ["mirror", "sky_only", "depth_1"])
def test_plain_pinned_body_exact_cases(case):
    # The plain pixel-pinned body (persistent_render_sum, keyed draws)
    # against the JAX package's on its draw-free cases: within 1e-6.
    if case == "mirror":
        scene = rtw.make_scene([rtw.metal((0, -100.0, 0), 99.0,
                                          (0.8, 0.6, 0.4), 0.0)])
        cam_j = rtw.default_camera((0, 2, 0), (1, 1, 0))
        u, v = rtw.pixel_coords(48, 27)
        ref = np.asarray(jpersistent(scene, cam_j, u, v, KEY, 1, 0, 16, 1e-4,
                                     48.0, 27.0))
        out = I.persistent_render_sum(
            pt.scene_from_numpy(scene), pt.camera_from_numpy(cam_j),
            torch.from_numpy(np.asarray(u)), torch.from_numpy(np.asarray(v)),
            5, 1, 0, 16, 1e-4, 48.0, 27.0).numpy()
    else:
        scene = rtw.make_scene([]) if case == "sky_only" \
            else rtw.scene_2_spheres()
        depth = 16 if case == "sky_only" else 1
        ref = _jax_xla_pinned(scene, "t_default_cam", max_depth=depth)
        out = _port_xla_pinned(scene, "t_default_cam", max_depth=depth)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    assert out.mean() > 0


def test_plain_pinned_body_matches_statistically():
    # Independent streams on 4_spheres, 48x27 spp 16: the per-pixel
    # difference of the port's plain pinned body and the JAX package's has
    # channel means within 3 standard errors, and the fused K9 route
    # estimates the same image.
    ref = _jax_xla_pinned(rtw.scene_4_spheres(), "t_default_cam", spp=16)
    out = _port_xla_pinned(rtw.scene_4_spheres(), "t_default_cam", spp=16)
    fused, _ = _both(rtw.scene_4_spheres(), "t_default_cam", spp=16)
    assert np.isfinite(out).all()
    for other in (ref, fused):
        d = (out - other).reshape(-1, 3) / 16
        se = d.std(0) / np.sqrt(d.shape[0])
        assert (np.abs(d.mean(0)) < 3 * se).all(), (d.mean(0), se)
