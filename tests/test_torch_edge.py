"""The port's edge (silhouette) gradient estimator (``ops/edge.py``)
against the JAX package and against its own contracts, the port's versions
of ``tests/test_edge.py``: the primal bit for bit the keyed trace, the
silhouette planes consistent with the sweep, the center gradient against
finite differences, the radius sign, a geometry fit that descends, metal
with the automatic sigma, checkpointed chunks, hollow glass, the misuse
errors, the per-ray recompute against dense autograd and finite gradients
on padded scenes and sky rays. All on the CPU (the sweep's plain version);
``test_edge_primal_on_card`` repeats the primal's contract on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.edge import (
    render_radiance_edge as jrender_edge)
from raytracingweekend_jl_tpu_torch import optimize as O
from raytracingweekend_jl_tpu_torch import rng
from raytracingweekend_jl_tpu_torch.camera import get_rays
from raytracingweekend_jl_tpu_torch.ops import edge as E
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
from raytracingweekend_jl_tpu_torch.ops.intersect import BIG
from test_torch_optimize import _mirror_world
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

W, H, SPP = 64, 36, 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ground_scene(pad_to=8):
    return pt.make_scene([pt.lambertian((0, 0, -1), 0.5, (0.7, 0.3, 0.3)),
                          pt.lambertian((0, -100.5, -1), 100,
                                        (0.8, 0.8, 0.0))], pad_to=pad_to)


def _camera_rays(cam, w, h, seed=0):
    u, v = pt.pixel_coords(w, h)
    return get_rays(cam, u, v, generator=rng.generator(seed, rng.LENS, 0))


def _edge_loss(scene, cam, target, **kw):
    img = E.render_radiance_edge(scene, cam, W, SPP, image_height=H, seed=0,
                                 device="cpu", **kw)
    return torch.mean((img - target) ** 2)


@pytest.mark.parametrize("edge_bounces", [1, 2])
def test_edge_matches_jax_on_the_mirror_world(edge_bounces):
    # The fuzz-0 mirror world at 32x18, spp 1, sigma 0.05: no draw reaches
    # the render, so both packages trace the same paths. The radiance by
    # the rule the trace tests hold the two sweeps to (the JAX package's
    # dot form against the port's expanded form): 1e-5 * max(1, |x|) on
    # >= 99.9% of the values, at least one free, and 1e-4 on all
    # (measured: max 3.3e-5 and 1.4e-5). The center and radius gradients of
    # a weighted sum of the image within 2e-3 of each field's largest
    # magnitude (measured 3.1e-4 and 1.2e-4, 6.7e-5 and 2.3e-5).
    scene_j, cam_j = _mirror_world()
    w, h = 32, 18
    wgt = np.random.default_rng(0).random((h, w, 3)).astype(np.float32)

    def loss_j(c, r):
        img = jrender_edge(scene_j._replace(center=c, radius=r), cam_j, w,
                           1, image_height=h, seed=0, sigma=0.05,
                           edge_bounces=edge_bounces)
        return jnp.sum(img * wgt), img

    (_, img_j), (gc_j, gr_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(scene_j.center, scene_j.radius)
    sp, cp = pt.scene_from_numpy(scene_j), pt.camera_from_numpy(cam_j)
    c = sp.center.clone().requires_grad_(True)
    r = sp.radius.clone().requires_grad_(True)
    img = E.render_radiance_edge(sp._replace(center=c, radius=r), cp, w, 1,
                                 image_height=h, seed=0, sigma=0.05,
                                 edge_bounces=edge_bounces, device="cpu")
    (img * torch.from_numpy(wgt)).sum().backward()
    got, want = img.detach().numpy().ravel(), np.asarray(img_j).ravel()
    diff = np.abs(got - want)
    assert diff.max() <= 1e-4
    assert (diff > 1e-5 * np.maximum(1, np.abs(want))).sum() <= max(
        1, int(1e-3 * want.size))
    for g, gj in ((c.grad, gc_j), (r.grad, gr_j)):
        gj = np.asarray(gj)
        assert np.isfinite(g.numpy()).all()
        assert np.abs(g.numpy() - gj).max() <= 2e-3 * np.abs(gj).max()


@pytest.mark.parametrize("case", ["ground_0", "ground_1", "ground_2",
                                  "hollow_glass_1"])
def test_edge_primal_is_the_keyed_trace(case):
    # The straight-through blend is zero in value: trace_edge is
    # trace(keyed=True) bit for bit at 64x36, with no, one and two edge
    # bounces, on the ground scene and on hollow glass (negative radius).
    name, eb = case.rsplit("_", 1)
    if name == "ground":
        scene, cam = _ground_scene(), pt.t_default_cam()
    else:
        scene, cam = pt.scene_diel_spheres_hollow(), pt.hollow_glass_cam()
    o, d = _camera_rays(cam, W, H, seed=2)
    seed = rng.purpose_seed(2, rng.SCATTER_DIR, 0) & 0xFFFFFFFF
    ref = pt.trace(scene, o, d, seed, keyed=True, impl="plain")
    out = E.trace_edge(scene, o, d, seed, sigma=0.05, edge_bounces=int(eb),
                       impl="plain")
    assert torch.equal(out, ref)


def test_silhouette_coords_match_the_sweep():
    # The planes' hard result is sweep_ref's bit for bit (t and idx, first
    # index on ties); sky rays cross the ground sphere's line only behind
    # the origin, so it is never rooted for them.
    scene, cam = _ground_scene(), pt.t_default_cam()
    o, d = _camera_rays(cam, W, H, seed=3)
    t, idx, s, t_int, rooted = E.silhouette_coords(o, d, scene)
    t_r, i_r = K1.sweep_ref(torch.cat([o.T, d.T]).contiguous(),
                            K1.sphere_consts(scene))
    assert torch.equal(t, t_r) and torch.equal(idx, i_r)
    assert torch.equal(torch.where(rooted, t_int, torch.full_like(t_int, BIG))
                       .min(1).values, t_r)
    sky_up = (d[:, 1] > 0.3) & (t >= BIG)
    assert int(sky_up.sum()) > 100
    assert not bool(rooted[sky_up, 1].any())
    assert bool((s[:, 2:] == -1e9).all())  # padding: never an edge


@pytest.mark.parametrize("disp", [(0.2, 0, 0), (0, 0, 0.2), (0, 0.15, 0)])
def test_edge_center_gradient_against_fd(disp):
    # Finite differences of the hard loss (the default render) against the
    # edge gradient at spp 2, cosine >= 0.8 on the ground scene: the
    # configuration where interior-only autodiff is wrong in sign (the y
    # case is the contact shadow, which needs the without-branch behind
    # e). The finite differences render at spp 16, not the JAX package's
    # 2: at spp 2 the port's streams give differences dominated by noise
    # (the y case's ranged from (0.010, 0.029, -0.013) to (0.123, 0.121,
    # 0.148) over two seeds, while the edge gradient stayed near (0.001,
    # 0.075, 0.060)); measured cosines 0.943, 0.990, 0.911.
    scene, cam = _ground_scene(), pt.t_default_cam()
    target = pt.render_radiance(scene, cam, W, SPP, image_height=H, seed=7,
                                device="cpu")
    c0 = scene.center.clone()
    c0[0] += torch.tensor(disp)
    c = c0.clone().requires_grad_(True)
    _edge_loss(scene._replace(center=c), cam, target, sigma=0.05,
               edge_bounces=1).backward()
    g = c.grad[0].double().numpy()

    def loss_plain(center):
        img = pt.render_radiance(scene._replace(center=center), cam, W, 16,
                                 image_height=H, seed=0, device="cpu")
        return float(torch.mean((img - target) ** 2))

    eps, fd = 1e-3, np.zeros(3)
    for j in range(3):
        cp, cm = c0.clone(), c0.clone()
        cp[0, j] += eps
        cm[0, j] -= eps
        fd[j] = (loss_plain(cp) - loss_plain(cm)) / (2 * eps)
    cos = fd @ g / (np.linalg.norm(fd) * np.linalg.norm(g) + 1e-12)
    assert cos >= 0.8, (disp, fd, g, cos)


def test_edge_radius_gradient_is_positive_when_oversized():
    # Growing a sphere that should shrink raises the loss: dL/dr > 0 where
    # the radius exceeds the target's, a pure boundary signal.
    scene, cam = _ground_scene(), pt.t_default_cam()
    target = pt.render_radiance(scene, cam, W, SPP, image_height=H, seed=7,
                                device="cpu")
    r = scene.radius.clone()
    r[0] = 0.58
    r.requires_grad_(True)
    _edge_loss(scene._replace(radius=r), cam, target, sigma=0.05,
               edge_bounces=1).backward()
    assert float(r.grad[0]) > 0


def test_fit_scene_edge_descends_geometry():
    # An autodiff-only center fit (no probes) descends on 4_spheres at
    # 48x27 spp 2 (the JAX package's case, 10 steps here, not 25, for the
    # CPU's time): loss below 0.85x its start and the center error below
    # 0.6x (measured 0.0334 -> 0.0145 and 0.119 -> 0.037).
    scene_true = pt.scene_4_spheres()
    movable = O.movable_mask(scene_true)
    jit = np.random.default_rng(7).uniform(
        -0.12, 0.12, tuple(scene_true.center.shape)).astype(np.float32)
    jit[~movable] = 0.0
    scene0 = scene_true._replace(center=scene_true.center
                                 + torch.from_numpy(jit))
    cam = pt.t_default_cam()
    target = pt.render_radiance(scene_true, cam, 48, SPP, image_height=27,
                                seed=0, device="cpu")
    res = O.fit_scene(scene0, cam, target, 48, SPP, steps=10, seed=0,
                      lr_albedo=0.0, lr_center=1.2e-2, geom="edge",
                      edge_kwargs=dict(sigma=0.06, edge_bounces=1),
                      device="cpu")
    assert np.isfinite(res.losses).all()
    assert res.losses[-1] < 0.85 * res.losses[0], res.losses

    def err(s):
        return np.abs((s.center - scene_true.center).numpy())[movable].max()

    assert err(res.scene) < 0.6 * err(scene0)
    assert torch.equal(res.scene.center[~movable], scene0.center[~movable])


def test_edge_metal_with_auto_sigma():
    # A metal sphere with the per-ray footprint sigma (sigma=None): finite
    # loss and gradients, and the boundary term points x back toward the
    # target.
    scene = pt.make_scene([pt.metal((0, 0, -1), 0.5, (0.8, 0.7, 0.2), 0.1),
                           pt.lambertian((0, -100.5, -1), 100,
                                         (0.5, 0.5, 0.5))], pad_to=8)
    cam = pt.t_default_cam()
    target = pt.render_radiance(scene, cam, W, SPP, image_height=H, seed=7,
                                device="cpu")
    c = scene.center.clone()
    c[0, 0] += 0.15
    c.requires_grad_(True)
    loss = _edge_loss(scene._replace(center=c), cam, target, sigma=None,
                      sigma_px=1.5, edge_bounces=1)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    assert bool(torch.isfinite(c.grad).all())
    assert float(c.grad[0, 0]) > 0, c.grad[0]


def test_edge_remat_chunks_match_the_plain_chunks():
    # Checkpointed chunks recompute what the plain chunked render computes:
    # image and center gradient bit for bit (64x32, spp 1, 512-pixel
    # chunks).
    scene, cam = _ground_scene(), pt.t_default_cam()
    out = []
    for remat in (False, True):
        c = scene.center.clone().requires_grad_(True)
        img = E.render_radiance_edge(scene._replace(center=c), cam, 64, 1,
                                     image_height=32, seed=0, sigma=0.05,
                                     pixel_chunk=512, remat_chunks=remat,
                                     edge_bounces=1, device="cpu")
        (img * img).sum().backward()
        out.append((img.detach(), c.grad))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])


def test_edge_hollow_glass_gradients():
    # The hollow shell's negative radius through the edge path: finite,
    # non-zero center gradients.
    scene, cam = pt.scene_diel_spheres_hollow(), pt.hollow_glass_cam()
    c = scene.center.clone().requires_grad_(True)
    img = E.render_radiance_edge(scene._replace(center=c), cam, W, SPP,
                                 image_height=H, seed=0, sigma=0.05,
                                 edge_bounces=1, device="cpu")
    img.mean().backward()
    assert bool(torch.isfinite(c.grad).all())
    assert float(c.grad.abs().sum()) > 0


def test_edge_misuse_raises():
    # The JAX package's loud failures: remat_chunks without chunking above
    # 2^16 pixels, sigma=None without pix_angle, and render_kwargs with
    # geom="edge" (both fit functions).
    scene, cam = _ground_scene(), pt.t_default_cam()
    with pytest.raises(ValueError, match="remat_chunks"):
        E.render_radiance_edge(scene, cam, 512, 1, image_height=512, seed=0,
                               sigma=0.05, remat_chunks=True, device="cpu")
    o, d = _camera_rays(cam, 4, 2)
    with pytest.raises(ValueError, match="pix_angle"):
        E.trace_edge(scene, o, d, 0, sigma=None)
    target = torch.zeros((27, 48, 3))
    for fit in (O.fit_scene, O.fit_scene_scan):
        with pytest.raises(ValueError, match="render_kwargs"):
            fit(scene, cam, target, 48, 1, steps=1, geom="edge",
                render_kwargs={"recorded": True},
                edge_kwargs=dict(sigma=0.05), device="cpu")


def test_row_terms_match_dense_autograd():
    # The per-ray recompute from gathered rows (what the edge bounce
    # differentiates) against autograd through the dense [R, N] planes
    # gathered at the same spheres: values bit for bit; gradients w.r.t.
    # centers, radii, origins and directions within 1e-5 of each field's
    # largest magnitude (the sums over rays run in another order).
    scene = pt.scene_diel_spheres_hollow()
    o, d = _camera_rays(pt.hollow_glass_cam(), 48, 27, seed=4)
    g = np.random.default_rng(5)
    k = torch.from_numpy(g.integers(0, scene.n_spheres, o.shape[0]))
    wt, ws = (torch.from_numpy(g.random(o.shape[0]).astype(np.float32))
              for _ in range(2))
    outs = []
    for dense in (True, False):
        leaves = [x.clone().requires_grad_(True)
                  for x in (scene.center, scene.radius, o, d)]
        c, r, o_, d_ = leaves
        if dense:
            _, _, s, t_int, _ = E.silhouette_coords(
                o_, d_, scene._replace(center=c, radius=r))
            t_k = t_int.gather(1, k[:, None])[:, 0]
            s_k = s.gather(1, k[:, None])[:, 0]
        else:
            t_k, s_k = E.row_terms(o_, d_, c[k], r[k])
        (wt * t_k + ws * s_k).sum().backward()
        outs.append(((t_k.detach(), s_k.detach()),
                     [x.grad for x in leaves]))
    (vals_d, grads_d), (vals_r, grads_r) = outs
    assert all(torch.equal(a, b) for a, b in zip(vals_d, vals_r))
    for a, b in zip(grads_d, grads_r):
        assert bool(torch.isfinite(b).all())
        assert float((a - b).abs().max()) <= 1e-5 * float(a.abs().max())


def test_edge_gradients_finite_on_padded_scenes_and_sky_rays():
    # Zero-radius padding spheres kept in the table (trace_edge does not
    # trim) and rays that leave for the sky at every bounce: the loss and
    # every field's gradient finite, both with a fixed and an automatic
    # sigma.
    scene = _ground_scene(pad_to=16)
    cam = pt.t_default_cam()
    o, d = _camera_rays(cam, 32, 18, seed=1)
    up = torch.tensor([0.0, 1.0, 0.0]).expand(8, 3)
    o = torch.cat([o, torch.zeros((8, 3))])
    d = torch.cat([d, up])  # straight up: sky at the first bounce
    pa = E.pixel_angle(cam, 18.0)
    for sigma in (0.05, None):
        leaves = [x.clone().requires_grad_(True) for x in scene[:5]]
        sc = pt.Scene(*leaves, scene.mat)
        rad = E.trace_edge(sc, o, d, 9, sigma=sigma, pix_angle=pa,
                           edge_bounces=2, impl="plain")
        rad.sum().backward()
        assert bool(torch.isfinite(rad).all())
        for x in leaves:
            assert bool(torch.isfinite(x.grad).all()), sigma


@pytest.mark.cuda
def test_edge_primal_on_card(cuda_device):
    # On the card the bounces sweep through K1: the primal is still
    # trace(keyed=True) bit for bit, and the center gradient finite.
    scene = pt.scene_4_spheres(device=cuda_device)
    cam = pt.t_default_cam(device=cuda_device)
    u, v = pt.pixel_coords(200, 112, device=cuda_device)
    o, d = get_rays(cam, u, v, generator=rng.generator(
        0, rng.LENS, 0, device=cuda_device))
    ref = pt.trace(scene, o, d, 77, keyed=True)
    for eb in (1, 2):
        c = scene.center.clone().requires_grad_(True)
        out = E.trace_edge(scene._replace(center=c), o, d, 77, sigma=0.05,
                           edge_bounces=eb)
        assert torch.equal(out.detach(), ref)
        out.sum().backward()
        assert bool(torch.isfinite(c.grad).all())
