"""The fixed-depth wavefront of the port (``ops/integrator.trace``, the
scatter stage, the differentiable sweeps, the default render route and the
remat gradient route) against the JAX package on the same inputs and draws.
Card-only: the trace through K1 and K10 against its plain path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.camera import get_rays as jget_rays
from raytracingweekend_jl_tpu.ops.integrator import trace as jtrace
from raytracingweekend_jl_tpu.ops.integrator import (
    trace_occupancy as jtrace_occupancy)
from raytracingweekend_jl_tpu.ops.materials import scatter as jscatter
from raytracingweekend_jl_tpu.ops.sampling import (
    unit_sphere_directions as jusd)
from raytracingweekend_jl_tpu.scene import trim_scene as jtrim
from raytracingweekend_jl_tpu_torch import grad as G
from raytracingweekend_jl_tpu_torch.ops import materials as M
from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.fused_grad import trace_recorded_fused
from raytracingweekend_jl_tpu_torch.ops.integrator import (
    trace, trace_compacted, trace_occupancy)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(7)

SCENES = {"4_spheres": (rtw.scene_4_spheres, rtw.t_default_cam),
          "diel_spheres_hollow": (rtw.scene_diel_spheres_hollow,
                                  rtw.hollow_glass_cam),
          "random_spheres": (lambda: rtw.scene_random_spheres(seed=1),
                             rtw.t_cam1)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _camera_rays(cam_j, W, H, seed=1):
    """Jittered camera rays of a ``W x H`` film, as numpy [R, 3] arrays."""
    g = np.random.default_rng(seed)
    u, v = rtw.pixel_coords(W, H)
    u = np.asarray(u) + g.random(W * H, dtype=np.float32) / W
    v = np.asarray(v) + g.random(W * H, dtype=np.float32) / H
    o, d = jget_rays(cam_j, jnp.asarray(u), jnp.asarray(v),
                     jax.random.PRNGKey(seed))
    return np.asarray(o), np.asarray(d)


def _jax_draws(R, key=KEY, depth=16):
    """The JAX trace's positional draws of every bounce, as a port hook."""
    out = []
    for b in range(depth):
        kd, kc = jax.random.split(jax.random.fold_in(key, b))
        out.append((torch.from_numpy(np.asarray(jusd(kd, (R,)))),
                    torch.from_numpy(np.asarray(jax.random.uniform(kc, (R,))))))
    return lambda b, n: out[b]


def _case(name, W=48, H=27):
    scene_j, cam_fn = SCENES[name]
    sj = jtrim(scene_j())
    o, d = _camera_rays(cam_fn(), W, H)
    return sj, o, d


def _port_grads(scene, o, d, target, weight=None, **kw):
    """``(radiance, {field: gradient})`` of the squared error of ``trace``
    against ``target`` (a mean, or a sum weighted by ``weight`` [R, 1] over
    R)."""
    kw.setdefault("seed", 0)
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in pt.DIFF_FIELDS}
    r = trace(scene._replace(**leaves), torch.from_numpy(o),
              torch.from_numpy(d), **kw)
    loss = (((r - target) ** 2).mean() if weight is None
            else (weight * (r - target) ** 2).sum() / r.shape[0])
    return r.detach(), dict(zip(pt.DIFF_FIELDS, torch.autograd.grad(
        loss, list(leaves.values()))))


def _cos_ratio(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na < 1e-12 and nb < 1e-12:
        return 1.0, 1.0
    return float(a @ b / (na * nb)), float(na / nb)


@pytest.mark.parametrize("mat", [0, 1, 2])
def test_scatter_matches_jax(mat):
    # materials.scatter against the JAX package's with the JAX draws
    # injected, every ray on one material (hollow glass: negative radius):
    # within 1e-6 * max(1, |x|) (measured: at most 1.8e-7).
    g = np.random.default_rng(mat)
    R = 2048
    sj = jtrim(rtw.scene_diel_spheres_hollow())
    sj = sj._replace(mat=jnp.full_like(sj.mat, mat),
                     fuzz=jnp.full_like(sj.fuzz, 0.3))
    o = g.uniform(-3, 3, (R, 3)).astype(np.float32)
    d = g.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hit = rtw.intersect_spheres(jnp.asarray(o), jnp.asarray(d), sj)
    t = np.where(np.asarray(hit.hit), np.asarray(hit.t), 1.0).astype(
        np.float32)
    idx = np.asarray(hit.index)
    key = jax.random.PRNGKey(mat)
    ref = jscatter(sj, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                   jnp.asarray(idx), key)
    kd, kc = jax.random.split(key)
    u = torch.from_numpy(np.asarray(jusd(kd, (R,))))
    xi = torch.from_numpy(np.asarray(jax.random.uniform(kc, (R,))))
    scene = pt.scene_from_numpy(sj)
    attrs = M.gather_sphere_attrs(scene, torch.from_numpy(idx),
                                  torch.float32)
    out = M.scatter(torch.from_numpy(o), torch.from_numpy(d),
                    torch.from_numpy(t), attrs, u, xi)
    for a, b in zip(out, ref):
        b = np.asarray(b)
        assert (np.abs(a.numpy() - b) <= 1e-6 * np.maximum(1, np.abs(b))).all()


@pytest.mark.parametrize("name,share", [("4_spheres", 0.99),
                                        ("diel_spheres_hollow", 0.99),
                                        ("random_spheres", 0.90)])
def test_trace_matches_jax(name, share):
    # trace (K1's plain version, gather, scatter) against the JAX package's
    # trace(use_pallas=False) with its positional draws injected, 48x27
    # jittered camera rays: per ray within 1e-5 * max(1, |x|) (measured:
    # 4_spheres 99.85%, hollow glass 100%, random_spheres 95.6%: the
    # expanded-form sweep and XLA's contracted dot form round t differently,
    # and a last-bit change at a hit can move the rest of that path), every
    # channel mean within 0.5% (measured at most 0.16%).
    sj, o, d = _case(name)
    R = o.shape[0]
    ref = np.asarray(jtrace(sj, jnp.asarray(o), jnp.asarray(d), KEY,
                            use_pallas=False))
    out = trace(pt.scene_from_numpy(sj), torch.from_numpy(o),
                torch.from_numpy(d), 0, draws=_jax_draws(R)).numpy()
    assert out.shape == (R, 3) and np.isfinite(out).all()
    close = (np.abs(out - ref) <= 1e-5 * np.maximum(1, np.abs(ref))).all(-1)
    assert close.mean() >= share, close.mean()
    np.testing.assert_allclose(out.mean(0), ref.mean(0), rtol=5e-3)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_grads_match_jax(name):
    # The MSE loss's gradients in all five fields against jax.grad of the
    # JAX trace(remat=True) with the same draws: cosine >= 0.999 and norm
    # ratio within 1% per field. The loss sums over the rays whose radiance
    # agrees within 1e-6 * max(1, |x|) in the forward (measured: 97.9%,
    # 98.6%, 88.0% of rays): a ray whose path diverged (see
    # test_trace_matches_jax) is a different path, and one grazing hit's
    # 1 / (p . d) can outweigh the rest of a small image. Measured: cosines
    # >= 0.999999, norm ratios within 2.5e-3; a field that no path reaches
    # (ir of 4_spheres) is zero in both.
    sj, o, d = _case(name)
    R = o.shape[0]
    ref = np.asarray(jtrace(sj, jnp.asarray(o), jnp.asarray(d), KEY,
                            use_pallas=False))
    out = trace(pt.scene_from_numpy(sj), torch.from_numpy(o),
                torch.from_numpy(d), 0, draws=_jax_draws(R)).numpy()
    same = (np.abs(out - ref) <= 1e-6 * np.maximum(1, np.abs(ref))).all(-1)
    assert same.mean() >= 0.85, same.mean()
    w = same.astype(np.float32)[:, None]
    tgt = np.full((R, 3), 0.3, np.float32)

    def jloss(params):
        r = jtrace(sj._replace(**params), jnp.asarray(o), jnp.asarray(d), KEY,
                   use_pallas=False, remat=True)
        return jnp.sum(w * (r - tgt) ** 2) / R

    gj = jax.grad(jloss)({f: getattr(sj, f) for f in pt.DIFF_FIELDS})
    _, gp = _port_grads(pt.scene_from_numpy(sj), o, d, torch.from_numpy(tgt),
                        weight=torch.from_numpy(w), remat=True,
                        draws=_jax_draws(R))
    for f in pt.DIFF_FIELDS:
        cos, ratio = _cos_ratio(gp[f].numpy(), gj[f])
        assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (f, cos, ratio)


def test_remat_and_fused_attrs_routes_agree():
    # remat=True and remat=False give bitwise-equal gradients (the recompute
    # redraws the same numbers); fused_attrs=True (K10's plain version and
    # its VJP) gives the same radiance bitwise and the same gradients within
    # 1e-6 * max(1, max|g|) (measured: 4.7e-10).
    sj, o, d = _case("diel_spheres_hollow", 32, 18)
    scene = pt.scene_from_numpy(sj)
    tgt = torch.full((o.shape[0], 3), 0.3)
    r0, g0 = _port_grads(scene, o, d, tgt, remat=False, seed=3)
    r1, g1 = _port_grads(scene, o, d, tgt, remat=True, seed=3)
    r2, g2 = _port_grads(scene, o, d, tgt, remat=True, seed=3,
                         fused_attrs=True)
    assert torch.equal(r0, r1) and torch.equal(r0, r2)
    for f in pt.DIFF_FIELDS:
        assert torch.equal(g0[f], g1[f]), f
        scale = max(1.0, g0[f].abs().max().item())
        assert (g2[f] - g0[f]).abs().max().item() <= 1e-6 * scale, f


def _edge_scenes():
    mirrors = pt.make_scene([pt.metal((0, -100.5, -1), 100.0, (0.8, 0.8, 0.8)),
                             pt.metal((0, 0, -1), 0.5, (0.9, 0.6, 0.3)),
                             pt.metal((1, 0, -1), 0.5, (0.7, 0.7, 0.9))])
    return {"hollow_glass": (pt.scene_diel_spheres_hollow(),
                             pt.hollow_glass_cam()),
            "fuzz0_mirrors": (mirrors, pt.t_default_cam()),
            "padded_4_spheres": (pt.scene_4_spheres(), pt.t_default_cam())}


@pytest.mark.parametrize("name", ["hollow_glass", "fuzz0_mirrors",
                                  "padded_4_spheres"])
def test_trace_grads_are_finite(name):
    # The NaN-under-where cases: a negative radius, fuzz-0 mirrors (the fuzz
    # gradient is the drawn vector's projection), radius-0 padding spheres
    # (kept here: no trim). Every field's gradient is finite through both
    # sweeps, and zero on the padding.
    scene, cam = _edge_scenes()[name]
    u, v = pt.pixel_coords(32, 18)
    o, d = pt.get_rays(cam, u, v, generator=torch.Generator().manual_seed(0))
    for fused in (False, True):
        leaves = {f: getattr(scene, f).clone().requires_grad_(True)
                  for f in pt.DIFF_FIELDS}
        r = trace(scene._replace(**leaves), o, d, 1, max_depth=8,
                  remat=True, fused_attrs=fused)
        loss = ((r - 0.4) ** 2).mean()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        assert torch.isfinite(r).all()
        live = int((scene.radius != 0).sum())
        for f, g in zip(pt.DIFF_FIELDS, grads):
            assert torch.isfinite(g).all(), (name, fused, f)
            assert (g[live:] == 0).all(), (name, fused, f)
        assert grads[2].abs().sum() > 0


def test_keyed_trace_matches_the_fixed_depth_pair():
    # keyed=True draws K7a's numbers (Philox by (seed, bounce), slot as the
    # counter), so the remat twin and the fixed-depth record/replay pair
    # trace the same paths: radiance within 1e-5 * max(1, |x|) on >= 99% of
    # rays (measured: 100%) and gradients with cosine >= 0.9999 (measured:
    # >= 0.999999998).
    sj, o, d = _case("4_spheres", 32, 18)
    scene = pt.scene_from_numpy(sj)
    tgt = torch.full((o.shape[0], 3), 0.3)
    r_k, g_k = _port_grads(scene, o, d, tgt, keyed=True, seed=11)
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in pt.DIFF_FIELDS}
    r_f = trace_recorded_fused(scene._replace(**leaves), torch.from_numpy(o),
                               torch.from_numpy(d), 11)
    g_f = torch.autograd.grad(((r_f - tgt) ** 2).mean(),
                              list(leaves.values()))
    close = ((r_k - r_f.detach()).abs()
             <= 1e-5 * r_f.detach().abs().clamp(min=1)).all(-1)
    assert close.float().mean() >= 0.99
    for f, g in zip(pt.DIFF_FIELDS, g_f):
        cos, _ = _cos_ratio(g_k[f].numpy(), g.numpy())
        assert cos >= 0.9999, (f, cos)


def test_draws_are_pure_and_slot_keyed():
    # Positional draws are a pure function of (seed, bounce); slot-keyed
    # draws follow the slot, not the position, and are unit vectors.
    a = M.positional_draws(5, 3, 100)
    b = M.positional_draws(5, 3, 100)
    c = M.positional_draws(5, 4, 100)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    slots = torch.arange(64, dtype=torch.int32)
    perm = torch.randperm(64, generator=torch.Generator().manual_seed(0))
    u, xi = M.slot_draws(9, 2, slots)
    up, xip = M.slot_draws(9, 2, slots[perm])
    assert torch.equal(up, u[perm]) and torch.equal(xip, xi[perm])
    assert ((u.norm(dim=-1) - 1).abs() < 1e-6).all()
    assert ((xi >= 0) & (xi < 1)).all()


def test_default_route_is_the_differentiable_trace():
    # render_radiance's default is the fixed-depth wavefront, as in the JAX
    # package: a loss on it back-propagates to the scene, and the image
    # estimates what the persistent route renders (channel means within 3
    # standard errors of the per-pixel difference).
    scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in pt.DIFF_FIELDS}
    img = pt.render_radiance(scene._replace(**leaves), cam, 48, 4,
                             device="cpu", seed=2)
    assert img.requires_grad and img.shape == (27, 48, 3)
    ((img - 0.3) ** 2).mean().backward()
    assert leaves["albedo"].grad.abs().sum() > 0
    assert torch.isfinite(leaves["center"].grad).all()
    ref = pt.render_radiance(scene, cam, 48, 4, device="cpu", seed=2,
                             persistent=True)
    diff = (img.detach() - ref).reshape(-1, 3)
    se = diff.std(0) / diff.shape[0] ** 0.5
    assert (diff.mean(0).abs() < 3 * se).all()


def test_remat_grad_route_matches_fd_and_noremat():
    # render_grads(recorded=False, remat=True) and its remat=False twin give
    # the same gradients bitwise; its albedo gradient of sphere 1 (the
    # ground) matches central differences of render_loss within 1e-3
    # relative (measured: at most 1.4e-5).
    scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
    target = pt.render_radiance(scene, cam, 32, 1, device="cpu", seed=9,
                                image_height=18)
    bad = scene._replace(albedo=scene.albedo * 0.8)
    kw = dict(device="cpu", seed=4, recorded=False)
    lf = lambda img, tgt: ((img.double() - tgt.double()) ** 2).mean()
    loss, g = pt.render_grads(bad, cam, target, 32, 2, remat=True,
                              loss_fn=lf, **kw)
    loss2, g2 = pt.render_grads(bad, cam, target, 32, 2, remat=False,
                                loss_fn=lf, **kw)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(getattr(g, f), getattr(g2, f))
               for f in pt.DIFF_FIELDS)
    pt.check_grads_sane(g, loss)
    k, eps = 1, 1e-3
    for c in range(3):
        vals = []
        for sgn in (1.0, -1.0):
            alb = bad.albedo.clone()
            alb[k, c] += sgn * eps
            with torch.no_grad():
                vals.append(float(pt.render_loss(
                    bad._replace(albedo=alb), cam, target, 32, 2,
                    remat=True, loss_fn=lf, **kw)))
        fd = (vals[0] - vals[1]) / (2 * eps)
        assert abs(fd - float(g.albedo[k, c])) <= 1e-3 * abs(fd)


def test_twin_ad_canary_passes_on_the_cpu():
    # The kernel pair (the fixed-depth pair below 2^17 pixels) against the
    # remat twin at 128x72, spp 4, the JAX package's own canary test size.
    G.twin_ad_canary(pt.scene_4_spheres(), pt.t_default_cam(), width=128,
                     n_samples=4, device="cpu")


def test_float64_mirror_render_matches_float32():
    # The fixed-depth route takes float64 scenes through the dot-form sweep
    # on any device. A draw-free scene (fuzz-0 mirrors, aperture 0, the
    # centred sample 0): the float64 image within 1e-4 of the float32 one
    # (measured: 4.4e-5, float32 rounding over several grazing mirror
    # bounces). The persistent route renders float64 too (the plain
    # pixel-pinned body): on this draw-free scene within 1e-10 of the
    # fixed-depth float64 image.
    spheres = [pt.metal((0, -100.5, -1), 100.0, (0.8, 0.8, 0.8)),
               pt.metal((0, 0, -1), 0.5, (0.9, 0.6, 0.3)),
               pt.metal((-1, 0, -1), 0.5, (0.7, 0.7, 0.9))]
    out = {}
    for dt in (torch.float32, torch.float64):
        out[dt] = pt.render_radiance(pt.make_scene(spheres, dtype=dt),
                                     pt.default_camera(dtype=dt), 48, 1,
                                     device="cpu")
    assert out[torch.float64].dtype == torch.float64
    assert (out[torch.float64] - out[torch.float32].double()).abs().max() \
        <= 1e-4
    pers = pt.render_radiance(pt.make_scene(spheres, dtype=torch.float64),
                              pt.default_camera(dtype=torch.float64), 48, 1,
                              device="cpu", persistent=True)
    assert pers.dtype == torch.float64
    assert (pers - out[torch.float64]).abs().max() <= 1e-10


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_compacted_equals_the_keyed_trace(name):
    # The compacting wavefront sweeps only live rays; its slot-keyed draws
    # give every ray the path it takes in trace(keyed=True), so the
    # radiance is bitwise equal (the reference holds its two to one ulp).
    sj, o, d = _case(name, 32, 18)
    scene = pt.scene_from_numpy(sj)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    a = trace(scene, o, d, 21, keyed=True)
    b = trace_compacted(scene, o, d, 21)
    assert torch.equal(a, b) and (b > 0).any()
    img = pt.render_radiance(scene, pt.t_default_cam(), 32, 2, device="cpu",
                             compact=True, seed=3)
    ref = pt.render_radiance(scene, pt.t_default_cam(), 32, 2, device="cpu",
                             seed=3)
    assert img.shape == ref.shape and torch.isfinite(img).all()
    assert not img.requires_grad


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_occupancy_matches_jax(name):
    # Live rays entering each bounce and live 256-ray tiles, against the
    # JAX package's trace_occupancy with its draws injected: every count
    # within 1% of the ray count, tiles within one (measured: equal on
    # 4_spheres and hollow glass; on random_spheres ray counts within 6 of
    # 1 296, where a few paths diverge as in test_trace_matches_jax, tiles
    # equal).
    sj, o, d = _case(name)
    R = o.shape[0]
    cj, tj = jtrace_occupancy(sj, jnp.asarray(o), jnp.asarray(d), KEY,
                              tile=256)
    cp, tp = trace_occupancy(pt.scene_from_numpy(sj), torch.from_numpy(o),
                             torch.from_numpy(d), 0, tile=256,
                             draws=_jax_draws(R))
    cj, tj = np.asarray(cj), np.asarray(tj)
    assert cp[0] == R and tp[0] == -(-R // 256)
    assert (np.abs(np.array(cp) - cj) <= 0.01 * R).all(), (cp, cj)
    assert (np.abs(np.array(tp) - tj) <= 1).all(), (tp, tj)


@pytest.mark.parametrize("kw", [{"tile_skip": 64}, {"remat_policy": "dots"},
                                {"recorded": True}])
def test_unported_trace_options_raise(kw):
    # These options once raised NotImplementedError; now each renders
    # through render_radiance (a finite image) and takes a gradient step
    # through render_grads (finite, sane, non-zero in albedo) on the CPU:
    # the trace options on the remat route, recorded=True alone on the
    # recorded wavefront.
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    img = pt.render_radiance(scene, cam, 16, 1, device="cpu", **kw)
    assert img.shape == (9, 16, 3) and torch.isfinite(img).all()
    route = kw if "recorded" in kw else {"recorded": False, "remat": True,
                                         **kw}
    loss, g = pt.render_grads(scene, cam, torch.full((9, 16, 3), 0.3), 16,
                              1, device="cpu", **route)
    pt.check_grads_sane(g, loss)
    assert (g.albedo != 0).any()


def test_trace_wrappers_on_cpu_launch_nothing():
    # On CPU tensors the differentiable sweeps run the plain versions: no
    # kernel launch is counted.
    before = (K.launches, K.fetch_launches, GK.record_launches)
    sj, o, d = _case("4_spheres", 16, 9)
    trace(pt.scene_from_numpy(sj), torch.from_numpy(o), torch.from_numpy(d),
          0, fused_attrs=True)
    trace(pt.scene_from_numpy(sj), torch.from_numpy(o), torch.from_numpy(d),
          0)
    assert (K.launches, K.fetch_launches, GK.record_launches) == before


@pytest.mark.cuda
def test_trace_kernels_match_plain_on_card(cuda_device):
    # trace through K1 and K10 on the card against its plain path (sweep_ref
    # and sweep_fetch_ref on the card): radiance within 1e-5 * max(1, |x|)
    # on >= 99.9% of rays; gradients of both kernel routes bitwise equal on
    # a second call; the counters move by max_depth per call.
    dev = cuda_device
    torch.backends.cuda.matmul.allow_tf32 = False
    sj, o, d = _case("random_spheres", 64, 36)
    scene = pt.scene_from_numpy(sj, device=dev)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    for fused in (False, True):
        before = (K.launches, K.fetch_launches)
        a = trace(scene, o, d, 3, fused_attrs=fused)
        moved = (K.launches - before[0], K.fetch_launches - before[1])
        assert moved == ((0, 16) if fused else (16, 0))
        b = trace(scene, o, d, 3, fused_attrs=fused, impl="plain")
        ok = ((a - b).abs() <= 1e-5 * b.abs().clamp(min=1)).all(-1)
        assert ok.float().mean() >= 0.999
        grads = []
        for _ in range(2):
            leaves = {f: getattr(scene, f).clone().requires_grad_(True)
                      for f in pt.DIFF_FIELDS}
            r = trace(scene._replace(**leaves), o, d, 3, remat=True,
                      fused_attrs=fused)
            grads.append(torch.autograd.grad(((r - 0.3) ** 2).mean(),
                                             list(leaves.values())))
        assert all(torch.equal(x, y) for x, y in zip(*grads))


def _jax_tile_draws(R, T, key=KEY, depth=16):
    """The JAX trace's per-tile draws under ``tile_skip=T`` (tile ``t`` of
    bounce ``b`` draws from ``fold_in(fold_in(key, b), t)``), every tile's
    laid end to end, as a port hook for the padded width."""
    n_tiles = -(-R // T)
    out = []
    for b in range(depth):
        kb = jax.random.fold_in(key, b)
        us, xis = [], []
        for t in range(n_tiles):
            kd, kc = jax.random.split(jax.random.fold_in(kb, t))
            us.append(np.asarray(jusd(kd, (T,))))
            xis.append(np.asarray(jax.random.uniform(kc, (T,))))
        out.append((torch.from_numpy(np.concatenate(us)),
                    torch.from_numpy(np.concatenate(xis))))
    return lambda b, n: out[b]


@pytest.mark.parametrize("name,share,mean_rtol",
                         [("4_spheres", 0.99, 5e-3),
                          ("diel_spheres_hollow", 0.99, 5e-3),
                          ("random_spheres", 0.90, 2e-2)])
def test_tile_skip_matches_jax(name, share, mean_rtol):
    # trace(tile_skip=256) (1 296 rays in 6 tiles, the last padded; the
    # live lanes swept by K3's plain version) against the JAX package's
    # trace(tile_skip=256, use_pallas=False) with its per-tile draws
    # injected: the share of rays within 1e-5 * max(1, |x|) as in
    # test_trace_matches_jax (measured: 99.6%, 99.9%, 94.6%) and the
    # channel means within mean_rtol (measured: 2.1e-4, 1.6e-3, 7.9e-3: on
    # random_spheres the 5% of paths that diverge, as they do without
    # tiles, move a 1 296-ray mean further); the MSE gradients of the
    # remat route against jax.grad of the JAX remat route, summed over the
    # rays that agree within 1e-6 in the forward, with cosine >= 0.999 and
    # norm ratio within 1% per field, as test_trace_grads_match_jax holds
    # the plain wavefront (measured: cosines >= 0.999996, ratios within
    # 4.1e-4).
    T = 256
    sj, o, d = _case(name)
    R = o.shape[0]
    draws = _jax_tile_draws(R, T)
    ref = np.asarray(jtrace(sj, jnp.asarray(o), jnp.asarray(d), KEY,
                            use_pallas=False, tile_skip=T))
    out = trace(pt.scene_from_numpy(sj), torch.from_numpy(o),
                torch.from_numpy(d), 0, tile_skip=T, draws=draws).numpy()
    assert out.shape == (R, 3) and np.isfinite(out).all()
    close = (np.abs(out - ref) <= 1e-5 * np.maximum(1, np.abs(ref))).all(-1)
    assert close.mean() >= share, close.mean()
    np.testing.assert_allclose(out.mean(0), ref.mean(0), rtol=mean_rtol)
    same = (np.abs(out - ref) <= 1e-6 * np.maximum(1, np.abs(ref))).all(-1)
    w = same.astype(np.float32)[:, None]
    tgt = np.full((R, 3), 0.3, np.float32)

    def jloss(params):
        r = jtrace(sj._replace(**params), jnp.asarray(o), jnp.asarray(d), KEY,
                   use_pallas=False, remat=True, tile_skip=T)
        return jnp.sum(w * (r - tgt) ** 2) / R

    gj = jax.grad(jloss)({f: getattr(sj, f) for f in pt.DIFF_FIELDS})
    _, gp = _port_grads(pt.scene_from_numpy(sj), o, d, torch.from_numpy(tgt),
                        weight=torch.from_numpy(w), remat=True, tile_skip=T,
                        draws=draws)
    for f in pt.DIFF_FIELDS:
        cos, ratio = _cos_ratio(gp[f].numpy(), gj[f])
        assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (f, cos, ratio)


def test_tile_skip_is_statistically_the_trace():
    # The JAX package's test_tile_skip_statistical_equivalence: tile_skip
    # changes only the draws' layout, so scene_2_spheres at 64x36, spp 8
    # renders the same image statistically: means within 0.01, mean
    # absolute difference below 0.05.
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    a = pt.render_radiance(scene, cam, 64, 8, device="cpu", seed=3)
    b = pt.render_radiance(scene, cam, 64, 8, device="cpu", seed=3,
                           tile_skip=256)
    assert torch.isfinite(b).all() and not torch.equal(a, b)
    assert abs(float(a.mean() - b.mean())) < 0.01
    assert float((a - b).abs().mean()) < 0.05


def test_tile_skip_gradient_matches_fd():
    # The JAX package's test_grad_tile_skip_matches_fd on the remat route
    # it names (recorded=False, remat=True, tile_skip=128): float64,
    # 32x18, spp 2, the albedo of sphere 0 against central differences at
    # eps 1e-4 within rtol 1e-4.
    dt = torch.float64
    scene = pt.make_scene([
        pt.lambertian((0, 0, -1), 0.5, (0.7, 0.3, 0.3)),
        pt.lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0)),
        pt.metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.0)], dtype=dt)
    cam = pt.default_camera(dtype=dt)
    target = torch.zeros((18, 32, 3), dtype=dt)
    kw = dict(device="cpu", seed=7, recorded=False, remat=True,
              tile_skip=128)
    _, g = pt.render_grads(scene, cam, target, 32, 2, **kw)
    vals = []
    for eps in (1e-4, -1e-4):
        alb = scene.albedo.clone()
        alb[0, 0] += eps
        with torch.no_grad():
            vals.append(float(pt.render_loss(scene._replace(albedo=alb), cam,
                                             target, 32, 2, **kw)))
    fd = (vals[0] - vals[1]) / 2e-4
    np.testing.assert_allclose(float(g.albedo[0, 0]), fd, rtol=1e-4,
                               atol=1e-9)


class _FetchCount:
    """Counts the winner-attribute gathers (tensor indexing of the
    ``[N, 9]`` attribute table) that run while it is entered."""

    def __init__(self, n):
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if func is torch.ops.aten.index.Tensor \
                        and tuple(args[0].shape) == (n, 9):
                    outer.n += 1
                return func(*args, **(kwargs or {}))

        self.n, self.mode = 0, Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def test_remat_policy_dots_keeps_the_fetch():
    # remat_policy="dots" gives the gradients of remat=True bit for bit,
    # and its backward recomputes no winner-attribute gather (the forward
    # keeps each bounce's), where remat=True recomputes one per bounce.
    sj, o, d = _case("diel_spheres_hollow", 32, 18)
    scene = pt.scene_from_numpy(sj)
    tgt = torch.full((o.shape[0], 3), 0.3)
    out = {}
    for policy in (None, "dots"):
        leaves = {f: getattr(scene, f).clone().requires_grad_(True)
                  for f in pt.DIFF_FIELDS}
        r = trace(scene._replace(**leaves), torch.from_numpy(o),
                  torch.from_numpy(d), 3, 8, remat=True, remat_policy=policy)
        loss = ((r - tgt) ** 2).mean()
        with _FetchCount(scene.n_spheres) as fc:
            grads = torch.autograd.grad(loss, list(leaves.values()))
        out[policy] = (r.detach(), grads, fc.n)
    assert torch.equal(out[None][0], out["dots"][0])
    assert all(torch.equal(a, b) for a, b in zip(out[None][1],
                                                 out["dots"][1]))
    assert out[None][2] == 8 and out["dots"][2] == 0, (out[None][2],
                                                      out["dots"][2])


def test_trace_option_misuse_raises():
    # keyed=True with tile_skip raises ValueError, as in the JAX package;
    # so does a remat_policy other than None and "dots" (the JAX package
    # ignores one) and a negative tile_skip, from trace and from render.
    scene = pt.scene_2_spheres()
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    with pytest.raises(ValueError, match="keyed"):
        trace(scene, o, d, 0, tile_skip=2, keyed=True)
    for kw in ({"remat_policy": "everything"}, {"tile_skip": -1}):
        with pytest.raises(ValueError):
            trace(scene, o, d, 0, remat=True, **kw)
        with pytest.raises(ValueError):
            pt.render_radiance(scene, pt.t_default_cam(), 16, 1,
                               device="cpu", **kw)


@pytest.mark.cuda
def test_tile_skip_on_card(cuda_device):
    # On the card tile_skip sweeps through K3 (counted): the radiance within
    # 1e-5 * max(1, |x|) of the plain version's on >= 99.9% of rays, and
    # the remat gradients finite.
    torch.backends.cuda.matmul.allow_tf32 = False
    sj, o, d = _case("random_spheres", 96, 54)
    scene = pt.scene_from_numpy(sj, device=cuda_device)
    o_c = torch.from_numpy(o).to(cuda_device)
    d_c = torch.from_numpy(d).to(cuda_device)
    before = K.masked_launches
    a = trace(scene, o_c, d_c, 5, tile_skip=1024)
    assert K.masked_launches > before
    b = trace(scene, o_c, d_c, 5, tile_skip=1024, impl="plain")
    err = ((a - b).abs() / b.abs().clamp(min=1)).amax(-1)
    assert (err <= 1e-5).float().mean() >= 0.999
    leaves = {f: getattr(scene, f).clone().requires_grad_(True)
              for f in pt.DIFF_FIELDS}
    r = trace(scene._replace(**leaves), o_c, d_c, 5, remat=True,
              tile_skip=1024)
    grads = torch.autograd.grad(((r - 0.3) ** 2).mean(),
                                list(leaves.values()))
    assert all(torch.isfinite(g).all() for g in grads)
