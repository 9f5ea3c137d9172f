"""Pass recomputation (``remat_passes=True``) in the port's pass loop
(``render.render_tile_sum_traced``, ``render._RecomputedPass``): the
counterpart of the JAX package's ``jax.checkpoint`` of the pass body.

Each pass keeps only its radiance sum; the backward runs the pass again and
replays the record it rebuilds. The draws are keyed by (seed, purpose,
pass) and by (seed, bounce or iteration) with the lane as the counter, so
the loss and every gradient field are bit for bit those of the loop that
keeps every pass's record, on both recorded pairs. Held here: that
equality, the ``stats`` hook counting each pass once, strict poisoning of a
recomputed pass, the records freed after the forward, the memory plan's
choice rendering, finite differences, and the JAX package's
``render_grads(remat_passes=True)`` at the statistical grade."""

import gc
import importlib
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.grad import render_grads as jrender_grads
from raytracingweekend_jl_tpu.render import render_radiance as jrender
from raytracingweekend_jl_tpu_torch import grad as G
from raytracingweekend_jl_tpu_torch.ops import fused_grad as FG
from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG
# The module, not the package's render function of the same name.
R = importlib.import_module("raytracingweekend_jl_tpu_torch.render")
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

W, SPP = 48, 4

#: The two recorded pairs that reach the pass loop.
PAIRS = {"fused": dict(recorded_fused=True),
         "persist": dict(recorded_persist=(4, None))}


def glass_metal_scene():
    """Ground, a diffuse sphere, glass and fuzzed metal."""
    return pt.make_scene([
        pt.lambertian((0, -100.5, -1), 100, (0.8, 0.8, 0.0)),
        pt.lambertian((0, 0, -1), 0.5, (0.1, 0.2, 0.5)),
        pt.dielectric((-1, 0, -1), 0.5, 1.5),
        pt.metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.3)])


def _problem():
    scene, cam = glass_metal_scene(), pt.t_default_cam()
    target = pt.render_radiance(scene, cam, W, 1, seed=9, device="cpu")
    return scene._replace(albedo=scene.albedo * 0.8), cam, target


def _grads(scene, cam, target, **kw):
    return pt.render_grads(scene, cam, target, W, SPP, device="cpu", seed=3,
                           **kw)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_remat_passes_bitwise_keeping_every_pass(pair):
    # Tolerance: none. The loss and all five gradient fields bit for bit.
    bad, cam, target = _problem()
    l0, g0 = _grads(bad, cam, target, remat_passes=False, **PAIRS[pair])
    l1, g1 = _grads(bad, cam, target, remat_passes=True, **PAIRS[pair])
    assert torch.isfinite(l0) and bool(l0 > 0)
    assert torch.equal(l0, l1)
    for f in pt.SceneGrads._fields:
        a, b = getattr(g0, f), getattr(g1, f)
        assert torch.equal(a, b), f
    assert float(g0.albedo.abs().sum()) > 0


def test_remat_passes_counts_stats_once():
    # The stats hook sees each of the four passes once: the recomputation in
    # the backward runs with the hook off.
    bad, cam, target = _problem()
    seen = []
    for rp in (False, True):
        st = {}
        _grads(bad, cam, target, remat_passes=rp, stats=st,
               **PAIRS["persist"])
        seen.append(st)
    assert len(seen[0]["lanes"]) == SPP
    assert seen[0] == seen[1]


def test_remat_passes_poisons_like_keeping_every_pass():
    # Two iterations cannot finish the paths: strict poisoning turns the
    # loss and every gradient NaN, in the recomputed passes as in the kept
    # ones (NaN in the same places, equal elsewhere).
    bad, cam, target = _problem()
    kw = dict(recorded_persist=(4, 2), persist_strict=True)
    l0, g0 = _grads(bad, cam, target, remat_passes=False, **kw)
    l1, g1 = _grads(bad, cam, target, remat_passes=True, **kw)
    assert torch.isnan(l0) and torch.isnan(l1)
    for f in pt.SceneGrads._fields:
        a, b = getattr(g0, f), getattr(g1, f)
        assert torch.isnan(a).any(), f
        assert torch.equal(torch.isnan(a), torch.isnan(b)), f
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)), f


def _watch_records(monkeypatch):
    """Weak references to every record tensor the record phases allocate."""
    refs = []
    run_phase, fused_fwd = PG._run_record_phase, FG._record_forward

    def phase(*a, **k):
        ph = run_phase(*a, **k)
        refs.extend(weakref.ref(x) for x in (ph.rec, ph.rec_idx))
        return ph

    def fused(*a, **k):
        out = fused_fwd(*a, **k)
        refs.extend(weakref.ref(x) for x in out[1:])
        return out

    monkeypatch.setattr(PG, "_run_record_phase", phase)
    monkeypatch.setattr(FG, "_record_forward", fused)
    return refs


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_remat_passes_frees_each_pass_record(pair, monkeypatch):
    # After a 4-pass forward that recomputes its passes no record is alive;
    # without recomputation all four passes' records are, until the
    # backward; the backward of the recomputed loss rebuilds them (four
    # more passes) and frees them too.
    bad, cam, target = _problem()
    refs = _watch_records(monkeypatch)
    leaves = {f: getattr(bad, f).detach().requires_grad_(True)
              for f in pt.DIFF_FIELDS}
    scene = bad._replace(**leaves)
    per_pass = 2
    for rp in (False, True):
        refs.clear()
        loss = pt.render_loss(scene, cam, target, W, SPP, device="cpu",
                              seed=3, remat_passes=rp, **PAIRS[pair])
        gc.collect()
        alive = sum(r() is not None for r in refs)
        assert len(refs) == SPP * per_pass
        assert alive == (0 if rp else SPP * per_pass)
        loss.backward()
        del loss
        gc.collect()
        assert len(refs) == SPP * per_pass * (2 if rp else 1)
        assert all(r() is None for r in refs)


def test_planned_remat_passes_renders(monkeypatch):
    # A budget below one pass's record: plan_pass_memory picks remat_passes
    # (as the JAX package's planner does on the same numbers), and the step
    # renders, bit for bit the step told to keep every pass.
    monkeypatch.setattr(G, "RECORD_HBM_BUDGET", 1 << 16)
    bad, cam, target = _problem()
    kw = G.resolve_grad_path(dict(PAIRS["persist"]), W * 27, "cuda")
    G.plan_pass_memory(kw, W * 27, SPP)
    assert kw["remat_passes"] is True
    built = []
    retracer = R._retracer
    monkeypatch.setattr(R, "_retracer",
                        lambda *a: built.append(a) or retracer(*a))
    l0, g0 = _grads(bad, cam, target, **PAIRS["persist"])
    assert len(built) == 1
    l1, g1 = _grads(bad, cam, target, remat_passes=False, **PAIRS["persist"])
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_remat_passes_fd_consistent():
    # The JAX package's finite-difference check of the checkpointed pass
    # loop (tests/test_grad.py, test_remat_passes_auto_and_fd):
    # scene_4_spheres at 48x27, spp 4, the persistent pair with recomputed
    # passes; albedo[1, 0] against a central difference, eps 1e-2,
    # rtol 3e-2 (atol 1e-6).
    scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
    target = pt.render_radiance(scene, cam, 48, 4, image_height=27, seed=3,
                                device="cpu")
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.8, 0, 1))
    kw = dict(recorded_persist=(4, None), remat_passes=True, device="cpu")
    _, g = pt.render_grads(bad, cam, target, 48, 4, **kw)
    g_ad = float(g.albedo[1, 0])

    def loss_at(dl):
        alb = bad.albedo.clone()
        alb[1, 0] += dl
        loss, _ = pt.render_grads(bad._replace(albedo=alb), cam, target, 48,
                                  4, **kw)
        return float(loss)

    eps = 1e-2
    g_fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    np.testing.assert_allclose(g_ad, g_fd, rtol=3e-2, atol=1e-6)


def test_remat_passes_matches_jax_statistically():
    # The JAX package's render_grads(recorded_fused=True, remat_passes=True)
    # on scene_4_spheres at 48x27, spp 4, against the port's on the same
    # target. The camera jitter and the bounce draws are different streams
    # (only global sample 0 is centered in both), so the grade is
    # statistical: the losses within 10% of each other, the albedo
    # gradients with cosine > 0.95 and norms within 20%.
    jscene, jcam = rtw.scene_4_spheres(), rtw.t_default_cam()
    target = np.array(jrender(jscene, jcam, 48, 4, image_height=27,
                                seed=3))
    jbad = jscene._replace(albedo=jnp.clip(jscene.albedo * 0.8, 0, 1))
    jl, jg = jrender_grads(jbad, jcam, target, 48, 4, recorded_fused=True,
                           remat_passes=True)
    scene = pt.trim_scene(pt.scene_4_spheres(), multiple=1)
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.8, 0, 1))
    tl, tg = pt.render_grads(bad, pt.t_default_cam(),
                             torch.as_tensor(target), 48, 4, device="cpu",
                             seed=3, recorded_fused=True, remat_passes=True)
    assert abs(float(tl) - float(jl)) <= 0.10 * float(jl)
    n = bad.albedo.shape[0]
    a = tg.albedo.double().numpy().ravel()
    b = np.asarray(jg.albedo, dtype=np.float64)[:n].ravel()
    cos = float(a @ b) / (np.linalg.norm(a) * np.linalg.norm(b))
    assert cos > 0.95, cos
    assert abs(np.linalg.norm(a) / np.linalg.norm(b) - 1) < 0.20
