"""The port's inverse-rendering fit (``optimize.py``) against the JAX
package: the movable mask, Adam with and without cosine decay against
optax, the SPSA direction stream, the clip tie gradients, two whole fit
steps on a draw-free scene, and the JAX package's own CPU contract for the
fit. The fit's kernels are held against their plain versions on the card by
the kernel tests of ``test_torch_fused_grad.py`` and
``test_torch_inline.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu import optimize as joptimize
from raytracingweekend_jl_tpu_torch import optimize as O
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["4_spheres", "diel_spheres_hollow",
                                  "random_spheres"])
def test_movable_mask_matches_jax(name):
    scene_j = rtw.ALL_SCENES[name]()
    mask = O.movable_mask(pt.scene_from_numpy(scene_j))
    assert mask.dtype == bool
    assert np.array_equal(mask, joptimize.movable_mask(scene_j))


@pytest.mark.parametrize("cosine_decay", [False, True])
def test_adam_matches_optax(cosine_decay):
    # Five updates from the same gradient sequence, two parameter groups at
    # their own rates: the port's torch.optim.Adam (with the closed-form
    # cosine schedule through LambdaLR) against Adam written out in float64
    # with optax's defaults, within 1e-6 relative (measured 1.1e-7), and
    # against optax.multi_transform of optax.adam: each parameter's
    # displacement within 3e-5 of its size (measured 1.1e-5). optax forms
    # the bias correction 1 - 0.999^t in float32, 1.3e-5 off at t = 1;
    # torch forms it in float64.
    g = np.random.default_rng(4)
    p0 = {"center": g.normal(size=(6, 3)).astype(np.float32),
          "albedo": g.random((6, 3), dtype=np.float32)}
    grads = [{k: g.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(5)]
    lrs = {"center": 8e-3, "albedo": 2e-2}
    steps = 5

    def lr(v):
        return optax.cosine_decay_schedule(v, steps) if cosine_decay else v

    opt = optax.multi_transform({k: optax.adam(lr(v)) for k, v in lrs.items()},
                                {k: k for k in lrs})
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(pj)
    params = {k: torch.from_numpy(v.copy()).requires_grad_(True)
              for k, v in p0.items()}
    topt, sched = O.make_optimizer(params, lrs, steps, cosine_decay)
    assert (sched is not None) == cosine_decay
    p64 = {k: v.astype(np.float64) for k, v in p0.items()}
    m = {k: 0.0 for k in p0}
    v2 = {k: 0.0 for k in p0}
    for t, gr in enumerate(grads, 1):
        upd, state = opt.update({k: jnp.asarray(v) for k, v in gr.items()},
                                state, pj)
        pj = optax.apply_updates(pj, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(gr[k])
            rate = lrs[k] * (0.5 * (1 + np.cos(np.pi * (t - 1) / steps))
                             if cosine_decay else 1.0)
            m[k] = 0.9 * m[k] + 0.1 * gr[k]
            v2[k] = 0.999 * v2[k] + 0.001 * gr[k].astype(np.float64) ** 2
            p64[k] = p64[k] - rate * (m[k] / (1 - 0.9 ** t)) / (
                np.sqrt(v2[k] / (1 - 0.999 ** t)) + 1e-8)
        topt.step()
        if sched is not None:
            sched.step()
    for k in p0:
        got = params[k].detach().numpy()
        np.testing.assert_allclose(got, p64[k], rtol=1e-6, atol=1e-8)
        moved = np.asarray(pj[k]) - p0[k]
        np.testing.assert_allclose(got - p0[k], moved, rtol=0,
                                   atol=3e-5 * np.abs(moved).max())


def _record_rng(monkeypatch):
    """Record every ``integers`` draw of the generators that
    ``np.random.default_rng`` makes while patched."""
    calls = []
    real = np.random.default_rng

    class Recording:
        def __init__(self, seed):
            self.seed, self.gen = seed, real(seed)

        def integers(self, *a, **k):
            out = self.gen.integers(*a, **k)
            calls.append((self.seed, out))
            return out

    monkeypatch.setattr(np.random, "default_rng", Recording)
    return calls


def test_spsa_directions_match_the_jax_stream(monkeypatch):
    # One fit step with two probe pairs in each package at 8x4: both draw
    # from np.random.default_rng(31 + seed), in the same order, and the
    # port's float32 directions equal the JAX package's bit for bit.
    scene_j = rtw.scene_4_spheres()
    cam_j = rtw.t_default_cam()
    target = np.full((4, 8, 3), 0.3, np.float32)
    calls = _record_rng(monkeypatch)
    joptimize.fit_scene(scene_j, cam_j, jnp.asarray(target), 8, 1, steps=1,
                        seed=4, spsa_pairs=2,
                        render_kwargs={"recorded": True, "max_depth": 2})
    j_calls, calls[:] = list(calls), []
    O.fit_scene(pt.scene_from_numpy(scene_j), pt.camera_from_numpy(cam_j),
                torch.from_numpy(target), 8, 1, steps=1, seed=4,
                spsa_pairs=2, render_kwargs={"max_depth": 2}, device="cpu")
    assert len(j_calls) == len(calls) == 2
    mov = joptimize.movable_mask(scene_j)
    for (sj, ij), (sp, ip) in zip(j_calls, calls):
        assert sj == sp == 35 and np.array_equal(ij, ip)
        want = np.asarray(jnp.asarray((ij * 2 - 1) * mov[:, None],
                                      jnp.float32))
        got = ((ip * 2 - 1) * mov[:, None]).astype(np.float32)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_spsa_delta_is_the_reference_expression():
    mov = np.array([True, False, True, True])
    a = O.spsa_delta(np.random.default_rng(31), (4, 3), mov)
    ints = np.random.default_rng(31).integers(0, 2, (4, 3))
    want = np.asarray(jnp.asarray((ints * 2 - 1) * mov[:, None], jnp.float32))
    assert a.dtype == np.float32 and np.array_equal(a, want)
    assert (a[1] == 0).all() and set(np.unique(a[0])) <= {-1.0, 1.0}


@pytest.mark.parametrize("x", [-0.5, 0.0, 0.3, 1.0, 1.5])
def test_clip_and_maximum_tie_gradients_match_jax(x):
    # jnp.clip and jnp.maximum pass half the cotangent where the input lies
    # on a bound (torch.clamp passes all of it): the port's clip and maximum
    # give JAX's gradient at, inside and outside the bounds.
    gc = float(jax.grad(lambda a: jnp.clip(a, 0.0, 1.0))(jnp.float32(x)))
    gm = float(jax.grad(lambda a: jnp.maximum(a, 0.0))(jnp.float32(x)))
    t = torch.tensor(x, requires_grad=True)
    (pc,) = torch.autograd.grad(O.clip(t, 0.0, 1.0), t)
    (pm,) = torch.autograd.grad(O.maximum(t, 0.0), t)
    assert float(pc) == gc and float(pm) == gm
    assert float(O.clip(t, 0.0, 1.0).detach()) == float(jnp.clip(x, 0.0,
                                                                1.0))
    if x in (0.0, 1.0):
        assert gc == 0.5


def _mirror_world():
    scene = rtw.make_scene([
        rtw.metal((0, -100.5, -1), 100.0, (0.8, 0.8, 0.8), 0.0),
        rtw.metal((0, 0, -1.2), 0.5, (0.9, 0.5, 0.3), 0.0),
        rtw.metal((1.1, 0.1, -1), 0.45, (0.3, 0.7, 0.9), 0.0),
        rtw.metal((-1.0, 0.0, -1.1), 0.4, (0.6, 0.6, 0.2), 0.0),
    ])
    return scene, rtw.default_camera((0, 0.3, 0.5), (0, 0, -1))


def test_two_fit_steps_match_jax_on_a_draw_free_scene():
    # The slice as a whole: two steps of fit_scene (albedo only, spsa_pairs
    # 0) on the fuzz-0 mirror world at 32x18 spp 1, where no draw reaches
    # the render. JAX runs its CPU recorded path, the port its default route
    # on the CPU (the fixed-depth pair through the plain versions). Losses
    # per step within 1e-5 relative (measured 1.8e-7); fitted albedos within
    # 1e-4 on every entry whose gradient at each step is above 1e-3 of the
    # field's largest magnitude (Adam's first steps follow a gradient's
    # sign, so an entry whose gradient is near 0 may move either way); few
    # entries are excluded (measured: 0 of the 9 movable entries, albedos
    # within 3.6e-7).
    scene_j, cam_j = _mirror_world()
    target = np.full((18, 32, 3), 0.4, np.float32)
    rj = joptimize.fit_scene(scene_j, cam_j, jnp.asarray(target), 32, 1,
                             steps=2, spsa_pairs=0,
                             render_kwargs={"recorded": True})
    grads = []
    rp = O.fit_scene(pt.scene_from_numpy(scene_j),
                     pt.camera_from_numpy(cam_j), torch.from_numpy(target),
                     32, 1, steps=2, spsa_pairs=0, device="cpu",
                     on_step=lambda i, loss, p: grads.append(
                         p["albedo"].grad.clone()))
    np.testing.assert_allclose(rp.losses, rj.losses, rtol=1e-5)
    mov = joptimize.movable_mask(scene_j)
    big = np.ones(rp.scene.albedo.shape, bool)
    for g in grads:
        g = g.numpy()
        big &= np.abs(g) > 1e-3 * np.abs(g).max()
    big &= mov[:, None]
    assert big.sum() >= mov.sum() * 3 - 2, (big.sum(), mov.sum())
    a_p = rp.scene.albedo.numpy()
    a_j = np.asarray(rj.scene.albedo)
    assert np.abs(a_p - a_j)[big].max() <= 1e-4
    assert np.array_equal(a_p[~mov], np.asarray(scene_j.albedo)[~mov])


def _perturbed_pair():
    """The JAX package's CPU fit contract: 4_spheres, centers jittered by
    U(-0.12, 0.12) and albedo 0.55 a + 0.15 on the movable spheres (the
    jitter drawn from numpy here)."""
    scene_true = pt.scene_4_spheres()
    movable = O.movable_mask(scene_true)
    g = np.random.default_rng(7)
    jit = g.uniform(-0.12, 0.12, tuple(scene_true.center.shape))
    jit[~movable] = 0.0
    alb = scene_true.albedo.numpy().copy()
    alb[movable] = np.clip(alb[movable] * 0.55 + 0.15, 0, 1)
    scene0 = scene_true._replace(
        center=scene_true.center + torch.from_numpy(jit.astype(np.float32)),
        albedo=torch.from_numpy(alb))
    return scene_true, scene0, movable


def test_port_fit_descends_and_recovers():
    # tests/test_inverse.py's contract at 48x27 spp 2, 10 steps: >= 25%
    # loss drop, the last loss within 1.15x of the minimum, the albedo error
    # below 0.8x its start, the center error below 1.3x its start, and the
    # immovable spheres bit for bit where they were (measured: loss
    # 0.0308 -> 0.0153, albedo error 0.210 -> 0.168, center error 0.119 ->
    # 0.132, the same at 1 and 3 threads).
    W, H, spp = 48, 27, 2
    scene_true, scene0, movable = _perturbed_pair()
    cam = pt.t_default_cam()
    target = pt.render_radiance(scene_true, cam, W, spp, image_height=H,
                                seed=0, device="cpu", persistent=False,
                                recorded_fused=True)
    res = O.fit_scene(scene0, cam, target, W, spp, steps=10, seed=0,
                      device="cpu")
    losses = res.losses
    assert len(losses) == 10 and np.isfinite(losses).all()
    assert losses[-1] < 0.75 * losses[0], losses
    assert losses[-1] <= min(losses) * 1.15, losses

    def err(a, b):
        return (a - b).abs().numpy()[movable].max()

    assert err(res.scene.albedo, scene_true.albedo) < \
        0.8 * err(scene0.albedo, scene_true.albedo)
    assert err(res.scene.center, scene_true.center) < \
        1.3 * err(scene0.center, scene_true.center)
    assert torch.equal(res.scene.center[~movable], scene0.center[~movable])
    assert torch.equal(res.scene.albedo[~movable], scene0.albedo[~movable])


def test_unported_estimators_raise():
    # Both estimators and fit_scene_scan are ported: what raises is what the
    # JAX package refuses, a bogus geom and render_kwargs with geom="edge"
    # (which reads edge_kwargs only), in both fit functions.
    scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
    target = torch.zeros((9, 16, 3))
    for fit in (O.fit_scene, O.fit_scene_scan):
        with pytest.raises(ValueError, match="geom"):
            fit(scene, cam, target, 16, 1, steps=1, geom="bogus",
                device="cpu")
        with pytest.raises(ValueError, match="render_kwargs"):
            fit(scene, cam, target, 16, 1, steps=1, geom="edge",
                render_kwargs={"max_depth": 2},
                edge_kwargs=dict(sigma=0.05), device="cpu")


def test_scan_matches_jax_scan_on_a_draw_free_scene():
    # fit_scene_scan, albedo only (spsa_pairs 0), two steps on the fuzz-0
    # mirror world at 32x18 spp 1 against the JAX package's fit_scene_scan
    # (its CPU recorded path): losses within 1e-5 relative (measured
    # 1.8e-7), and equal to the port's own fit_scene, whose steps are the
    # scan's.
    scene_j, cam_j = _mirror_world()
    target = np.full((18, 32, 3), 0.4, np.float32)
    rj = joptimize.fit_scene_scan(scene_j, cam_j, jnp.asarray(target), 32, 1,
                                  steps=2, spsa_pairs=0,
                                  render_kwargs={"recorded": True})
    args = (pt.scene_from_numpy(scene_j), pt.camera_from_numpy(cam_j),
            torch.from_numpy(target), 32, 1)
    rp = O.fit_scene_scan(*args, steps=2, spsa_pairs=0, device="cpu")
    np.testing.assert_allclose(rp.losses, rj.losses, rtol=1e-5)
    assert rp.losses == O.fit_scene(*args, steps=2, spsa_pairs=0,
                                    device="cpu").losses
    assert len(rp.step_seconds) == 2 and rp.step_seconds[0] > 0


def test_scan_edge_matches_the_loop_and_jax():
    # geom="edge" (sigma 0.05, one edge bounce, depth 4) on the mirror
    # world at 32x18 spp 1, two steps with the centers and albedos moving:
    # the scan's losses and fitted scene equal the port's fit_scene's bit
    # for bit (the same steps), and the losses within 1e-5 relative of the
    # JAX package's fit_scene_scan, as the albedo-only case (measured: equal
    # in every bit; the fitted centers within 3.6e-7).
    scene_j, cam_j = _mirror_world()
    target = np.full((18, 32, 3), 0.4, np.float32)
    ekw = dict(sigma=0.05, edge_bounces=1, max_depth=4)
    rj = joptimize.fit_scene_scan(scene_j, cam_j, jnp.asarray(target), 32, 1,
                                  steps=2, geom="edge", edge_kwargs=ekw)
    args = (pt.scene_from_numpy(scene_j), pt.camera_from_numpy(cam_j),
            torch.from_numpy(target), 32, 1)
    kw = dict(steps=2, geom="edge", edge_kwargs=ekw, device="cpu")
    rs, rl = O.fit_scene_scan(*args, **kw), O.fit_scene(*args, **kw)
    assert rs.losses == rl.losses
    assert all(torch.equal(a, b) for a, b in zip(rs.scene, rl.scene))
    np.testing.assert_allclose(rs.losses, rj.losses, rtol=1e-5)


def test_scan_runs_on_the_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.fit_scene_scan(pt.scene_4_spheres(), pt.t_default_cam(),
                          torch.zeros((9, 16, 3)), 16, 1, steps=1)


def test_fit_needs_a_card_unless_the_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.fit_scene(pt.scene_4_spheres(), pt.t_default_cam(),
                     torch.zeros((9, 16, 3)), 16, 1, steps=1)
