"""The staged fixed-depth record/replay pair of the port
(``ops/fused_grad.trace_recorded_fused_staged``) against the JAX package's
``trace_recorded_fused_staged(interpret=True)`` fed the same uniforms, the
unstaged pair, finite differences and the JAX package's stage plan and
partition; its budget overflow count and warning. Card-only: the staged
pair through K3, K7a and K7b against its plain version."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.pallas import grad_kernel as JG
from raytracingweekend_jl_tpu_torch.ops import fused_grad as FG
from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
from test_torch_fused_grad import (FIELDS, _cos_ratio, _radiance_close,
                                   camera_rays, mixed_scene)

STAGES = ((0, 1), (2, 2), (4, 4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _u5_fn(tk):
    """The JAX package's interpret-mode uniforms of bounce ``b`` for ``n``
    lanes: ``_u5_for(key, b, rows)`` of the JAX layout's rows for ``n``
    (whole blocks of 64 rows of 128 lanes), its first ``n`` lanes."""
    def u5(b, n):
        rows = -(-(-(-n // FG.LANES)) // FG.SHADE_ROWS) * FG.SHADE_ROWS
        return torch.from_numpy(np.array(JG._u5_for(tk, b, rows)).reshape(
            5, -1)[:, :n])
    return u5


def _grads(scene_j, o, d, fn, g_out=None):
    """``(radiance, {field: grad}, g_origin, g_direction)`` of the port's
    ``fn(scene, o, d)`` under the cotangent ``g_out`` (the squared mean's
    without it)."""
    scene = pt.scene_from_numpy(scene_j, requires_grad=True)
    ot = torch.from_numpy(o).requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    rad = fn(scene, ot, dt)
    if g_out is None:
        (rad * rad).mean().backward()
    else:
        rad.backward(torch.from_numpy(g_out))
    return (rad.detach(), {f: getattr(scene, f).grad for f in FIELDS},
            ot.grad, dt.grad)


@pytest.mark.parametrize("u5", [False, True])
def test_one_stage_is_the_unstaged_pair(u5):
    # stages=((0, 1),) is one full-width stage: the same lanes (the padding
    # to 8 192 lanes starts dead), the same draws, so the radiance and
    # every gradient bit for bit the unstaged pair's, with the port's
    # Philox draws and with the JAX uniforms injected.
    scene_j = mixed_scene()
    o, d, tk = camera_rays(rtw.default_camera())
    kw = dict(u5_fn=_u5_fn(tk)) if u5 else {}
    a = _grads(scene_j, o, d, lambda s, oo, dd: pt.trace_recorded_fused(
        s, oo, dd, 123, 8, 1e-4, **kw))
    b = _grads(scene_j, o, d, lambda s, oo, dd: pt.trace_recorded_fused_staged(
        s, oo, dd, 123, 8, 1e-4, ((0, 1),), **kw))
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][f], b[1][f]) for f in FIELDS)
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])


def test_staged_pair_and_vjp_match_jax():
    # The port's staged pair (plain versions) against the JAX package's
    # trace_recorded_fused_staged(interpret=True) and jax.vjp on the mixed
    # scene, 32x18 rays, depth 8, stages ((0, 1), (2, 2), (4, 4)), the
    # same uniforms at each stage's width (_u5_for). Radiance by
    # _radiance_close (as the unstaged pair's test); per scene field and
    # for the ray origins cosine >= 0.9999 and norm ratio within 1e-3, the
    # directions in the plane normal to the ray (measured: worst lane
    # 2.9e-6, cosines >= 0.99999999995, ratios within 4.7e-5).
    scene_j = mixed_scene()
    o, d, tk = camera_rays(rtw.default_camera())
    g_out = np.random.default_rng(0).normal(size=(o.shape[0], 3)).astype(
        np.float32)

    def f(sc, oo, dd):
        return JG.trace_recorded_fused_staged(sc, oo, dd, tk, 8, 1e-4, True,
                                              STAGES)

    rad_j, vjp = jax.vjp(f, scene_j, jnp.asarray(o), jnp.asarray(d))
    gs_j, go_j, gd_j = vjp(jnp.asarray(g_out))
    rad, gs, go, gd = _grads(
        scene_j, o, d, lambda s, oo, dd: pt.trace_recorded_fused_staged(
            s, oo, dd, 123, 8, 1e-4, STAGES, u5_fn=_u5_fn(tk)), g_out)
    rad_j = np.asarray(rad_j)
    assert _radiance_close(rad.numpy(), rad_j), np.abs(rad.numpy()
                                                       - rad_j).max()
    for fld in FIELDS:
        cos, ratio = _cos_ratio(gs[fld], getattr(gs_j, fld))
        assert cos >= 0.9999 and abs(ratio - 1) <= 1e-3, (fld, cos, ratio)
    cos, ratio = _cos_ratio(go, go_j)
    assert cos >= 0.9999 and abs(ratio - 1) <= 1e-3, ("origin", cos, ratio)
    proj = lambda g: g - (g * d).sum(-1, keepdims=True) * d
    cos, ratio = _cos_ratio(proj(gd.numpy()), proj(np.asarray(gd_j)))
    assert cos >= 0.9999 and abs(ratio - 1) <= 1e-3, ("direction", cos, ratio)


def test_staged_pair_fd_of_albedo():
    # The port's own staged program with its Philox draws: the VJP in
    # albedo[0, 0] against central differences at eps 1e-2 (radiance is
    # polynomial in albedo) within 3e-2 relative, as the JAX package holds
    # its staged pair.
    scene_j = mixed_scene()
    o, d, _ = camera_rays(rtw.default_camera())
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)

    def loss(sc):
        r = pt.trace_recorded_fused_staged(sc, ot, dt, 99, 8, 1e-4, STAGES)
        return (r * r).mean()

    scene = pt.scene_from_numpy(scene_j, requires_grad=True)
    loss(scene).backward()
    g_ad = float(scene.albedo.grad[0, 0])

    def loss_at(delta):
        alb = scene.albedo.detach().clone()
        alb[0, 0] += delta
        with torch.no_grad():
            return float(loss(pt.scene_from_numpy(scene_j)._replace(
                albedo=alb)))

    g_fd = (loss_at(1e-2) - loss_at(-1e-2)) / 2e-2
    assert abs(g_ad) > 0
    np.testing.assert_allclose(g_ad, g_fd, rtol=3e-2, atol=1e-6)


@pytest.mark.parametrize("R", [1, 576, 8192, 8193, 20736, 1 << 20,
                               1920 * 1080])
def test_stage_plan_and_partition_match_jax(R):
    # The stage widths (whole multiples of 8 192 lanes) are the JAX
    # package's for the default and two other schedules at every depth
    # tried, and the stable partition is its _partition_alive.
    for stages in (FG.DEFAULT_STAGES, STAGES, ((0, 1), (1, 64))):
        for depth in (1, 3, 8, 16):
            assert FG.stage_plan(R, depth, stages) == \
                JG._stage_plan(R, depth, stages)
    alive = np.random.default_rng(R).random(min(R, 4096)) < 0.3
    order, n = FG.partition_alive(torch.from_numpy(alive))
    order_j, n_j = JG._partition_alive(jnp.asarray(alive))
    assert int(n) == int(n_j)
    assert np.array_equal(order.numpy(), np.asarray(order_j))


def _primary_hits(scene, o, d):
    """Camera rays that hit a sphere: the lanes alive entering bounce 1,
    whatever the draws."""
    t, _ = K.sweep_ref(torch.cat([o.T, d.T]).contiguous(),
                       K.sphere_consts(scene))
    return int((t < K.BIG).sum())


def test_overflow_is_counted_and_warns_once():
    # 192x108 rays of the four-sphere scene with stages ((0, 1), (1, 64)):
    # the second stage holds 8 192 lanes, fewer than the rays that hit at
    # bounce 0. n_over is that excess (counted on the device), the overflow
    # lanes read black (the mean drops), a direct call without stats warns
    # once, and a render of two passes warns once, after its pass loop,
    # with both passes' counts in stats["overflow"]. The default schedule
    # has room: n_over 0, no warning.
    scene, cam = pt.trim_scene(pt.scene_4_spheres()), pt.t_default_cam()
    u, v = pt.pixel_coords(192, 108)
    o, d = pt.get_rays(cam, u, v, generator=torch.Generator().manual_seed(0))
    tight = ((0, 1), (1, 64))
    stats = {}
    r = pt.trace_recorded_fused_staged(scene, o, d, 5, 6, stages=tight,
                                       stats=stats)
    excess = _primary_hits(scene, o, d) - 8192
    assert excess > 0 and int(stats["n_over"]) == excess
    full = pt.trace_recorded_fused(scene, o, d, 5, 6)
    assert torch.isfinite(r).all() and r.mean() < full.mean()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pt.trace_recorded_fused_staged(scene, o, d, 5, 6, stages=tight)
        stats = {}
        img = pt.render_radiance(scene, cam, 192, 2, device="cpu", seed=3,
                                 recorded_fused=True, fused_stages=tight,
                                 max_depth=6, stats=stats)
        ok = {}
        pt.trace_recorded_fused_staged(scene, o, d, 5, 6, stats=ok)
        pt.render_radiance(scene, cam, 192, 1, device="cpu", seed=3,
                           recorded_fused=True,
                           fused_stages=FG.DEFAULT_STAGES, max_depth=6)
    hits = [w for w in rec if issubclass(w.category, RuntimeWarning)]
    assert len(hits) == 2, [str(w.message) for w in hits]
    assert torch.isfinite(img).all()
    assert int(stats["overflow"]) > excess and int(ok["n_over"]) == 0


def test_staged_pair_refuses_what_it_cannot_run():
    # Float64 raises as the unstaged pair does; impl="kernels" needs a CUDA
    # device; a malformed schedule raises ValueError.
    scene = pt.scene_2_spheres()
    o = torch.zeros((4, 3))
    with pytest.raises(NotImplementedError):
        pt.trace_recorded_fused_staged(pt.scene_2_spheres(
            dtype=torch.float64), o.double(), o.double(), 0)
    with pytest.raises(ValueError, match="CUDA"):
        pt.trace_recorded_fused_staged(scene, o, o, 0, impl="kernels")
    for bad in ((2, 2), ((1, 1),), ((0, 2), (4, 1)), ((0, 1), (0, 2))):
        with pytest.raises(ValueError, match="fused_stages"):
            pt.trace_recorded_fused_staged(scene, o, o, 0, stages=bad)


@pytest.mark.cuda
def test_staged_pair_kernels_match_plain_on_card(cuda_device):
    # K3, K7a and K7b at the stage widths of 240x135 rays (32 768, 16 384
    # and 8 192 lanes) against the plain versions with the same injected
    # uniforms: radiance within 1e-5 per lane, every field's gradient
    # cosine >= 0.99999; each kernel launched.
    dev = cuda_device
    scene_j = mixed_scene()
    o, d, _ = camera_rays(rtw.default_camera(), 240, 135)
    g = torch.Generator(device=dev).manual_seed(0)
    u5 = {}

    def u5_fn(b, n):
        if (b, n) not in u5:
            u5[b, n] = torch.rand((5, n), generator=g, device=dev)
        return u5[b, n]

    out = []
    for impl in ("kernels", "plain"):
        scene = pt.scene_from_numpy(scene_j, device=dev, requires_grad=True)
        before = (K.masked_launches, GK.record_launches,
                  GK.replay_step_launches)
        r = pt.trace_recorded_fused_staged(
            scene, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev),
            7, 8, 1e-4, STAGES, impl=impl, u5_fn=u5_fn)
        (r * r).mean().backward()
        after = (K.masked_launches, GK.record_launches,
                 GK.replay_step_launches)
        assert all((a > b) == (impl == "kernels")
                   for a, b in zip(after, before))
        out.append((r.detach().cpu(), [getattr(scene, f).grad.cpu()
                                       for f in FIELDS]))
    assert (out[0][0] - out[1][0]).abs().max() <= 1e-5
    for a, b in zip(out[0][1], out[1][1]):
        cos, _ = _cos_ratio(a, b)
        assert cos >= 0.99999
