"""K9 with its winner fetch inside: the plain entry the pinned route calls
(``shade_and_regen_fetch_ref``: the gather, then the attribute-level step)
against the gather plus ``shade_and_regen_ref`` and against the JAX
package's fetch and ``shade_and_regen`` (interpret mode); the route with the
kernels' impl calls no gather of its own and gives the bits of the route
before K9 took the fetch. Card-only: K9 bit for bit K1 + gather + the kept
previous K9, and against its plain version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.materials import (
    attr_mat as jax_attr_mat, fetch_attr_planes as jax_fetch)
from raytracingweekend_jl_tpu.ops.pallas.shade_kernel import (
    shade_and_regen as jshade_and_regen)
from raytracingweekend_jl_tpu.scene import trim_scene as jtrim
from raytracingweekend_jl_tpu_torch.ops import integrator as I
from raytracingweekend_jl_tpu_torch.ops import materials
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
from raytracingweekend_jl_tpu_torch.ops.materials import (attr_mat,
                                                          fetch_attr_planes)
from test_torch_pinned import SCENES
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

W, H, LAST, DEPTH = 48, 27, 3, 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pinned(name, iters, device="cpu"):
    """The scene's tables, camera constants, film and a pinned state after
    ``iters`` plain iterations of a 48x27 spp 4 render (numpy uniforms)."""
    scene_fn, cam_name = SCENES[name]
    sj = jtrim(scene_fn())
    scene = pt.scene_from_numpy(sj, device=device)
    cam = getattr(pt, cam_name)(device=device)
    u, v = pt.pixel_coords(W, H, device=device)
    n = u.shape[0]
    org, d = I.pinned_start_rays(cam, u, v, 1, 0, float(W), float(H))
    fs = torch.zeros((12, n), device=device)
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=torch.int32, device=device)
    ist[2] = 1
    cc = K2.pack_camera_consts(cam, W, H)
    tables = (scene, K1.sphere_consts(scene), attr_mat(scene))
    g = np.random.default_rng(iters)
    for it in range(iters):
        t, idx = I.sweep_hits(tables, fs[0:6], 1e-4, "plain")
        u9 = torch.from_numpy(g.random((9, n), dtype=np.float32)).to(device)
        K2.shade_and_regen_fetch_ref(fs, ist, t, idx, tables[2], u, v, cc, 0,
                                     it, LAST, DEPTH, u9)
    return sj, tables, cc, u, v, fs, ist


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("iters", [0, 12, 24])
def test_fetch_entry_is_gather_plus_step_ref(name, iters):
    # The pinned route's plain entry is the gather followed by the
    # attribute-level step, bit for bit, at the start, mid-render and late
    # (live hit and miss lanes and idle lanes present after 12 and 24
    # iterations), with Philox and with injected uniforms; the CPU wrapper
    # runs it and counts no launch.
    _, tables, cc, u, v, fs, ist = _pinned(name, iters)
    t, idx = I.sweep_hits(tables, fs[0:6], 1e-4, "plain")
    assert idx.dtype == torch.int32
    active = ist[2] != 0
    if iters:
        assert (active & (t < K1.BIG)).any() and (active & (t >= K1.BIG)).any()
        assert (~active).any()
    u9 = torch.from_numpy(np.random.default_rng(50 + iters).random(
        (9, t.shape[0]), dtype=np.float32))
    before = K2.pinned_launches
    for draws in (None, u9):
        outs = []
        for run in ("entry", "gather", "wrapper"):
            x = [fs.clone(), ist.clone()]
            if run == "entry":
                K2.shade_and_regen_fetch_ref(*x, t, idx, tables[2], u, v, cc,
                                             7, iters, LAST, DEPTH, draws)
            elif run == "gather":
                K2.shade_and_regen_ref(*x, t, fetch_attr_planes(idx, tables[2]),
                                       u, v, cc, 7, iters, LAST, DEPTH, draws)
            else:
                K2.shade_and_regen_fetch(*x, t, idx, tables[2], u, v, cc, 7,
                                         iters, LAST, DEPTH, draws)
            outs.append(x)
        for a, b, c in zip(*outs):
            assert torch.equal(a, b) and torch.equal(a, c)
    assert K2.pinned_launches == before


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fetch_entry_matches_jax_fetch_and_interpret_kernel(name):
    # The same mid-render state (iteration 12), winners and injected
    # uniforms through the JAX package's fetch (its one-hot contraction) and
    # shade_and_regen (interpret mode), and through the port's plain entry.
    # The fetched attributes are exact; the step under
    # test_pinned_step_matches_jax's tolerance: integer planes identical,
    # float planes within 1e-5 * max(1, |x|) on >= 99.9% of lanes (the JAX
    # package's jitted interpret mode contracts a*b+c into FMA, eager
    # PyTorch does not).
    sj, tables, cc, u, v, fs, ist = _pinned(name, 12)
    t, idx = I.sweep_hits(tables, fs[0:6], 1e-4, "plain")
    n = t.shape[0]
    n_sph = tables[2].shape[0]
    attrs_j = np.asarray(jax_fetch(jnp.asarray(idx.numpy()),
                                   jax_attr_mat(sj)[:n_sph], n_sph))
    np.testing.assert_array_equal(attrs_j.reshape(10, n),
                                  fetch_attr_planes(idx, tables[2]).numpy())
    u9 = torch.from_numpy(np.random.default_rng(9).random((9, n),
                                                          dtype=np.float32))
    state = tuple(jnp.asarray(x) for x in fs.numpy()) + tuple(
        jnp.asarray(x) for x in ist.numpy())
    ref = jshade_and_regen(state, jnp.asarray(t.numpy()),
                           jnp.asarray(attrs_j.reshape(10, n)),
                           jnp.asarray(u.numpy()), jnp.asarray(v.numpy()),
                           jnp.asarray(cc.numpy()), 12, LAST, DEPTH, 1e-4,
                           interpret=True, rng_u9=jnp.asarray(u9.numpy()))
    K2.shade_and_regen_fetch_ref(fs, ist, t, idx, tables[2], u, v, cc, 0, 12,
                                 LAST, DEPTH, u9)
    rf = np.stack([np.asarray(x) for x in ref[:12]])
    ri = np.stack([np.asarray(x) for x in ref[12:]])
    np.testing.assert_array_equal(ist.numpy(), ri)
    ok = (np.abs(fs.numpy() - rf) <= 1e-5 * np.maximum(1, np.abs(rf))).all(0)
    assert ok.mean() >= 0.999, ok.mean()
    assert 0 < ist[2].sum() < n


def _forced(iteration):
    """A pinned iteration with the impl forced to "kernels" (on the CPU
    each wrapper runs its plain version; K1's is ``sweep_ref``)."""
    def run(impl, *args):
        iteration("kernels", *args)
    return run


def _route_before(impl, tables, fs, ist, u, v, cc, seed32, it, last, depth,
                  tmin, u9):
    """The pinned iteration before K9 took the fetch: the sweep, a gather
    of ten planes, then the previous K9's wrapper."""
    t, attrs = I.sweep_attr_planes(tables, fs[0:6], tmin, impl)
    K2.shade_and_regen(fs, ist, t, attrs, u, v, cc, seed32, it, last, depth,
                       u9)


@pytest.mark.parametrize("name", ["4_spheres", "random_spheres"])
def test_kernels_route_gathers_nothing_and_keeps_its_bits(monkeypatch, name):
    # With the impl forced to "kernels" on the CPU, the pinned iteration is
    # K1 and K9 only: it calls neither sweep_attr_planes nor the
    # integrator's gather, and the one gather per iteration is the plain K9
    # entry's own. The whole render through the loop of
    # persistent_render_sum_fused (Philox draws) is bitwise the render
    # through the iteration it replaced (K1, gather, previous K9).
    scene_fn, cam_name = SCENES[name]
    sc = pt.scene_from_numpy(jtrim(scene_fn()))
    cam = getattr(pt, cam_name)()
    u, v = pt.pixel_coords(32, 18)
    args = (sc, cam, u, v, 7, 2, 0, DEPTH, 1e-4, 32.0, 18.0, None, None,
            None)
    before = I.pinned_render_loop(*args, _forced(_route_before))
    calls = []
    real = K2.shade_and_regen_fetch

    def counted(*a, **k):
        calls.append(materials.fetch_calls)
        real(*a, **k)
        assert materials.fetch_calls == calls[-1] + 1

    def refuse(*a, **k):
        raise AssertionError("the kernels' pinned iteration gathered")

    monkeypatch.setattr(I, "sweep_attr_planes", refuse)
    monkeypatch.setattr(I, "fetch_attr_planes", refuse)
    monkeypatch.setattr(K2, "shade_and_regen_fetch", counted)
    out = I.pinned_render_loop(*args, _forced(I._pinned_iteration))
    assert len(calls) >= DEPTH
    assert torch.equal(out, before)
    assert out.sum() > 0


@pytest.mark.cuda
def test_pinned_fetch_kernel_bitwise_previous_on_card(cuda_device):
    # K9 on the card against K1 + gather + the kept previous K9 on the
    # even rows of a 512x288 image of the flagship scene, before iterations
    # 0, 8 and 24: every state word bit for bit, injected and Philox draws;
    # one launch per call. And against its plain version under
    # test_pinned_kernel_matches_plain_on_card's tolerance.
    dev = cuda_device
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    cam = pt.t_cam1(device=dev)
    Wc, Hc = 512, 288
    u, v = pt.pixel_coords(Wc, Hc, device=dev)
    rows = torch.arange(Wc * Hc, device=dev).reshape(Hc, Wc)[::2].reshape(-1)
    u, v = u[rows].contiguous(), v[rows].contiguous()
    n = u.shape[0]
    org, d = I.pinned_start_rays(cam, u, v, 0, 0, float(Wc), float(Hc))
    fs = torch.zeros((12, n), device=dev)
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=torch.int32, device=dev)
    ist[2] = 1
    cc = K2.pack_camera_consts(cam, Wc, Hc)
    spheres, amat = K1.sphere_consts(scene), attr_mat(scene)
    g = torch.Generator(device=dev).manual_seed(2)
    for it in range(25):
        t, idx = K1.sweep(fs[0:6], spheres)
        if it in (0, 8, 24):
            for u9 in (torch.rand((9, n), generator=g, device=dev), None):
                a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
                before = K2.pinned_launches
                K2.shade_and_regen_fetch(*a, t, idx, amat, u, v, cc, 5, it, 3,
                                         16, u9)
                torch.cuda.synchronize()
                assert K2.pinned_launches == before + 1
                K2.shade_and_regen(*b, t, fetch_attr_planes(idx, amat), u, v,
                                   cc, 5, it, 3, 16, u9)
                assert torch.equal(a[0].view(torch.int32),
                                   b[0].view(torch.int32))
                assert torch.equal(a[1], b[1])
                c = [fs.clone(), ist.clone()]
                K2.shade_and_regen_fetch_ref(*c, t, idx, amat, u, v, cc, 5,
                                             it, 3, 16, u9)
                ok = (a[1] == c[1]).all(0) & (
                    (a[0] - c[0]).abs() <= 1e-6 * c[0].abs().clamp(min=1)
                ).all(0)
                assert ok.float().mean() >= 0.9999
        K2.shade_and_regen_fetch(fs, ist, t, idx, amat, u, v, cc, 5, it, 3,
                                 16)
    assert 0 < int(ist[2].sum()) < n
