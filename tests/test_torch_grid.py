"""The port's two-level cluster sweep (K13's plain version,
``ops/experimental/grid.py``) against the JAX package's
``ops/pallas/experimental/grid_kernel.py``: ``build_grid`` array for array,
the sweep against ``intersect_spheres_grid(interpret=True)`` and against
the flat sweep, culling on tile-ordered rays, a scene of big spheres.
Card-only: K13 against its plain version."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu import rng as jrng
from raytracingweekend_jl_tpu.camera import get_rays as jget_rays
from raytracingweekend_jl_tpu.ops.pallas.experimental import (
    grid_kernel as JG)
from raytracingweekend_jl_tpu.render import pixel_coords as jpixel_coords
from raytracingweekend_jl_tpu.scene import trim_scene as jtrim
from raytracingweekend_jl_tpu_torch.ops.cuda import grid_kernel as GK
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.experimental import grid as G
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(W=48, H=27, seed=3):
    """The flagship camera's rays at W x H, row-major, as numpy."""
    u, v = jpixel_coords(W, H)
    key = jax.random.PRNGKey(seed)
    o, d = jget_rays(rtw.t_cam1(), u, v, jrng.purpose_key(key, jrng.LENS))
    return np.asarray(o), np.asarray(d)


def _tile_perm(W, H, tw, th):
    """Pixels reordered so that consecutive rays cover ``tw x th`` image
    tiles (``scripts/spatial_probe.py``'s ``tile_perm``)."""
    i, j = np.mgrid[0:H, 0:W]
    key = ((i // th) * ((W + tw - 1) // tw) + (j // tw)) * (W * H) \
        + (i % th) * tw + (j % tw)
    return np.argsort(key.ravel(), kind="stable")


@pytest.fixture(scope="module")
def flagship():
    sj = jtrim(rtw.scene_random_spheres(seed=1))
    return sj, pt.scene_from_numpy(sj)


@pytest.mark.parametrize("name", ["random_spheres", "2_spheres",
                                  "4_spheres"])
def test_build_grid_matches_jax(name):
    # Every array and the layout equal to the JAX package's build_grid
    # (ck and bk computed in float64, stored in float32, by both).
    sj = jtrim(rtw.ALL_SCENES[name]())
    want = JG.build_grid(sj)
    got = G.build_grid(pt.scene_from_numpy(sj))
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_grid_sweep_ref_matches_jax_interpret(flagship):
    # The plain grid sweep against intersect_spheres_grid(interpret=True) on
    # the flagship camera's rays (48x27): hit and idx identical; t within
    # 5e-5 relative (tests/test_grid_kernel.py's bound for the JAX grid
    # against the JAX flat sweep) on >= 99% of hits and within the K1
    # test's rtol = atol = 1e-3 on all: JAX's jitted interpret mode
    # contracts a*b+c into FMA and eager PyTorch does not, and the expanded
    # quadratic's cancellation amplifies that on grazing hits (measured: 5
    # of 1 095 hits above 5e-5, the largest 1.1e-4).
    sj, sc = flagship
    o, d = _rays()
    hj, _ = JG.intersect_spheres_grid(jnp.asarray(o), jnp.asarray(d), sj,
                                      interpret=True)
    hp, skips = G.intersect_spheres_grid(torch.from_numpy(o),
                                         torch.from_numpy(d), sc)
    hit = np.asarray(hj.hit)
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(hp.hit.numpy(), hit)
    np.testing.assert_array_equal(hp.index.numpy(), np.asarray(hj.index))
    a, b = hp.t.numpy()[hit], np.asarray(hj.t)[hit]
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
    assert (np.abs(a - b) <= 1e-5 + 5e-5 * np.abs(b)).mean() >= 0.99
    assert skips.shape == (-(-o.shape[0] // 32),)


@pytest.mark.parametrize("order", ["row_major", "tile32"])
def test_grid_sweep_ref_matches_flat_sweep(flagship, order):
    # Against the flat sweep (K1's plain version) on the same rays: hit and
    # idx identical (no hit is culled: a bound contains its members), t
    # within 5e-5 relative (ck in float64 here, float32 in sphere_consts).
    _, sc = flagship
    o, d = _rays(64, 36)
    if order == "tile32":
        p = _tile_perm(64, 36, 32, 32)
        o, d = o[p], d[p]
    rays = torch.from_numpy(np.concatenate([o.T, d.T])).contiguous()
    t, idx, _ = G.grid_sweep(rays, G.grid_tables(G.build_grid(sc)))
    tf, idf = K.sweep_ref(rays, K.sphere_consts(sc))
    hit = tf < K.BIG
    assert torch.equal(t < K.BIG, hit)
    assert torch.equal(idx, torch.where(hit, idf, torch.zeros_like(idf)))
    np.testing.assert_allclose(t[hit].numpy(), tf[hit].numpy(), rtol=5e-5,
                               atol=1e-5)


def test_grid_sweep_culls_tile_ordered_rays(flagship):
    # Rays ordered in 32x32 image tiles give warps narrow frusta: warps
    # cull clusters (skips > 0), and more of them than in row-major order
    # over the same rays; each warp's count is at most K.
    _, sc = flagship
    o, d = _rays(64, 32)
    tabs = G.grid_tables(G.build_grid(sc))
    p = _tile_perm(64, 32, 32, 32)
    cull = {}
    for name, (oo, dd) in {"row_major": (o, d),
                           "tile32": (o[p], d[p])}.items():
        rays = torch.from_numpy(np.concatenate([oo.T, dd.T])).contiguous()
        _, _, skips = G.grid_sweep(rays, tabs)
        assert ((skips >= 0) & (skips <= tabs.K)).all()
        cull[name] = int(skips.sum())
    assert cull["tile32"] > 0 and cull["tile32"] >= cull["row_major"]


def test_grid_sweep_small_scene_all_global():
    # A scene of big spheres and one small one (the JAX package's
    # test_grid_sweep_small_scene_all_global case): the global list holds
    # all but one sphere, one cluster holds it, the other 35 are empty and
    # every warp culls them; hits and t as the JAX grid sweep's.
    sj = jtrim(rtw.ALL_SCENES["2_spheres"]())
    sc = pt.scene_from_numpy(sj)
    o, d = _rays(32, 18)
    g = G.build_grid(sc)
    assert g["n_global"] == sc.n_spheres - 1
    hj, _ = JG.intersect_spheres_grid(jnp.asarray(o), jnp.asarray(d), sj,
                                      interpret=True)
    hp, skips = G.intersect_spheres_grid(torch.from_numpy(o),
                                         torch.from_numpy(d), sc, g)
    hit = np.asarray(hj.hit)
    np.testing.assert_array_equal(hp.hit.numpy(), hit)
    np.testing.assert_allclose(hp.t.numpy()[hit], np.asarray(hj.t)[hit],
                               rtol=5e-5, atol=1e-5)
    assert (skips >= g["K"] - 1).all()


def test_grid_wrapper_on_cpu_runs_plain_version(flagship):
    # On CPU tensors the wrapper runs its plain version and counts no
    # launch; impl="kernels" on the CPU and a device that is neither the
    # CPU nor CUDA raise.
    _, sc = flagship
    o, d = _rays(16, 9)
    rays = torch.from_numpy(np.concatenate([o.T, d.T])).contiguous()
    tabs = G.grid_tables(G.build_grid(sc))
    before = GK.launches
    a = GK.grid_sweep(rays, *tabs, 1e-4)
    b = GK.grid_sweep_ref(rays, *tabs, 1e-4)
    assert GK.launches == before
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        G.grid_sweep(rays, tabs, impl="kernels")
    with pytest.raises(ValueError):
        GK.grid_sweep(rays.to("meta"), *tabs, 1e-4)


@pytest.mark.cuda
def test_grid_kernel_matches_plain_on_card(cuda_device):
    # K13 on the card against its plain version on the flagship camera's
    # rays at 256x144, row-major and in 32x32 tiles: t, idx and skips
    # bitwise equal (the same expressions without FMA, the same per-warp
    # decisions); idx and hits equal to K1's; one launch per call.
    dev = cuda_device
    sc = pt.scene_from_numpy(jtrim(rtw.scene_random_spheres(seed=1)),
                             device=dev)
    tabs = G.grid_tables(G.build_grid(sc), dev)
    o, d = _rays(256, 144)
    for perm in (None, _tile_perm(256, 144, 32, 32)):
        oo, dd = (o, d) if perm is None else (o[perm], d[perm])
        rays = torch.from_numpy(np.concatenate([oo.T, dd.T])).contiguous() \
            .to(dev)
        n = GK.launches
        got = G.grid_sweep(rays, tabs)
        torch.cuda.synchronize()
        assert GK.launches == n + 1
        for a, b in zip(got, GK.grid_sweep_ref(rays, *tabs, 1e-4)):
            assert torch.equal(a, b)
        t1, i1 = K.sweep(rays, K.sphere_consts(sc))
        hit = t1 < K.BIG
        assert torch.equal(got[0] < K.BIG, hit)
        assert torch.equal(got[1][hit], i1[hit])


@pytest.mark.cuda
def test_grid_kernel_bitwise_previous_on_card(cuda_device):
    # K13 (the roots behind disc > 0) against the kept
    # previous kernel (grid_sweep_all_roots) and the plain version, on the
    # flagship camera's rays at 256x144 and on rays leaving their hit
    # points in random directions, each row-major, strided and in 32x32
    # tiles: t, idx and skips bitwise equal to both; one counted launch per
    # call, none for the kept kernel.
    dev = cuda_device
    sc = pt.scene_from_numpy(jtrim(rtw.scene_random_spheres(seed=1)),
                             device=dev)
    tabs = G.grid_tables(G.build_grid(sc), dev)
    o, d = _rays(256, 144)
    cam = torch.from_numpy(np.concatenate([o.T, d.T])).contiguous().to(dev)
    t0, _ = K.sweep(cam, K.sphere_consts(sc))
    hit = torch.where(t0 < K.BIG, t0, torch.ones_like(t0))
    g = np.random.default_rng(5).normal(size=(3, cam.shape[1]))
    g = torch.from_numpy(g / np.linalg.norm(g, axis=0)).float().to(dev)
    bounce = torch.cat([cam[0:3] + hit * cam[3:6], g]).contiguous()
    n = cam.shape[1]
    orders = (None, np.argsort(np.arange(n) % 64, kind="stable"),
              _tile_perm(256, 144, 32, 32))
    for rays in (cam, bounce):
        for perm in orders:
            r = rays if perm is None else rays[:, torch.from_numpy(perm).to(
                dev)].contiguous()
            before = GK.launches
            got = GK.grid_sweep(r, *tabs, 1e-4)
            prev = GK.grid_sweep_all_roots(r, *tabs, 1e-4)
            torch.cuda.synchronize()
            assert GK.launches == before + 1
            ref = GK.grid_sweep_ref(r, *tabs, 1e-4)
            for a, b, c in zip(got, prev, ref):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
                assert torch.equal(a.view(torch.int32), c.view(torch.int32))
