"""K1's and K3's split schedule (csrc/sweep.cu): a group of P threads
sweeps one ray, part p taking spheres s == p (mod P), and the parts merge
on the lexicographic minimum of (t, idx).

- Its plain mirror ``sweep_split_ref`` bitwise ``sweep_ref`` (and, with a
  live mask, ``sweep_masked_ref``) for every P, on the flagship scene, on
  ``scene_4_spheres`` with more parts than spheres, on ties that cross
  parts, and on rays that miss, start inside a sphere or carry a NaN.
- ``sweep_split_ref`` against the JAX package's sweep in interpret mode.
- K1's choice of P (``sweep_parts``) and the wrappers' argument checks.
- Card-only: the kernels with each P forced, bitwise against the plain
  version's winners and against the kept one-thread kernel
  (``sweep_fetch_one_thread``, the previous K10).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.pallas.intersect_kernel import (
    _sweep_forward)
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
from test_torch_intersect import _rays, _rays6

PARTS = [1, 2, 4, 8, 16, 32]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _flagship():
    """The flagship scene trimmed to 488 spheres, and its table."""
    sc = pt.trim_scene(pt.scene_random_spheres(seed=1))
    assert sc.n_spheres == 488
    return sc, K.sphere_consts(sc)


def _camera_and_scattered(n=1024, seed=0):
    """``[6, 2n]`` rays of the flagship: n camera rays of ``t_cam1`` (film
    coordinates and lens samples from numpy), then n rays leaving their hit
    points (or the camera, on a miss) in numpy-drawn unit directions."""
    g = np.random.default_rng(seed)
    _, sph = _flagship()
    s, t = (torch.from_numpy(g.random(n, dtype=np.float32)) for _ in "st")
    r, a = np.sqrt(g.random(n)), 2 * np.pi * g.random(n)
    disk = torch.from_numpy(np.stack([r * np.cos(a), r * np.sin(a)], 1)
                            .astype(np.float32))
    o, d = pt.make_rays(pt.t_cam1(), s, t, disk)
    cam = torch.cat([o.T, d.T]).contiguous()
    t_cam, _ = K.sweep_ref(cam, sph)
    hit = t_cam < K.BIG
    p = o + torch.where(hit, t_cam, torch.zeros_like(t_cam))[:, None] * d
    d2 = g.normal(size=(n, 3))
    d2 = torch.from_numpy((d2 / np.linalg.norm(d2, axis=1, keepdims=True))
                          .astype(np.float32))
    return torch.cat([cam, torch.cat([p.T, d2.T])], 1).contiguous()


def _assert_bitwise(a, b):
    """Two ``(t, idx)`` pairs equal in every bit."""
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


@pytest.mark.parametrize("parts", PARTS)
def test_split_ref_is_sweep_ref_on_the_flagship(parts):
    # Camera and scattered rays against the 488 spheres: every bit of t
    # and idx; both kinds of ray hit.
    _, sph = _flagship()
    rays = _camera_and_scattered()
    ref = K.sweep_ref(rays, sph)
    _assert_bitwise(K.sweep_split_ref(rays, sph, parts), ref)
    hit = ref[0] < K.BIG
    assert hit[:1024].float().mean() > 0.5 and hit[1024:].any()


@pytest.mark.parametrize("parts", PARTS)
def test_split_ref_with_more_parts_than_spheres(parts):
    # scene_4_spheres cut to its 4 spheres (trim_scene keeps 8 rows): from
    # 8 parts on, some parts hold no sphere and give (BIG, 0) to the merge.
    sc = pt.trim_scene(pt.scene_4_spheres(), multiple=1)
    sph = K.sphere_consts(sc)
    assert sph.shape[0] == 4 and (sc.radius > 0).all()
    o, d = _rays("diel_spheres_hollow", 512, 512, seed=4)
    rays = _rays6(o, d)
    ref = K.sweep_ref(rays, sph)
    _assert_bitwise(K.sweep_split_ref(rays, sph, parts), ref)
    assert (ref[0] < K.BIG).any()


def _tie_table():
    """64 spheres far below the scene, with a sphere X at indices 0 and 17
    (in different parts for every P >= 2) and a sphere Y at indices 9 and
    41 (in the same part for every P <= 32): rays at X and Y tie on t."""
    g = np.random.default_rng(3)
    c = g.uniform(-50, 50, (64, 3)).astype(np.float32)
    c[:, 1] = -1000.0
    r = np.full(64, 0.5, np.float32)
    for i in (0, 17):
        c[i], r[i] = (0.0, 0.0, -3.0), 1.0
    for i in (9, 41):
        c[i], r[i] = (4.0, 0.0, -3.0), 0.75
    sc = pt.make_scene([pt.lambertian(tuple(ci), float(ri), (0.5, 0.5, 0.5))
                        for ci, ri in zip(c, r)])
    return K.sphere_consts(sc)


@pytest.mark.parametrize("parts", PARTS)
def test_split_ref_ties_cross_parts(parts):
    # Duplicate spheres: the lower index of each pair wins on every ray, in
    # the plain loop (strict t < best_t) and in the merge (least idx among
    # equal t), whether the pair lies in one part or in two.
    sph = _tie_table()
    g = np.random.default_rng(5)
    n = 256
    target = np.where(np.arange(n)[:, None] < n // 2, [0.0, 0.0, -3.0],
                      [4.0, 0.0, -3.0])
    o = g.uniform(-0.3, 0.3, (n, 3)) + [0.0, 0.0, 3.0]
    d = target + g.uniform(-0.2, 0.2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = _rays6(o.astype(np.float32), d.astype(np.float32))
    ref = K.sweep_ref(rays, sph)
    assert (ref[0] < K.BIG).all()
    assert (ref[1][:n // 2] == 0).all() and (ref[1][n // 2:] == 9).all()
    _assert_bitwise(K.sweep_split_ref(rays, sph, parts), ref)


@pytest.mark.parametrize("parts", PARTS)
def test_split_ref_misses_inside_and_nan(parts):
    # Rays to the sky miss: (BIG, 0). A ray from a sphere's center leaves
    # through its far root (the near one is behind it). A NaN direction
    # accepts nothing: (BIG, 0).
    sc, sph = _flagship()
    k = int(torch.argmax(sc.radius[1:])) + 1  # a large sphere, not the ground
    c = sc.center[k]
    o = torch.tensor([[0.0, 50.0, 0.0], [3.0, 40.0, -2.0], c.tolist(),
                      [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0],
                      [float("nan"), 0.0, 1.0], [0.0, float("nan"), 0.0]])
    rays = torch.cat([o.T, d.T]).contiguous()
    ref = K.sweep_ref(rays, sph)
    miss = [0, 1, 3, 4]
    assert (ref[0][miss] == K.BIG).all() and (ref[1][miss] == 0).all()
    assert ref[1][2] == k
    assert abs(ref[0][2].item() - sc.radius[k].item()) < 1e-4
    _assert_bitwise(K.sweep_split_ref(rays, sph, parts), ref)


@pytest.fixture(scope="module")
def masked_case():
    """The flagship's camera and scattered rays and a live mask per share
    (numpy draws), with ``sweep_masked_ref``'s results."""
    _, sph = _flagship()
    rays = _camera_and_scattered(n=768, seed=2)
    g = np.random.default_rng(9)
    out = {}
    for share in (0.0, 0.01, 0.62, 1.0):
        alive = torch.from_numpy(
            (g.random(rays.shape[1]) < share).astype(np.int32))
        out[share] = (alive, K.sweep_masked_ref(rays, alive, sph))
    return rays, sph, out


@pytest.mark.parametrize("parts", PARTS)
@pytest.mark.parametrize("share", [0.0, 0.01, 0.62, 1.0])
def test_split_ref_masked_is_sweep_masked_ref(masked_case, share, parts):
    # Only the live lanes are swept, packed in lane order; dead lanes are
    # (BIG, 0). Every bit equals the plain K3's.
    rays, sph, cases = masked_case
    alive, ref = cases[share]
    live = alive != 0
    assert abs(live.float().mean().item() - share) < 0.02
    got = K.sweep_split_ref(rays, sph, parts, alive=alive)
    _assert_bitwise(got, ref)
    assert (got[0][~live] == K.BIG).all() and (got[1][~live] == 0).all()


def test_split_ref_matches_pallas_interpret():
    # The split mirror (8 parts) against the TPU sweep _sweep_forward in
    # interpret mode, given the same ck: hit and index identical, t within
    # rtol = atol = 1e-3, the tolerance of test_sweep_ref_matches_pallas_
    # interpret (two evaluation orders of the expanded form).
    _, sph = _flagship()
    o, d = _rays("random_spheres")
    tj, ij = _sweep_forward(jnp.asarray(o), jnp.asarray(d),
                            jnp.asarray(sph[:, 0:3].numpy()),
                            jnp.asarray(sph[:, 3].numpy()), 1e-4,
                            interpret=True)
    t, idx = K.sweep_split_ref(_rays6(o, d), sph, 8)
    hit = np.asarray(tj) < K.BIG
    assert hit.mean() > 0.3
    np.testing.assert_array_equal(t.numpy() < K.BIG, hit)
    np.testing.assert_array_equal(idx.numpy()[hit], np.asarray(ij)[hit])
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(tj)[hit],
                               rtol=1e-3, atol=1e-3)


H100_RESIDENT = 132 * 2048  # 132 SMs x 8 blocks of K1's 256 threads


@pytest.mark.parametrize("n_rays, n_spheres, want", [
    (32400, 488, 8),      # the flagship's strided lanes
    (262144, 488, 1),     # the flagship step's lanes
    (2073600, 488, 1),    # one film pass
    (32400, 4, 4),        # capped at scene_4_spheres' 4 spheres
    (100, 488, 32),       # a handful of rays: 32 parts each
    (100, 1, 1),
])
def test_sweep_parts_rule(n_rays, n_spheres, want):
    assert K.sweep_parts(n_rays, n_spheres, H100_RESIDENT) == want
    assert K.parts_cap(n_spheres) >= want


def test_wrappers_check_parts_and_run_plain_on_cpu():
    # On the CPU the wrappers run the plain versions (no launch counted),
    # with any P; a P the kernels do not take raises.
    sph = K.sphere_consts(pt.trim_scene(pt.scene_4_spheres()))
    o, d = _rays("diel_spheres_hollow", 64, 64)
    rays = _rays6(o, d)
    alive = torch.ones(rays.shape[1], dtype=torch.int32)
    before = (K.launches, K.masked_launches)
    _assert_bitwise(K.sweep(rays, sph, parts=8), K.sweep_ref(rays, sph))
    _assert_bitwise(K.sweep_masked(rays, alive, sph, parts=4),
                    K.sweep_masked_ref(rays, alive, sph))
    assert (K.launches, K.masked_launches) == before
    for bad in (0, 3, 64, 2.0):
        with pytest.raises(ValueError):
            K.sweep(rays, sph, parts=bad)
    with pytest.raises(ValueError):
        K.sweep_masked(rays, alive, sph, parts=3)
    with pytest.raises(ValueError):
        K.sweep_split_ref(rays, sph, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", PARTS)
def test_split_kernels_match_plain_and_k10_on_card(cuda_device, parts):
    # K1 with P forced: idx identical to sweep_ref's, t and idx bitwise
    # the one-thread kernel's. K3 with P forced: bitwise the one-thread
    # kernel on the live lanes, (BIG, 0) on the dead ones.
    sc, _ = _flagship()
    sc = sc.to(cuda_device)
    sph, amat = K.sphere_consts(sc), attr_mat(sc)
    rays = _camera_and_scattered(n=1 << 14).to(cuda_device)
    t10, i10, _ = K.sweep_fetch_one_thread(rays, sph, amat)
    got = K.sweep(rays, sph, parts=parts)
    torch.cuda.synchronize()
    _assert_bitwise(got, (t10, i10))
    assert torch.equal(got[1], K.sweep_ref(rays, sph)[1])
    g = np.random.default_rng(1)
    for share in (0.01, 0.62):
        alive = torch.from_numpy((g.random(rays.shape[1]) < share)
                                 .astype(np.int32)).to(cuda_device)
        live = alive != 0
        want = (torch.where(live, t10, torch.full_like(t10, K.BIG)),
                torch.where(live, i10, torch.zeros_like(i10)))
        _assert_bitwise(K.sweep_masked(rays, alive, sph, parts=parts), want)
