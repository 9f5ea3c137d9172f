"""K10's split schedule (csrc/sweep.cu :: sweep_fetch_kernel): K1's split
sweep, P threads of a warp per ray, then the winner's row of the [N, 10]
attribute table read by index, zeros on a miss.

- Its plain mirror ``sweep_fetch_split_ref`` bitwise ``sweep_fetch_ref``
  (t, idx and all ten planes) for every P and the wrapper's choice, on the
  flagship scene, on ``scene_4_spheres`` with more parts than spheres, on
  ties that cross parts (duplicate spheres with different attributes), and
  on rays that miss, start inside a sphere or carry a NaN.
- The mirror against the JAX package's fused sweep in interpret mode.
- ``sweep_fetch``'s ``parts=`` argument and the one-thread reference's
  wrapper on the CPU.
- Card-only: K10 at every P bitwise the kept one-thread kernel.

Every comparison between the port's versions is bit for bit (no
tolerance): both sweep with the same expressions in the same order and read
the same row.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.pallas.intersect_kernel import (
    intersect_fetch_pallas)
from raytracingweekend_jl_tpu.scene import trim_scene as jtrim
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
from test_torch_intersect import _rays, _rays6
from test_torch_sweep_split import (H100_RESIDENT, _camera_and_scattered,
                                    _flagship)

#: Every forced P, then the wrapper's choice on an H100 ("auto").
PARTS = [1, 2, 4, 8, 16, 32, "auto"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _p(parts, rays, sph):
    """A forced P, or the wrapper's rule on an H100's resident threads."""
    if parts == "auto":
        return K.sweep_parts(rays.shape[1], sph.shape[0], H100_RESIDENT)
    return parts


def _assert_bitwise(a, b):
    """Two ``(t, idx, attrs)`` triples equal in every bit."""
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])
    assert torch.equal(a[2].view(torch.int32), b[2].view(torch.int32))


@pytest.mark.parametrize("parts", PARTS)
def test_fetch_split_ref_is_sweep_fetch_ref_on_the_flagship(parts):
    # Camera and scattered rays against the 488 spheres: every bit of t,
    # idx and the ten planes; hits take their winner's row, misses zeros.
    sc, sph = _flagship()
    amat = attr_mat(sc)
    rays = _camera_and_scattered()
    ref = K.sweep_fetch_ref(rays, sph, amat)
    got = K.sweep_fetch_split_ref(rays, sph, amat, _p(parts, rays, sph))
    _assert_bitwise(got, ref)
    hit = ref[0] < K.BIG
    assert hit.float().mean() > 0.3 and (~hit).any()
    assert torch.equal(got[2][:, hit], amat[got[1][hit].long()].T)
    assert (got[2][:, ~hit] == 0).all()


@pytest.mark.parametrize("parts", PARTS)
def test_fetch_split_ref_with_more_parts_than_spheres(parts):
    # scene_4_spheres cut to its 4 spheres: from 8 parts on, some parts hold
    # no sphere and give (BIG, 0) to the merge; the row read follows the
    # merged index.
    sc = pt.trim_scene(pt.scene_4_spheres(), multiple=1)
    sph, amat = K.sphere_consts(sc), attr_mat(sc)
    assert sph.shape[0] == 4
    o, d = _rays("diel_spheres_hollow", 512, 512, seed=4)
    rays = _rays6(o, d)
    ref = K.sweep_fetch_ref(rays, sph, amat)
    _assert_bitwise(K.sweep_fetch_split_ref(rays, sph, amat,
                                            _p(parts, rays, sph)), ref)
    assert (ref[0] < K.BIG).any()


def _tie_scene():
    """64 spheres far below the scene, with a sphere X at indices 0 and 17
    (in different parts for every P >= 2) and a sphere Y at indices 9 and
    41 (in the same part for every P <= 32); each copy has its own albedo,
    fuzz and material, so the row of the wrong copy shows."""
    g = np.random.default_rng(3)
    c = g.uniform(-50, 50, (64, 3)).astype(np.float32)
    c[:, 1] = -1000.0
    r = np.full(64, 0.5, np.float32)
    for i in (0, 17):
        c[i], r[i] = (0.0, 0.0, -3.0), 1.0
    for i in (9, 41):
        c[i], r[i] = (4.0, 0.0, -3.0), 0.75
    mats = []
    for i, (ci, ri) in enumerate(zip(c, r)):
        alb = (0.1 + 0.01 * i, 0.5, 0.9 - 0.01 * i)
        mats.append(pt.metal(tuple(ci), float(ri), alb, 0.01 * i) if i % 2
                    else pt.lambertian(tuple(ci), float(ri), alb))
    return pt.make_scene(mats)


@pytest.mark.parametrize("parts", PARTS)
def test_fetch_split_ref_ties_cross_parts(parts):
    # Duplicate spheres: the lower index of each pair wins on every ray, in
    # the plain loop (strict t < best_t) and in the merge (least idx among
    # equal t), and the planes are that copy's row, not the other's.
    sc = _tie_scene()
    sph, amat = K.sphere_consts(sc), attr_mat(sc)
    g = np.random.default_rng(5)
    n = 256
    target = np.where(np.arange(n)[:, None] < n // 2, [0.0, 0.0, -3.0],
                      [4.0, 0.0, -3.0])
    o = g.uniform(-0.3, 0.3, (n, 3)) + [0.0, 0.0, 3.0]
    d = target + g.uniform(-0.2, 0.2, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = _rays6(o.astype(np.float32), d.astype(np.float32))
    ref = K.sweep_fetch_ref(rays, sph, amat)
    assert (ref[0] < K.BIG).all()
    assert (ref[1][:n // 2] == 0).all() and (ref[1][n // 2:] == 9).all()
    assert not torch.equal(amat[0], amat[17]) and \
        not torch.equal(amat[9], amat[41])
    got = K.sweep_fetch_split_ref(rays, sph, amat, _p(parts, rays, sph))
    _assert_bitwise(got, ref)
    assert torch.equal(got[2][:, 0], amat[0]) and \
        torch.equal(got[2][:, -1], amat[9])


@pytest.mark.parametrize("parts", PARTS)
def test_fetch_split_ref_misses_inside_and_nan(parts):
    # Rays to the sky miss: (BIG, 0) and ten zeros (not sphere 0's row). A
    # ray from a sphere's center leaves through its far root and takes that
    # sphere's row. A NaN direction accepts nothing: (BIG, 0), zeros.
    sc, sph = _flagship()
    amat = attr_mat(sc)
    k = int(torch.argmax(sc.radius[1:])) + 1  # a large sphere, not the ground
    c = sc.center[k]
    o = torch.tensor([[0.0, 50.0, 0.0], [3.0, 40.0, -2.0], c.tolist(),
                      [0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    d = torch.tensor([[0.0, 1.0, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0],
                      [float("nan"), 0.0, 1.0], [0.0, float("nan"), 0.0]])
    rays = torch.cat([o.T, d.T]).contiguous()
    ref = K.sweep_fetch_ref(rays, sph, amat)
    miss = [0, 1, 3, 4]
    assert (ref[0][miss] == K.BIG).all() and (ref[1][miss] == 0).all()
    assert (ref[2][:, miss] == 0).all() and (amat[0] != 0).any()
    assert ref[1][2] == k and torch.equal(ref[2][:, 2], amat[k])
    _assert_bitwise(K.sweep_fetch_split_ref(rays, sph, amat,
                                            _p(parts, rays, sph)), ref)


@pytest.mark.parametrize("name", ["random_spheres", "diel_spheres_hollow"])
def test_fetch_split_ref_matches_pallas_interpret(name):
    # The split mirror (8 parts) against the TPU kernel's fused sweep in
    # interpret mode (intersect_fetch_pallas): hits and indices identical,
    # t within rtol = atol = 1e-3 (test_sweep_fetch_matches_jax's bound:
    # two evaluation orders of the expanded form), and on hits the ten raw
    # planes equal to the JAX winners' rows.
    from test_torch_intersect import SCENES
    sj = jtrim(SCENES[name][0]())
    o, d = _rays(name)
    hj, aj = intersect_fetch_pallas(jnp.asarray(o), jnp.asarray(d), sj,
                                    interpret=True)
    sc = pt.scene_from_numpy(sj)
    t, idx, a = K.sweep_fetch_split_ref(_rays6(o, d), K.sphere_consts(sc),
                                        attr_mat(sc), 8)
    hit = np.asarray(hj.hit)
    assert hit.mean() > 0.3
    np.testing.assert_array_equal(t.numpy() < K.BIG, hit)
    np.testing.assert_array_equal(idx.numpy()[hit], np.asarray(hj.index)[hit])
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(hj.t)[hit],
                               rtol=1e-3, atol=1e-3)
    jrows = np.concatenate([np.asarray(aj[0]), np.asarray(aj[1])[:, None],
                            np.asarray(aj[2]), np.asarray(aj[3])[:, None],
                            np.asarray(aj[4])[:, None],
                            np.asarray(aj[5])[:, None].astype(np.float32)],
                           1)
    np.testing.assert_array_equal(a.numpy().T[hit], jrows[hit])
    assert (a.numpy()[:, ~hit] == 0).all()


def test_sweep_fetch_parts_argument_and_plain_on_cpu():
    # On the CPU sweep_fetch and the one-thread reference run the plain
    # version (no launch counted) with any P; a P the kernel does not take
    # raises, as sweep's does.
    sc = pt.trim_scene(pt.scene_4_spheres())
    sph, amat = K.sphere_consts(sc), attr_mat(sc)
    o, d = _rays("diel_spheres_hollow", 64, 64)
    rays = _rays6(o, d)
    ref = K.sweep_fetch_ref(rays, sph, amat)
    before = K.fetch_launches
    for parts in (None, 1, 8, 32):
        _assert_bitwise(K.sweep_fetch(rays, sph, amat, parts=parts), ref)
    _assert_bitwise(K.sweep_fetch_one_thread(rays, sph, amat), ref)
    assert K.fetch_launches == before
    for bad in (0, 3, 64, 2.0, "auto"):
        with pytest.raises(ValueError):
            K.sweep_fetch(rays, sph, amat, parts=bad)
    with pytest.raises(ValueError):
        K.sweep_fetch_split_ref(rays, sph, amat, 12)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", PARTS)
def test_fetch_kernel_matches_one_thread_kernel_on_card(cuda_device, parts):
    # K10 with P forced (or the wrapper's own choice): t, idx and the ten
    # planes bitwise the kept one-thread kernel's and the plain mirror's;
    # one launch counted per call, none for the reference.
    sc, _ = _flagship()
    sc = sc.to(cuda_device)
    sph, amat = K.sphere_consts(sc), attr_mat(sc)
    rays = _camera_and_scattered(n=1 << 14).to(cuda_device)
    ref = K.sweep_fetch_one_thread(rays, sph, amat)
    before = K.fetch_launches
    got = K.sweep_fetch(rays, sph, amat,
                        parts=None if parts == "auto" else parts)
    torch.cuda.synchronize()
    assert K.fetch_launches == before + 1
    _assert_bitwise(got, ref)
    mirror = K.sweep_fetch_split_ref(rays.cpu(), sph.cpu(), amat.cpu(),
                                     8 if parts == "auto" else parts)
    assert torch.equal(got[1].cpu(), mirror[1])
    assert torch.equal(got[2].cpu(), mirror[2])
