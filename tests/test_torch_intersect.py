"""K1 (the sphere sweep) and the dot-form sweep of the port against the JAX
package; card-only checks of the CUDA kernel against its plain version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.camera import get_rays as jget_rays
from raytracingweekend_jl_tpu.ops.pallas.intersect_kernel import (
    intersect_spheres_pallas)
from raytracingweekend_jl_tpu.scene import trim_scene as jtrim
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SCENES = {"random_spheres": (lambda: rtw.scene_random_spheres(seed=1),
                             rtw.t_cam1),
          "diel_spheres_hollow": (rtw.scene_diel_spheres_hollow,
                                  rtw.hollow_glass_cam)}


def _rays(name, n_cam=1024, n_rand=1024, seed=0):
    """Camera rays of the scene's camera plus random rays around the scene."""
    import jax
    g = np.random.default_rng(seed)
    u = g.random(n_cam, dtype=np.float32)
    v = g.random(n_cam, dtype=np.float32)
    oc, dc = jget_rays(SCENES[name][1](), jnp.asarray(u), jnp.asarray(v),
                       jax.random.PRNGKey(seed))
    o = g.uniform(-6, 6, (n_rand, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) + 0.05
    d = g.normal(size=(n_rand, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (np.concatenate([np.asarray(oc), o]),
            np.concatenate([np.asarray(dc), d]))


def _rays6(o, d, device="cpu"):
    return torch.from_numpy(np.concatenate([o.T, d.T])).contiguous().to(device)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sweep_ref_matches_pallas_interpret(name):
    # K1's plain version against the TPU kernel in interpret mode on the
    # trimmed scene: hit and index identical; t within rtol = atol = 1e-3,
    # the JAX package's own tolerance for this kernel (the expanded form's
    # cancellation reaches a 2.3e-3 relative gap on grazing rays between
    # two evaluation orders).
    sj = jtrim(SCENES[name][0]())
    o, d = _rays(name)
    ref = intersect_spheres_pallas(jnp.asarray(o), jnp.asarray(d), sj,
                                   interpret=True)
    t, idx = K.sweep_ref(_rays6(o, d), K.sphere_consts(pt.scene_from_numpy(sj)))
    hit = np.asarray(ref.hit)
    np.testing.assert_array_equal(t.numpy() < K.BIG, hit)
    np.testing.assert_array_equal(idx.numpy()[hit], np.asarray(ref.index)[hit])
    np.testing.assert_allclose(t.numpy()[hit], np.asarray(ref.t)[hit],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_dot_form_sweep_matches_jax(name):
    # The port's CPU sweep is the JAX package's dot form evaluated in the
    # same operation order: identical indices, t equal bit for bit on at
    # least 99% of hits (the rest differ in the last bit where the two
    # libraries round a three-term sum differently).
    sj = SCENES[name][0]()
    o, d = _rays(name, seed=1)
    a = rtw.intersect_spheres(jnp.asarray(o), jnp.asarray(d), sj)
    b = pt.intersect_spheres(torch.from_numpy(o), torch.from_numpy(d),
                             pt.scene_from_numpy(sj))
    hit = np.asarray(a.hit)
    np.testing.assert_array_equal(b.hit.numpy(), hit)
    np.testing.assert_array_equal(b.index.numpy(), np.asarray(a.index))
    assert b.index.dtype == torch.int32
    same = (b.t.numpy() == np.asarray(a.t))[hit]
    assert same.mean() >= 0.99, same.mean()


def test_sweep_wrapper_on_cpu_runs_plain_version():
    sc = pt.trim_scene(pt.scene_4_spheres())
    o, d = _rays("diel_spheres_hollow", 64, 64)
    before = K.launches
    t, idx = K.sweep(_rays6(o, d), K.sphere_consts(sc))
    t2, idx2 = K.sweep_ref(_rays6(o, d), K.sphere_consts(sc))
    assert K.launches == before
    assert torch.equal(t, t2) and torch.equal(idx, idx2)


def test_sweep_ref_ties_keep_first_index():
    # Two identical spheres: the strict t < best_t update keeps index 0.
    sc = pt.make_scene([pt.lambertian((0, 0, -2), 0.5, (1, 1, 1)),
                        pt.lambertian((0, 0, -2), 0.5, (1, 1, 1))])
    rays = torch.tensor([[0.0], [0.0], [0.0], [0.0], [0.0], [-1.0]])
    t, idx = K.sweep_ref(rays, K.sphere_consts(sc))
    assert idx.item() == 0 and abs(t.item() - 1.5) < 1e-6


@pytest.mark.cuda
def test_sweep_kernel_matches_plain_on_card(cuda_device):
    # Built with --fmad=false, the kernel evaluates the plain version's
    # expressions in the same order: idx identical, t bit-equal on >= 99.99%
    # of rays and within a relative 1e-6 on all.
    sj = jtrim(rtw.scene_random_spheres(seed=1))
    o, d = _rays("random_spheres", 1 << 14, 1 << 14, seed=2)
    rays = _rays6(o, d, cuda_device)
    sph = K.sphere_consts(pt.scene_from_numpy(sj, device=cuda_device))
    before = K.launches
    t, idx = K.sweep(rays, sph)
    torch.cuda.synchronize()
    assert K.launches == before + 1
    tr, ir = K.sweep_ref(rays, sph)
    assert torch.equal(idx, ir)
    assert (t == tr).float().mean().item() >= 0.9999
    assert ((t - tr).abs() <= 1e-6 * tr.abs()).all()
