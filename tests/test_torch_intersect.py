"""K1 (the sphere sweep), K10 (the sweep with the winner's attribute fetch),
their backward passes and the dot-form sweep of the port against the JAX
package; card-only checks of the CUDA kernels against their plain
versions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.camera import get_rays as jget_rays
from raytracingweekend_jl_tpu.ops.pallas.intersect_kernel import (
    intersect_fetch_pallas, intersect_spheres_pallas)
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
    # same operation order: identical hits and indices, and on every hit t
    # within 4x the first-order rounding-error bound of the half-b
    # quadratic, u * (hb^2 + |o|^2 + 2|o.c| + |ck| + 2 (|o.d| + |c.d|) |hb|)
    # / sqrt(disc) + 2 u |t| with u = 2^-24, which holds whichever way a
    # host's XLA build rounds or contracts the three-term sums. Bit equality
    # is not held: it measures that contraction (89.6% and 90.2% of hits on
    # one x86 host, 99% on another). Measured on the first: the largest gap
    # 0.65 of the bound (5.9e-4 relative, on a grazing hit of random_spheres;
    # 1.2e-5 on diel_spheres_hollow).
    sj = SCENES[name][0]()
    o, d = _rays(name, seed=1)
    a = rtw.intersect_spheres(jnp.asarray(o), jnp.asarray(d), sj)
    b = pt.intersect_spheres(torch.from_numpy(o), torch.from_numpy(d),
                             pt.scene_from_numpy(sj))
    hit = np.asarray(a.hit)
    np.testing.assert_array_equal(b.hit.numpy(), hit)
    np.testing.assert_array_equal(b.index.numpy(), np.asarray(a.index))
    assert b.index.dtype == torch.int32
    ta, tb = np.asarray(a.t)[hit], b.t.numpy()[hit]
    o64, d64 = o[hit].astype(np.float64), d[hit].astype(np.float64)
    idx = np.asarray(a.index)[hit]
    c = np.asarray(sj.center, np.float64)[idx]
    ck = (c * c).sum(-1) - np.asarray(sj.radius, np.float64)[idx] ** 2
    od, cd, oc = (o64 * d64).sum(-1), (c * d64).sum(-1), (o64 * c).sum(-1)
    oo, hb = (o64 * o64).sum(-1), od - cd
    disc = hb * hb - (oo - 2 * oc + ck)
    u = 2.0 ** -24
    bound = (u * (hb * hb + oo + 2 * np.abs(oc) + np.abs(ck)
                  + 2 * (np.abs(od) + np.abs(cd)) * np.abs(hb))
             / np.sqrt(disc) + 2 * u * np.abs(ta))
    gap = np.abs(tb.astype(np.float64) - ta) / bound
    assert (gap <= 4).all(), gap.max()


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


# ---------------------------------------------------------------------------
# The backward of K1 and K10, and K10's forward
# ---------------------------------------------------------------------------

ATTR_NAMES = ("center", "radius", "albedo", "fuzz", "ir", "mat")


def _agreeing_cotangent(name, sj, o, d, seed=5):
    """A random cotangent on t, zero on the rays where the port's sweep_ref
    and the JAX kernel in interpret mode disagree on t in any bit. A
    last-bit change of t moves p = o + t d - c and with it 1 / (p . d),
    which is unbounded on grazing hits; on the rays where the two forwards
    agree the backward passes must agree to rounding."""
    sc = pt.scene_from_numpy(sj)
    t_port, _ = K.sweep_ref(_rays6(o, d), K.sphere_consts(sc))
    t_jax = np.asarray(intersect_spheres_pallas(
        jnp.asarray(o), jnp.asarray(d), sj, interpret=True).t)
    same = t_port.numpy() == t_jax
    assert same.mean() >= 0.5, same.mean()
    g = np.random.default_rng(seed).normal(size=o.shape[0]) * same
    return g.astype(np.float32)


def _close(a, b, rel):
    b = np.asarray(b)
    return np.abs(np.asarray(a) - b) <= rel * np.maximum(1, np.abs(b))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sweep_vjp_matches_jax(name):
    # The port's autograd.Function over sweep_ref against jax.vjp of
    # intersect_spheres_pallas(interpret=True), with a random cotangent on
    # t (on the rays whose t agrees bitwise, see _agreeing_cotangent):
    # d_origin, d_direction, d_centers and d_radius within
    # 1e-5 * max(1, |x|) (measured: rays exactly equal, sphere sums within
    # 9.6e-7; 59% and 65% of the rays carry a cotangent). The sphere sums go
    # through the ordered contraction.
    import jax
    sj = jtrim(SCENES[name][0]())
    o, d = _rays(name, 512, 512)
    g = _agreeing_cotangent(name, sj, o, d)

    def f(o_, d_, c_, r_):
        return intersect_spheres_pallas(
            o_, d_, sj._replace(center=c_, radius=r_), interpret=True).t

    _, vjp = jax.vjp(f, jnp.asarray(o), jnp.asarray(d), sj.center, sj.radius)
    ref = vjp(jnp.asarray(g))
    sc = pt.scene_from_numpy(sj)
    leaves = [torch.from_numpy(o).requires_grad_(),
              torch.from_numpy(d).requires_grad_(),
              sc.center.clone().requires_grad_(),
              sc.radius.clone().requires_grad_()]
    hit = K.intersect_spheres_kernel(
        leaves[0], leaves[1], sc._replace(center=leaves[2], radius=leaves[3]))
    out = torch.autograd.grad(hit.t, leaves, torch.from_numpy(g))
    for what, a, b in zip(("origin", "direction", "center", "radius"), out,
                          ref):
        assert _close(a.numpy(), b, 1e-5).all(), what


def test_sweep_vjp_is_order_free():
    # Permuting the rays permutes the ray gradients and leaves the sphere
    # gradients bitwise equal (the ordered contraction, not atomics).
    sc = pt.trim_scene(pt.scene_random_spheres(seed=1))
    o, d = _rays("random_spheres", 512, 512, seed=3)
    g = torch.from_numpy(np.random.default_rng(0).normal(
        size=o.shape[0]).astype(np.float32))
    perm = torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(1))

    def grads(o_, d_, g_):
        leaves = [torch.from_numpy(o_).requires_grad_(),
                  torch.from_numpy(d_).requires_grad_(),
                  sc.center.clone().requires_grad_(),
                  sc.radius.clone().requires_grad_()]
        hit = K.intersect_spheres_kernel(
            leaves[0], leaves[1],
            sc._replace(center=leaves[2], radius=leaves[3]))
        return torch.autograd.grad(hit.t, leaves, g_)

    a = grads(o, d, g)
    b = grads(o[perm.numpy()], d[perm.numpy()], g[perm])
    assert torch.equal(a[0][perm], b[0]) and torch.equal(a[1][perm], b[1])
    assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    assert a[2].abs().sum() > 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sweep_fetch_matches_jax(name):
    # K10's plain version through intersect_fetch_kernel against
    # intersect_fetch_pallas(interpret=True): hits and indices identical,
    # t as K1's test holds it, the six attribute rows (with the miss
    # defaults) exactly equal.
    sj = jtrim(SCENES[name][0]())
    o, d = _rays(name)
    hj, aj = intersect_fetch_pallas(jnp.asarray(o), jnp.asarray(d), sj,
                                    interpret=True)
    hp, ap = K.intersect_fetch_kernel(torch.from_numpy(o), torch.from_numpy(d),
                                      pt.scene_from_numpy(sj))
    hit = np.asarray(hj.hit)
    np.testing.assert_array_equal(hp.hit.numpy(), hit)
    np.testing.assert_array_equal(hp.index.numpy()[hit],
                                  np.asarray(hj.index)[hit])
    np.testing.assert_allclose(hp.t.numpy()[hit], np.asarray(hj.t)[hit],
                               rtol=1e-3, atol=1e-3)
    for what, a, b in zip(ATTR_NAMES, ap, aj):
        assert a.dtype == (torch.int32 if what == "mat" else torch.float32)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=what)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sweep_fetch_vjp_matches_jax(name):
    # K10's backward against jax.vjp of intersect_fetch_pallas with
    # cotangents on t (on the agreeing rays) and on every attribute row:
    # rays and the five fields within 1e-5 * max(1, |x|) (measured: rays
    # exactly equal, fields within 3.7e-6). mat gets no gradient.
    import jax
    sj = jtrim(SCENES[name][0]())
    o, d = _rays(name, 512, 512)
    g = _agreeing_cotangent(name, sj, o, d)
    fields = pt.DIFF_FIELDS

    def f(o_, d_, *vals):
        h, at = intersect_fetch_pallas(o_, d_, sj._replace(**dict(zip(
            fields, vals))), interpret=True)
        return (h.t,) + tuple(at[:5])

    outs, vjp = jax.vjp(f, jnp.asarray(o), jnp.asarray(d),
                        *(getattr(sj, k) for k in fields))
    gen = np.random.default_rng(6)
    cots = [g] + [gen.normal(size=np.shape(x)).astype(np.float32)
                  for x in outs[1:]]
    ref = vjp(tuple(jnp.asarray(c) for c in cots))
    sc = pt.scene_from_numpy(sj)
    leaves = [torch.from_numpy(o).requires_grad_(),
              torch.from_numpy(d).requires_grad_()] + [
        getattr(sc, k).clone().requires_grad_() for k in fields]
    h, at = K.intersect_fetch_kernel(
        leaves[0], leaves[1], sc._replace(**dict(zip(fields, leaves[2:]))))
    out = torch.autograd.grad([h.t] + list(at[:5]), leaves,
                              [torch.from_numpy(c) for c in cots])
    for what, a, b in zip(("origin", "direction") + fields, out, ref):
        assert _close(a.numpy(), b, 1e-5).all(), what


def test_sweep_fetch_ref_is_sweep_plus_gather():
    # K10's plain version is sweep_ref followed by a gather of the winner's
    # attr_mat row, zeros on a miss: bitwise.
    from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat
    sc = pt.trim_scene(pt.scene_random_spheres(seed=1))
    o, d = _rays("random_spheres", 256, 256)
    rays, sph, amat = _rays6(o, d), K.sphere_consts(sc), attr_mat(sc)
    t, idx, attrs = K.sweep_fetch_ref(rays, sph, amat)
    t1, idx1 = K.sweep_ref(rays, sph)
    assert torch.equal(t, t1) and torch.equal(idx, idx1)
    hit = t < K.BIG
    assert torch.equal(attrs[:, hit], amat[idx[hit].long()].T)
    assert (attrs[:, ~hit] == 0).all() and (~hit).any()
    before = K.fetch_launches
    out = K.sweep_fetch(rays, sph, amat)
    assert K.fetch_launches == before
    assert all(torch.equal(x, y) for x, y in zip(out, (t, idx, attrs)))


@pytest.mark.cuda
def test_sweep_fetch_kernel_matches_plain_on_card(cuda_device):
    # K10 on the card: idx identical to its plain version, t bitwise K1's,
    # the attribute planes equal; one launch per call.
    from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat
    sj = jtrim(rtw.scene_random_spheres(seed=1))
    o, d = _rays("random_spheres", 1 << 14, 1 << 14, seed=2)
    rays = _rays6(o, d, cuda_device)
    sc = pt.scene_from_numpy(sj, device=cuda_device)
    sph, amat = K.sphere_consts(sc), attr_mat(sc)
    before = K.fetch_launches
    t, idx, attrs = K.sweep_fetch(rays, sph, amat)
    torch.cuda.synchronize()
    assert K.fetch_launches == before + 1
    t1, _ = K.sweep(rays, sph)
    tr, ir, ar = K.sweep_fetch_ref(rays, sph, amat)
    assert torch.equal(idx, ir) and torch.equal(t, t1)
    assert torch.equal(attrs, ar)
