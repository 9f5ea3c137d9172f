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


def _close(a, b, rel, mass=None):
    """``|a - b| <= rel * max(1, m)`` elementwise, with ``m = |b|`` or, for
    a gradient summed over rays, ``mass``: the sum over the rays of the
    absolute per-ray terms (:func:`_term_mass`). A sum of large terms that
    cancel is only as accurate as its terms are, and its error scales with
    them, not with the result."""
    b = np.asarray(b)
    m = np.abs(b) if mass is None else np.asarray(mass)
    return np.abs(np.asarray(a) - b) <= rel * np.maximum(1, m)


def _term_mass(sj, o, d, g_t, g_attrs=None):
    """Per sphere, ``sum over rays of |per-ray term|`` of the sweep VJP's
    sphere gradients, in float64: the terms the backward hands the ordered
    contraction, ``scale * p`` and ``scale * radius`` at the winner
    (``K._winner_scale``) plus the hit-masked attribute cotangents
    ``g_attrs`` (center [R, 3], radius, albedo [R, 3], fuzz, ir). Returns
    ``{field: [N, ...]}`` for center and radius, and with ``g_attrs`` also
    albedo, fuzz and ir."""
    sc = pt.scene_from_numpy(sj)
    t, idx = K.sweep_ref(_rays6(o, d), K.sphere_consts(sc))
    f64 = torch.float64
    _, _, p, scale = K._winner_scale(
        torch.from_numpy(o).to(f64), torch.from_numpy(d).to(f64),
        sc.center.to(f64), t, idx, torch.from_numpy(g_t).to(f64))
    hit = (t < K.BIG).to(f64)
    ga = [torch.zeros((o.shape[0], 3), dtype=f64), torch.zeros(o.shape[0],
                                                                dtype=f64)]
    if g_attrs is not None:
        ga = [torch.from_numpy(np.asarray(c)).to(f64) for c in g_attrs]
    cols = {"center": (ga[0] * hit[:, None] + scale[:, None] * p).abs(),
            "radius": (ga[1] * hit + scale * sc.radius.to(f64)[idx.long()])
            .abs()}
    for name, c in zip(("albedo", "fuzz", "ir"), ga[2:]):
        cols[name] = (c * (hit[:, None] if c.dim() == 2 else hit)).abs()
    n = sc.center.shape[0]
    return {k: torch.zeros((n,) + v.shape[1:], dtype=f64)
            .index_add_(0, idx.long(), v).numpy() for k, v in cols.items()}


def _hit_ray(t, g_t):
    """The first ray that hits and carries a cotangent on t."""
    return int(np.flatnonzero((t.detach().numpy() < K.BIG) & (g_t != 0))[0])


def _drop_ray(cots, k):
    """The cotangents with ray ``k``'s zeroed (its last axis entry, or row)."""
    out = [np.array(c) for c in cots]
    for c in out:
        c[k] = 0
    return out


def _drops_one_ray(grads, ref, fields, mass):
    """The sphere gradients computed without one ray's terms lie outside
    the limit of :func:`_close` on some entry, and the limit is nowhere
    above 1e-2: it is tight enough to see a single ray go missing from the
    sums."""
    assert max(1e-5 * np.maximum(1, mass[f]).max() for f in fields) <= 1e-2
    return not all(_close(a.numpy(), b, 1e-5, mass[f]).all()
                   for f, a, b in zip(fields, grads, ref))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_sweep_vjp_matches_jax(name):
    # The port's autograd.Function over sweep_ref against jax.vjp of
    # intersect_spheres_pallas(interpret=True), with a random cotangent on
    # t (on the rays whose t agrees bitwise, see _agreeing_cotangent):
    # d_origin and d_direction within 1e-5 * max(1, |x|), d_centers and
    # d_radius within 1e-5 * max(1, sum of the absolute per-ray terms) (see
    # _close; measured: rays exactly equal, sphere sums within 9.6e-7; 59%
    # and 65% of the rays carry a cotangent). The sphere sums go through the
    # ordered contraction. The limit this gives is at most 9.1e-3 absolute
    # (held below 1e-2) and 1.6e-3 of |x| (a center entry of 3.17 on
    # diel_spheres_hollow); half the entries have it below 3.9e-5 of |x|.
    # It still sees one ray: the port's gradient with one hit ray's
    # cotangent zeroed fails it (_drops_one_ray).
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
    out = torch.autograd.grad(hit.t, leaves, torch.from_numpy(g),
                              retain_graph=True)
    mass = _term_mass(sj, o, d, g)
    for what, a, b in zip(("origin", "direction", "center", "radius"), out,
                          ref):
        assert _close(a.numpy(), b, 1e-5, mass.get(what)).all(), what
    k = _hit_ray(hit.t, g)
    dropped = torch.autograd.grad(hit.t, leaves[2:],
                                  torch.from_numpy(_drop_ray([g], k)[0]))
    assert _drops_one_ray(dropped, ref[2:], ("center", "radius"), mass)


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
    # rays within 1e-5 * max(1, |x|), the five fields within 1e-5 * max(1,
    # sum of the absolute per-ray terms) (see _close; measured: rays exactly
    # equal, fields within 1.1e-5 of the JAX sums). On diel_spheres_hollow a
    # center entry of -0.573 sums terms of up to ~30 that cancel; the float32
    # sum of the JAX package is 9.4e-6 from the float64 value and the
    # port's ordered contraction 1.4e-6 (test_sweep_vjp_f32_matches_f64).
    # The limit this gives is at most 9.9e-3 absolute (held below 1e-2) and
    # 5.5e-3 of |x| (3.2e-3 on that -0.573 entry); half the entries have it
    # below 2.2e-4 of |x|. It still sees one ray: the port's gradient with
    # one hit ray's cotangents zeroed fails it (_drops_one_ray). mat gets no
    # gradient.
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
                              [torch.from_numpy(c) for c in cots],
                              retain_graph=True)
    mass = _term_mass(sj, o, d, g, cots[1:])
    for what, a, b in zip(("origin", "direction") + fields, out, ref):
        assert _close(a.numpy(), b, 1e-5, mass.get(what)).all(), what
    dropped = torch.autograd.grad(
        [h.t] + list(at[:5]), leaves[2:],
        [torch.from_numpy(c) for c in _drop_ray(cots, _hit_ray(h.t, g))])
    assert _drops_one_ray(dropped, ref[2:], fields, mass)


def _well_conditioned(sj, o, d, limit=1e-5):
    """Rays whose sweep VJP terms carry at most ``limit`` relative float32
    rounding: misses, and hits with ``2u (|o|_1 + t + |c|_1) / |p . d| <=
    limit`` (u = 2^-24). ``p = o + t d - c`` cancels terms of size |o|, t
    and |c| down to the radius, and the terms divide by ``p . d``."""
    sc = pt.scene_from_numpy(sj)
    t, idx = K.sweep_ref(_rays6(o, d), K.sphere_consts(sc))
    hit = (t < K.BIG).numpy()
    c = np.asarray(sj.center, np.float64)[idx.numpy()]
    ts = np.where(hit, t.numpy(), 0.0)
    pd = np.abs(((o + ts[:, None] * d - c) * d).sum(-1))
    kappa = (2 * 2.0 ** -24 * (np.abs(o).sum(-1) + ts + np.abs(c).sum(-1))
             / np.maximum(pd, 1e-30))
    return ~hit | (kappa <= limit)


@pytest.mark.parametrize("fetch", [False, True], ids=["sweep", "fetch"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_sweep_vjp_f32_matches_f64(name, fetch):
    # The port's float32 VJP of K1 / K10 (plain versions) against the same
    # VJP in float64 over the same rays and cotangents: the sweep itself runs
    # in float32 either way (sphere_consts, _rays6), so t and the winners are
    # the same and only the backward's arithmetic differs. The cotangent on t
    # is zero on the rays whose per-ray term is itself ill-conditioned in
    # float32 (_well_conditioned: 1.3% of the rays of diel_spheres_hollow,
    # 21% of random_spheres), so what is held is the sum onto the spheres.
    # Every gradient within 1e-5 * max(1, |x|) of float64, including the
    # center sums whose terms cancel (measured: within 2.0e-6; on
    # diel_spheres_hollow with every ray carrying a cotangent, 1.4e-6 at an
    # entry of -0.573 whose terms reach ~30).
    sj = jtrim(SCENES[name][0]())
    o, d = _rays(name, 512, 512)
    gen = np.random.default_rng(6)
    g_t = gen.normal(size=o.shape[0]) * _well_conditioned(sj, o, d)
    g_at = [gen.normal(size=(o.shape[0], 3)), gen.normal(size=o.shape[0]),
            gen.normal(size=(o.shape[0], 3)), gen.normal(size=o.shape[0]),
            gen.normal(size=o.shape[0])]
    fields = pt.DIFF_FIELDS if fetch else ("center", "radius")

    def grads(dt):
        sc = pt.scene_from_numpy(sj)
        leaves = [torch.from_numpy(o).to(dt).requires_grad_(),
                  torch.from_numpy(d).to(dt).requires_grad_()] + [
            getattr(sc, k).to(dt).requires_grad_() for k in fields]
        scene = sc._replace(**dict(zip(fields, leaves[2:])))
        if fetch:
            h, at = K.intersect_fetch_kernel(leaves[0], leaves[1], scene)
            outs, cots = [h.t] + list(at[:5]), [g_t] + g_at
        else:
            outs = [K.intersect_spheres_kernel(leaves[0], leaves[1], scene).t]
            cots = [g_t]
        cots = [torch.from_numpy(np.asarray(c, np.float32)).to(
            x.dtype if x.dtype.is_floating_point else dt)
            for c, x in zip(cots, outs)]
        return torch.autograd.grad(outs, leaves, cots)

    lo, hi = grads(torch.float32), grads(torch.float64)
    for what, a, b in zip(("origin", "direction") + fields, lo, hi):
        assert a.dtype == torch.float32 and b.dtype == torch.float64
        assert _close(a.numpy(), b.numpy(), 1e-5).all(), what


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
