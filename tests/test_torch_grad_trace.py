"""The recorded wavefront of the port (``ops/grad_trace.py``:
``trace_recorded`` and ``trace_recorded_staged``) against the JAX package's
``ops/grad_trace.py`` on the same rays and draws, against the port's own
``trace``, and against finite differences. Card-only: the recorded
wavefront through K1 against its plain version."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops import grad_trace as JGT
from raytracingweekend_jl_tpu.ops.sampling import (
    unit_sphere_directions as jusd)
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.grad_trace import (
    trace_recorded, trace_recorded_staged)
from raytracingweekend_jl_tpu_torch.ops.integrator import trace
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
from test_torch_trace import KEY, SCENES, _case, _cos_ratio, _jax_draws

F0 = np.zeros((), jax.dtypes.float0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _draws(key=KEY, dtype=jnp.float32):
    """The JAX package's positional draws of bounce ``b`` at width ``n``
    (``fold_in(key, b)``, split into direction and coin), as a port hook."""
    cache = {}

    def draws(b, n):
        if (b, n) not in cache:
            with jax.enable_x64(dtype == jnp.float64):
                kd, kc = jax.random.split(jax.random.fold_in(key, b))
                cache[b, n] = (
                    torch.from_numpy(np.asarray(jusd(kd, (n,), dtype=dtype))),
                    torch.from_numpy(np.asarray(
                        jax.random.uniform(kc, (n,), dtype=dtype))))
        return cache[b, n]
    return draws


def _lane_err(a, b):
    """Per lane (row) the largest ``|a - b| / max(1, |b|)``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs(a - b) / np.maximum(1, np.abs(b))).reshape(
        a.shape[0], -1).max(1)


def _lane_rule(a, b):
    """The per-lane rule of the port's trace tests: within 1e-5 * max(1,
    |x|) on at least 99.9% of lanes and within 1e-4 on all."""
    err = _lane_err(a, b)
    return bool((err <= 1e-5).mean() >= 0.999 and (err <= 1e-4).all())


def _jax_vjp(fn, sj, o, d, g, staged=False):
    """``(radiance, count or None, scene grads, origin grad, direction
    grad)`` of a JAX trace ``fn(scene, o, d)`` under the cotangent ``g``."""
    out, vjp = jax.vjp(fn, sj, jnp.asarray(o), jnp.asarray(d))
    if staged:
        (rad, count), (gs, go, gd) = out, vjp((jnp.asarray(g), F0))
    else:
        (rad, count), (gs, go, gd) = (out, None), vjp(jnp.asarray(g))
    return (np.asarray(rad), count, {f: np.asarray(getattr(gs, f))
                                     for f in pt.DIFF_FIELDS},
            np.asarray(go), np.asarray(gd))


def _port_vjp(fn, sj, o, d, g, dtype):
    """The same for the port's ``fn(scene, o, d)``."""
    scene = pt.scene_from_numpy(sj, dtype=dtype, requires_grad=True)
    ot = torch.from_numpy(o).to(dtype).requires_grad_(True)
    dt = torch.from_numpy(d).to(dtype).requires_grad_(True)
    out = fn(scene, ot, dt)
    rad, count = out if isinstance(out, tuple) else (out, None)
    rad.backward(torch.from_numpy(g).to(dtype))
    return (rad.detach().numpy(), count, {f: getattr(scene, f).grad.numpy()
                                          for f in pt.DIFF_FIELDS},
            ot.grad.numpy(), dt.grad.numpy())


def _unit64(d):
    """Float32 directions as float64 unit vectors: both packages' recorded
    backwards then linearize the same sphere equation (they differ only
    along a direction, which ``|d| = 1`` removes)."""
    d = d.astype(np.float64)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _tangential(g, d):
    """Direction cotangents ``g`` [R, 3] in the plane normal to the unit
    rays ``d``: the two packages' backwards differ along the ray (the
    JAX package's closed-form root takes |d| = 1 inside its derivative)."""
    return g - (g * d).sum(-1, keepdims=True) * d


def _to64(sj):
    return sj._replace(**{f: jnp.asarray(np.asarray(getattr(sj, f)),
                                         jnp.float64)
                          for f in pt.DIFF_FIELDS})


@pytest.mark.parametrize("name", ["4_spheres", "diel_spheres_hollow"])
def test_trace_recorded_matches_jax_float32(name):
    # Float32, 48x27 jittered camera rays, the JAX draws injected: radiance
    # by the per-lane rule (measured: 99.92% and 100% of lanes within
    # 1e-5, worst 1.5e-5). The VJP under a random cotangent: per scene
    # field, and for the rays' origins and directions (these in the plane
    # normal to the ray, as test_torch_fused_grad.py compares them),
    # cosine >= 0.99999 and norm ratio within 1% (measured: cosines >=
    # 0.9999985, ratios within 3.4e-3). The JAX package solves
    # the hit distance's quadratic again in the backward, which cancels in
    # float32 (|oc|^2 - r^2 of the ground sphere); the port linearizes the
    # sphere equation at the recorded distance, as the sweep's backward
    # does, so a ray's cotangent agrees only to ~1e-3 in float32; float64
    # below holds them lane by lane.
    sj, o, d = _case(name)
    R = o.shape[0]
    g = np.random.default_rng(0).normal(size=(R, 3)).astype(np.float32)
    rj, _, gsj, goj, gdj = _jax_vjp(
        lambda s, a, b: JGT.trace_recorded(s, a, b, KEY, 16, 1e-4, None),
        sj, o, d, g)
    rp, _, gsp, gop, gdp = _port_vjp(
        lambda s, a, b: trace_recorded(s, a, b, 0, 16, draws=_jax_draws(R)),
        sj, o, d, g, torch.float32)
    assert np.isfinite(rp).all() and _lane_rule(rp, rj), _lane_err(rp, rj)
    for what, a, b in [(f, gsp[f], gsj[f]) for f in pt.DIFF_FIELDS] + [
            ("origin", gop, goj), ("direction", _tangential(gdp, d),
                                   _tangential(gdj, d))]:
        cos, ratio = _cos_ratio(a, b)
        assert cos >= 0.99999 and abs(ratio - 1) <= 1e-2, (what, cos, ratio)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_recorded_matches_jax_float64(name):
    # Float64 (both packages sweep in the dot form), 32x18 unit rays, the
    # JAX float64 draws injected: the radiance and the whole VJP (every
    # scene field element, every ray's origin cotangent and its direction
    # cotangent normal to the ray) by the per-lane rule (measured: every
    # value within 4.3e-9).
    sj, o, d = _case(name, 32, 18)
    o, d = o.astype(np.float64), _unit64(d)
    R = o.shape[0]
    g = np.random.default_rng(1).normal(size=(R, 3))
    with jax.enable_x64(True):
        ref = _jax_vjp(
            lambda s, a, b: JGT.trace_recorded(s, a, b, KEY, 16, 1e-4, None),
            _to64(sj), o, d, g)
    out = _port_vjp(lambda s, a, b: trace_recorded(
        s, a, b, 0, 16, draws=_draws(dtype=jnp.float64)),
        sj, o, d, g, torch.float64)
    assert out[0].dtype == np.float64
    assert _lane_rule(out[0], ref[0]), "radiance"
    for f in pt.DIFF_FIELDS:
        assert _lane_rule(out[2][f], ref[2][f]), f
    assert _lane_rule(out[3], ref[3])
    assert _lane_rule(_tangential(out[4], d), _tangential(ref[4], d))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_recorded_primal_is_the_trace(name, dtype):
    # With the same seed (the port's own positional draws) the recorded
    # primal is trace(remat=False)'s bit for bit.
    sj, o, d = _case(name, 32, 18)
    scene = pt.scene_from_numpy(sj, dtype=dtype)
    o, d = torch.from_numpy(o).to(dtype), torch.from_numpy(d).to(dtype)
    a = trace(scene, o, d, 17)
    b = trace_recorded(scene, o, d, 17)
    assert b.dtype == dtype and torch.equal(a, b) and (b > 0).any()


def _small_scene(dtype):
    return pt.make_scene([
        pt.lambertian((0, 0, -1), 0.5, (0.7, 0.3, 0.3)),
        pt.lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0)),
        pt.metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.0)], dtype=dtype)


@pytest.mark.parametrize("route", [{"recorded": True, "remat": False},
                                   {"recorded_stage": (4, 4)}])
def test_recorded_routes_match_fd(route):
    # The JAX package's FD tests of the recorded paths (test_grad.py:139,
    # :183): float64, 32x18, spp 2, the albedo of sphere 0 against central
    # differences of render_loss at eps 1e-4 within rtol 1e-4 (radiance is
    # polynomial in albedo).
    dt = torch.float64
    scene, cam = _small_scene(dt), pt.default_camera(dtype=dt)
    target = torch.zeros((18, 32, 3), dtype=dt)
    kw = dict(device="cpu", seed=7, **route)
    loss, g = pt.render_grads(scene, cam, target, 32, 2, **kw)
    vals = []
    for eps in (1e-4, -1e-4):
        alb = scene.albedo.clone()
        alb[0, 0] += eps
        with torch.no_grad():
            vals.append(float(pt.render_loss(scene._replace(albedo=alb), cam,
                                             target, 32, 2, **kw)))
    fd = (vals[0] - vals[1]) / 2e-4
    assert np.isfinite(float(g.albedo[0, 0])) and abs(fd) > 0
    np.testing.assert_allclose(float(g.albedo[0, 0]), fd, rtol=1e-4,
                               atol=1e-9)


def test_recorded_step_matches_the_remat_step():
    # The JAX package's test_recorded_matches_remat_gradients: the recorded
    # step and the remat step (same bounce math, same draws) agree on every
    # field within 2e-6 + 1e-3 * max|g| (scene_2_spheres, 48x27, spp 2).
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    target = torch.zeros((27, 48, 3))
    kw = dict(device="cpu", seed=5)
    l_rec, g_rec = pt.render_grads(scene, cam, target, 48, 2, recorded=True,
                                   remat=False, **kw)
    l_rem, g_rem = pt.render_grads(scene, cam, target, 48, 2, recorded=False,
                                   remat=True, **kw)
    assert torch.equal(l_rec, l_rem)
    for f in pt.DIFF_FIELDS:
        a, b = getattr(g_rec, f), getattr(g_rem, f)
        scale = max(b.abs().max().item(), 1e-6)
        assert (a - b).abs().max().item() <= 2e-6 + 1e-3 * scale, f


class _OpLog(TorchDispatchMode):
    """Names of the aten operations run inside the mode, with whether an
    ``index_put`` accumulated."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        if name.startswith("index_put") and (
                kwargs.get("accumulate") or (len(args) > 3 and args[3])):
            name += "[accumulate]"
        self.ops.append(name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("staged", [False, True])
def test_recorded_backward_sums_through_the_contraction(staged):
    # The backward sums the winners' rows onto the spheres with the ordered
    # contraction (one sort), never by atomic scatters: no index_add,
    # scatter_add or accumulating index_put runs in it, and two backward
    # passes give the same bits.
    sj, o, d = _case("4_spheres", 32, 18)
    grads = []
    for _ in range(2):
        scene = pt.scene_from_numpy(sj, requires_grad=True)
        fn = (lambda: trace_recorded_staged(scene, torch.from_numpy(o),
                                            torch.from_numpy(d), 3, 8, 1e-4,
                                            2)[0]) if staged else \
            (lambda: trace_recorded(scene, torch.from_numpy(o),
                                    torch.from_numpy(d), 3, 8))
        loss = ((fn() - 0.3) ** 2).mean()
        with _OpLog() as log:
            loss.backward()
        bad = [n for n in log.ops if n in ("index_add", "index_add_",
                                           "scatter_add", "scatter_add_",
                                           "index_reduce")
               or n.endswith("[accumulate]")]
        assert not bad and "sort" in log.ops, bad
        grads.append([getattr(scene, f).grad for f in pt.DIFF_FIELDS])
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert grads[0][2].abs().sum() > 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_trace_recorded_staged_matches_jax(name):
    # Stage bounce 3, tail width R // 4 at 32x18, the JAX draws injected at
    # each stage's width. Float64 (unit rays): the radiance, the live count
    # at bounce 3 and the whole VJP by the per-lane rule (measured: within
    # 1.3e-9).
    # Float32 on hollow glass, where no path diverges between the two
    # packages' sweeps: the count equal and the radiance by the per-lane
    # rule. (Elsewhere a lane whose float32 path diverges before bounce 3
    # moves every later survivor to another tail position, and so to other
    # draws.)
    sj, o, d = _case(name, 32, 18)
    R = o.shape[0]
    g = np.random.default_rng(2).normal(size=(R, 3))
    jfn = lambda s, a, b: JGT.trace_recorded_staged(s, a, b, KEY, 16, 1e-4,
                                                    None, 3, R // 4)
    o64, d64 = o.astype(np.float64), _unit64(d)
    with jax.enable_x64(True):
        ref = _jax_vjp(jfn, _to64(sj), o64, d64, g, staged=True)
    out = _port_vjp(lambda s, a, b: trace_recorded_staged(
        s, a, b, 0, 16, 1e-4, 3, R // 4, draws=_draws(dtype=jnp.float64)),
        sj, o64, d64, g, torch.float64)
    assert int(out[1]) == int(ref[1]) > 0
    assert _lane_rule(out[0], ref[0]), "radiance"
    for f in pt.DIFF_FIELDS:
        assert _lane_rule(out[2][f], ref[2][f]), f
    assert _lane_rule(out[3], ref[3])
    assert _lane_rule(_tangential(out[4], d64), _tangential(ref[4], d64))
    if name != "diel_spheres_hollow":
        return
    rj, cj = JGT.trace_recorded_staged(sj, jnp.asarray(o), jnp.asarray(d),
                                       KEY, 16, 1e-4, None, 3, R // 4)
    rp, cp = trace_recorded_staged(
        pt.scene_from_numpy(sj), torch.from_numpy(o), torch.from_numpy(d), 0,
        16, 1e-4, 3, R // 4, draws=_draws())
    assert int(cp) == int(cj)
    assert _lane_rule(rp.numpy(), np.asarray(rj)), _lane_err(rp.numpy(), rj)


def test_staged_at_full_depth_is_the_unstaged_trace():
    # A stage bounce at max_depth leaves no tail: the radiance and every
    # gradient bit for bit trace_recorded's.
    sj, o, d = _case("diel_spheres_hollow", 32, 18)
    out = []
    for staged in (False, True):
        scene = pt.scene_from_numpy(sj, requires_grad=True)
        o_t = torch.from_numpy(o).requires_grad_(True)
        if staged:
            r, count = trace_recorded_staged(scene, o_t, torch.from_numpy(d),
                                             4, 8, 1e-4, 8)
            assert int(count) >= 0
        else:
            r = trace_recorded(scene, o_t, torch.from_numpy(d), 4, 8)
        ((r - 0.2) ** 2).mean().backward()
        out.append([r.detach(), o_t.grad]
                   + [getattr(scene, f).grad for f in pt.DIFF_FIELDS])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_staged_budget_drops_exactly_the_overflow_tails():
    # Hollow glass (long paths), stage bounce 2, a 64-lane tail for 1 296
    # rays: more lanes are alive at bounce 2 than the tail holds. With
    # draws that are a prefix-stable table (a lane at tail position j
    # draws row j at any width), the lanes beyond the budget read exactly
    # black, and every other lane is bit for bit the run whose tail holds
    # every lane; the mean drops below trace_recorded's.
    sj, o, d = _case("diel_spheres_hollow")
    R = o.shape[0]
    gen = torch.Generator().manual_seed(3)
    table = [(pt.unit_sphere_directions((R,), generator=gen),
              torch.rand((R,), generator=gen)) for _ in range(16)]
    draws = lambda b, n: (table[b][0][:n], table[b][1][:n])
    scene, o, d = (pt.scene_from_numpy(sj), torch.from_numpy(o),
                   torch.from_numpy(d))
    full, count = trace_recorded_staged(scene, o, d, 0, 16, 1e-4, 2, R,
                                        draws=draws)
    cut, count2 = trace_recorded_staged(scene, o, d, 0, 16, 1e-4, 2, 64,
                                        draws=draws)
    assert int(count) == int(count2) > 64
    head = trace_recorded(scene, o, d, 0, 2, draws=draws)
    alive = (head == 0).all(-1)  # a lane banks light only when it dies
    assert int(alive.sum()) == int(count)
    dropped = alive & (torch.cumsum(alive.long(), 0) > 64)
    assert int(dropped.sum()) == int(count) - 64
    assert (cut[dropped] == 0).all() and (full[dropped] > 0).any()
    assert torch.equal(cut[~dropped], full[~dropped])
    assert cut.mean() < trace_recorded(scene, o, d, 0, 16,
                                       draws=draws).mean()


def test_staged_width_is_checked():
    scene = pt.scene_2_spheres()
    o = torch.zeros((3, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3)
    for width in (4, -1):
        with pytest.raises(ValueError, match="stage_width"):
            trace_recorded_staged(scene, o, d, 0, 4, 1e-4, 2, width)
    with pytest.raises(ValueError, match="R < 4"):
        trace_recorded_staged(scene, o, d, 0, 4, 1e-4, 2)


def test_recorded_stage_overflow_warns_once_per_render():
    # render_radiance at 48x27, spp 4 in two passes and two pixel chunks,
    # with recorded_stage=(2, 64) on hollow glass: every pass overflows its
    # tail, and the render warns once, after its pass loop, with the
    # summed count added to stats["overflow"] (a tensor, read once). The
    # budget that holds every lane warns nothing and counts 0.
    scene, cam = pt.scene_diel_spheres_hollow(), pt.hollow_glass_cam()
    for div, n_warn in ((64, 1), (1, 0)):
        stats = {}
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            img = pt.render_radiance(scene, cam, 48, 4, device="cpu", seed=1,
                                     recorded=True, recorded_stage=(2, div),
                                     rays_per_pass=1296, pixel_chunk=648,
                                     stats=stats)
        assert torch.isfinite(img).all()
        assert isinstance(stats["overflow"], torch.Tensor)
        assert (int(stats["overflow"]) > 0) == bool(n_warn)
        hits = [w for w in rec if issubclass(w.category, RuntimeWarning)]
        assert len(hits) == n_warn, [str(w.message) for w in hits]


@pytest.mark.cuda
def test_recorded_wavefront_on_card(cuda_device):
    # On the card the recorded wavefront sweeps through K1 (counted), its
    # radiance within 1e-5 * max(1, |x|) of the plain version's on >= 99.9%
    # of lanes, and two backward passes give the same bits.
    torch.backends.cuda.matmul.allow_tf32 = False
    sj, o, d = _case("random_spheres", 96, 54)
    o_c, d_c = torch.from_numpy(o).to(cuda_device), torch.from_numpy(d).to(
        cuda_device)
    grads = []
    for impl in ("kernels", "kernels", "plain"):
        scene = pt.scene_from_numpy(sj, device=cuda_device,
                                    requires_grad=True)
        before = K.launches
        r = trace_recorded(scene, o_c, d_c, 9, 16, impl=impl)
        assert (K.launches > before) == (impl == "kernels")
        ((r - 0.3) ** 2).mean().backward()
        grads.append((r.detach().cpu().numpy(),
                      [getattr(scene, f).grad for f in pt.DIFF_FIELDS]))
    assert all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))
    assert _lane_rule(grads[0][0], grads[2][0])
