"""The port's persistent-record gradient trace against the JAX package.

- The plain versions of the masked sweep (K3), the record state machine
  (K4), the bounce adjoint and the replay core (K5/K6) against the JAX
  functions on the same arrays.
- The whole trace and its VJP against ``trace_recorded_persist(...,
  interpret=True)`` fed the same uniforms (``_u5_for``), with and without
  tail compaction; the dropped-path audit against ``persist_dropped_paths``.
- The port's own program: finite differences in albedo with its Philox
  draws (record and replay must draw the same numbers), strict poisoning,
  the replay variants, the wrappers on the CPU.
- Card-only: the CUDA kernels K3-K6 against their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu import rng as jrng
from raytracingweekend_jl_tpu.camera import default_camera
from raytracingweekend_jl_tpu.camera import get_rays as jget_rays
from raytracingweekend_jl_tpu.ops.pallas import persist_grad_kernel as JP
from raytracingweekend_jl_tpu.ops.pallas.grad_kernel import _bounce_adjoint
from raytracingweekend_jl_tpu.ops.pallas.intersect_kernel import (
    sweep_masked_planes)
from raytracingweekend_jl_tpu.render import pixel_coords as jpixel_coords
from raytracingweekend_jl_tpu_torch import rng
from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
from raytracingweekend_jl_tpu_torch.ops.cuda.grad_kernel import bounce_adjoint
from raytracingweekend_jl_tpu_torch.ops.materials import (attr_mat,
                                                          fetch_attr_planes)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

S, DEPTH = 4, 8
FIELDS = ("center", "radius", "albedo", "fuzz", "ir")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def mixed_scene():
    """All three materials: Lambertian, ground, fuzzy metal, glass."""
    return rtw.make_scene([
        rtw.lambertian((0, 0, -1), 0.5, (0.7, 0.3, 0.3)),
        rtw.lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0)),
        rtw.metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.3),
        rtw.dielectric((-1, 0, -1), 0.5, 1.5),
    ], pad_to=4)


def rays_for(W=32, H=18, seed=7):
    """Camera rays of the default camera, as numpy, and the JAX trace key."""
    u, v = jpixel_coords(W, H)
    key = jax.random.PRNGKey(seed)
    o, d = jget_rays(default_camera(), u, v, jrng.purpose_key(key, jrng.LENS))
    return (np.array(o), np.array(d),
            jrng.purpose_key(key, jrng.SCATTER_DIR))


def u5_hook(key):
    """The port's draw hook giving JAX's interpret-mode uniforms of absolute
    iteration ``i`` at ``width`` lanes, lane for lane."""
    def u5_fn(i, width):
        return torch.from_numpy(np.asarray(
            JP._u5_for(key, i, width // PG.LANES)).reshape(5, -1))
    return u5_fn


def j(x):
    return jnp.asarray(x.numpy())


def assert_close(a, b, tol=1e-5, share=1.0):
    """Planes [k, W]: on at least ``share`` of the lanes every plane is
    within ``tol * max(1, |b|)``, and every lane within ten times that."""
    a, b = np.asarray(a), np.asarray(b)
    err = np.abs(a - b) / np.maximum(1.0, np.abs(b))
    assert (err <= 10 * tol).all(), float(err.max())
    ok = (err <= tol).all(0).mean()
    assert ok >= share, (ok, float(err.max()))


def is_close(a, b, tol=1e-5, share=1.0):
    """:func:`assert_close`'s rule as a truth value."""
    try:
        assert_close(a, b, tol, share)
    except AssertionError:
        return False
    return True


@pytest.fixture(scope="module")
def record():
    """Twelve plain record iterations of the mixed scene at 32 768 rays
    (S = 4 strips of 8 192 real lanes, depth 8), uniforms from a numpy seed:
    per iteration the inputs (t, winner, attributes, uniforms, state) and
    the written record slot."""
    scene_j = mixed_scene()
    o, d, _ = rays_for(256, 128, seed=3)
    scene = pt.scene_from_numpy(scene_j)
    strips, sf, si, rad = PG.start_planes(torch.from_numpy(o),
                                          torch.from_numpy(d), S)
    W = sf.shape[1]
    spheres, amat = K.sphere_consts(scene), attr_mat(scene)
    g = np.random.default_rng(11)
    steps = []
    for i in range(12):
        t, idx = K.sweep_masked_ref(sf[0:6], si[2], spheres)
        attrs = fetch_attr_planes(idx, amat)
        u5 = torch.from_numpy(g.random((5, W), dtype=np.float32))
        state = (sf.clone(), si.clone(), rad.clone())
        slot = torch.zeros((PK.N_REC, W))
        PK.persist_record_step_ref(t, attrs, strips, sf, si, rad, slot, 0, i,
                                   DEPTH, u5)
        steps.append(dict(t=t, idx=idx, attrs=attrs, u5=u5, state=state,
                          slot=slot))
    return dict(scene_j=scene_j, strips=strips, steps=steps, W=W)


def test_record_covers_every_event_and_material(record):
    # The fixture's records hold every flag and every material among hits,
    # so the parity tests below reach each branch.
    flags = torch.stack([PK.flags_of(s["slot"]) for s in record["steps"]])
    act = (flags & PK.F_ACT) != 0
    for bit in (PK.F_HIT, PK.F_TERM, PK.F_REGEN):
        assert ((flags & bit) != 0).any()
    assert (~act).any() and act.any()
    mats = torch.stack([s["slot"][20] for s in record["steps"]])
    hit = (flags & PK.F_HIT) != 0
    assert set(mats[hit].unique().tolist()) == {0.0, 1.0, 2.0}


@pytest.mark.parametrize("it", [0, 5, 11])
def test_advance_record_bank_matches_jax(record, it):
    # The record step's state machine against _advance_record_bank on the
    # same inputs: flags and integer state identical, float planes within
    # 1e-5 * max(1, |x|) on every lane.
    st = record["steps"][it]
    sf, si, rad = st["state"]
    strips = record["strips"]
    rec21, new_state, new_rad = JP._advance_record_bank(
        j(st["u5"]), j(st["t"]), tuple(j(a) for a in st["attrs"]),
        tuple(j(p) for p in strips), tuple(j(p) for p in sf)
        + tuple(j(p) for p in si), tuple(j(p) for p in rad), DEPTH, S)
    rec10, flags, sf2, si2, rad2 = PK.advance_record_bank(
        st["u5"], st["t"], st["attrs"], strips, sf, si, rad, DEPTH)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(rec21[10]))
    np.testing.assert_array_equal(
        si2.numpy(), np.stack([np.asarray(x) for x in new_state[9:12]]))
    assert_close(rec10.numpy(), np.stack(rec21[:10]))
    assert_close(sf2.numpy(), np.stack(new_state[:9]))
    assert_close(rad2.numpy(), np.stack(new_rad))


def test_record_step_ref_writes_zero_record_for_dead_lanes(record):
    # Inactive lanes keep their state and write an all-zero record slot.
    st = record["steps"][11]
    sf, si, rad = (x.clone() for x in st["state"])
    dead = si[2] == 0
    assert dead.any()
    slot = torch.full((PK.N_REC, record["W"]), 7.0)
    before = (sf.clone(), si.clone(), rad.clone())
    PK.persist_record_step_ref(st["t"], st["attrs"], record["strips"], sf, si,
                               rad, slot, 0, 11, DEPTH, st["u5"])
    assert (slot[:, dead] == 0).all()
    for a, b in zip((sf, si, rad), before):
        assert torch.equal(a[:, dead], b[:, dead])
    assert torch.equal(slot, st["slot"])


@pytest.mark.parametrize("it", [0, 5, 11])
def test_replay_iter_core_matches_jax(record, it):
    # One reverse iteration over a recorded slot (deposits at regens, chain
    # cuts, strip-selected radiance cotangent, bounce adjoint) against
    # _replay_iter_core with the same random carry, by the rule of
    # test_bounce_adjoint_matches_jax: within 1e-5 * max(1, |x|) on >= 99.9%
    # of lanes and 1e-4 on all. XLA's CPU backend contracts a*b+c into FMA
    # and eager PyTorch does not, so a grazing lane may sit a few last bits
    # further off on one host than on another (a lane beyond 1e-5 failed the
    # old every-lane limit on one host and passed on others). Measured here,
    # worst lane: cot 1.9e-6 / 5.2e-6 / 5.7e-6, dattr 1.4e-6 / 7.0e-6 /
    # 5.7e-6 (iterations 0 / 5 / 11), deposits bitwise; no lane beyond
    # 1e-5. The rule still fails on one lane's deposit dropped and on one
    # lane's cotangent with its sign flipped.
    st = record["steps"][it]
    slot, W = st["slot"], record["W"]
    g = np.random.default_rng(100 + it)
    cot, gs, dep = (torch.from_numpy(g.normal(size=(k, W)).astype(np.float32))
                    for k in (9, 3 * S, 6 * S))
    flags = PK.flags_of(slot)
    cot9, dattr9, dep2 = PK.replay_iter_core(st["u5"], slot[0:10],
                                             slot[11:21], flags, cot, gs, dep)
    jc, jd, jdep = JP._replay_iter_core(
        j(st["u5"]), tuple(j(p) for p in slot[0:10]),
        tuple(j(p) for p in slot[11:21]), j(flags), tuple(j(c) for c in cot),
        tuple(j(p) for p in gs), tuple(j(p) for p in dep), S)
    jc, jd, jdep = np.stack(jc), np.stack(jd), np.stack(jdep)
    assert_close(cot9.numpy(), jc, share=0.999)
    assert_close(dattr9.numpy(), jd, share=0.999)
    assert_close(dep2.numpy(), jdep, share=0.999)
    # planted faults: the largest deposit dropped, one cotangent negated
    deposited = np.abs(jdep - dep.numpy()).max(0)
    assert deposited.max() > 0
    k = int(deposited.argmax())
    dropped = dep2.numpy().copy()
    dropped[:, k] = dep.numpy()[:, k]
    assert not is_close(dropped, jdep, share=0.999)
    k = int(np.abs(jc).max(0).argmax())
    flipped = cot9.numpy().copy()
    flipped[:, k] *= -1
    assert not is_close(flipped, jc, share=0.999)


@pytest.mark.parametrize("masks", ["recorded", "all_hit", "all_miss"])
def test_bounce_adjoint_matches_jax(record, masks):
    # The hand-written bounce adjoint against _bounce_adjoint on recorded
    # bounces of all three materials, with the recorded advance/inject masks
    # and with every lane forced to advance or to bank the sky: within
    # 1e-5 * max(1, |x|) on >= 99.9% of lanes and 1e-4 on all. XLA's CPU
    # backend contracts a*b+c into FMA and eager PyTorch does not; the
    # implicit hit-distance term divides by p.d, which amplifies a last-bit
    # difference on grazing hits (measured: at most 2 of 8 192 lanes above
    # 1e-5, max 2.5e-5).
    st = record["steps"][5]
    slot, W = st["slot"], record["W"]
    flags = PK.flags_of(slot)
    act, hit = (flags & PK.F_ACT) != 0, (flags & PK.F_HIT) != 0
    term = (flags & PK.F_TERM) != 0
    hitm, missm = {"recorded": (hit & ~term, act & ~hit),
                   "all_hit": (slot[9] < K.BIG, slot[9] >= K.BIG),
                   "all_miss": (torch.zeros_like(act), torch.ones_like(act))
                   }[masks]
    g = np.random.default_rng(7)
    cots = torch.from_numpy(g.normal(size=(9, W)).astype(np.float32))
    g3 = torch.from_numpy(g.normal(size=(3, W)).astype(np.float32))
    cot9, dattr9 = bounce_adjoint(st["u5"], tuple(slot[0:10])
                                  + tuple(slot[11:21]), tuple(g3),
                                  tuple(cots), hitm, missm)
    jc, jd = _bounce_adjoint(
        j(st["u5"]), tuple(j(p) for p in slot[0:10])
        + (tuple(j(p) for p in slot[11:21]),), tuple(j(p) for p in g3),
        tuple(j(c) for c in cots), j(hitm), j(missm))
    assert_close(torch.stack(cot9).numpy(), np.stack(jc), share=0.999)
    assert_close(torch.stack(dattr9).numpy(), np.stack(jd), share=0.999)


def test_sweep_masked_ref_matches_pallas_interpret(record):
    # K3's plain version against the TPU masked sweep in interpret mode on a
    # mid-phase state with dead lanes: on live lanes hit and index
    # identical, t within rtol = atol = 1e-3 (the K1 test's bound for two
    # evaluation orders of the expanded form); dead lanes are (BIG, 0).
    sf, si, _ = record["steps"][11]["state"]
    alive = si[2]
    live = alive.numpy() != 0
    assert 0 < live.mean() < 1
    sj = record["scene_j"]
    pl = lambda x: jnp.asarray(x.numpy().reshape(-1, PG.LANES))
    tj, ij = sweep_masked_planes(tuple(pl(p) for p in sf[0:3]),
                                 tuple(pl(p) for p in sf[3:6]), pl(alive),
                                 sj.center, sj.radius, 1e-4, interpret=True)
    t, idx = K.sweep_masked_ref(sf[0:6].contiguous(), alive,
                                K.sphere_consts(pt.scene_from_numpy(sj)))
    tj, ij = np.asarray(tj).ravel()[live], np.asarray(ij).ravel()[live]
    hit = tj < K.BIG
    assert hit.any() and (~hit).any()
    np.testing.assert_array_equal(t.numpy()[live] < K.BIG, hit)
    np.testing.assert_array_equal(idx.numpy()[live][hit], ij[hit])
    np.testing.assert_allclose(t.numpy()[live][hit], tj[hit], rtol=1e-3,
                               atol=1e-3)
    assert (t.numpy()[~live] == K.BIG).all() and (idx.numpy()[~live] == 0).all()


def _cosine_and_ratio(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / (na * nb)), float(na / nb)


@pytest.mark.parametrize("tc", [None, (6, 16)], ids=["plain", "tail_compact"])
def test_trace_and_vjp_match_jax_interpret(tc):
    # The whole trace at 32x18 rays, S = 4, depth 8, with JAX's uniforms
    # injected: radiance within the JAX suite's own atol 2e-4, rtol 1e-4 on
    # >= 99% of rays; each scene field's VJP and the ray cotangents against
    # jax.vjp with cosine >= 0.999 and norm ratio within 1%.
    scene_j = mixed_scene()
    o, d, tk = rays_for()
    g_out = np.random.default_rng(0).normal(size=(o.shape[0], 3)) \
        .astype(np.float32)
    rj, vjp = jax.vjp(lambda sc, oo, dd: JP.trace_recorded_persist(
        sc, oo, dd, tk, DEPTH, 1e-4, S, None, True, False, tc),
        scene_j, jnp.asarray(o), jnp.asarray(d))
    gj_scene, gj_o, gj_d = vjp(jnp.asarray(g_out))

    sc = pt.scene_from_numpy(scene_j, requires_grad=True)
    ot = torch.from_numpy(o).requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    stats = {}
    r = PG.trace_recorded_persist(sc, ot, dt, 0, DEPTH, 1e-4, S,
                                  tail_compact=tc, u5_fn=u5_hook(tk),
                                  stats=stats)
    grads = torch.autograd.grad(r, [*sc[:5], ot, dt], torch.from_numpy(g_out))
    assert stats["dropped"] == 0
    rj = np.asarray(rj)
    close = (np.abs(r.detach().numpy() - rj) <= 2e-4 + 1e-4 * np.abs(rj))
    assert close.all(-1).mean() >= 0.99
    want = [getattr(gj_scene, f) for f in FIELDS] + [gj_o, gj_d]
    for name, a, b in zip(FIELDS + ("origin", "direction"), grads, want):
        assert tuple(a.shape) == tuple(np.shape(b)), name
        cos, ratio = _cosine_and_ratio(a.numpy(), b)
        assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (name, cos, ratio)


@pytest.mark.parametrize("n_iters,tc", [(3, None), (5, (3, 16))],
                         ids=["starved", "starved_compact"])
def test_dropped_paths_match_jax(n_iters, tc):
    # Starved iteration caps drop paths; the port counts exactly the paths
    # the JAX package counts (padding dummies excluded).
    scene_j = mixed_scene()
    o, d, tk = rays_for()
    want = int(JP.persist_dropped_paths(scene_j, jnp.asarray(o),
                                        jnp.asarray(d), tk, DEPTH, 1e-4, S,
                                        n_iters, True, False, tc))
    got = PG.persist_dropped_paths(pt.scene_from_numpy(scene_j),
                                   torch.from_numpy(o), torch.from_numpy(d),
                                   0, DEPTH, 1e-4, S, n_iters, tail_compact=tc,
                                   u5_fn=u5_hook(tk))
    assert want > 0 and got == want


def test_dropped_paths_boundary_overflow_matches_jax(monkeypatch):
    # A phase-2 wavefront narrower than the survivors at the boundary: with
    # 2-row blocks, (3, 17) compaction keeps 512 lanes of the ~576 real
    # paths still in flight. The port counts the overflow as the JAX
    # package counts it, and its radiance (the dropped paths read black)
    # is the JAX package's within the suite's atol 2e-4, rtol 1e-4.
    monkeypatch.setattr(JP, "_persist_block_rows", lambda n_strips: 2)
    monkeypatch.setattr(PG, "persist_block_rows", lambda n_strips: 2)
    scene_j = mixed_scene()
    o, d, tk = rays_for()
    tc = (3, 17)
    rj, _, want = JP._persist_record_forward(
        scene_j, jnp.asarray(o), jnp.asarray(d), tk, DEPTH, 1e-4, S,
        JP.default_n_iters(S, DEPTH), True, False, tc)
    scene = pt.scene_from_numpy(scene_j)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    stats = {}
    r = PG.trace_recorded_persist(scene, ot, dt, 0, DEPTH, 1e-4, S,
                                  tail_compact=tc, u5_fn=u5_hook(tk),
                                  stats=stats)
    assert stats["boundary_active"][0] > 512
    assert int(want) > 0 and stats["dropped"] == int(want)
    assert PG.persist_dropped_paths(scene, ot, dt, 0, DEPTH, 1e-4, S,
                                    tail_compact=tc,
                                    u5_fn=u5_hook(tk)) == int(want)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=2e-4,
                               rtol=1e-4)


def _loss_and_albedo_grad(seed, **kw):
    """A fixed random weighting of the port's radiance (plain versions,
    Philox draws), in float64, and its albedo gradient."""
    scene_j = mixed_scene()
    o, d, _ = rays_for()
    w = torch.from_numpy(np.random.default_rng(2).random(o.shape)) \
        .to(torch.float64)
    base = pt.scene_from_numpy(scene_j)

    def loss(albedo):
        r = PG.trace_recorded_persist(base._replace(albedo=albedo),
                                      torch.from_numpy(o), torch.from_numpy(d),
                                      seed, DEPTH, 1e-4, S, **kw)
        return (r.double() * w).sum()

    alb = base.albedo.clone().requires_grad_(True)
    g = torch.autograd.grad(loss(alb), alb)[0]
    return loss, base.albedo, g


def test_fd_self_consistency_albedo():
    # Albedo moves no path, so with the draws fixed the loss is a polynomial
    # in it and a central difference (eps 1e-3) is exact up to float32
    # rounding of the radiance: within 1e-2 relative of the replay's
    # gradient. The record and replay phases draw their Philox uniforms
    # independently, so this also holds the record/replay draw contract.
    loss, alb, g = _loss_and_albedo_grad(1234, tail_compact=(6, 16))
    eps = 1e-3
    for k, c in ((0, 0), (1, 1), (2, 2)):  # Lambertian, ground, metal
        up, dn = alb.clone(), alb.clone()
        up[k, c] += eps
        dn[k, c] -= eps
        with torch.no_grad():
            fd = float(loss(up) - loss(dn)) / (2 * eps)
        an = float(g[k, c])
        assert an != 0 and abs(fd - an) <= 1e-2 * abs(an), (k, c, fd, an)


def test_strict_poisons_radiance_and_gradients_on_drop():
    # strict: a dropped path turns the radiance and every output cotangent
    # to NaN, even for a loss linear in the radiance; without strict the
    # starved trace reads black and stays finite; with no drop strict
    # changes nothing.
    scene_j = mixed_scene()
    o, d, _ = rays_for()
    sc = pt.scene_from_numpy(scene_j, requires_grad=True)
    ot = torch.from_numpy(o).requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    leaves = [*sc[:5], ot, dt]
    r = PG.trace_recorded_persist(sc, ot, dt, 5, DEPTH, 1e-4, S, 3,
                                  strict=True)
    assert torch.isnan(r).all()
    for g in torch.autograd.grad(r.sum(), leaves):
        assert torch.isnan(g).all()
    r_plain = PG.trace_recorded_persist(sc, ot, dt, 5, DEPTH, 1e-4, S, 3)
    assert torch.isfinite(r_plain).all()
    for g in torch.autograd.grad(r_plain.sum(), leaves):
        assert torch.isfinite(g).all()
    ok = PG.trace_recorded_persist(sc, ot, dt, 5, DEPTH, 1e-4, S, strict=True)
    assert torch.equal(ok, PG.trace_recorded_persist(sc, ot, dt, 5, DEPTH,
                                                     1e-4, S))


@pytest.mark.parametrize("tc", [None, (6, 16)], ids=["plain", "tail_compact"])
def test_lean_record_bitwise_equal_to_full_record(tc):
    # The lean 11-plane record, replayed slot by slot (K6) with the winner
    # attributes refetched, runs the same per-lane arithmetic as the fused
    # replay (K5) of the full record: bitwise-equal radiance and gradients.
    def run(rec_attrs):
        sc = pt.scene_from_numpy(mixed_scene(), requires_grad=True)
        o, d, _ = rays_for()
        ot = torch.from_numpy(o).requires_grad_(True)
        dt = torch.from_numpy(d).requires_grad_(True)
        r = PG.trace_recorded_persist(sc, ot, dt, 77, DEPTH, 1e-4, S,
                                      tail_compact=tc, rec_attrs=rec_attrs)
        return (r, *torch.autograd.grad((r * r).sum(), [*sc[:5], ot, dt]))
    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)


def test_wrappers_on_cpu_run_plain_versions(record):
    # On CPU tensors each wrapper runs its plain version and counts no
    # launch; on a device that is neither the CPU nor CUDA it raises.
    st = record["steps"][5]
    sf, si, rad = st["state"]
    strips, W = record["strips"], record["W"]
    spheres = K.sphere_consts(pt.scene_from_numpy(record["scene_j"]))
    before = (K.masked_launches, PK.record_launches,
              PK.replay_fused_launches, PK.replay_step_launches)
    assert all(torch.equal(a, b) for a, b in zip(
        K.sweep_masked(sf[0:6], si[2], spheres),
        K.sweep_masked_ref(sf[0:6], si[2], spheres)))
    outs = []
    amat = attr_mat(pt.scene_from_numpy(record["scene_j"]))
    for step, table in ((PK.persist_record_step, (st["idx"], amat)),
                        (PK.persist_record_step_ref, (st["attrs"],))):
        state = [x.clone() for x in (sf, si, rad)]
        slot = torch.zeros((PK.N_REC, W))
        step(st["t"], *table, strips, *state, slot, 9, 5, DEPTH)
        outs.append(state + [slot])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    rec = torch.stack([s["slot"] for s in record["steps"]])
    rec_idx = torch.stack([s["idx"] for s in record["steps"]])
    gs = torch.ones((3 * S, W))
    outs = []
    for fused in (PK.persist_replay_fused, PK.persist_replay_fused_ref):
        cot, dep = torch.zeros((9, W)), torch.zeros((6 * S, W))
        outs.append((fused(cot, dep, rec, gs, 0, 9), cot, dep))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    outs = []
    for step in (lambda c, d, r, *a: PK.persist_replay_step(
                     c, d, r[:PK.N_REC_LEAN], rec_idx[3], amat, *a),
                 PK.persist_replay_step_ref):
        cot, dep = torch.zeros((9, W)), torch.zeros((6 * S, W))
        outs.append((step(cot, dep, rec[3], gs, 9, 3), cot, dep))
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    assert before == (K.masked_launches, PK.record_launches,
                      PK.replay_fused_launches, PK.replay_step_launches)
    meta = torch.empty((9, W), device="meta")
    with pytest.raises(ValueError):
        PK.persist_replay_step(meta, meta, rec[3, :PK.N_REC_LEAN], rec_idx[3],
                               amat, gs, 9, 3)
    with pytest.raises(ValueError):
        K.sweep_masked(sf[0:6].to("meta"), si[2], spheres)


@pytest.mark.cuda
def test_gradient_kernels_match_plain_on_card(cuda_device):
    # K3-K6 against their plain versions on the card over a recorded phase
    # of the mixed scene (each wrapper launches once per call): K3 idx
    # identical; K4 integer planes identical and floats within
    # 1e-6 * max(1, |x|) on >= 99.99% of lanes; K5 and K6 cot, dep and
    # dattr within 1e-5 * max(1, |x|) on >= 99.9% of lanes; K5 with its own
    # Philox draws bitwise equal to K5 fed philox_uniforms.
    dev = cuda_device
    scene = pt.scene_from_numpy(mixed_scene(), device=dev)
    o, d, _ = rays_for(256, 128, seed=3)
    strips, sf, si, rad = PG.start_planes(torch.from_numpy(o).to(dev),
                                          torch.from_numpy(d).to(dev), S)
    W = sf.shape[1]
    spheres, amat = K.sphere_consts(scene), attr_mat(scene)
    n_slots, seed = 12, 4242
    rec = torch.zeros((n_slots, PK.N_REC, W), device=dev)
    rec_idx = torch.zeros((n_slots, W), dtype=torch.int32, device=dev)

    def within(pairs, rel):
        ok = torch.ones(W, dtype=torch.bool, device=dev)
        for a, b in pairs:
            a, b = a.reshape(-1, W), b.reshape(-1, W)
            ok &= ((a - b).abs() <= rel * b.abs().clamp(min=1)).all(0)
        return ok.float().mean().item()

    for i in range(n_slots):
        n3 = K.masked_launches
        t, idx = K.sweep_masked(sf[0:6], si[2], spheres)
        tr, ir = K.sweep_masked_ref(sf[0:6], si[2], spheres)
        assert K.masked_launches == n3 + 1 and torch.equal(idx, ir)
        assert (t == tr).float().mean().item() >= 0.9999
        attrs = fetch_attr_planes(idx, amat)
        ref = [x.clone() for x in (sf, si, rad)]
        slot_ref = torch.zeros((PK.N_REC, W), device=dev)
        n4 = PK.record_launches
        PK.persist_record_step(t, idx, amat, strips, sf, si, rad, rec[i],
                               seed, i, DEPTH)
        PK.persist_record_step_ref(t, attrs, strips, *ref, slot_ref, seed, i,
                                   DEPTH)
        torch.cuda.synchronize()
        assert PK.record_launches == n4 + 1
        assert torch.equal(si, ref[1])
        assert torch.equal(PK.flags_of(rec[i]), PK.flags_of(slot_ref))
        floats = [k for k in range(PK.N_REC) if k != 10]
        assert within([(sf, ref[0]), (rad, ref[2]),
                       (rec[i][floats], slot_ref[floats])], 1e-6) >= 0.9999
        rec_idx[i] = idx
        sf, si, rad = ref  # continue from the plain state

    g = torch.Generator(device=dev).manual_seed(5)
    gs = torch.randn((3 * S, W), generator=g, device=dev)
    cot0 = torch.randn((9, W), generator=g, device=dev)
    dep0 = torch.zeros((6 * S, W), device=dev)

    def fused(fn, u5_all=None):
        cot, dep = cot0.clone(), dep0.clone()
        return (fn(cot, dep, rec, gs, 0, seed, u5_all), cot, dep)

    def per_slot(fn):
        cot, dep = cot0.clone(), dep0.clone()
        dattr = torch.zeros((n_slots, 9, W), device=dev)
        for s in reversed(range(n_slots)):
            fn(cot, dep, rec[s, :PK.N_REC_LEAN], rec_idx[s], amat, gs, seed,
               s, None, out=dattr[s])
        return dattr, cot, dep

    n5, n6 = PK.replay_fused_launches, PK.replay_step_launches
    k5 = fused(PK.persist_replay_fused)
    k6 = per_slot(PK.persist_replay_step)
    torch.cuda.synchronize()
    assert PK.replay_fused_launches == n5 + 1
    assert PK.replay_step_launches == n6 + n_slots
    assert within(zip(k5, fused(PK.persist_replay_fused_ref)), 1e-5) >= 0.999
    assert within(zip(k6, per_slot(PK.persist_replay_step_fetch_ref)),
                  1e-5) >= 0.999
    u5_all = torch.stack([rng.philox_uniforms(seed, i, W, 5, device=dev)
                          for i in range(n_slots)])
    for a, b in zip(k5, fused(PK.persist_replay_fused, u5_all)):
        assert torch.equal(a, b)
