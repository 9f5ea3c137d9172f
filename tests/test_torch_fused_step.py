"""The port's single-dispatch record step (K11, ``fused_step=True``) against
the JAX package.

- K11's plain version against ``persist_record_fused_step(interpret=True,
  u5=...)`` from mid-phase states of the mixed scene, fed the same uniforms.
- ``trace_recorded_persist(fused_step=True)`` and its VJP against the JAX
  function in interpret mode with JAX's uniforms injected.
- The port's own program: fused against unfused bitwise, the two
  ``ValueError`` s, finite differences in albedo with its Philox draws, the
  wrapper on the CPU.
- Card-only: K11 against its plain version and the fused trace on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.pallas import persist_grad_kernel as JP
from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
from raytracingweekend_jl_tpu_torch.ops.materials import (attr_mat,
                                                          fetch_attr_planes)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
from test_torch_persist_grad import (DEPTH, FIELDS, S, _cosine_and_ratio,
                                     _loss_and_albedo_grad, mixed_scene,
                                     rays_for, u5_hook)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def states():
    """The planes before iterations 0-11 of a plain three-step record
    phase (K3, the gather, K4) of the mixed scene at 8 192 rays (S = 4
    strips of 2 048 real lanes, padded to 8 192, depth 8), with uniforms
    from a numpy seed."""
    scene_j = mixed_scene()
    o, d, _ = rays_for(128, 64, seed=3)
    scene = pt.scene_from_numpy(scene_j)
    strips, sf, si, rad = PG.start_planes(torch.from_numpy(o),
                                          torch.from_numpy(d), S)
    W = sf.shape[1]
    spheres, amat = K.sphere_consts(scene), attr_mat(scene)
    g = np.random.default_rng(11)
    out = {}
    for i in range(12):
        u5 = torch.from_numpy(g.random((5, W), dtype=np.float32))
        out[i] = (sf.clone(), si.clone(), rad.clone(), u5)
        t, idx = K.sweep_masked_ref(sf[0:6], si[2], spheres)
        PK.persist_record_step_ref(t, fetch_attr_planes(idx, amat), strips,
                                   sf, si, rad, torch.zeros((PK.N_REC, W)),
                                   0, i, DEPTH, u5)
    return dict(scene_j=scene_j, scene=scene, strips=strips, states=out, W=W,
                spheres=spheres, amat=amat)


def _fused_ref(st, it):
    sf, si, rad, u5 = (x.clone() for x in st["states"][it])
    slot = torch.zeros((PK.N_REC, st["W"]))
    idx = torch.zeros(st["W"], dtype=torch.int32)
    PK.persist_record_fused_step_ref(st["strips"], sf, si, rad, slot, idx,
                                     st["spheres"], st["amat"], 0, it, DEPTH,
                                     1e-4, u5)
    return sf, si, rad, slot, idx


def _within(a, b, tol=1e-5):
    """Per lane (last axis): every plane within ``tol * max(1, |b|)``."""
    a, b = np.asarray(a), np.asarray(b)
    a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
    return (np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b))).all(0)


@pytest.mark.parametrize("it", [0, 4, 7])
def test_fused_step_ref_matches_jax(states, it):
    # K11's plain version against persist_record_fused_step(interpret=True)
    # from the same state with the same uniforms: the integer state
    # identical; on live lanes the flags and the winner index identical;
    # the float state, the radiance and, on live lanes, the 20 float record
    # planes within 1e-5 * max(1, |x|) on >= 99.9% of lanes (the K4 test's
    # bound; the two sweeps evaluate the expanded quadratic in two orders,
    # so a grazing hit can move t's last bits: measured 100%, 99.99% (one
    # lane) and 100%). A dead lane keeps its state in both. Its
    # record slot and winner are zeros in the port (as K3 + K4 write them);
    # the JAX kernel fills them from the lane's stale ray and its strip
    # number, which its replay masks out.
    st = states
    rows = st["W"] // PG.LANES
    pl = lambda x: jnp.asarray(x.numpy().reshape(rows, PG.LANES))
    sf, si, rad, u5 = st["states"][it]
    rec0 = tuple(jnp.zeros((1, rows, PG.LANES),
                           jnp.int32 if k in (10, 21) else jnp.float32)
                 for k in range(22))
    st_j, rad_j, rec_j = JP.persist_record_fused_step(
        tuple(pl(p) for p in sf) + tuple(pl(p) for p in si),
        tuple(pl(p) for p in rad), rec0, tuple(pl(p) for p in st["strips"]),
        st["scene_j"], 0, 0, DEPTH, S, 1e-4, interpret=True,
        u5=jnp.asarray(u5.numpy().reshape(5, rows, PG.LANES)))
    sf2, si2, rad2, slot, idx = _fused_ref(st, it)
    flat = lambda planes: np.stack([np.asarray(p).reshape(-1)
                                    for p in planes])
    live = si[2].numpy() != 0
    assert live.any() and (it == 0 or (~live).any())
    np.testing.assert_array_equal(si2.numpy(), flat(st_j[9:12]))
    rec_j = flat(rec_j)
    np.testing.assert_array_equal(PK.flags_of(slot).numpy()[live],
                                  rec_j[10][live])
    np.testing.assert_array_equal(idx.numpy()[live], rec_j[21][live])
    assert (idx.numpy()[~live] == 0).all()
    assert (slot.numpy()[:, ~live] == 0).all()
    floats = [k for k in range(PK.N_REC) if k != 10]
    ok = (_within(sf2.numpy(), flat(st_j[:9]))
          & _within(rad2.numpy(), flat(rad_j))
          & (~live | _within(slot.numpy()[floats], rec_j[floats])))
    assert ok.mean() >= 0.999, ok.mean()


@pytest.mark.parametrize("it", [0, 4, 7])
def test_fused_step_ref_is_the_three_step_iteration(states, it):
    # K11's plain version against K3 + the gather + K4 from the same state:
    # state, radiance, flags, o, d, T, t and the winners identical; the
    # attribute planes identical on hit lanes and zero on miss lanes (the
    # gather gives sphere 0's row there).
    st = states
    sf2, si2, rad2, slot, idx = _fused_ref(st, it)
    sf, si, rad, u5 = (x.clone() for x in st["states"][it])
    t, idx3 = K.sweep_masked_ref(sf[0:6], si[2], st["spheres"])
    ref = torch.zeros((PK.N_REC, st["W"]))
    PK.persist_record_step_ref(t, fetch_attr_planes(idx3, st["amat"]),
                               st["strips"], sf, si, rad, ref, 0, it, DEPTH,
                               u5)
    for a, b in ((sf2, sf), (si2, si), (rad2, rad), (idx, idx3),
                 (slot[0:11], ref[0:11])):
        assert torch.equal(a, b)
    hit = (PK.flags_of(slot) & PK.F_HIT) != 0
    assert hit.any() and (~hit).any()
    assert torch.equal(slot[11:, hit], ref[11:, hit])
    assert (slot[11:, ~hit] == 0).all()


def test_fused_trace_and_vjp_match_jax_interpret():
    # The whole fused trace at 32x18 rays, S = 4, depth 8, with JAX's
    # uniforms injected, against JAX's trace_recorded_persist(fused_step=
    # True) in interpret mode: radiance within the JAX suite's atol 2e-4,
    # rtol 1e-4 on >= 99% of rays; each scene field's VJP and the ray
    # cotangents with cosine >= 0.999 and norm ratio within 1% (the
    # unfused test's bounds).
    scene_j = mixed_scene()
    o, d, tk = rays_for()
    g_out = np.random.default_rng(0).normal(size=(o.shape[0], 3)) \
        .astype(np.float32)
    rj, vjp = jax.vjp(lambda sc, oo, dd: JP.trace_recorded_persist(
        sc, oo, dd, tk, DEPTH, 1e-4, S, None, True, True),
        scene_j, jnp.asarray(o), jnp.asarray(d))
    gj_scene, gj_o, gj_d = vjp(jnp.asarray(g_out))

    sc = pt.scene_from_numpy(scene_j, requires_grad=True)
    ot = torch.from_numpy(o).requires_grad_(True)
    dt = torch.from_numpy(d).requires_grad_(True)
    stats = {}
    r = PG.trace_recorded_persist(sc, ot, dt, 0, DEPTH, 1e-4, S,
                                  fused_step=True, u5_fn=u5_hook(tk),
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


@pytest.mark.parametrize("n_iters", [None, 3], ids=["exact", "starved"])
def test_fused_trace_bitwise_equal_to_unfused(n_iters):
    # With the port's Philox draws the fused trace runs the three-step
    # iteration's arithmetic on every hit lane and replays the same record
    # (a miss lane's attributes are read by nothing): radiance, the five
    # field gradients and the ray cotangents bitwise equal, and the same
    # dropped-path count (0 at the default cap, > 0 when starved).
    def run(fused):
        sc = pt.scene_from_numpy(mixed_scene(), requires_grad=True)
        o, d, _ = rays_for()
        ot = torch.from_numpy(o).requires_grad_(True)
        dt = torch.from_numpy(d).requires_grad_(True)
        stats = {}
        r = PG.trace_recorded_persist(sc, ot, dt, 77, DEPTH, 1e-4, S, n_iters,
                                      fused_step=fused, stats=stats)
        dropped = PG.persist_dropped_paths(sc, ot, dt, 77, DEPTH, 1e-4, S,
                                           n_iters, fused_step=fused)
        assert dropped == stats["dropped"]
        return dropped, (r, *torch.autograd.grad(
            (r * r).sum(), [*sc[:5], ot, dt]))
    (d_f, fused), (d_u, unfused) = run(True), run(False)
    assert d_f == d_u and (d_f == 0) == (n_iters is None)
    for a, b in zip(fused, unfused):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [{"tail_compact": (6, 16)},
                                {"rec_attrs": False}],
                         ids=["tail_compact", "lean_record"])
def test_fused_step_value_errors(kw):
    # As the JAX package: fused_step takes neither tail compaction nor the
    # lean record (persist_grad_kernel.py _persist_record_forward).
    scene_j = mixed_scene()
    o, d, tk = rays_for(8, 4)
    with pytest.raises(ValueError):
        JP.persist_dropped_paths(scene_j, jnp.asarray(o), jnp.asarray(d), tk,
                                 DEPTH, 1e-4, S, None, True, True,
                                 kw.get("tail_compact"),
                                 kw.get("rec_attrs", True))
    scene = pt.scene_from_numpy(scene_j)
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    with pytest.raises(ValueError):
        PG.trace_recorded_persist(scene, ot, dt, 0, DEPTH, 1e-4, S,
                                  fused_step=True, **kw)
    with pytest.raises(ValueError):
        PG.persist_dropped_paths(scene, ot, dt, 0, DEPTH, 1e-4, S,
                                 fused_step=True, **kw)


def test_fused_fd_self_consistency_albedo():
    # The fused trace with its own Philox draws (record in K11's plain
    # version, replay in K5's): a central difference in albedo (eps 1e-3)
    # within 1e-2 relative of the replay's gradient, as for the unfused
    # trace (test_torch_persist_grad.py).
    loss, alb, g = _loss_and_albedo_grad(4321, fused_step=True)
    eps = 1e-3
    for k, c in ((0, 0), (1, 1), (2, 2)):  # Lambertian, ground, metal
        up, dn = alb.clone(), alb.clone()
        up[k, c] += eps
        dn[k, c] -= eps
        with torch.no_grad():
            fd = float(loss(up) - loss(dn)) / (2 * eps)
        an = float(g[k, c])
        assert an != 0 and abs(fd - an) <= 1e-2 * abs(an), (k, c, fd, an)


def test_fused_wrapper_on_cpu_runs_plain_version(states):
    # On CPU tensors the wrapper runs its plain version with the Philox
    # draws of (seed, iteration) and counts no launch; a device that is
    # neither the CPU nor CUDA raises.
    st = states
    outs = []
    before = PK.record_fused_launches
    for step in (PK.persist_record_fused_step,
                 PK.persist_record_fused_step_ref):
        sf, si, rad, _ = (x.clone() for x in st["states"][5])
        slot = torch.zeros((PK.N_REC, st["W"]))
        idx = torch.zeros(st["W"], dtype=torch.int32)
        step(st["strips"], sf, si, rad, slot, idx, st["spheres"], st["amat"],
             9, 5, DEPTH, 1e-4)
        outs.append((sf, si, rad, slot, idx))
    assert PK.record_fused_launches == before
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    meta = torch.empty((9, st["W"]), device="meta")
    with pytest.raises(ValueError):
        PK.persist_record_fused_step(st["strips"], meta, *outs[0][1:],
                                     st["spheres"], st["amat"], 9, 5, DEPTH,
                                     1e-4)


@pytest.mark.cuda
def test_fused_step_kernel_matches_plain_on_card(cuda_device):
    # K11 on the card against its plain version from a mid-phase state of
    # the mixed scene at 32 768 rays, with injected and with Philox draws:
    # integer planes, flags and winners identical, float planes within
    # 1e-6 * max(1, |x|) on >= 99.99% of lanes; one launch per call. The
    # fused trace on the card is bitwise the unfused trace.
    dev = cuda_device
    scene = pt.scene_from_numpy(mixed_scene(), device=dev)
    o, d, _ = rays_for(256, 128, seed=3)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    strips, sf, si, rad = PG.start_planes(o, d, S)
    W = sf.shape[1]
    spheres, amat = K.sphere_consts(scene), attr_mat(scene)
    for i in range(6):
        t, idx = K.sweep_masked(sf[0:6], si[2], spheres)
        PK.persist_record_step(t, idx, amat, strips, sf, si, rad,
                               torch.zeros((PK.N_REC, W), device=dev), 3, i,
                               DEPTH)
    g = torch.Generator(device=dev).manual_seed(2)
    for u5 in (torch.rand((5, W), generator=g, device=dev), None):
        outs = []
        for step in (PK.persist_record_fused_step,
                     PK.persist_record_fused_step_ref):
            state = [x.clone() for x in (sf, si, rad)]
            slot = torch.zeros((PK.N_REC, W), device=dev)
            idx = torch.zeros(W, dtype=torch.int32, device=dev)
            n = PK.record_fused_launches
            step(strips, *state, slot, idx, spheres, amat, 3, 6, DEPTH, 1e-4,
                 u5)
            torch.cuda.synchronize()
            outs.append((state, slot, idx, PK.record_fused_launches - n))
        (sk, slk, ik, nk), (sr, slr, ir, nr) = outs
        assert nk == 1 and nr == 0
        assert torch.equal(ik, ir) and torch.equal(sk[1], sr[1])
        assert torch.equal(PK.flags_of(slk), PK.flags_of(slr))
        floats = [k for k in range(PK.N_REC) if k != 10]
        ok = torch.ones(W, dtype=torch.bool, device=dev)
        for a, b in ((sk[0], sr[0]), (sk[2], sr[2]),
                     (slk[floats], slr[floats])):
            ok &= ((a - b).abs() <= 1e-6 * b.abs().clamp(min=1)).all(0)
        assert ok.float().mean().item() >= 0.9999
    sc = pt.scene_from_numpy(mixed_scene(), requires_grad=True, device=dev)
    outs = []
    for fused in (True, False):
        r = PG.trace_recorded_persist(sc, o, d, 5, DEPTH, 1e-4, S,
                                      fused_step=fused)
        outs.append((r, *torch.autograd.grad((r * r).sum(), sc[:5])))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
