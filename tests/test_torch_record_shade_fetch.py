"""K7a with its winner fetch inside: the plain entry the fixed-depth record
loop calls (``record_shade_fetch_ref``: the gather, then the
attribute-level step) against the gather plus ``record_shade_step_ref`` and
against the JAX package's fetch and record kernel (interpret mode); the
record's attribute planes on miss and dead lanes; the whole trace and its
gradients against the route that gathered; a card-only check of the kernel
against the plain entry."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.materials import (
    attr_mat as jax_attr_mat, fetch_attr_planes as jax_fetch)
from raytracingweekend_jl_tpu.ops.pallas import grad_kernel as JG
from raytracingweekend_jl_tpu_torch.ops import fused_grad as FG
from raytracingweekend_jl_tpu_torch.ops import materials
from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.materials import (attr_mat,
                                                          fetch_attr_planes)
from test_torch_fused_grad import (LANES, SCENES, SEED, alive_of,
                                   close_share, flat, jplanes, mid_trace)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CAMS = {"random_spheres": "t_cam1", "random_spheres_reference": "t_cam1",
        "diel_spheres_hollow": "hollow_glass_cam"}
DEPTH = 8


def _rays(name, device="cpu", W=48, H=27):
    scene = pt.trim_scene(pt.ALL_SCENES[name](device=device))
    cam = getattr(pt, CAMS.get(name, "t_default_cam"))(device=device)
    u, v = pt.pixel_coords(W, H, device=device)
    g = torch.Generator(device=device).manual_seed(5)
    o, d = pt.get_rays(cam, u, v, generator=g)
    return scene, o, d


def _bounces(name, device="cpu"):
    """Yield ``(b, t, idx, amat, st)`` before each of ``DEPTH`` record
    bounces from the scene's camera rays, advancing the state by the plain
    entry (Philox draws)."""
    scene, o, d = _rays(name, device)
    st = FG.start_state(o, d)
    spheres, amat = K.sphere_consts(scene), attr_mat(scene)
    slot = torch.empty((GK.N_REC, st.shape[1]), device=device)
    for b in range(DEPTH):
        t, idx = K.sweep_masked_ref(st[0:6], st[12].view(torch.int32),
                                    spheres)
        yield b, t, idx, amat, st
        GK.record_shade_fetch_ref(t, idx, amat, st, slot, SEED, b)


def _run(step, t, idx_or_attrs, amat, st, b, u5=None):
    """One record bounce on a copy of ``st``: ``(st, slot)`` (the slot
    starts as garbage: every word is written)."""
    st = st.clone()
    slot = torch.full((GK.N_REC, st.shape[1]), 7.0, device=st.device)
    table = () if amat is None else (amat,)
    step(t, idx_or_attrs, *table, st, slot, SEED, b, u5)
    return st, slot


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("draws", ["philox", "injected"])
@pytest.mark.parametrize("name", sorted(pt.ALL_SCENES))
def test_fetch_entry_is_gather_plus_step_ref(name, draws):
    # The record loop's plain entry is the gather followed by the
    # attribute-level step, bit for bit (state and every record word), on
    # every scene, at every bounce of an 8-bounce record (live misses and
    # dead lanes both occur); the CPU wrapper runs it.
    seen = np.zeros(2, dtype=bool)
    rng_np = np.random.default_rng(8)
    for b, t, idx, amat, st in _bounces(name):
        live = st[12].view(torch.int32) != 0
        u5 = (None if draws == "philox" else torch.from_numpy(
            rng_np.random((5, t.shape[0]), dtype=np.float32)))
        entry = _run(GK.record_shade_fetch_ref, t, idx, amat, st, b, u5)
        gather = _run(GK.record_shade_step_ref, t,
                      fetch_attr_planes(idx, amat), None, st, b, u5)
        wrapper = _run(GK.record_shade_step, t, idx, amat, st, b, u5)
        assert _same(entry, gather) and _same(entry, wrapper), b
        seen |= [bool((live & (t >= K.BIG)).any()), bool((~live).any())]
    assert seen.all(), seen


@pytest.mark.parametrize("name", sorted(pt.ALL_SCENES))
def test_record_holds_sphere0_row_on_miss(name):
    # Planes 11-20 of a record slot are the winner's row on every live lane:
    # sphere 0's row where the ray missed (the sweep's index is 0 there, as
    # the gather reads it), and a dead lane's slot is all zeros (its alive
    # flag 0 is all the replay reads).
    n_miss = n_dead = 0
    for b, t, idx, amat, st in _bounces(name):
        live = st[12].view(torch.int32) != 0
        slot = _run(GK.record_shade_fetch_ref, t, idx, amat, st, b)[1]
        miss = live & (t >= K.BIG)
        assert torch.equal(idx[miss], torch.zeros_like(idx[miss]))
        assert torch.equal(slot[11:21][:, miss],
                           amat[0][:, None].expand(10, int(miss.sum())))
        assert torch.equal(slot[11:21][:, live], amat[idx[live].long()].T)
        assert torch.equal(slot[10].view(torch.int32), live.to(torch.int32))
        assert not slot[:, ~live].any()
        n_miss += int(miss.sum())
        n_dead += int((~live).sum())
    assert n_miss > 0 and n_dead > 0


@pytest.mark.parametrize("name", sorted(SCENES))
def test_fetch_entry_matches_jax_fetch_and_record_kernel(name):
    # The same state, winners and injected uniforms through the JAX
    # package's fetch (its one-hot contraction) and record kernel
    # (interpret mode), and through the port's plain entry, one bounce after
    # a bounce of the plain record. The fetched attributes are exact; the
    # alive flags identical; every live lane's record holds its inputs bit
    # for bit; the state within 1e-5 * max(1, |x|) on every lane and 1e-6 on
    # >= 99.9% of lanes (the rule of test_record_step_matches_jax: XLA
    # contracts FMA in the hit point).
    scene, st, spheres, amat, gen = mid_trace(name)
    t, idx = K.sweep_masked_ref(st[0:6], alive_of(st), spheres)
    amat_j = jax_attr_mat(SCENES[name][0]())[:amat.shape[0]]
    attrs_j = np.asarray(jax_fetch(jnp.asarray(idx.numpy()), amat_j,
                                   amat.shape[0])).reshape(10, LANES)
    np.testing.assert_array_equal(attrs_j,
                                  fetch_attr_planes(idx, amat).numpy())
    u5 = torch.from_numpy(gen.random((5, LANES), dtype=np.float32))
    st_p, rec_p = _run(GK.record_shade_fetch_ref, t, idx, amat, st, 1, u5)
    rec0 = tuple(jnp.zeros((2, LANES // 128, 128),
                           jnp.int32 if p == 10 else jnp.float32)
                 for p in range(GK.N_REC))
    st_j, rec_j = JG.record_shade_step(
        jplanes(st, 12), rec0, jnp.asarray(t.numpy().reshape(-1, 128)),
        [jnp.asarray(a.reshape(-1, 128)) for a in attrs_j], 1, SEED,
        interpret=True, u5=jnp.asarray(u5.numpy().reshape(5, -1, 128)))
    st_j, slot_j = flat(st_j), flat(tuple(r[1] for r in rec_j))
    live = alive_of(st).numpy() != 0
    assert np.array_equal(st_p[12].numpy().view(np.int32),
                          st_j[12].view(np.int32))
    assert np.array_equal(rec_p[10].numpy().view(np.int32),
                          slot_j[10].view(np.int32))
    assert np.array_equal(rec_p.numpy()[:, live], slot_j[:, live])
    share, err = close_share(st_p[:12].numpy(), st_j[:12], 1e-5)
    assert share == 1.0, (share, err)
    share, err = close_share(st_p[:12].numpy(), st_j[:12], 1e-6)
    assert share >= 0.999, (share, err)


def _gathered_forward(scene, o, d, cfg):
    """The record bounces as the route ran them before K7a fetched the
    winner's row itself: the sweep, the gather, the attribute-level step."""
    st = FG.start_state(o, d)
    spheres, amat = K.sphere_consts(scene), attr_mat(scene)
    R = o.shape[0]
    rec = torch.empty((cfg.max_depth, GK.N_REC, R))
    rec_idx = torch.empty((cfg.max_depth, R), dtype=torch.int32)
    for b in range(cfg.max_depth):
        t, idx = K.sweep_masked_ref(st[0:6], st[12].view(torch.int32),
                                    spheres, cfg.tmin)
        rec_idx[b] = idx
        u5 = None if cfg.u5_fn is None else cfg.u5_fn(b, R)
        GK.record_shade_step_ref(t, fetch_attr_planes(idx, amat), st, rec[b],
                                 cfg.seed, b, u5)
    return st[9:12].T.contiguous(), rec, rec_idx


@pytest.mark.parametrize("replay_fused", [True, False])
@pytest.mark.parametrize("name", ["4_spheres", "diel_spheres_hollow",
                                  "random_spheres"])
def test_trace_radiance_and_gradients_match_gathered_route(name,
                                                           replay_fused):
    # trace_recorded_fused on the CPU: its radiance, record and winners are
    # the gathering route's bit for bit, and so are the gradients (the
    # replay of either record, and autograd through the trace).
    scene, o, d = _rays(name, W=32, H=18)
    cfg = FG._Config(DEPTH, 1e-4, GK.base_seed(SEED), replay_fused, "plain",
                     None)
    new = FG._record_forward(scene, o, d, cfg)
    old = _gathered_forward(scene, o, d, cfg)
    assert _same(new, old)
    g_rad = torch.from_numpy(np.random.default_rng(3).normal(
        size=(o.shape[0], 3)).astype(np.float32))
    g_new = FG._replay_backward(new[1], new[2], g_rad, scene.n_spheres, cfg)
    g_old = FG._replay_backward(old[1], old[2], g_rad, scene.n_spheres, cfg)
    assert _same(g_new, g_old)
    leaves = [x.clone().requires_grad_(True) for x in scene[:5]]
    rad = pt.trace_recorded_fused(scene._replace(
        **dict(zip(("center", "radius", "albedo", "fuzz", "ir"), leaves))),
        o, d, SEED, DEPTH, replay_fused=replay_fused, impl="plain")
    assert _same((rad,), (old[0],))
    grads = torch.autograd.grad(rad, leaves, g_rad)
    g_attr = g_old[0]
    want = (g_attr[:, 0:3], g_attr[:, 3], g_attr[:, 4:7], g_attr[:, 7],
            g_attr[:, 8])
    assert _same(grads, want)


def test_record_loop_gathers_only_in_plain_entry():
    # The record loop passes the sweep's index to K7a; on the CPU the plain
    # entry gathers once per bounce and nothing else in the forward does.
    scene, o, d = _rays("4_spheres", W=16, H=9)
    cfg = FG._Config(6, 1e-4, SEED, True, "plain", None)
    before = materials.fetch_calls
    FG._record_forward(scene, o, d, cfg)
    assert materials.fetch_calls - before == 6


def test_wrapper_rejects_other_devices():
    # Tensors on neither the CPU nor a card raise; nothing falls back.
    for b, t, idx, amat, st in _bounces("2_spheres"):
        meta = [x.to("meta") for x in (t, idx, amat, st)]
        slot = torch.empty((GK.N_REC, st.shape[1]), device="meta")
        with pytest.raises(ValueError):
            GK.record_shade_step(*meta, slot, SEED, b)
        break


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    # K7a on the card against the plain entry, bit for bit in every state
    # and record word, at every bounce of the record, injected and Philox
    # draws, one launch per call; and the small-image gradient step
    # launches no gather.
    g = torch.Generator(cuda_device).manual_seed(4)
    for name in ("random_spheres", "diel_spheres_hollow"):
        for b, t, idx, amat, st in _bounces(name, cuda_device):
            for u in (torch.rand((5, t.shape[0]), generator=g,
                                 device=cuda_device), None):
                ref = _run(GK.record_shade_fetch_ref, t, idx, amat, st, b, u)
                n = GK.record_launches
                got = _run(GK.record_shade_step, t, idx, amat, st, b, u)
                torch.cuda.synchronize()
                assert GK.record_launches == n + 1
                assert _same(got, ref), (name, b)
    scene, cam = pt.scene_4_spheres(), pt.t_default_cam()
    target = torch.full((36, 64, 3), 0.3, device=cuda_device)
    before = materials.fetch_calls
    pt.render_grads(scene, cam, target, 64, 2, seed=1, device=cuda_device)
    assert materials.fetch_calls == before
