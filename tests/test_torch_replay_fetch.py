"""K6 with the winner fetch inside, and why K5 keeps reading the record's
attribute planes: K6's plain entry (``persist_replay_step_fetch_ref``)
against the gather plus the attribute-level ref, bit for bit; on phases
recorded by K4 and by K11, a hit lane's planes are its winner's row of the
table (so a row fetch there keeps every bit) while a miss lane's attribute
cotangent rows are zeros whose signs follow the attributes (so row 0 there
does not); the lean and full replays bitwise equal; card-only checks of
the kernels against their plain versions and of the lean replay's
gathers."""

import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch import rng
from raytracingweekend_jl_tpu_torch.ops import materials
from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
from raytracingweekend_jl_tpu_torch.ops.materials import (attr_mat,
                                                          fetch_attr_planes)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CAMS = {"random_spheres": "t_cam1", "random_spheres_reference": "t_cam1",
        "diel_spheres_hollow": "hollow_glass_cam"}
S, DEPTH, N_SLOTS, SEED = 4, 8, 12, 77


def _phase(name, recorder, device="cpu", W=48, H=27):
    """A ``N_SLOTS``-slot record phase of the scene's camera rays (4
    strips), recorded by K4's plain entry (``"k4"``: sphere 0's row in a
    miss lane's attribute planes) or by K11's (``"k11"``: zeros there), with
    Philox draws: ``(rec, rec_idx, amat)``."""
    scene = pt.trim_scene(pt.ALL_SCENES[name](device=device))
    cam = getattr(pt, CAMS.get(name, "t_default_cam"))(device=device)
    u, v = pt.pixel_coords(W, H, device=device)
    g = torch.Generator(device=device).manual_seed(5)
    o, d = pt.get_rays(cam, u, v, generator=g)
    spheres, amat = K.sphere_consts(scene), attr_mat(scene)
    strips, sf, si, rad = PG.start_planes(o, d, S)
    lanes = sf.shape[1]
    rec = torch.empty((N_SLOTS, PK.N_REC, lanes), device=device)
    rec_idx = torch.empty((N_SLOTS, lanes), dtype=torch.int32, device=device)
    for s in range(N_SLOTS):
        if recorder == "k11":
            PK.persist_record_fused_step_ref(strips, sf, si, rad, rec[s],
                                             rec_idx[s], spheres, amat, SEED,
                                             s, DEPTH, 1e-4)
            continue
        t, idx = K.sweep_masked_ref(sf[0:6], si[2], spheres)
        rec_idx[s] = idx
        PK.persist_record_fetch_ref(t, idx, amat, strips, sf, si, rad, rec[s],
                                    SEED, s, DEPTH)
    return rec, rec_idx, amat


def _carry(lanes, seed=3, device="cpu"):
    """A random carry, radiance cotangent and zero deposits, from numpy."""
    g = np.random.default_rng(seed)
    cot = torch.from_numpy(g.normal(size=(9, lanes)).astype(np.float32))
    gs = torch.from_numpy(g.normal(size=(3 * S, lanes)).astype(np.float32))
    return (cot.to(device), torch.zeros((6 * S, lanes), device=device),
            gs.to(device))


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _events(rec):
    """Which of dead, live-miss, regeneration and strip-change slots the
    phase holds (each must occur)."""
    fl = rec[:, 10].view(torch.int32)
    act = (fl & PK.F_ACT) != 0
    strip = fl >> PK.F_STRIP_SHIFT
    return np.array([bool((~act).any()),
                     bool((act & ((fl & PK.F_HIT) == 0)).any()),
                     bool(((fl & PK.F_REGEN) != 0).any()),
                     bool((act[1:] & act[:-1]
                           & (strip[1:] != strip[:-1])).any())])


def _walk(fn, rec, u5_all=None):
    """``(dattr, cot, dep)`` of one replay walk ``fn`` over ``rec``."""
    cot, dep, gs = _carry(rec.shape[2])
    return fn(cot, dep, rec, gs, 0, SEED, u5_all), cot, dep


def _with_rows(rec, rec_idx, amat, lanes):
    """``rec`` with planes 11-20 replaced, on the (slot, lane) pairs of the
    mask ``lanes``, by each winner's row of ``amat``."""
    rows = fetch_attr_planes(rec_idx.reshape(-1), amat).reshape(
        10, rec.shape[0], -1).transpose(0, 1)
    out = rec.clone()
    out[:, 11:21] = torch.where(lanes[:, None], rows, rec[:, 11:21])
    return out


def _hit(rec):
    fl = rec[:, 10].view(torch.int32)
    return ((fl & PK.F_ACT) != 0) & ((fl & PK.F_HIT) != 0)


@pytest.mark.parametrize("recorder", ["k4", "k11"])
@pytest.mark.parametrize("name", sorted(pt.ALL_SCENES))
def test_hit_lane_planes_are_the_winner_rows(name, recorder):
    # On every hit lane of a phase recorded by K4 or by K11, planes 11-20
    # hold the winner's row of the table bit for bit, so K5's walk with
    # those planes fetched by index (the row variant of
    # scripts/torch_k5_k6_variants.py, measured slower) gives the same cot,
    # dep and dattr bits, with Philox and with injected draws; the CPU
    # wrapper runs the plain walk. The phase holds dead, miss, regeneration
    # and strip-change slots.
    rec, rec_idx, amat = _phase(name, recorder)
    assert _events(rec).all(), _events(rec)
    hit = _hit(rec)
    rows = _with_rows(rec, rec_idx, amat, hit)
    assert torch.equal(_bits(rows), _bits(rec))
    g = np.random.default_rng(9)
    u5 = torch.from_numpy(g.random((N_SLOTS, 5, rec.shape[2]),
                                   dtype=np.float32))
    for u in (None, u5):
        ref = _walk(PK.persist_replay_fused_ref, rec, u)
        assert _same(_walk(PK.persist_replay_fused_ref, rows, u), ref)
        assert _same(_walk(PK.persist_replay_fused, rec, u), ref)


@pytest.mark.parametrize("name", sorted(pt.ALL_SCENES))
def test_step_fetch_entry_is_fetch_plus_ref(name):
    # K6's plain entry (the gather of the slot's winners, then the
    # attribute-level slot) walked over a lean record, newest slot first,
    # equals fetch_attr_planes plus persist_replay_step_ref bit for bit
    # after every slot, and so does the replay of the full record's own
    # planes (a K4 record holds each winner's row there); the CPU wrapper
    # runs the entry.
    rec, rec_idx, amat = _phase(name, "k4")
    lean = rec[:, :PK.N_REC_LEAN].contiguous()
    runs = [_carry(rec.shape[2]) for _ in range(4)]
    for s in reversed(range(N_SLOTS)):
        outs = []
        for k, (cot, dep, gs) in enumerate(runs):
            if k == 0:
                d = PK.persist_replay_step_ref(
                    cot, dep, lean[s], gs, SEED, s, None,
                    fetch_attr_planes(rec_idx[s], amat))
            elif k == 1:
                d = PK.persist_replay_step_fetch_ref(
                    cot, dep, lean[s], rec_idx[s], amat, gs, SEED, s)
            elif k == 2:
                d = PK.persist_replay_step(cot, dep, lean[s], rec_idx[s],
                                           amat, gs, SEED, s)
            else:
                d = PK.persist_replay_step_ref(cot, dep, rec[s], gs, SEED, s)
            outs.append((d, cot, dep))
        assert all(_same(o, outs[0]) for o in outs[1:]), s


@pytest.mark.parametrize("name", sorted(pt.ALL_SCENES))
def test_miss_lane_replay_with_row0_or_zeros(name):
    # One reverse iteration of a miss lane with sphere 0's row (K4's
    # record) and with zeros (K11's) as the winner attributes: the same
    # carry and deposits bit for bit, the same attribute cotangent rows by
    # value, and rows 3-7 (radius, albedo, fuzz) bit for bit. Rows 0-2
    # (center) and 8 (ir) are zeros whose signs may follow the attributes
    # (test_miss_lane_zero_signs_follow_the_row).
    rec, _, amat = _phase(name, "k4")
    n_miss = 0
    for s in range(N_SLOTS):
        slot = rec[s]
        fl = PK.flags_of(slot)
        miss = ((fl & PK.F_ACT) != 0) & ((fl & PK.F_HIT) == 0)
        cot, dep, gs = _carry(slot.shape[1], seed=s)
        u5 = rng.philox_uniforms(SEED, s, slot.shape[1], 5)
        outs = [PK.replay_iter_core(u5, slot[0:10], a, fl, cot, gs, dep)
                for a in (amat[0][:, None].expand(10, slot.shape[1]),
                          torch.zeros((10, slot.shape[1])))]
        (c0, d0, p0), (c1, d1, p1) = ((x[..., miss] for x in o) for o in outs)
        assert torch.equal(_bits(c0), _bits(c1))
        assert torch.equal(_bits(p0), _bits(p1))
        assert torch.equal(d0, d1) and not d0.any()
        assert torch.equal(_bits(d0[3:8]), _bits(d1[3:8]))
        n_miss += int(miss.sum())
    assert n_miss > 0


def test_miss_lane_zero_signs_follow_the_row():
    # Why K5 reads a miss lane's attributes from the record: over the six
    # scenes, replaying a K11 phase (zero attributes on miss lanes) with
    # sphere 0's row there (the row fetched by the miss lane's index 0)
    # keeps cot and dep bit for bit and dattr by value, but changes the
    # sign of some zero dattr word.
    flipped = 0
    for name in sorted(pt.ALL_SCENES):
        rec, rec_idx, amat = _phase(name, "k11")
        live = (rec[:, 10].view(torch.int32) & PK.F_ACT) != 0
        ref = _walk(PK.persist_replay_fused_ref, rec)
        other = _walk(PK.persist_replay_fused_ref,
                      _with_rows(rec, rec_idx, amat, live))
        assert _same(other[1:], ref[1:])
        assert torch.equal(other[0], ref[0])
        flipped += int((_bits(other[0]) != _bits(ref[0])).sum())
    assert flipped > 0


@pytest.mark.parametrize("tc", [None, (6, 16)], ids=["plain", "tail_compact"])
def test_lean_and_full_replay_bitwise_through_fetch_entries(tc):
    # The default replay (K5 over the full record) and the lean one (K6's
    # entry slot by slot over the 11-plane record) give bitwise-equal
    # radiance and gradients on a scene of all three materials; the lean
    # walk gathers once per realized slot in its plain entry, the default
    # one never.
    def run(rec_attrs):
        scene = pt.trim_scene(pt.scene_random_spheres(seed=1))
        sc = pt.Scene(*(x.clone().requires_grad_(x.is_floating_point()
                                                 and k < 5)
                        for k, x in enumerate(scene)))
        cam = pt.t_cam1()
        u, v = pt.pixel_coords(48, 27)
        o, d = pt.get_rays(cam, u, v,
                           generator=torch.Generator().manual_seed(2))
        stats = {}
        r = PG.trace_recorded_persist(sc, o, d, 31, DEPTH, 1e-4, S,
                                      tail_compact=tc, rec_attrs=rec_attrs,
                                      stats=stats)
        before = materials.fetch_calls
        grads = torch.autograd.grad((r * r).sum(), list(sc[:5]))
        walked = sum(sum(c > 0 for c in stats[k][0]) for k in
                     ("phase1_counts", "phase2_counts") if k in stats)
        assert materials.fetch_calls - before == (0 if rec_attrs else walked)
        return (r, *grads)
    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)


def test_wrappers_reject_other_devices():
    # Tensors on neither the CPU nor a card raise; nothing falls back.
    rec, rec_idx, amat = _phase("2_spheres", "k4")
    cot, dep, gs = (x.to("meta") for x in _carry(rec.shape[2]))
    meta = [x.to("meta") for x in (rec, rec_idx, amat)]
    with pytest.raises(ValueError):
        PK.persist_replay_fused(cot, dep, meta[0], gs, 0, SEED)
    with pytest.raises(ValueError):
        PK.persist_replay_step(cot, dep, meta[0][0], meta[1][0], meta[2], gs,
                               SEED, 0)


def _within(pairs, rel):
    """Share of lanes on which every word is within ``rel * max(1, |b|)``."""
    ok = None
    for a, b in pairs:
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        o = ((a - b).abs() <= rel * b.abs().clamp(min=1)).all(0)
        ok = o if ok is None else ok & o
    return ok.float().mean().item()


@pytest.mark.cuda
@pytest.mark.parametrize("recorder", ["k4", "k11"])
def test_k5_matches_plain_on_card(cuda_device, recorder):
    # K5 on the card against its plain version over phases recorded by K4
    # and by K11: cot, dep and dattr within 1e-5 * max(1, |x|) on >= 99.9% of
    # lanes, with injected and with Philox draws; one launch per call; its
    # own Philox draws bitwise equal to injected philox_uniforms.
    rec, rec_idx, amat = _phase("random_spheres", recorder, cuda_device,
                                256, 128)
    lanes = rec.shape[2]
    u5 = torch.stack([rng.philox_uniforms(SEED, s, lanes, 5,
                                          device=cuda_device)
                      for s in range(N_SLOTS)])

    def run(fn, u):
        cot, dep, gs = _carry(lanes, device=cuda_device)
        return fn(cot, dep, rec, gs, 0, SEED, u), cot, dep

    n = PK.replay_fused_launches
    got = run(PK.persist_replay_fused, None)
    torch.cuda.synchronize()
    assert PK.replay_fused_launches == n + 1
    assert _within(zip(got, run(PK.persist_replay_fused_ref, None)),
                   1e-5) >= 0.999
    assert _same(got, run(PK.persist_replay_fused, u5))


@pytest.mark.cuda
def test_k6_matches_plain_on_card(cuda_device):
    # K6 on the card against its plain entry over every slot of a lean
    # record, newest first: cot, dep and dattr within 1e-5 * max(1, |x|) on
    # >= 99.9% of lanes; one launch per slot; K6's walk bitwise K5's.
    rec, rec_idx, amat = _phase("random_spheres", "k4", cuda_device, 256, 128)
    lanes = rec.shape[2]
    lean = rec[:, :PK.N_REC_LEAN].contiguous()

    def walk(fn):
        cot, dep, gs = _carry(lanes, device=cuda_device)
        dattr = torch.empty((N_SLOTS, 9, lanes), device=cuda_device)
        for s in reversed(range(N_SLOTS)):
            fn(cot, dep, lean[s], rec_idx[s], amat, gs, SEED, s, out=dattr[s])
        return dattr, cot, dep

    n = PK.replay_step_launches
    got = walk(PK.persist_replay_step)
    torch.cuda.synchronize()
    assert PK.replay_step_launches == n + N_SLOTS
    assert _within(zip(got, walk(PK.persist_replay_step_fetch_ref)),
                   1e-5) >= 0.999
    cot, dep, gs = _carry(lanes, device=cuda_device)
    k5 = PK.persist_replay_fused(cot, dep, rec, gs, 0, SEED)
    assert _same(got, (k5, cot, dep))


@pytest.mark.cuda
def test_lean_replay_launches_no_gather_on_card(cuda_device):
    # The lean route's backward on the card launches K6 once per realized
    # slot and no gather; its gradients are bitwise the default route's.
    def run(rec_attrs):
        scene = pt.trim_scene(pt.scene_random_spheres(seed=1,
                                                      device=cuda_device))
        sc = pt.Scene(*(x.clone().requires_grad_(x.is_floating_point()
                                                 and k < 5)
                        for k, x in enumerate(scene)))
        cam = pt.t_cam1(device=cuda_device)
        u, v = pt.pixel_coords(256, 144, device=cuda_device)
        o, d = pt.get_rays(cam, u, v, generator=torch.Generator(
            device=cuda_device).manual_seed(2))
        stats = {}
        r = PG.trace_recorded_persist(sc, o, d, 31, DEPTH, 1e-4, S,
                                      tail_compact=(6, 16),
                                      rec_attrs=rec_attrs, stats=stats)
        before = (materials.fetch_calls, PK.replay_step_launches)
        grads = torch.autograd.grad((r * r).sum(), list(sc[:5]))
        torch.cuda.synchronize()
        walked = sum(sum(c > 0 for c in stats[k][0])
                     for k in ("phase1_counts", "phase2_counts"))
        assert materials.fetch_calls == before[0]
        assert PK.replay_step_launches - before[1] == (
            0 if rec_attrs else walked)
        return (r, *grads)
    for a, b in zip(run(True), run(False)):
        assert torch.equal(a, b)
