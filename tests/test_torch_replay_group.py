"""K7c's schedule (``replay_bwd_fused``, csrc/replay_bwd.cu) through its
plain mirror ``replay_bwd_fused_group_ref``: at every group size G the
mirror is bit for bit the unchanged plain version ``replay_bwd_fused_ref``
on lanes of every depth 0-16, on lanes whose live slots are not a prefix,
past the 32-slot chunk, with injected and with Philox draws; it agrees with
the JAX package's fused replay kernel (interpret mode) as the plain version
does; the wrapper's rule for G. Card-only: the kernel at every G bit for
bit K7b's walk and its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.pallas import grad_kernel as JG
from raytracingweekend_jl_tpu_torch.ops import fused_grad as FG
from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
from test_torch_fused_grad import (SEED, _record, close_share, flat,
                                   jplanes)

LANES = 1024


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def enclosed_record(depth: int, lanes: int = LANES, device="cpu"):
    """A fixed-depth record [depth, 21, lanes] in which most paths live to
    the last bounce (the camera inside a diffuse sphere, with glass and
    fuzzed metal inside too; metal can absorb), recorded by the plain K3
    and K7a with Philox draws; then lane ``i``'s flags are cut after
    ``i % (depth + 1)`` live slots, and every fifth lane keeps a random, not
    prefix, subset of its live slots (numpy seed 5). Returns the record and
    the lanes' live counts."""
    scene = pt.trim_scene(pt.make_scene([
        pt.lambertian((0, 0, 0), 20.0, (0.9, 0.8, 0.7)),
        pt.dielectric((1.0, 0.2, -3.0), 0.8, 1.5),
        pt.metal((-1.2, -0.3, -3.5), 0.9, (0.8, 0.6, 0.2), 0.3),
        pt.lambertian((0.2, -1.0, -2.5), 0.6, (0.2, 0.5, 0.3))]),
        multiple=1).to(device)
    g = np.random.default_rng(5)
    d = torch.from_numpy(g.normal(size=(lanes, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    o = torch.zeros((lanes, 3))
    st = FG.start_state(o.to(device), d.to(device))
    spheres, amat = K.sphere_consts(scene), attr_mat(scene)
    rec = torch.empty((depth, GK.N_REC, lanes), device=device)
    for b in range(depth):
        t, idx = K.sweep_masked_ref(st[0:6], st[12].view(torch.int32),
                                    spheres)
        GK.record_shade_fetch_ref(t, idx, amat, st, rec[b], SEED, b)
    alive = rec[:, 10].view(torch.int32)
    assert float((alive[-1] != 0).float().mean()) > 0.5
    keep = torch.arange(depth)[:, None] < (torch.arange(lanes)
                                           % (depth + 1))[None, :]
    rand = torch.from_numpy(g.random((depth, lanes)) < 0.4)
    every5 = (torch.arange(lanes) % 5 == 4)[None, :]
    keep = torch.where(every5, rand, keep).to(device) & (alive != 0)
    alive.copy_(torch.where(keep, alive, torch.zeros_like(alive)))
    return rec, keep.sum(0)


@pytest.fixture(scope="module")
def walk16():
    rec, depth = enclosed_record(16)
    g = np.random.default_rng(6)
    g3 = torch.from_numpy(g.normal(size=(3, LANES)).astype(np.float32))
    cot = torch.from_numpy(g.normal(size=(9, LANES)).astype(np.float32))
    u5 = torch.from_numpy(g.random((16, 5, LANES), dtype=np.float32))
    return rec, depth, g3, cot, u5


@pytest.mark.parametrize("group", GK.REPLAY_GROUPS)
@pytest.mark.parametrize("draws", ["injected", "philox"])
def test_group_schedule_is_the_plain_walk(walk16, group, draws):
    # Tolerance: none. cot and every dattr row (zeros included: a dead
    # slot's rows are +0.0) bit for bit; lanes of every depth 0-16 and
    # lanes with non-prefix live slots are present.
    rec, depth, g3, cot0, u5 = walk16
    u5 = u5 if draws == "injected" else None
    assert set(range(17)) <= set(depth.tolist())
    cot_r, cot_m = cot0.clone(), cot0.clone()
    d_r = GK.replay_bwd_fused_ref(rec, g3, cot_r, SEED, u5)
    d_m = GK.replay_bwd_fused_group_ref(rec, g3, cot_m, SEED, u5, group)
    assert torch.equal(cot_m.view(torch.int32), cot_r.view(torch.int32))
    assert torch.equal(d_m.view(torch.int32), d_r.view(torch.int32))
    dead = (rec[:, 10].view(torch.int32) == 0)[:, None, :].expand_as(d_m)
    assert (d_m[dead].view(torch.int32) == 0).all()


@pytest.mark.parametrize("group", GK.REPLAY_GROUPS)
def test_group_schedule_past_one_chunk(group):
    # 40 slots: two chunks of flags (32 + 8); Philox draws. Tolerance: none.
    rec, depth = enclosed_record(40, lanes=256)
    assert int(depth.max()) == 40 and int(depth.min()) == 0
    g = np.random.default_rng(7)
    g3 = torch.from_numpy(g.normal(size=(3, 256)).astype(np.float32))
    cot0 = torch.from_numpy(g.normal(size=(9, 256)).astype(np.float32))
    cot_r, cot_m = cot0.clone(), cot0.clone()
    d_r = GK.replay_bwd_fused_ref(rec, g3, cot_r, SEED)
    d_m = GK.replay_bwd_fused_group_ref(rec, g3, cot_m, SEED, None, group)
    assert torch.equal(cot_m.view(torch.int32), cot_r.view(torch.int32))
    assert torch.equal(d_m.view(torch.int32), d_r.view(torch.int32))


def test_group_schedule_matches_jax():
    # The mirror (G = 2) on test_torch_fused_grad's 4-bounce record of
    # scene_4_spheres, injected uniforms, the carry starting at zero,
    # against the JAX fused replay kernel in interpret mode: within
    # 1e-5 * max(1, |x|) on >= 99.9% of lanes (the plain version's bound).
    rec, u5_all = _record("4_spheres")
    n = rec.shape[2]
    g3 = torch.from_numpy(np.random.default_rng(4).normal(
        size=(3, n)).astype(np.float32))
    cot = torch.zeros((9, n))
    d = GK.replay_bwd_fused_group_ref(rec, g3, cot, SEED, u5_all, 2)
    cot_j, d_j = JG.replay_bwd_fused(
        jplanes(rec, 10), jplanes(g3), SEED, interpret=True,
        u5_all=jnp.asarray(u5_all.numpy().reshape(4, 5, -1, 128)))
    d_j = np.stack([np.asarray(p).reshape(4, -1) for p in d_j], axis=1)
    for a, b in ((cot, flat(cot_j)), (d, d_j)):
        share, err = close_share(a.numpy(), b, 1e-5)
        assert share >= 0.999, (share, err)


def test_replay_group_rule():
    # G = 2 while its threads fit one wave of the card, else the
    # one-thread walk; H100 residency at 80 and 96 registers.
    resident = {1: 6 * 128 * 132, 2: 5 * 128 * 132}
    assert GK.replay_group(8192, resident) == 2
    assert GK.replay_group(22400, resident) == 2
    assert GK.replay_group(42240, resident) == 2
    assert GK.replay_group(42241, resident) == 1
    assert GK.replay_group(131071, resident) == 1
    for bad in (0, 3, 4):
        with pytest.raises(ValueError):
            GK.replay_bwd_fused_group_ref(*_small(), group=bad)


def _small():
    rec, _ = enclosed_record(2, lanes=8)
    return rec, torch.zeros((3, 8)), torch.zeros((9, 8)), SEED


@pytest.mark.cuda
@pytest.mark.parametrize("depth,lanes", [(16, 22400), (40, 4096)])
def test_k7c_kernel_is_the_k7b_walk_on_card(cuda_device, depth, lanes):
    # K7c at every G (and the wrapper's), injected and Philox draws, on the
    # enclosed record (16 slots at the fit's 22 400 lanes; 40 slots, two
    # chunks of flags, at 4 096): cot and every dattr row bit for bit K7b's
    # walk (one launch per slot, the carry in device memory) and the plain
    # version; one launch counted per call.
    dev = cuda_device
    rec, _ = enclosed_record(depth, lanes=lanes, device=dev)
    g = torch.Generator(device=dev).manual_seed(2)
    g3 = torch.rand((3, lanes), generator=g, device=dev) * 2 - 1
    for u5 in (torch.rand((depth, 5, lanes), generator=g, device=dev),
               None):
        cot0 = torch.randn((9, lanes), generator=g, device=dev)
        cb, db = cot0.clone(), torch.empty((depth, 9, lanes), device=dev)
        for b in reversed(range(depth)):
            GK.replay_bwd_step(rec[b], g3, cb, SEED, b,
                               None if u5 is None else u5[b], out=db[b])
        cp = cot0.clone()
        dp = GK.replay_bwd_fused_ref(rec, g3, cp, SEED, u5)
        for group in (None,) + GK.REPLAY_GROUPS:
            ck = cot0.clone()
            n = GK.replay_fused_launches
            dk = GK.replay_bwd_fused(rec, g3, ck, SEED, u5, group=group)
            torch.cuda.synchronize()
            assert GK.replay_fused_launches == n + 1
            for a, b in ((ck, cb), (dk, db), (ck, cp), (dk, dp)):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
