"""K8's lane work queue and its winner by index, through their plain
versions: the mirror of the kernel's schedule (``trace_inline_queue_ref``:
warps of 32 slots refilled from one counter, a bounce counter per lane)
against ``trace_inline_ref`` and the JAX package's kernel (interpret mode);
the index sweep against the running select; the live-share statistic
against hand counts; card-only checks of the kernel at the route's largest
table and of its occupancy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.pallas import inline_kernel as JI
from raytracingweekend_jl_tpu.scene import trim_scene as jtrim
from raytracingweekend_jl_tpu_torch.ops.cuda import inline_kernel as K8
from test_torch_inline import CASES, _rays
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


DEPTH = 16
#: (warps, refill threshold) schedules of the mirror: one warp, a few warps
#: refilled when any lane is idle or when half the warp is, and more slots
#: than lanes (every lane fetched in the first round).
SCHEDULES = [(1, 1), (3, 1), (3, 16), (40, 1)]


def _case(name, W=32, H=18):
    scene_j, cam_j = CASES[name][0]()
    scene_j = jtrim(scene_j)
    o, d = _rays(cam_j, W, H)
    return scene_j, pt.scene_from_numpy(scene_j), torch.from_numpy(o), \
        torch.from_numpy(d)


def _u5(draws, n):
    if draws == "philox":
        return None
    return torch.from_numpy(np.random.default_rng(2).random(
        (DEPTH, 5, n), dtype=np.float32))


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("draws", ["philox", "injected"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_queue_mirror_is_trace_inline_ref(name, draws):
    # Whatever the schedule, every lane's radiance is the one-thread loop's
    # bit for bit: a lane's draws are keyed by its own (lane, bounce), and
    # a refilled slot starts the next lane from its camera ray.
    _, scene, o, d = _case(name)
    u5 = _u5(draws, o.shape[0])
    ref = K8.trace_inline_ref(scene, o, d, 9, DEPTH, 1e-4, u5)
    for n_warps, refill in SCHEDULES:
        got = K8.trace_inline_queue_ref(scene, o, d, 9, DEPTH, 1e-4, u5,
                                        n_warps=n_warps, refill=refill)
        assert torch.equal(_bits(got), _bits(ref)), (n_warps, refill)


@pytest.mark.parametrize("name", sorted(CASES))
def test_queue_mirror_matches_jax(name):
    # The mirror against the JAX kernel in interpret mode on the same camera
    # rays and injected uniforms, by test_trace_inline_ref_matches_jax's
    # rule: sky-only and the mirror scene within 1e-6 on every lane, the
    # others within 1e-5 * max(1, |x|) on >= 99% of lanes.
    scene_j, scene, o, d = _case(name)
    u5 = _u5("injected", o.shape[0])
    ref = np.asarray(JI.trace_inline(scene_j, jnp.asarray(o.numpy()),
                                     jnp.asarray(d.numpy()), 0, DEPTH, 1e-4,
                                     interpret=True,
                                     rng_u5=jnp.asarray(u5.numpy())))
    out = K8.trace_inline_queue_ref(scene, o, d, 0, DEPTH, 1e-4, u5,
                                    n_warps=3).numpy()
    share = CASES[name][2]
    if share == 1.0:
        np.testing.assert_allclose(out, ref, atol=1e-6, rtol=0)
    else:
        ok = (np.abs(out - ref) <= 1e-5 * np.maximum(1, np.abs(ref))).all(1)
        assert ok.mean() >= share, ok.mean()


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_queue_mirror_depth_budget(depth):
    # A path alive after the last bounce reads black, and depth 0 reads
    # black everywhere, in the mirror as in the one-thread loop.
    _, scene, o, d = _case("diel_spheres_hollow", 16, 9)
    ref = K8.trace_inline_ref(scene, o, d, 4, depth)
    got = K8.trace_inline_queue_ref(scene, o, d, 4, depth, n_warps=2)
    assert torch.equal(_bits(got), _bits(ref))
    if depth == 0:
        assert not got.any()


def _scattered(scene, o, d):
    """The camera rays and the rays of their first scatter (hits only)."""
    planes = K8.sphere_planes(scene)
    state = K8._start(o, d)
    bt, attrs = K8.sweep_select_ref(planes, *state[0:6], 1e-4)
    u5 = torch.from_numpy(np.random.default_rng(6).random(
        (5, o.shape[0]), dtype=np.float32))
    alive = torch.ones(o.shape[0], dtype=torch.bool)
    nxt, hitm = K8._bounce(u5, bt, attrs, state, alive)
    return [torch.cat([a, b[hitm]]) for a, b in zip(state[0:6], nxt[0:6])]


@pytest.mark.parametrize("name", sorted(CASES))
def test_index_select_is_running_select(name):
    # The kernel's sweep keeps the winner's index and reads its attributes
    # after the loop: the same distance and attributes as the running
    # select, bit for bit, and zeros on a miss, as the running select
    # leaves them.
    _, scene, o, d = _case(name)
    planes = K8.sphere_planes(scene)
    rays = _scattered(scene, o, d)
    bt, attrs = K8.sweep_select_ref(planes, *rays, 1e-4)
    bt_i, idx = K8.sweep_index_ref(planes, *rays, 1e-4)
    by_idx = K8.attrs_by_index(planes, idx)
    assert torch.equal(_bits(bt_i), _bits(bt))
    assert torch.equal(_bits(by_idx), _bits(attrs))
    miss = idx < 0
    assert torch.equal(miss, bt >= K8.BIG)
    assert not by_idx[:, miss].any()
    assert bool(miss.all()) == (name == "sky_only")


def test_warp_live_share_hand_count():
    # Lanes of a warp issue as many bounces as the warp's longest lane.
    # Warps of 4: (3, 1, 0, 2) issues 4 * 3 = 12 slots for 6 bounces;
    # (1, 1, 1, 1) 4 for 4; the last warp (5) is padded with idle lanes,
    # 4 * 5 = 20 slots for 5. In all 15 of 36.
    b = torch.tensor([3, 1, 0, 2, 1, 1, 1, 1, 5])
    got = K8.warp_live_share(b, warp=4)
    assert got == {"lane_bounces": 15, "issued_slots": 36,
                   "live_share": 15 / 36}


def test_queue_stats_hand_count():
    # 40 sky-only lanes, one bounce each. One warp: round 1 takes lanes
    # 0-31, round 2 lanes 32-39 (the queue is then empty), round 3 finds
    # nothing: 2 rounds, 2 refills, 64 issued slots for 40 live ones. The
    # one-thread loop issues 2 warps x 32 slots for the same 40.
    _, scene, o, d = _case("sky_only", 8, 5)
    st_loop, st_q = {}, {}
    K8.trace_inline_ref(scene, o, d, 1, DEPTH, stats=st_loop)
    K8.trace_inline_queue_ref(scene, o, d, 1, DEPTH, n_warps=1, stats=st_q)
    assert st_q == {"lane_bounces": 40, "issued_slots": 64, "rounds": 2,
                    "refills": 2, "live_share": 40 / 64}
    assert K8.warp_live_share(st_loop["bounces"]) == {
        "lane_bounces": 40, "issued_slots": 64, "live_share": 40 / 64}
    assert st_loop["live"] == [40] + [0] * (DEPTH - 1)


def test_queue_lifts_the_live_share():
    # On the 4-sphere scene (64x36 rays, 2 304 lanes) the one-thread loop's
    # warps issue three slots for each bounce a lane runs (measured: 32.3%
    # live); the queue over two warps, 36 lanes a slot, issues few more
    # than run (90.8%). With fewer lanes a slot the last lanes' paths
    # weigh more (32x18 rays: 80.9% over one warp, 57.5% over four).
    _, scene, o, d = _case("4_spheres", 64, 36)
    st_loop, st_q = {}, {}
    K8.trace_inline_ref(scene, o, d, 1, DEPTH, stats=st_loop)
    K8.trace_inline_queue_ref(scene, o, d, 1, DEPTH, n_warps=2, stats=st_q)
    loop = K8.warp_live_share(st_loop["bounces"])
    assert loop["lane_bounces"] == st_q["lane_bounces"] \
        == sum(st_loop["live"])
    assert loop["live_share"] < 0.35 < 0.9 < st_q["live_share"]


@pytest.mark.cuda
def test_queue_kernel_at_64_spheres_on_card(cuda_device):
    # The route takes tables of up to 64 spheres (render.inline_route_for):
    # K8 against its plain version at 64 spheres, with injected and Philox
    # draws, bit for bit on every lane; the launch fills only the resident
    # blocks.
    scene = pt.scene_random_spheres(seed=1, device=cuda_device)
    scene = pt.trim_scene(scene._replace(**{
        f: getattr(scene, f)[:64] for f in scene._fields}))
    assert scene.n_spheres == 64
    cam = pt.t_cam1(device=cuda_device)
    u, v = pt.pixel_coords(96, 54, device=cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    o, d = pt.get_rays(cam, u, v, generator=g)
    for u5 in (torch.rand((DEPTH, 5, o.shape[0]), generator=g,
                          device=cuda_device), None):
        a = K8.trace_inline(scene, o, d, 5, DEPTH, 1e-4, u5)
        b = K8.trace_inline_ref(scene, o, d, 5, DEPTH, 1e-4, u5)
        assert torch.equal(_bits(a), _bits(b))
    occ = K8.occupancy(64, cuda_device)
    assert occ["blocks_per_sm"] > 0 and occ["sms"] > 0
