"""The strided loop's chunked schedule on the CPU (``ops/integrator.py``
``_chunked_strided_sums``): the same plan, chunks and schedule that the card
replays as one CUDA graph a chunk, run here as they stand on the plain
sweep and step, bit for bit the eager loop's sums; the schedule's order of
queueing and reading, the plan key and the plan cache's eviction."""

import sys
import threading
from collections import OrderedDict

import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch.camera import default_camera
from raytracingweekend_jl_tpu_torch.ops import integrator as I
from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as S

from test_torch_scene_camera import _one_torch_thread  # noqa: F401

TMIN = 1e-4

#: A camera straight up from the 4-sphere scene's centre: every ray misses,
#: so each sample ends after one pass.
SKY_CAM = dict(lookfrom=(0.0, 0.0, 0.0), lookat=(0.0, 1.0, 0.0),
               vup=(0.0, 0.0, -1.0), vfov=20.0)

# (W, H, n_pix, pixel_start, k, sample_groups, spp, max_depth, camera)
CASES = {
    "strips_k3": (24, 16, 24 * 16, 0, 3, 1, 2, 4, "default"),
    "sample_groups_4": (16, 9, 16 * 9, 0, 1, 4, 8, 4, "default"),
    "tile_pixel_start": (24, 16, 100, 150, 2, 1, 2, 3, "default"),
    "tile_groups_last": (24, 16, 84, 300, 1, 2, 4, 3, "default"),
    "depth_1_limit_13": (20, 12, 20 * 12, 0, 3, 1, 4, 1, "default"),
    "all_end_before_check": (20, 12, 20 * 12, 0, 2, 1, 2, 4, "sky"),
}


def _camera(name):
    if name == "sky":
        return default_camera(**SKY_CAM)
    return pt.t_default_cam()


def _setup(case, seed, offset, scene):
    W, H, n_pix, start, k, m, spp, depth, cam = CASES[case]
    return I.strided_setup(scene, _camera(cam), n_pix, seed, spp, offset,
                           depth, W, H, k, start, m, None, None)


def _eager(case, seed, offset, scene):
    st, cc, tables, seed32 = _setup(case, seed, offset, scene)
    passes = I._eager_strided_loop(tables, st, cc, seed32, offset,
                                   CASES[case][7], TMIN, "plain")
    return I.strided_result(st), passes, st.iter_limit


def _chunked(case, seed, offset, scene):
    st, cc, tables, seed32 = _setup(case, seed, offset, scene)
    return I._chunked_strided_sums(tables, st, cc, seed32, offset,
                                   CASES[case][7], TMIN)


@pytest.fixture
def fresh_plans():
    I._STRIDED_PLANS.clear()
    yield I._STRIDED_PLANS
    I._STRIDED_PLANS.clear()


@pytest.mark.parametrize("case", sorted(CASES))
def test_chunked_loop_bitwise_eager(case, fresh_plans):
    # Two calls of different seeds and first samples through one plan: each
    # sum is the eager loop's, bit for bit (no call's scalars are kept in
    # the plan), whether the chunks overrun iter_limit or the lanes' end.
    scene = pt.scene_4_spheres()
    for seed, offset in ((5, 0), (2**31 + 11, 6)):
        want, passes, limit = _eager(case, seed, offset, scene)
        got = _chunked(case, seed, offset, scene)
        assert torch.equal(got, want), case
        assert float(want.abs().sum()) > 0
    assert len(fresh_plans) == 1
    if case == "depth_1_limit_13":
        assert limit == 13 and passes == 13
    if case == "all_end_before_check":
        assert passes == 9 and limit > 2 * I.ACTIVE_CHECK_EVERY


def test_plans_shared_by_threads(fresh_plans, monkeypatch):
    # Threads render two shapes through a cache that keeps one plan: a plan
    # serves one call at a time and is dropped only once its last call is
    # done, so every sum is the eager loop's.
    monkeypatch.setattr(I, "STRIDED_PLANS_KEPT", 1)
    scene = pt.scene_4_spheres()
    cases = ("strips_k3", "sample_groups_4")
    want = {(c, s): _eager(c, s, 0, scene)[0] for c in cases for s in (1, 2)}
    results, errors = {}, []

    def work(i):
        try:
            for r in range(2):
                key = (cases[(i + r) % 2], 1 + i % 2)
                results[i, r] = torch.equal(_chunked(*key, 0, scene),
                                            want[key])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(results) == 12 and all(results.values()), results


def test_chunk_pass_past_limit_changes_nothing():
    # A pass at or past iter_limit leaves the state as it is; one before it
    # runs the step with the block's scalars.
    st, cc, tables, seed32 = _setup("strips_k3", 3, 0, pt.scene_4_spheres())
    t, idx = I.sweep_hits(tables, st.fstate[0:6], TMIN, "plain")
    params = torch.tensor([seed32 - 2**32 if seed32 >= 2**31 else seed32, 0,
                           st.geom[4], 16, 20], dtype=torch.int32)
    for j, moves in ((3, True), (4, False), (7, False)):
        x = [v.clone() for v in (st.fstate, st.istate, st.buf)]
        S.shade_strided_pass(*x, t, idx, tables[2], cc, st.geom, params, j,
                             4)
        ref = [v.clone() for v in (st.fstate, st.istate, st.buf)]
        if moves:
            S.shade_strided_fetch_ref(*ref, t, idx, tables[2], cc, st.geom,
                                      seed32, 16 + j, 0, 4)
        assert all(torch.equal(a, b) for a, b in zip(x, ref)), j


def test_chunk_end_flags_and_advance():
    istate = torch.zeros((7, 5), dtype=torch.int32)
    params = torch.tensor([0, 0, 0, 16, 40], dtype=torch.int32)
    flags = torch.zeros(2, dtype=torch.int32)
    host = torch.zeros(2, dtype=torch.int32)
    S.strided_chunk_end(istate, params, flags, host, 8)  # chunk 2, idle
    assert flags.tolist() == [0, 0] and int(params[3]) == 24
    istate[5, 3] = 1
    S.strided_chunk_end(istate, params, flags, host, 8)  # chunk 3, active
    assert flags.tolist() == [0, 4] and host.tolist() == [0, 4]
    assert int(params[3]) == 32


@pytest.mark.parametrize("n_chunks,flags,queued", [
    (1, [True], 1),
    (5, [True] * 5, 5),
    (5, [True, False, False, False, False], 3),
    (6, [False] * 6, 2),
])
def test_run_chunks_order(n_chunks, flags, queued):
    # Chunk c + 1 is queued before chunk c's flag is read; the schedule stops
    # at the first flag that says no lane is active, or once every chunk is
    # queued.
    log = []
    got = I.run_chunks(n_chunks, lambda c: log.append(("queue", c)),
                       lambda c: log.append(("read", c)) or flags[c])
    assert got == queued
    want = [("queue", 0)]
    for c in range(1, queued):
        want += [("queue", c), ("read", c - 1)]
    assert log == want


def test_plan_key_holds_the_shape_not_the_call():
    scene = pt.scene_4_spheres()
    key = lambda st, **kw: I.strided_plan_key(  # noqa: E731
        st, 4, kw.get("depth", 16), kw.get("tmin", TMIN), kw.get("sid", 0),
        kw.get("lib"))
    a = I.strided_setup(scene, pt.t_default_cam(), 100, 1, 4, 0, 16, 24, 16,
                        1, 0, 2, None, None)[0]
    b = I.strided_setup(scene, pt.t_default_cam(), 100, 9, 4, 8, 16, 24, 16,
                        1, 200, 2, None, None)[0]
    c = I.strided_setup(scene, pt.t_default_cam(), 84, 1, 4, 0, 16, 24, 16,
                        1, 300, 2, None, None)[0]
    assert a.geom[4] != b.geom[4]  # p_end is the call's
    assert key(a) == key(b)  # tiles of one shape share a plan
    assert key(c) != key(a)  # the ragged last tile gets its own
    assert key(a, depth=8) != key(a)
    assert key(a, tmin=1e-3) != key(a)
    assert key(a, sid=3) != key(a)
    assert key(a, lib="rebuilt.so") != key(a)


def test_plan_cache_drops_least_recently_used():
    cache = OrderedDict()
    made = []

    def get(key):
        return I.lru_get(cache, key, lambda: made.append(key) or key, 3)

    assert get("a") == ("a", []) and get("b") == ("b", [])
    assert get("c") == ("c", [])
    assert get("a") == ("a", [])  # a hit: a is now the most recent
    assert get("d") == ("d", ["b"])
    assert list(cache) == ["c", "a", "d"] and made == ["a", "b", "c", "d"]
    assert get("e") == ("e", ["c"])
    assert list(cache) == ["a", "d", "e"]
