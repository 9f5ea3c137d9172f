"""Motion blur on the strided route (book 2's bouncing spheres): the moving
sweep K1m's and the moving step K2m's plain versions against the plain
reference of moving scenes (``portbench/reference/motion.py``) and against
a hand-traced path, the strided render of a moving film against the
reference's image, the plan cache across static and moving calls, the
routes that have no time, and the preset scene. A card-only test holds
K1m and K2m bit for bit to their plain versions, and the static K1 and K2
to theirs around moving calls.

No JAX here: the reference is plain PyTorch, and the card test runs on a
machine where this file imports only the port and the benchmark."""

import math
import os
import sys

import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch.camera import default_camera
from raytracingweekend_jl_tpu_torch.ops import integrator as I
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as S
from raytracingweekend_jl_tpu_torch.ops.materials import (attr_mat,
                                                          motion_attr_mat)
from raytracingweekend_jl_tpu_torch.render import (inline_route_for,
                                                   render_tile_sum)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.harness import stats  # noqa: E402
from portbench.reference import motion as ref  # noqa: E402
from portbench.reference.camera import camera_arrays, camera_tensors  # noqa: E402
from portbench.reference.scene import scene_arrays  # noqa: E402

TMIN = 1e-4
CELL_LIMITS = os.path.join(ROOT, "portbench", "limits",
                           "book2_motion.render_400px.json")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread while a test runs (several test workers would
    otherwise oversubscribe the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _moving(scene: pt.Scene, motion) -> pt.MovingScene:
    """``scene`` with the first spheres' ``motion`` (a list of triples), the
    others still."""
    m = torch.zeros_like(scene.center)
    for i, v in enumerate(motion):
        m[i] = torch.tensor(v, dtype=m.dtype)
    return pt.MovingScene(*scene, motion=m)


def _ref_scene(scene: pt.MovingScene) -> dict:
    return dict(scene._asdict())


def test_bouncing_spheres_is_the_lattice_with_motion():
    # The lattice is scene_random_spheres(1) bit for bit; only diffuse grid
    # spheres move, straight up by [0, 0.5); the benchmark's scene module
    # builds the same arrays.
    a = pt.trim_scene(pt.scene_random_spheres(seed=1))
    b = pt.trim_scene(pt.scene_bouncing_spheres(seed=1))
    assert isinstance(b, pt.MovingScene) and pt.scene_moves(b)
    assert not pt.scene_moves(a)
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    m = b.motion
    moving = (m != 0).any(1)
    assert int(moving.sum()) == 386
    assert bool((b.mat[moving] == pt.LAMBERTIAN).all())
    assert bool((b.radius[moving] == np.float32(0.2)).all())
    assert not bool(moving[0]) and not bool(moving[483:].any())
    assert bool((m[:, 0] == 0).all() and (m[:, 2] == 0).all())
    assert bool((m[:, 1] >= 0).all() and (m[:, 1] < 0.5).all())
    spec = {"module": "bouncing_spheres", "args": {"seed": 1}}
    mine = ref.motion_array(spec)
    assert mine.shape == (486, 3)
    assert torch.equal(torch.from_numpy(mine.astype(np.float32)), m[:486])
    arrays = scene_arrays(spec)
    for f in ("center", "radius"):
        assert torch.equal(torch.from_numpy(arrays[f].astype(np.float32)),
                           getattr(b, f)[:486]), f


def test_moving_scene_keeps_its_motion_through_trim_to_and_files(tmp_path):
    s = pt.scene_bouncing_spheres()
    t = pt.trim_scene(s.to("cpu"))
    assert isinstance(t, pt.MovingScene) and t.n_spheres == 488
    assert torch.equal(t.motion, s.motion[:488])
    pt.save_scene(t, str(tmp_path / "m.npz"))
    back = pt.load_scene(str(tmp_path / "m.npz"))
    assert isinstance(back, pt.MovingScene)
    assert all(torch.equal(x, y) for x, y in zip(back, t))
    g = pt.scene_from_numpy({f: getattr(t, f).numpy() for f in t._fields},
                            requires_grad=True)
    assert isinstance(g, pt.MovingScene) and g.center.requires_grad
    assert not g.motion.requires_grad


def test_moving_sphere_count_is_taken_on_the_host():
    # The count of moving spheres (the render's rtw.render.moving_spheres
    # counter) is taken where the motion is made and carried through trim
    # and to(), so a call reads nothing back from the device; a scene made
    # from device tensors is counted once, then kept.
    from raytracingweekend_jl_tpu_torch.scene import moving_spheres
    s = pt.scene_bouncing_spheres()
    assert s.motion.moving_spheres == 386
    t = pt.trim_scene(s.to("cpu"))
    assert t.motion is not s.motion and t.motion.moving_spheres == 386
    arrays = {f: getattr(t, f).numpy() for f in t._fields}
    assert pt.scene_from_numpy(arrays).motion.moving_spheres == 386
    d = _moving(pt.scene_4_spheres(), [(0.0, 0.5, 0.0), (0.0, 0.0, 0.0),
                                       (0.1, 0.0, 0.0)])
    assert getattr(d.motion, "moving_spheres", None) is None
    assert moving_spheres(d) == 2 and d.motion.moving_spheres == 2
    assert moving_spheres(t) == 386


def _late_scene() -> pt.MovingScene:
    """Three spheres of a lattice, two still, and one that rises from below
    a ray's path into it over the shutter (centre y from -1.4 to 0)."""
    scene = pt.make_scene([
        pt.lambertian((0.0, 0.0, -5.0), 0.5, (0.5, 0.5, 0.5)),
        pt.metal((2.0, 0.0, -5.0), 0.5, (0.7, 0.6, 0.5), 0.1),
        pt.lambertian((-2.0, -1.4, -5.0), 0.5, (0.2, 0.3, 0.4)),
    ], pad_to=8)
    return _moving(scene, [(0.0, 0.0, 0.0), (0.0, 0.3, 0.0),
                           (0.0, 1.4, 0.0)])


def test_moving_sweep_matches_the_reference_closest_hit():
    # K1m's plain version against the reference's closest hit at times 0,
    # 0.5 and 0.999: the same winner, t within 1e-5. A ray at the rising
    # sphere's path hits it only late in the shutter; rays at the lattice
    # of the preset scene hit what the reference hits.
    scene = _late_scene()
    table = K.motion_sphere_table(scene)
    o = torch.zeros((3, 3))
    d = torch.tensor([[0.0, 0.0, -1.0], [2.0, 0.0, -5.0], [-2.0, 0.0, -5.0]])
    d = d / d.norm(dim=1, keepdim=True)
    for time, late_hit in ((0.0, False), (0.5, False), (0.999, True)):
        times = torch.full((3,), time)
        t, idx = K.sweep_motion_ref(torch.cat([o, d], 1).T.contiguous(),
                                    times, table, TMIN)
        rt, ridx = ref.closest_hit(_ref_scene(scene), o, d, times, TMIN)
        assert torch.equal(idx.long(), ridx), time
        assert torch.allclose(t, rt, atol=1e-5, rtol=0), time
        assert int(idx[0]) == 0 and int(idx[1]) == 1
        assert bool(t[2] < K.BIG) is late_hit, (time, float(t[2]))
        if late_hit:
            assert int(idx[2]) == 2
    lattice = pt.trim_scene(pt.scene_bouncing_spheres())
    g = torch.Generator().manual_seed(3)
    n = 512
    o = torch.tensor([13.0, 2.0, 3.0]) + 0.05 * torch.randn((n, 3),
                                                            generator=g)
    aim = torch.rand((n, 3), generator=g) * torch.tensor([8.0, 1.0, 8.0]) \
        - torch.tensor([4.0, 0.0, 4.0])
    d = aim - o
    d = d / d.norm(dim=1, keepdim=True)
    for time in (0.0, 0.5, 0.999):
        times = torch.full((n,), time)
        t, idx = K.sweep_motion_ref(torch.cat([o, d], 1).T.contiguous(),
                                    times, K.motion_sphere_table(lattice),
                                    TMIN)
        rt, ridx = ref.closest_hit(_ref_scene(lattice), o, d, times, TMIN)
        hit = t < K.BIG
        assert int(hit.sum()) > n // 2
        assert torch.equal(hit, rt < K.BIG)
        assert torch.equal(idx.long()[hit], ridx[hit])
        assert torch.allclose(t[hit], rt[hit], atol=1e-5, rtol=0)


def test_moving_sweep_with_no_motion_is_the_static_sweep():
    # K1m's plain version on a table whose motions are zero gives K1's
    # (t, idx) bit for bit at any time.
    static = pt.trim_scene(pt.scene_random_spheres())
    still = _moving(static, [])
    g = torch.Generator().manual_seed(5)
    o = torch.tensor([13.0, 2.0, 3.0]) + torch.randn((256, 3), generator=g)
    d = -o + torch.randn((256, 3), generator=g)
    d = d / d.norm(dim=1, keepdim=True)
    rays = torch.cat([o, d], 1).T.contiguous()
    want = K.sweep_ref(rays, K.sphere_consts(static), TMIN)
    got = K.sweep_motion_ref(rays, torch.rand(256, generator=g),
                             K.motion_sphere_table(still), TMIN)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_time_is_drawn_once_a_camera_ray_and_inherited():
    # A hand-traced path through K2m's plain version with injected draws:
    # the lane's ray at time 0.25 hits the rising sphere (centre (0, 0, -3)
    # at that time, (0, -1, -3) at time 0, where the ray misses it) at t =
    # 2.5 with the normal (0, 0, 1) at the moved centre, scatters up, hits
    # the still sphere above, scatters and leaves to the sky; the time
    # stays 0.25 through both bounces, and the camera ray of the next
    # sample takes the 10th uniform as its time.
    scene = _moving(pt.make_scene([
        pt.lambertian((0.0, -1.0, -3.0), 0.5, (0.5, 0.5, 0.5)),
        pt.lambertian((0.0, 5.0, 2.5), 2.0, (0.8, 0.8, 0.8)),
    ], pad_to=8), [(0.0, 4.0, 0.0)])
    cam = default_camera()
    st = I.init_strided_state(cam, 1, 1, 1, 0, 2, 0, 50, 1,
                              init_u4=torch.zeros((1, 4)),
                              shutter=True, init_time=torch.tensor([0.25]))
    st.fstate[0:6, 0] = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, -1.0])
    cc = S.pack_camera_consts(cam, 1, 1)
    tables = (scene, K.motion_sphere_table(scene), motion_attr_mat(scene))

    def draws(time):
        # u0 = 0.5, u1 = 0.25, u3 = 0.25: the unit vector (0, 1, ~0); the
        # coin, jitter and lens uniforms; the 10th, the time of a new ray.
        return torch.tensor([[0.5], [0.25], [0.5], [0.25], [0.5], [0.5],
                             [0.5], [0.5], [0.5], [time]])

    t, idx = I.sweep_hits(tables, st.fstate[0:6], TMIN, "plain",
                          I.shutter_plane(st))
    assert float(t[0]) == 2.5 and int(idx[0]) == 0
    I.strided_step(tables, st, cc, 9, 0, 0, 50, TMIN, "plain", draws(0.9))
    p = st.fstate[0:3, 0]
    assert torch.equal(p, torch.tensor([0.0, 0.0, -2.5]))
    n = torch.tensor([0.0, 0.0, 1.0])
    u = torch.tensor(S.gauss3(*(torch.tensor(x) for x in
                                (0.5, 0.25, 0.5, 0.25))))
    u = u / u.norm()
    want = (n + u) / (n + u).norm()
    assert torch.allclose(st.fstate[3:6, 0], want, atol=1e-6)
    assert float(st.fstate[12, 0]) == 0.25 and int(st.istate[0, 0]) == 1
    I.strided_step(tables, st, cc, 9, 1, 0, 50, TMIN, "plain", draws(0.8))
    assert int(st.istate[0, 0]) == 2 and float(st.fstate[12, 0]) == 0.25
    on_b = st.fstate[0:3, 0] - torch.tensor([0.0, 5.0, 2.5])
    assert abs(float(on_b.norm()) - 2.0) < 1e-4   # on the still sphere
    for it in range(2, 6):
        I.strided_step(tables, st, cc, 9, it, 0, 50, TMIN, "plain",
                       draws(0.6 + 0.01 * it))
        if int(st.istate[1, 0]) == 1:   # the second sample's camera ray
            assert float(st.fstate[12, 0]) == np.float32(0.6 + 0.01 * it)
            break
        assert float(st.fstate[12, 0]) == 0.25
    else:
        pytest.fail("the path never left to the sky")
    assert float(st.fstate[9:12, 0].sum()) > 0   # the sky, banked


#: A camera close to a small moving lattice (4 x 4 grid cells): each sphere
#: spans pixels of a 48x27 film, and its rise of up to 0.5 several rows.
NEAR = {"lookfrom": [4.0, 1.2, 1.0], "lookat": [0.0, 0.2, 0.0],
        "vup": [0.0, 1.0, 0.0], "vfov": 30.0, "aspect_ratio": 16.0 / 9.0,
        "aperture": 0.0, "focus_dist": 4.0}


def _block_z(scene, cam, spp, ref_stats, W=48, H=27, blocks=(4, 9)):
    """The cell's check, per block of 12 x 3 pixels and channel: one call
    of ``spp`` samples of a ``W x H`` film (its variance then the
    reference's alone) against the reference's image."""
    out = render_tile_sum(scene, cam, W * H, 11, spp, 0, 50, TMIN, float(W),
                          float(H), persistent=True, inline=False)
    z = stats.image_z(out, out * out, 1, spp, 1, ref_stats, W, H, blocks)
    return {"block_z_max": float(z.abs().max()),
            "block_z2_mean": float((z * z).mean())}


def test_moving_film_agrees_with_the_reference_and_frozen_does_not():
    # The strided route's plain render of a moving 48x27 film, 48 samples a
    # pixel at depth 50, against the reference's image (256 jittered
    # samples), under the cell's limits; the same render with every motion
    # zeroed fails them (the blocks are 12 x 3 pixels, so that a sphere's
    # rise moves light from block to block at this film's size).
    import json
    limits = json.load(open(CELL_LIMITS))
    scene = pt.trim_scene(pt.scene_bouncing_spheres(grid_half=2))
    cam = pt.default_camera(*(NEAR[k] for k in (
        "lookfrom", "lookat", "vup", "vfov", "aspect_ratio", "aperture",
        "focus_dist")))
    r = ref.render_stats(_ref_scene(scene),
                         camera_tensors(camera_arrays(NEAR), torch.float32,
                                        "cpu"),
                         48, 27, torch.Generator().manual_seed(4), 256, 50,
                         TMIN)
    got = _block_z(scene, cam, 48, r)
    frozen = _block_z(pt.MovingScene(*scene[:6],
                                     motion=torch.zeros_like(scene.motion)),
                      cam, 48, r)
    assert all(got[k] <= limits[k] for k in limits), got
    assert all(frozen[k] > limits[k] for k in limits), frozen
    assert math.isfinite(frozen["block_z2_mean"])


def test_one_plan_cache_serves_a_static_and_a_moving_call():
    # A static call and a moving call of one film shape get a plan each
    # (the key tells them apart); the static sums are bit for bit what
    # they were before the moving call, and the moving sums are the eager
    # loop's.
    I._STRIDED_PLANS.clear()
    try:
        static = pt.trim_scene(pt.scene_4_spheres())
        moving = _moving(static, [(0.0, 0.3, 0.0), (0.0, 0.0, 0.0),
                                  (0.1, 0.2, 0.0)])
        cam = pt.t_default_cam()
        W, H, spp, depth = 24, 16, 2, 8

        def chunked(scene):
            st, cc, tables, seed32 = I.strided_setup(
                scene, cam, W * H, 5, spp, 0, depth, W, H, 3, 0, 1, None,
                None)
            return I._chunked_strided_sums(tables, st, cc, seed32, 0, depth,
                                           TMIN), st

        first, st_s = chunked(static)
        mov, st_m = chunked(moving)
        again, _ = chunked(static)
        assert torch.equal(first, again)
        assert len(I._STRIDED_PLANS) == 2
        key = lambda st: I.strided_plan_key(st, 8, depth, TMIN)  # noqa: E731
        assert key(st_s) != key(st_m) and key(st_s)[2] is False
        st, cc, tables, seed32 = I.strided_setup(
            moving, cam, W * H, 5, spp, 0, depth, W, H, 3, 0, 1, None, None)
        I._eager_strided_loop(tables, st, cc, seed32, 0, depth, TMIN,
                              "plain")
        assert torch.equal(I.strided_result(st), mov)
        assert not torch.equal(mov, first)
    finally:
        I._STRIDED_PLANS.clear()


def _routes():
    """Every route with no shutter time, as a call on a small moving film."""
    from raytracingweekend_jl_tpu_torch.ops.edge import (render_radiance_edge,
                                                         trace_edge)
    from raytracingweekend_jl_tpu_torch.ops.inline import render_inline_sum
    from raytracingweekend_jl_tpu_torch.parallel.mesh import RenderMesh
    from raytracingweekend_jl_tpu_torch.parallel.shard import (
        render_radiance_sharded, sharded_train_step)
    mesh = RenderMesh(1, 1, torch.device("cpu"))
    s = _moving(pt.trim_scene(pt.scene_4_spheres()), [(0.0, 0.3, 0.0)])
    cam = pt.t_default_cam()
    W, H = 16, 9
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    u, v = pt.pixel_coords(W, H)
    target = torch.zeros((H, W, 3))
    f64 = pt.MovingScene(*(x.double() if x.is_floating_point() else x
                           for x in s))
    return {
        "persistent_false": lambda: render_tile_sum(
            s, cam, W * H, 1, 1, 0, 4, TMIN, W, H),
        "inline": lambda: render_tile_sum(
            s, cam, W * H, 1, 1, 0, 4, TMIN, W, H, persistent=True,
            inline=True),
        "pinned_tile": lambda: render_tile_sum(
            s, cam, 8, 1, 1, 0, 4, TMIN, W, H, persistent=True,
            u=u[:8], v=v[:8]),
        "float64": lambda: render_tile_sum(
            f64, pt.t_default_cam(dtype=torch.float64), W * H, 1, 1, 0, 4,
            TMIN, W, H, persistent=True),
        "render_radiance": lambda: pt.render_radiance(s, cam, W, 1,
                                                      device="cpu"),
        "render_grads": lambda: pt.render_grads(s, cam, target, W, 1,
                                                device="cpu"),
        "fit_scene": lambda: pt.fit_scene(s, cam, target, W, 1, steps=1,
                                          device="cpu"),
        "trace": lambda: pt.trace(s, o, d, 1),
        "trace_compacted": lambda: pt.trace_compacted(s, o, d, 1),
        "persistent_render_sum": lambda: pt.persistent_render_sum(
            s, cam, u, v, 1, 1, f32_w=W, f32_h=H),
        "persistent_render_sum_fused": lambda: pt.persistent_render_sum_fused(
            s, cam, u, v, 1, 1, f32_w=W, f32_h=H),
        "render_inline_sum": lambda: render_inline_sum(
            s, cam, u, v, 1, 1, 0, 4, TMIN, W, H),
        "trace_recorded": lambda: pt.trace_recorded(s, o, d, 1),
        "trace_recorded_fused": lambda: pt.trace_recorded_fused(s, o, d, 1),
        "trace_recorded_persist": lambda: pt.trace_recorded_persist(
            s, o, d, 1),
        "trace_edge": lambda: trace_edge(s, o, d, 1),
        "render_radiance_edge": lambda: render_radiance_edge(
            s, cam, W, 1, device="cpu"),
        "sharded_render": lambda: render_radiance_sharded(
            s, cam, W, 1, mesh=mesh),
        "sharded_train_step": lambda: sharded_train_step(
            s, cam, target, W, 1, mesh=mesh),
    }


@pytest.mark.parametrize("route", sorted(_routes()))
def test_every_route_without_time_refuses_a_moving_scene(route):
    with pytest.raises(NotImplementedError, match="strided route"):
        _routes()[route]()


def test_inline_route_is_never_picked_for_a_moving_scene():
    assert inline_route_for(48 * 27, 8)
    assert not inline_route_for(48 * 27, 8, moving=True)


def _mid_state(scene, cam, W, H, n_pix, start, k, groups, spp, iters,
               device):
    """A moving scene's strided state after ``iters`` plain iterations."""
    st, cc, tables, seed32 = I.strided_setup(
        scene, cam, n_pix, 3, spp, 0, 50, W, H, k, start, groups, None, None)
    for it in range(iters):
        I.strided_step(tables, st, cc, seed32, it, 0, 50, TMIN, "plain")
    return st, cc, tables


@pytest.mark.cuda
def test_moving_kernels_match_their_plain_versions_on_card(cuda_device):
    # K1m and K2m on the card against their plain versions, bit for bit,
    # with injected and with Philox draws, at the cell's film (400x225,
    # k = 2: 45 000 lanes) and at a tile shape (8 192 pixels of the 1080p
    # film's middle, k = 1, 4 sample groups); K1m at every P. Static K1 and K2 around the moving
    # launches give their plain versions' bits, before and after.
    scene = pt.trim_scene(pt.scene_bouncing_spheres(device=cuda_device))
    static = pt.trim_scene(pt.scene_random_spheres(device=cuda_device))
    cam = pt.t_cam1(device=cuda_device)
    s_tabs = (static, K.sphere_consts(static), attr_mat(static))

    def static_step():
        st = I.init_strided_state(cam, 400 * 225, 400, 225, 7, 4, 0, 16, 2,
                                  device=cuda_device)
        cc = S.pack_camera_consts(cam, 400, 225)
        t, idx = K.sweep(st.fstate[0:6].contiguous(), s_tabs[1])
        t_r, idx_r = K.sweep_ref(st.fstate[0:6], s_tabs[1])
        ref = [x.clone() for x in (st.fstate, st.istate, st.buf)]
        S.shade_strided_fetch_ref(*ref, t, idx, s_tabs[2], cc, st.geom, 5, 0,
                                  0, 16)
        S.shade_strided_step(st.fstate, st.istate, st.buf, t, idx, s_tabs[2],
                             cc, st.geom, 5, 0, 0, 16)
        torch.cuda.synchronize()
        assert torch.equal(t, t_r) and torch.equal(idx, idx_r)
        assert all(torch.equal(a, b)
                   for a, b in zip((st.fstate, st.istate, st.buf), ref))
        return t, st.fstate.clone()

    before = static_step()
    g = torch.Generator(cuda_device).manual_seed(1)
    for W, H, n_pix, start, k, groups in (
            (400, 225, 400 * 225, 0, 2, 1),
            (1920, 1080, 8192, 127 * 8192, 1, 4)):
        st, cc, tabs = _mid_state(scene, cam, W, H, n_pix, start, k, groups,
                                  16, 4, cuda_device)
        rays, times = st.fstate[0:6].contiguous(), I.shutter_plane(st)
        t_r, idx_r = K.sweep_motion_ref(rays, times, tabs[1])
        assert int((t_r < K.BIG).sum()) > rays.shape[1] // 8
        for parts in (None, 1, 2, 4, 8, 16, 32):
            t, idx = K.sweep_motion(rays, times.contiguous(), tabs[1],
                                    parts=parts)
            torch.cuda.synchronize()
            assert torch.equal(t, t_r) and torch.equal(idx, idx_r), parts
        for u in (torch.rand((10, t_r.shape[0]), generator=g,
                             device=cuda_device), None):
            ref = [x.clone() for x in (st.fstate, st.istate, st.buf)]
            kern = [x.clone() for x in ref]
            S.shade_strided_fetch_ref(*ref, t_r, idx_r, tabs[2], cc, st.geom,
                                      5, 4, 0, 50, u)
            S.shade_strided_step(*kern, t_r, idx_r, tabs[2], cc, st.geom, 5,
                                 4, 0, 50, u)
            torch.cuda.synchronize()
            for a, b in zip(kern, ref):
                assert torch.equal(a, b)
    after = static_step()
    assert torch.equal(before[0], after[0])
    assert torch.equal(before[1], after[1])


@pytest.mark.cuda
def test_moving_chunk_graphs_match_the_eager_loop_on_card(cuda_device):
    # The cell's call through the chunk graphs (render_tile_sum's route)
    # against the strided loop pass by pass with the kernels, bit for bit,
    # twice through one plan; a static call of the same film shape before
    # and after gives the same bits.
    scene = pt.trim_scene(pt.scene_bouncing_spheres(device=cuda_device))
    static = pt.trim_scene(pt.scene_random_spheres(device=cuda_device))
    cam = pt.t_cam1(device=cuda_device)
    W, H = 400, 225

    def graphed(sc, seed):
        return render_tile_sum(sc, cam, W * H, seed, 8, 0, 50, TMIN,
                               float(W), float(H), persistent=True,
                               inline=False)

    first = graphed(static, 2)
    for seed in (7, 2**31 + 5):
        K.launches = S.launches = K.motion_launches = S.motion_launches = 0
        got = graphed(scene, seed)
        # Each replay counts 8 launches of K1m and of K2m, none of K1 or K2.
        assert K.motion_launches == S.motion_launches > 0
        assert K.motion_launches % 8 == 0 and K.launches == S.launches == 0
        st, cc, tables, seed32 = I.strided_setup(
            scene, cam, W * H, seed, 8, 0, 50, W, H, 2, 0, 1, None, None)
        I._eager_strided_loop(tables, st, cc, seed32, 0, 50, TMIN, "kernels")
        torch.cuda.synchronize()
        assert torch.equal(got, I.strided_result(st)), seed
        assert bool(torch.isfinite(got).all())
    assert torch.equal(first, graphed(static, 2))
