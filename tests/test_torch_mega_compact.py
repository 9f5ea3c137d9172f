"""K12's compacted schedule (csrc/mega.cu): each block of 128 lanes packs
its active lanes, sweeps only those (P threads each, P per block by K3's
rule) and shades the packed lanes; idle lanes are not touched.

- Whether skipping an idle lane keeps its bits: the pinned step runs an
  idle lane through 0/1 blends (``0 * x + w``), which give back ``w`` bit
  for bit unless ``w`` is a signed zero or ``x`` is not finite. Over whole
  renders (the JAX package's exact mega cases and the 48x27 scenes of
  ``test_torch_mega.py``), the plain step changes no word of any idle lane
  at any iteration.
- The plain mirror ``mega_step_compact_ref`` bitwise ``mega_step_ref`` at
  several active shares, block sizes and forced P, with Philox and
  injected draws; renders through the mirror against the JAX megakernel's
  exact cases in interpret mode.
- The per-block rule for P, and ``mega_step`` on CPU tensors.
- Card-only: K12 bitwise K1 + gather + K9 on four scenes whose tables and
  active counts make the rule choose every P it can (1, 2, 4, 8, 16).
"""

import importlib

import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.scene import trim_scene as jtrim
from raytracingweekend_jl_tpu_torch.ops import integrator as I
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K1
from raytracingweekend_jl_tpu_torch.ops.cuda import mega_kernel as K12
from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as K2
from raytracingweekend_jl_tpu_torch.ops.materials import (attr_mat,
                                                          fetch_attr_planes)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
from test_torch_pinned import SCENES
from test_torch_mega import _jax_mega

M = importlib.import_module("raytracingweekend_jl_tpu_torch.ops.experimental"
                            ".mega")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _exact_case(case):
    """The JAX package's draw-free mega cases (test_torch_mega.py's
    test_mega_exact_cases_match_jax): scene, camera, spp, depth, atol."""
    if case == "mirror":
        scene = rtw.make_scene([rtw.metal((0, -100.0, 0), 99.0,
                                          (0.8, 0.6, 0.4), 0.0)])
        return scene, rtw.default_camera((0, 2, 0), (1, 1, 0)), 1, 16, 1e-5
    if case == "sky":
        return rtw.make_scene([]), rtw.t_default_cam(), 1, 16, 1e-6
    return rtw.scene_2_spheres(), rtw.t_default_cam(), 1, 1, 1e-6


#: name -> (scene, camera, spp, depth) of the renders the idle-lane count
#: runs: the exact cases, then test_torch_mega's 48x27 scenes at spp 4.
RENDERS = {**{c: _exact_case(c)[:4] for c in ("mirror", "sky", "depth_1")},
           **{n: (SCENES[n][0](), getattr(rtw, SCENES[n][1])(), 4, 16)
              for n in ("4_spheres", "diel_spheres_hollow",
                        "random_spheres")}}


def _film(scene_j, cam_j, W=48, H=27):
    sc = pt.scene_from_numpy(jtrim(scene_j))
    u, v = pt.pixel_coords(W, H)
    return sc, pt.camera_from_numpy(cam_j), u, v


def _words(fs, ist):
    """Every state word of every lane as int32 [15, n]."""
    return torch.cat([fs.view(torch.int32), ist])


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_step_leaves_idle_lanes_unchanged(name):
    # Whole renders at 48x27 through the plain step: at every iteration,
    # the idle lanes (istate[2] == 0) whose 15 state words the step
    # changes in any bit. Zero in every case, so K12 may skip idle lanes
    # whole. (depth_1 renders one iteration with every lane active.)
    scene_j, cam_j, spp, depth = RENDERS[name]
    sc, cam, u, v = _film(scene_j, cam_j)
    seen = {"idle": 0, "changed": 0, "iterations": 0}

    def counting(impl, tables, fs, ist, u_, v_, cc, seed32, it, last, md,
                 tmin, u9):
        before, idle = _words(fs, ist), ist[2] == 0
        K12.mega_step_ref(fs, ist, tables[1], tables[2], u_, v_, cc, seed32,
                          it, last, md, tmin, u9)
        changed = (_words(fs, ist) != before).any(0)
        seen["idle"] += int(idle.sum())
        seen["changed"] += int((changed & idle).sum())
        seen["iterations"] += 1

    I.pinned_render_loop(sc, cam, u, v, 5, spp, 0, depth, 1e-4, 48.0, 27.0,
                         "plain", None, None, counting)
    assert seen["changed"] == 0, seen
    assert seen["idle"] > 0 or name == "depth_1", seen


def _mid_render(n_iter, W=48, H=27, seed=5):
    """The random_spheres film pinned after ``n_iter`` plain iterations
    (spp 2): state, film, tables and camera constants."""
    scene_j, cam_j, _, _ = RENDERS["random_spheres"]
    sc, cam, u, v = _film(scene_j, cam_j, W, H)
    n = u.shape[0]
    org, d = I.pinned_start_rays(cam, u, v, seed, 0, float(W), float(H))
    fs = torch.zeros((12, n))
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=torch.int32)
    ist[2] = 1
    cc = K2.pack_camera_consts(cam, W, H)
    sph, amat = K1.sphere_consts(sc), attr_mat(sc)
    for it in range(n_iter):
        K12.mega_step_ref(fs, ist, sph, amat, u, v, cc, seed, it, 1, 16,
                          1e-4)
    return fs, ist, (sph, amat, u, v, cc)


@pytest.fixture(scope="module")
def states():
    """Mid-render states of the 48x27 random_spheres film: the natural ones
    after 0 and 9 iterations, and the one after 3 with numpy-drawn active
    masks of share 0, 3%, 40% and 100% over its lanes."""
    out = {}
    for n_iter in (0, 9):
        fs, ist, env = _mid_render(n_iter)
        out[f"iteration{n_iter}"] = (fs, ist, env, n_iter)
    fs, ist, env = _mid_render(3)
    g = np.random.default_rng(21)
    for share in (0.0, 0.03, 0.4, 1.0):
        forced = ist.clone()
        forced[2] = torch.from_numpy(
            (g.random(ist.shape[1]) < share).astype(np.int32))
        out[f"share{share}"] = (fs, forced, env, 3)
    return out


STATE_NAMES = ["iteration0", "iteration9", "share0.0", "share0.03",
               "share0.4", "share1.0"]


@pytest.mark.parametrize("block", [32, 128, 256])
@pytest.mark.parametrize("state", STATE_NAMES)
def test_compact_mirror_is_mega_step_ref(states, state, block):
    # Per block of `block` lanes: pack the active lanes, sweep them at the
    # block's P, shade the packed lanes with their own lane ids as the
    # Philox counters. Every state word bit for bit mega_step_ref's, with
    # Philox and with numpy-injected draws.
    fs, ist, (sph, amat, u, v, cc), it = states[state]
    n = fs.shape[1]
    u9 = torch.from_numpy(np.random.default_rng(block).random(
        (9, n), dtype=np.float32))
    for draws in (None, u9):
        a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
        K12.mega_step_ref(*a, sph, amat, u, v, cc, 5, it, 1, 16, 1e-4, draws)
        K12.mega_step_compact_ref(*b, sph, amat, u, v, cc, 5, it, 1, 16,
                                  1e-4, draws, block=block)
        assert torch.equal(_words(*a), _words(*b))
    if state != "share0.0":
        assert not torch.equal(_words(*a), _words(fs, ist))


@pytest.mark.parametrize("parts", [1, 2, 4, 8, 16, 32])
def test_compact_mirror_with_forced_parts(states, parts):
    # Every block at one forced P (the mirror's parts=): the same bits as
    # mega_step_ref, on the natural mid-render state and a sparse mask.
    for state in ("iteration9", "share0.03"):
        fs, ist, (sph, amat, u, v, cc), it = states[state]
        a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
        K12.mega_step_ref(*a, sph, amat, u, v, cc, 5, it, 1, 16, 1e-4)
        K12.mega_step_compact_ref(*b, sph, amat, u, v, cc, 5, it, 1, 16,
                                  1e-4, parts=parts)
        assert torch.equal(_words(*a), _words(*b))


@pytest.mark.parametrize("case", ["mirror", "sky", "depth_1"])
def test_compact_render_matches_jax_exact_cases(case):
    # The megakernel render with every iteration through the compact
    # mirror: bitwise the port's plain megakernel render, and within the
    # JAX megakernel's exact-case tolerances (interpret mode; 1e-5 for the
    # fuzz-0 mirror, 1e-6 for the sky and depth 1; test_torch_mega.py's).
    scene_j, cam_j, spp, depth, atol = _exact_case(case)
    sc, cam, u, v = _film(scene_j, cam_j)

    def compact(impl, tables, fs, ist, u_, v_, cc, seed32, it, last, md,
                tmin, u9):
        K12.mega_step_compact_ref(fs, ist, tables[1], tables[2], u_, v_, cc,
                                  seed32, it, last, md, tmin, u9)

    out = I.pinned_render_loop(sc, cam, u, v, 5, spp, 0, depth, 1e-4, 48.0,
                               27.0, "plain", None, None, compact)
    plain = M.persistent_render_sum_mega(sc, cam, u, v, 5, spp, 0, depth,
                                         1e-4, 48.0, 27.0)
    assert torch.equal(out, plain)
    ref = _jax_mega(scene_j, cam_j, spp=spp, max_depth=depth)
    np.testing.assert_allclose(out.numpy(), ref, atol=atol)
    assert out.mean() > 0


def _rule(n_active, n_spheres, block):
    p = min(K1.parts_cap(n_spheres), 16)
    while p > 1 and n_active * p > 4 * block:
        p //= 2
    return p


@pytest.mark.parametrize("n_spheres", [1, 4, 488])
@pytest.mark.parametrize("block", [64, 128])
def test_block_parts_rule(n_spheres, block):
    # K3's and K12's P per block: the largest power of two <= min(the
    # table's cap, 16) with n_active * P <= 4 * block.
    n_active = torch.arange(block + 1)
    got = K12.block_parts(n_active, n_spheres, block)
    assert got.tolist() == [_rule(int(a), n_spheres, block)
                            for a in n_active]
    if n_spheres == 488 and block == K12.THREADS:
        assert got[[0, 32, 33, 64, 65, 128]].tolist() == [16, 16, 8, 8, 4,
                                                          4]


def test_mega_step_on_cpu_runs_plain_version(states):
    # On CPU tensors mega_step runs mega_step_ref and counts no launch; the
    # mirror's forced P takes only a power of two in [1, 32] (0: per block).
    fs, ist, (sph, amat, u, v, cc), it = states["iteration9"]
    ref, got = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
    K12.mega_step_ref(*ref, sph, amat, u, v, cc, 5, it, 1, 16, 1e-4)
    before = K12.launches
    K12.mega_step(*got, sph, amat, u, v, cc, 5, it, 1, 16, 1e-4)
    assert torch.equal(_words(*got), _words(*ref))
    assert K12.launches == before
    for bad in (3, 64, -1, 2.0):
        with pytest.raises(ValueError):
            K12.mega_step_compact_ref(fs.clone(), ist.clone(), sph, amat, u,
                                      v, cc, 5, it, 1, 16, 1e-4, parts=bad)


def _card_scene(name, dev):
    """(scene, camera, the P the rule may choose on it) of the card test:
    the flagship's 488 spheres (P 4, 8 or 16 by the block's active count),
    then tables of 4, 2 and 1 spheres (the cap: P 4, 2, 1)."""
    if name == "random_spheres":
        return (pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev)),
                pt.t_cam1(device=dev), {4, 8, 16})
    if name == "mirror":
        sc = pt.make_scene([pt.metal((0, -100.0, 0), 99.0, (0.8, 0.6, 0.4),
                                     0.0)], device=dev)
        cam = pt.default_camera((0, 2, 0), (1, 1, 0), device=dev)
    else:
        sc = getattr(pt, f"scene_{name}")(device=dev)
        cam = pt.t_default_cam(device=dev)
    sc = pt.trim_scene(sc, multiple=1)
    return sc, cam, {min(K1.parts_cap(sc.center.shape[0]), 16)}


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["random_spheres", "4_spheres",
                                   "2_spheres", "mirror"])
def test_mega_kernel_matches_k1_gather_k9_on_card(cuda_device, scene):
    # K12 at iterations 0, 6 and 14 of the scene pinned at 512x288 (spp 2),
    # Philox and injected draws: every state word bitwise the pinned
    # route's iteration (K1, the gather, K9); one launch counted per call.
    # The P its blocks choose (block_parts) cover the scene's set.
    dev = cuda_device
    sc, cam, p_expected = _card_scene(scene, dev)
    W, H = 512, 288
    u, v = pt.pixel_coords(W, H, device=dev)
    n = u.shape[0]
    org, d = I.pinned_start_rays(cam, u, v, 0, 0, float(W), float(H))
    fs = torch.zeros((12, n), device=dev)
    fs[0:3], fs[3:6], fs[6:9] = org.T, d.T, 1.0
    ist = torch.zeros((3, n), dtype=torch.int32, device=dev)
    ist[2] = 1
    cc = K2.pack_camera_consts(cam, W, H)
    sph, amat = K1.sphere_consts(sc), attr_mat(sc)
    g = torch.Generator(device=dev).manual_seed(3)
    chosen = set()

    def pinned(fs_, ist_, it, u9):
        t, idx = K1.sweep(fs_[0:6], sph)
        K2.shade_and_regen(fs_, ist_, t, fetch_attr_planes(idx, amat), u, v,
                           cc, 5, it, 1, 16, u9)

    for it in range(15):
        if it in (0, 6, 14):
            n_act = torch.bincount(torch.nonzero(ist[2] != 0)[:, 0]
                                   // K12.THREADS)
            chosen |= set(K12.block_parts(n_act[n_act > 0],
                                          sph.shape[0]).tolist())
            for u9 in (torch.rand((9, n), generator=g, device=dev), None):
                a, b = [fs.clone(), ist.clone()], [fs.clone(), ist.clone()]
                before = K12.launches
                K12.mega_step(*a, sph, amat, u, v, cc, 5, it, 1, 16, 1e-4,
                              u9)
                assert K12.launches == before + 1
                pinned(*b, it, u9)
                torch.cuda.synchronize()
                assert torch.equal(_words(*a), _words(*b))
        pinned(fs, ist, it, None)
    assert int((ist[2] != 0).sum()) < n
    assert chosen == p_expected, chosen
