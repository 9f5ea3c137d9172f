"""The port's gradient API (grad.py, the recorded branch of render.py)
against the JAX package: the path selection and memory planning over tables
of inputs, the whole gradient step on a scene whose render draws no random
number, the attribute contraction, the sanity tripwire, and the gradient
integrators that are not ported."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu import grad as jgrad
from raytracingweekend_jl_tpu.render import pick_samples_per_pass as jpick
from raytracingweekend_jl_tpu.ops.pallas import persist_grad_kernel as JP
from raytracingweekend_jl_tpu.ops.pallas.grad_kernel import _dattr_contract
from raytracingweekend_jl_tpu_torch import grad as G
from raytracingweekend_jl_tpu_torch.render import pick_samples_per_pass
from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG
from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
from raytracingweekend_jl_tpu_torch.ops.cuda.grad_kernel import dattr_contract
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

FLAGSHIP = 1920 * 1080
GIB = 2 ** 30


@pytest.mark.parametrize("kw,n_pix,backend", [
    ({}, FLAGSHIP, "tpu"),
    ({}, 1 << 17, "tpu"),
    ({}, (1 << 17) - 1, "tpu"),
    ({"max_depth": 8}, FLAGSHIP, "tpu"),
    ({"max_depth": 4}, FLAGSHIP, "tpu"),
    ({"persist_strict": False}, FLAGSHIP, "tpu"),
    ({"recorded_persist": (8, None)}, FLAGSHIP, "tpu"),
    ({"recorded_persist": [4, 32, (6, 16)]}, 64 * 36, "tpu"),
    ({"recorded_fused": True}, FLAGSHIP, "tpu"),
    ({"remat": True}, FLAGSHIP, "tpu"),
    ({"recorded": False}, FLAGSHIP, "tpu"),
    ({"remat": False, "recorded_persist": None}, FLAGSHIP, "tpu"),
    ({}, FLAGSHIP, "cpu"),
])
def test_resolve_grad_path_matches_jax(kw, n_pix, backend):
    # The same resolved flags as the JAX package; the port's "cuda" backend
    # resolves as the JAX package's "tpu".
    want = jgrad.resolve_grad_path(dict(kw), n_pix, backend)
    assert G.resolve_grad_path(dict(kw), n_pix, backend) == want
    if backend == "tpu":
        assert G.resolve_grad_path(dict(kw), n_pix, "cuda") == want


@pytest.mark.parametrize("kw", [{"persistent": True}, {"compact": True},
                                {"recorded_persist": True},
                                {"recorded_persist": (8,)}])
def test_resolve_grad_path_rejects_like_jax(kw):
    with pytest.raises(ValueError):
        jgrad.resolve_grad_path(dict(kw), FLAGSHIP, "tpu")
    with pytest.raises(ValueError):
        G.resolve_grad_path(dict(kw), FLAGSHIP, "cuda")


@pytest.mark.parametrize("budget_gib", [75.0, 8.0, 2.0, 0.25])
@pytest.mark.parametrize("kw,n_pix,spp", [
    ({"recorded": True, "recorded_persist": (8, None, (44, 16))},
     FLAGSHIP, 1),
    ({"recorded": True, "recorded_persist": (8, None, (44, 16))},
     FLAGSHIP, 4),
    ({"recorded": True, "recorded_persist": (8, None, (44, 16))},
     FLAGSHIP, 16),
    ({"recorded": True, "recorded_persist": (8, None, (44, 16)),
      "pixel_chunk": 1 << 20}, FLAGSHIP, 8),
    ({"recorded": True, "recorded_persist": (8, None)}, 1 << 18, 8),
    ({"recorded": True, "recorded_persist": (8, None, (44, 16), True)},
     FLAGSHIP, 16),
    ({"recorded": True, "recorded_fused": True}, 256 * 144, 32),
    ({"recorded": True}, 256 * 144, 32),
    ({"recorded": True, "remat_passes": False}, FLAGSHIP, 64),
    ({"recorded": False}, FLAGSHIP, 64),
])
def test_plan_pass_memory_matches_jax(monkeypatch, budget_gib, kw, n_pix,
                                      spp):
    # Keep all records, drop to the lean record, or fall back to pass
    # remat exactly where the JAX package does, under the same budget.
    budget = int(budget_gib * GIB)
    monkeypatch.setattr(jgrad, "RECORD_HBM_BUDGET", budget)
    monkeypatch.setattr(G, "RECORD_HBM_BUDGET", budget)
    want = jgrad.plan_pass_memory(dict(kw), n_pix, spp)
    assert G.plan_pass_memory(dict(kw), n_pix, spp) == want


@pytest.mark.parametrize("args", [
    (FLAGSHIP, 16, 8 * GIB, None, 1 << 20),
    (FLAGSHIP, 16, 75 * GIB, 176, 1 << 21),
    (FLAGSHIP, 16, 2 * GIB, 176, 1 << 21),
    (FLAGSHIP, 8, 100, None, 1 << 20),
    (4096, 16, 8 * GIB, None, 1 << 20),
    (3 * 8192 + 1, 16, 8 * GIB, 88, 8192),
])
def test_auto_pixel_chunk_matches_jax(args):
    n_pix, depth, budget, bprb, cap = args
    assert G.auto_pixel_chunk(n_pix, depth, budget, bprb, cap) == \
        jgrad.auto_pixel_chunk(n_pix, depth, budget, bprb, cap)


@pytest.mark.parametrize("R,S,n_iters,tc,depth,rec_attrs", [
    (FLAGSHIP, 8, None, (44, 16), 16, True),
    (FLAGSHIP, 8, None, (44, 16), 16, False),
    (FLAGSHIP, 8, None, None, 16, True),
    (FLAGSHIP, 8, 40, (44, 16), 16, True),
    (1 << 20, 16, None, (22, 8), 8, True),
    (576, 4, None, (6, 16), 8, True),
    (129600, 8, 64, None, 16, False),
])
def test_persist_geometry_and_record_bytes_match_jax(R, S, n_iters, tc,
                                                     depth, rec_attrs):
    assert PG.strip_geometry(R, S) == JP._strip_geometry(R, S)
    assert PG.default_n_iters(S, depth) == JP.default_n_iters(S, depth)
    assert PG.persist_record_bytes(R, S, n_iters, tc, depth, rec_attrs) == \
        JP.persist_record_bytes(R, S, n_iters, tc, depth, rec_attrs)


@pytest.mark.parametrize("n_pix,spp,rpp", [(FLAGSHIP, 1, 1 << 21),
                                           (FLAGSHIP, 16, 1 << 21),
                                           (256 * 144, 64, 1 << 21),
                                           (256 * 144, 12, 100000)])
def test_pick_samples_per_pass_matches_jax(n_pix, spp, rpp):
    assert pick_samples_per_pass(n_pix, spp, rpp) == jpick(n_pix, spp, rpp)


def _mirror_world():
    """Fuzz-0 metal spheres under an aperture-0 camera: at one sample per
    pixel (sample 0 is centered) no random number reaches the render, so
    the JAX package and the port trace the same paths."""
    scene = rtw.make_scene([
        rtw.metal((0, -100.5, -1), 100.0, (0.8, 0.8, 0.8), 0.0),
        rtw.metal((0, 0, -1.2), 0.5, (0.9, 0.5, 0.3), 0.0),
        rtw.metal((1.1, 0.1, -1), 0.45, (0.3, 0.7, 0.9), 0.0),
        rtw.metal((-1.0, 0.0, -1.1), 0.4, (0.6, 0.6, 0.2), 0.0),
    ])
    return scene, rtw.default_camera((0, 0.3, 0.5), (0, 0, -1))


def test_render_grads_matches_jax_on_a_draw_free_scene():
    # The whole step through the public entry points: the JAX package's
    # default CPU integrator against the port's persistent-record path
    # (pinned: 32x18 defaults to the fixed-depth pair, which
    # test_torch_fused_grad.py holds to the same check) on the same
    # deterministic paths. Loss within 1e-5 relative; center,
    # radius and albedo gradients with cosine >= 0.999 and norm ratio
    # within 1%, in the caller's padded shapes. (The fuzz gradient at fuzz
    # 0 is the drawn unit vector's projection, so the two generators' draws
    # differ there; ir reaches no path of an all-metal scene.)
    scene_j, cam_j = _mirror_world()
    target = np.full((18, 32, 3), 0.4, np.float32)
    lj, gj = jgrad.render_grads(scene_j, cam_j, jnp.asarray(target), 32, 1)
    scene = pt.scene_from_numpy(scene_j)
    lp, gp = pt.render_grads(scene, pt.camera_from_numpy(cam_j),
                             torch.from_numpy(target), 32, 1, device="cpu",
                             recorded_persist=(8, None, (44, 16)),
                             persist_strict=True)
    assert abs(float(lp) - float(lj)) <= 1e-5 * abs(float(lj))
    for f in ("center", "radius", "albedo"):
        a = getattr(gp, f).numpy().astype(np.float64).ravel()
        b = np.asarray(getattr(gj, f), np.float64).ravel()
        assert getattr(gp, f).shape == getattr(scene, f).shape
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        ratio = np.linalg.norm(a) / np.linalg.norm(b)
        assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (f, cos, ratio)


def test_render_grads_small_image_is_finite_and_untrimmed():
    # 64x36 pinned to the persistent-record path with the large-image
    # default's strict (44, 16) compaction (below 2^17 pixels the default is
    # the fixed-depth pair); the gradients are finite and sane, in the
    # caller's untrimmed shapes, zero on padding spheres; render_loss gives
    # the same loss.
    scene = pt.make_scene([pt.lambertian((0, 0, -1), 0.5, (0.7, 0.3, 0.3)),
                           pt.lambertian((0, -100.5, -1), 100.0,
                                         (0.8, 0.8, 0.0)),
                           pt.metal((1, 0, -1), 0.5, (0.8, 0.6, 0.2), 0.3),
                           pt.dielectric((-1, 0, -1), 0.5, 1.5)])
    assert scene.n_spheres == 128
    cam = pt.default_camera()
    target = pt.render_radiance(scene, cam, 64, 1, seed=4, device="cpu")
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.8, 0, 1))
    stats = {}
    pin = dict(recorded_persist=(8, None, (44, 16)), persist_strict=True,
               device="cpu")
    loss, g = pt.render_grads(bad, cam, target, 64, 1, seed=5, stats=stats,
                              **pin)
    pt.check_grads_sane(g, loss)
    assert stats["dropped"] == 0 and stats["lanes"] == [8192]
    assert len(stats["phase1_counts"][0]) == 44
    for f in pt.DIFF_FIELDS:
        x = getattr(g, f)
        assert x.shape == getattr(scene, f).shape and x.dtype == torch.float32
        assert (x[4:] == 0).all()
    assert (g.albedo[:3] != 0).all() and float(loss) > 0
    with torch.no_grad():
        again = pt.render_loss(bad, cam, target, 64, 1, seed=5, **pin)
    assert torch.equal(again, loss)


def test_strict_default_poisons_loss_and_gradients():
    # A starved iteration cap under strict: the loss and the gradient of
    # every traced sphere are NaN (spheres past the trimmed count never
    # enter the trace and get exact zeros), and the tripwire names the
    # loss.
    scene = pt.scene_from_numpy(_mirror_world()[0])
    cam = pt.camera_from_numpy(_mirror_world()[1])
    target = torch.zeros((18, 32, 3))
    loss, g = pt.render_grads(scene, cam, target, 32, 1,
                              recorded_persist=(8, 3), persist_strict=True,
                              device="cpu")
    assert torch.isnan(loss)
    assert all(torch.isnan(getattr(g, f)[:8]).all() for f in pt.DIFF_FIELDS)
    assert all((getattr(g, f)[8:] == 0).all() for f in pt.DIFF_FIELDS)
    with pytest.raises(G.GradSanityError, match="loss"):
        pt.check_grads_sane(g, loss)


@pytest.mark.parametrize("field", pt.DIFF_FIELDS)
def test_check_grads_sane_names_the_field(field):
    # The tripwire names the offending field plainly: grad[<field>].
    good = {f: torch.zeros((8, 3) if f in ("center", "albedo") else (8,))
            for f in pt.DIFF_FIELDS}
    pt.check_grads_sane(pt.SceneGrads(**good), torch.tensor(0.1))
    bad = dict(good)
    bad[field] = good[field].clone()
    bad[field].view(-1)[3] = float("nan")
    with pytest.raises(G.GradSanityError, match=rf"grad\[{field}\] contains"):
        pt.check_grads_sane(pt.SceneGrads(**bad))
    bad[field] = good[field] + 1e4
    with pytest.raises(G.GradSanityError,
                       match=rf"grad\[{field}\] magnitude"):
        pt.check_grads_sane(pt.SceneGrads(**bad))


@pytest.mark.parametrize("kw", [{"recorded": True},
                                {"remat": True, "tile_skip": 64},
                                {"recorded": False, "remat_policy": "dots"},
                                {"recorded_stage": (4, 8)},
                                {"recorded_fused": True,
                                 "fused_stages": ((0, 1), (4, 8))}])
def test_unported_gradient_integrators_raise(kw):
    # These gradient integrators once raised NotImplementedError; each now
    # takes a step on the draw-free mirror world through render_loss and
    # render_grads on the CPU: the same finite loss from both, finite and
    # sane gradients, non-zero in albedo.
    scene = pt.scene_from_numpy(_mirror_world()[0])
    cam = pt.camera_from_numpy(_mirror_world()[1])
    target = torch.zeros((18, 32, 3))
    loss = pt.render_loss(scene, cam, target, 32, 1, device="cpu", **kw)
    loss2, g = pt.render_grads(scene, cam, target, 32, 1, device="cpu", **kw)
    assert torch.isfinite(loss) and torch.equal(loss.detach(), loss2)
    pt.check_grads_sane(g, loss2)
    assert (g.albedo != 0).any()


def test_fused_step_and_twin_canary_raise(monkeypatch):
    # The fused record step (K11, test_torch_fused_step.py) raises the JAX
    # package's ValueError when asked for tail compaction. The canary now
    # runs (test_torch_trace.py) and raises GradSanityError when the kernel
    # pair's gradients are corrupted: here its albedo gradient scaled by
    # 1e6, as the JAX package's test_twin_ad_canary_catches_norm_blowup.
    scene = pt.scene_from_numpy(_mirror_world()[0])
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="tail_compact requires "
                                         "fused_step=False"):
        pt.trace_recorded_persist(scene, o, o, 0, fused_step=True,
                                  tail_compact=(44, 16))
    real = G.render_grads

    def corrupted(*a, **k):
        loss, g = real(*a, **k)
        if k.get("recorded") is not False:
            g = g._replace(albedo=g.albedo * 1e6)
        return loss, g

    monkeypatch.setattr(G, "render_grads", corrupted)
    with pytest.raises(G.GradSanityError):
        G.twin_ad_canary(scene, pt.camera_from_numpy(_mirror_world()[1]),
                         width=32, n_samples=1, device="cpu")


def test_dattr_contract_exact_deterministic_and_order_free():
    # Per-sphere sums of per-lane rows: within 1e-6 relative of a float64
    # sum (and of the JAX package's contraction, 1e-5), bitwise the same
    # for any order of the lanes; a NaN poisons only its own field.
    g = np.random.default_rng(3)
    K_, W, n = 6, 4096, 37
    dattr = torch.from_numpy(g.normal(size=(K_, 9, W)).astype(np.float32))
    idx = torch.from_numpy(g.integers(0, n, size=(K_, W)).astype(np.int32))
    out = dattr_contract(dattr, idx, n)
    ref = torch.zeros((n, 9), dtype=torch.float64)
    ref.index_add_(0, idx.reshape(-1).long(),
                   dattr.permute(0, 2, 1).reshape(-1, 9).double())
    assert out.shape == (n, 9) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    flat = dattr.permute(1, 0, 2).reshape(9, -1)
    jout = np.asarray(_dattr_contract([jnp.asarray(r.numpy()) for r in flat],
                                      jnp.asarray(idx.reshape(-1).numpy()), n))
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    perm = torch.from_numpy(g.permutation(K_ * W))
    shuffled = dattr_contract(
        flat[:, perm].reshape(9, K_, W).permute(1, 0, 2),
        idx.reshape(-1)[perm].reshape(K_, W), n)
    assert torch.equal(out, shuffled)
    dattr[2, 4, 7] = float("nan")
    poisoned = dattr_contract(dattr, idx, n)
    assert torch.isnan(poisoned[:, 4]).all()
    assert torch.isfinite(poisoned[:, [0, 1, 2, 3, 5, 6, 7, 8]]).all()


@pytest.mark.parametrize("block", [1, 5])
def test_dattr_contract_field_blocks_give_the_same_bits(block, monkeypatch):
    # The contraction sums its fields in blocks of CONTRACT_BLOCK values:
    # one field at a time (block 1) or a few (block 5, a ragged last block)
    # give the bits of all fields at once, a non-finite field and an
    # all-zero one included, in float32 and float64.
    g = np.random.default_rng(8)
    for K_, F, W, n, dt in ((6, 9, 4096, 37, torch.float32),
                            (2, 4, 300, 5, torch.float64)):
        d = torch.from_numpy(g.normal(size=(K_, F, W))
                             * 10.0 ** g.integers(-6, 6, size=(1, F, 1))
                             ).to(dt)
        d[:, 2] = 0.0
        d[1, 3, 7] = float("inf")
        idx = torch.from_numpy(g.integers(0, n, size=(K_, W)).astype(np.int32))
        whole = dattr_contract(d, idx, n)
        monkeypatch.setattr(GK, "CONTRACT_BLOCK", block * K_ * W)
        blocked = dattr_contract(d, idx, n)
        monkeypatch.undo()
        assert torch.isnan(whole[:, 3]).all()
        assert torch.equal(whole.nan_to_num(nan=7.0), blocked.nan_to_num(
            nan=7.0)) and torch.equal(whole.isnan(), blocked.isnan())


def test_record_hbm_budget_on_the_cpu(monkeypatch):
    monkeypatch.setattr(G, "RECORD_HBM_BUDGET", None)
    assert G.record_hbm_budget("cpu") == 8 * GIB
    monkeypatch.setattr(G, "RECORD_HBM_BUDGET", 3 * GIB)
    assert G.record_hbm_budget("cpu") == 3 * GIB


def test_scene_requires_grad_survives_trim_and_to():
    scene = pt.scene_from_numpy(_mirror_world()[0], requires_grad=True)
    for s in (scene, pt.trim_scene(scene), scene.to("cpu")):
        assert all(getattr(s, f).requires_grad for f in pt.DIFF_FIELDS)
        assert not s.mat.requires_grad
    assert pt.trim_scene(scene).n_spheres == 8


def test_sgd_step_moves_against_the_gradient():
    scene = pt.scene_from_numpy(_mirror_world()[0])
    cam = pt.camera_from_numpy(_mirror_world()[1])
    target = torch.full((18, 32, 3), 0.4)
    loss, g = pt.render_grads(scene, cam, target, 32, 1, device="cpu")
    loss2, new = pt.sgd_inverse_render_step(scene, cam, target, 32, 1, lr=0.5,
                                            device="cpu")
    assert torch.equal(loss, loss2)
    for f in pt.DIFF_FIELDS:
        assert torch.equal(getattr(new, f),
                           getattr(scene, f) - 0.5 * getattr(g, f))
    assert torch.equal(new.mat, scene.mat)
