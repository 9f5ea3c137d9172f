"""K2 (the strided shade step) and the Philox draws of the port against the
JAX package's strided kernel in interpret mode; card-only checks of the CUDA
kernel against its plain version."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.pallas.shade_kernel import (
    shade_strided_step as jax_strided_step, pack_camera_consts as jax_pack)
from raytracingweekend_jl_tpu_torch import rng
from raytracingweekend_jl_tpu_torch.ops import integrator as I
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as S
from raytracingweekend_jl_tpu_torch.ops.materials import (attr_mat,
                                                          fetch_attr_planes)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SCENES = {"random_spheres": (lambda: rtw.scene_random_spheres(seed=1),
                             "t_cam1"),
          "diel_spheres_hollow": (rtw.scene_diel_spheres_hollow,
                                  "hollow_glass_cam"),
          "4_spheres": (rtw.scene_4_spheres, "t_default_cam")}
W, H, K_STRIPS, SPP = 128, 72, 4, 4


def _state(scene_j, cam_name, iters, device="cpu"):
    """A strided state after ``iters`` plain iterations (in-loop Philox),
    plus the sweep's winner t and attributes for the next one, and the
    winner index (int32) and attribute table they come from."""
    scene = pt.trim_scene(pt.scene_from_numpy(scene_j, device=device))
    cam = getattr(pt, cam_name)(device=device)
    st = I.init_strided_state(cam, W * H, W, H, 7, SPP, 0, 16, K_STRIPS,
                              device=device)
    cc = S.pack_camera_consts(cam, W, H)
    tabs = (scene, K.sphere_consts(scene), attr_mat(scene))
    for it in range(iters):
        I.strided_step(tabs, st, cc, 123, it, 0, 16, 1e-4, "plain")
    hit = pt.intersect_spheres(st.fstate[0:3].T, st.fstate[3:6].T, scene)
    attrs = fetch_attr_planes(hit.index, tabs[2])
    return (st, cc, hit.t.contiguous(), attrs, hit.index.to(torch.int32),
            tabs[2])


def _jax_step(st, t, attrs, cam_j, u9):
    """The JAX package's strided kernel (interpret mode) on the same state,
    in its padded (rows, 128) plane layout."""
    n = t.shape[0]
    rows = -(-(-(-n // 128)) // 64) * 64
    pad = lambda x: jnp.asarray(np.pad(x.numpy(), (0, rows * 128 - n))
                                .reshape(rows, 128))
    planes = [pad(p) for p in [*st.fstate, *st.istate, *st.buf]]
    out = jax_strided_step(tuple(planes), jnp.asarray(t.numpy()),
                           jnp.asarray(attrs.numpy()), jax_pack(cam_j, W, H),
                           jnp.asarray(st.geom, jnp.int32), 0, SPP - 1, 0, 16,
                           K_STRIPS, interpret=True,
                           rng_u9=jnp.stack([pad(u) for u in u9]))
    flat = [np.asarray(o).reshape(-1)[:n] for o in out]
    return np.stack(flat[:12]), np.stack(flat[12:19]), np.stack(flat[19:])


def _lanes_within(a, b, tol):
    """Per lane: every plane within tol * max(1, |x|)."""
    return (np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b))).all(0)


@pytest.mark.parametrize("name", sorted(SCENES))
def test_strided_step_ref_matches_pallas_interpret(name):
    # Same state, hit and injected uniforms into both. Integer planes must be
    # identical and float planes within 1e-5 (scaled by max(1, |x|): a
    # float32 ulp of a hit point 600 units away is 6e-5) on >= 99.9% of
    # lanes, and every lane within 1e-4. The rest are rounding differences:
    # XLA's CPU backend contracts a*b+c into FMA inside the interpret kernel
    # and eager PyTorch does not; in random_spheres a last-bit difference in a
    # hit point is amplified by 1/r = 5 in the normal of its r = 0.2 spheres.
    # Measured: 100%, 100% and 99.96% (one lane of 2 304) of lanes.
    scene_j, cam_name = SCENES[name]
    st, cc, t, attrs, _, _ = _state(scene_j(), cam_name, 12)
    u9 = torch.from_numpy(np.random.default_rng(5).random(
        (9, t.shape[0]), dtype=np.float32))
    f_j, i_j, b_j = _jax_step(st, t, attrs, getattr(rtw, cam_name)(), u9)
    S.shade_strided_step_ref(st.fstate, st.istate, st.buf, t, attrs, cc,
                             st.geom, 0, 0, 0, 16, u9)
    ints = (st.istate.numpy() == i_j).all(0)
    ok = ints & _lanes_within(st.fstate.numpy(), f_j, 1e-5) \
        & _lanes_within(st.buf.numpy(), b_j, 1e-5)
    assert ok.mean() >= 0.999, ok.mean()
    assert ints.all()
    assert _lanes_within(st.fstate.numpy(), f_j, 1e-4).all()
    assert _lanes_within(st.buf.numpy(), b_j, 1e-4).all()


@pytest.mark.parametrize("case", ["mirror", "sky"])
def test_strided_step_rng_free_exact(case):
    # Fuzz-0 mirror under an aperture-0 camera, and an empty scene: no
    # uniform reaches the result (metal adds 0 * u, sample 0 is centered).
    # Within the port that is exact: other uniforms give the same bits.
    # Against the interpret kernel it is 1e-6, the JAX package's own bound
    # for its RNG-free cases: XLA contracts the sky sum rx + tx*skyr into an
    # FMA there (measured max difference 1.8e-7).
    spheres = ([rtw.metal((0, -100.0, 0), 99.0, (0.8, 0.6, 0.4), 0.0)]
               if case == "mirror" else [])
    scene_j = rtw.make_scene(spheres)
    cam_j = rtw.default_camera((0, 2, 0), (1, 1, 0))
    cam = pt.camera_from_numpy(cam_j)
    scene = pt.trim_scene(pt.scene_from_numpy(scene_j))
    st = I.init_strided_state(cam, W * H, W, H, 0, 1, 0, 16, K_STRIPS,
                              init_u4=torch.full((W * H // K_STRIPS, 4), 0.3))
    cc = S.pack_camera_consts(cam, W, H)
    for it in range(2):
        hit = pt.intersect_spheres(st.fstate[0:3].T, st.fstate[3:6].T, scene)
        attrs = fetch_attr_planes(hit.index, attr_mat(scene))
        u9 = torch.from_numpy(np.random.default_rng(it).random(
            (9, hit.t.shape[0]), dtype=np.float32))
        f_j, i_j, b_j = _jax_step(st, hit.t.contiguous(), attrs, cam_j, u9)
        other = [x.clone() for x in (st.fstate, st.istate, st.buf)]
        S.shade_strided_step_ref(*other, hit.t.contiguous(), attrs, cc,
                                 st.geom, 0, it, 0, 16, 1 - u9)
        S.shade_strided_step_ref(st.fstate, st.istate, st.buf,
                                 hit.t.contiguous(), attrs, cc, st.geom, 0,
                                 it, 0, 16, u9)
        for x, y in zip((st.fstate, st.istate, st.buf), other):
            assert torch.equal(x, y)
        np.testing.assert_array_equal(st.istate.numpy(), i_j)
        np.testing.assert_allclose(st.fstate.numpy(), f_j, atol=1e-6, rtol=0)
        np.testing.assert_allclose(st.buf.numpy(), b_j, atol=1e-6, rtol=0)
    assert st.buf.sum() > 0


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    # Random123's published known-answer vectors for Philox4x32-10.
    out = rng.philox4x32(tuple(torch.tensor([c]) for c in ctr), key)
    assert tuple(int(w) for w in out) == want


def test_philox_uniforms_shape_independent_and_in_range():
    a = rng.philox_uniforms(99, 5, 1000)
    b = rng.philox_uniforms(99, 5, 300)
    assert a.shape == (9, 1000) and a.dtype == torch.float32
    assert torch.equal(a[:, :300], b)
    assert (a >= 0).all() and (a < 1).all()
    assert not torch.equal(a, rng.philox_uniforms(99, 6, 1000))
    # 24-bit uniforms: mean 1/2 within 5 standard errors of 9000 draws.
    assert abs(a.mean().item() - 0.5) < 5 * (1 / 12 / a.numel()) ** 0.5


def test_persistent_seed_folds_seed_and_offset():
    seeds = {rng.persistent_seed(s, off) for s in (0, 1, 2) for off in (0, 4)}
    assert len(seeds) == 6 and all(0 <= s < 2 ** 32 for s in seeds)


def test_strided_step_wrapper_cpu_uses_plain_and_philox():
    # On CPU tensors the wrapper runs the plain version (the winner fetch,
    # then the attribute-level step) and counts no launch; without u9 it
    # draws rng.philox_uniforms(seed, iteration).
    st, cc, t, attrs, idx, amat = _state(rtw.scene_4_spheres(),
                                         "t_default_cam", 2)
    copies = [x.clone() for x in (st.fstate, st.istate, st.buf)]
    before = S.launches
    S.shade_strided_step(st.fstate, st.istate, st.buf, t, idx, amat, cc,
                         st.geom, 77, 2, 0, 16)
    assert S.launches == before
    u9 = rng.philox_uniforms(77, 2, t.shape[0])
    S.shade_strided_step_ref(*copies, t, attrs, cc, st.geom, 0, 0, 0, 16, u9)
    for x, y in zip((st.fstate, st.istate, st.buf), copies):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("injected", [True, False])
def test_strided_step_kernel_matches_plain_on_card(cuda_device, injected):
    # The kernel (its own winner fetch) against its plain version (the
    # gather, then the attribute-level step) on the card, with injected
    # uniforms and with its own Philox draws (which the plain version
    # reproduces): state and strip buffers bit for bit.
    st, cc, t, attrs, idx, amat = _state(rtw.scene_random_spheres(seed=1),
                                         "t_cam1", 12, device=cuda_device)
    u9 = (torch.rand((9, t.shape[0]), device=cuda_device,
                     generator=torch.Generator(cuda_device).manual_seed(3))
          if injected else None)
    ref = [x.clone() for x in (st.fstate, st.istate, st.buf)]
    before = S.launches
    S.shade_strided_step(st.fstate, st.istate, st.buf, t, idx, amat, cc,
                         st.geom, 41, 12, 0, 16, u9)
    torch.cuda.synchronize()
    assert S.launches == before + 1
    S.shade_strided_step_ref(*ref, t, attrs, cc, st.geom, 41, 12, 0, 16, u9)
    for a, b in zip((st.fstate, st.istate, st.buf), ref):
        assert torch.equal(a, b)
