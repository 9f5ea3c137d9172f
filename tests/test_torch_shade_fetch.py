"""K2 with its winner fetch inside: the plain entry the strided loop calls
(``shade_strided_fetch_ref``: the gather, then the attribute-level step)
against the gather plus ``shade_strided_step_ref`` and against the JAX
package's fetch and strided kernel (interpret mode); a card-only check of
the kernel against the plain entry."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.materials import (
    attr_mat as jax_attr_mat, fetch_attr_planes as jax_fetch)
from raytracingweekend_jl_tpu.ops.pallas.shade_kernel import (
    shade_strided_step as jax_strided_step, pack_camera_consts as jax_pack)
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


CAMS = {"random_spheres": "t_cam1", "random_spheres_reference": "t_cam1",
        "diel_spheres_hollow": "hollow_glass_cam"}
# 70 x 40 pixels at k = 3 strips: 934 lanes (the last lane's third pixel
# lies past the film, so it ends after two), 4 samples, depth 16.
W, H, K_STRIPS, SPP = 70, 40, 3, 4


def _strided(name, iters, device="cpu"):
    """The scene, its tables and camera constants, and a strided state
    after ``iters`` plain iterations of the loop (Philox draws)."""
    scene = pt.trim_scene(pt.ALL_SCENES[name](device=device))
    cam = getattr(pt, CAMS.get(name, "t_default_cam"))(device=device)
    st = I.init_strided_state(cam, W * H, W, H, 3, SPP, 0, 16, K_STRIPS,
                              device=device)
    cc = S.pack_camera_consts(cam, W, H)
    tabs = (scene, K.sphere_consts(scene), attr_mat(scene))
    for it in range(iters):
        I.strided_step(tabs, st, cc, 99, it, 0, 16, 1e-4, "plain")
    return scene, tabs, cc, st


def _lane_kinds(st, t):
    """Counts of live miss lanes, dead lanes and lanes past their first
    pixel (refilled at least once)."""
    active = st.istate[5] != 0
    return (int((active & (t >= K.BIG)).sum()), int((~active).sum()),
            int((st.istate[2] > 0).sum()))


@pytest.mark.parametrize("name", sorted(pt.ALL_SCENES))
@pytest.mark.parametrize("iters", [3, 24])
def test_fetch_entry_is_gather_plus_step_ref(name, iters):
    # The strided loop's plain entry is the gather followed by the
    # attribute-level step, bit for bit, on every scene, early and later in
    # the render (live miss lanes, dead lanes and refilled lanes all present
    # at iteration 24), with Philox and with injected uniforms; the CPU
    # wrapper runs it.
    scene, tabs, cc, st = _strided(name, iters)
    t, idx = I.sweep_hits(tabs, st.fstate[0:6], 1e-4, "plain")
    assert idx.dtype == torch.int32
    if iters == 24:
        assert all(c > 0 for c in _lane_kinds(st, t)), _lane_kinds(st, t)
    u9 = torch.from_numpy(np.random.default_rng(iters).random(
        (9, t.shape[0]), dtype=np.float32))
    for u in (None, u9):
        outs = []
        for run in ("entry", "gather", "wrapper"):
            x = [v.clone() for v in (st.fstate, st.istate, st.buf)]
            if run == "entry":
                S.shade_strided_fetch_ref(*x, t, idx, tabs[2], cc, st.geom,
                                          99, iters, 0, 16, u)
            elif run == "gather":
                S.shade_strided_step_ref(*x, t, fetch_attr_planes(idx, tabs[2]),
                                         cc, st.geom, 99, iters, 0, 16, u)
            else:
                S.shade_strided_step(*x, t, idx, tabs[2], cc, st.geom, 99,
                                     iters, 0, 16, u)
            outs.append(x)
        for a, b, c in zip(*outs):
            assert torch.equal(a, b) and torch.equal(a, c)


def test_loop_gathers_nothing():
    # The strided loop fetches inside the step: no call of the gather.
    _, tabs, cc, st = _strided("4_spheres", 0)
    from raytracingweekend_jl_tpu_torch.ops import materials
    before = materials.fetch_calls
    I.strided_step(tabs, st, cc, 99, 0, 0, 16, 1e-4, "plain")
    # the plain entry's own gather is the only one
    assert materials.fetch_calls == before + 1
    before = materials.fetch_calls
    I.sweep_hits(tabs, st.fstate[0:6], 1e-4, "plain")
    assert materials.fetch_calls == before


@pytest.mark.parametrize("name", ["random_spheres", "diel_spheres_hollow"])
def test_fetch_entry_matches_jax_fetch_and_interpret_kernel(name):
    # The same state, winners and injected uniforms through the JAX
    # package's fetch (its one-hot contraction) and strided kernel
    # (interpret mode), and through the port's plain entry. The fetched
    # attributes are exact; the step by the rule of the port's JAX
    # comparisons (ROADMAP, Queue 3): integer planes identical, float planes
    # within 1e-5 * max(1, |x|) on >= 99.9% of lanes (at least one lane
    # free) and 1e-4 on all (XLA contracts FMAs on the CPU, and a last-bit
    # difference in a hit point grows by 1/r in a small sphere's normal).
    scene, tabs, cc, st = _strided(name, 12)
    t, idx = I.sweep_hits(tabs, st.fstate[0:6], 1e-4, "plain")
    n = t.shape[0]
    scene_j = rtw.ALL_SCENES[name]()
    amat_j = jax_attr_mat(scene_j)[:tabs[2].shape[0]]
    attrs_j = np.asarray(jax_fetch(jnp.asarray(idx.numpy()), amat_j,
                                   tabs[2].shape[0]))
    np.testing.assert_array_equal(attrs_j.reshape(10, n),
                                  fetch_attr_planes(idx, tabs[2]).numpy())
    u9 = torch.from_numpy(np.random.default_rng(4).random((9, n),
                                                          dtype=np.float32))
    rows = -(-(-(-n // 128)) // 64) * 64
    pad = lambda x: jnp.asarray(np.pad(np.asarray(x).reshape(-1),
                                       (0, rows * 128 - n))
                                .reshape(rows, 128))
    planes = [pad(p.numpy()) for p in [*st.fstate, *st.istate, *st.buf]]
    cam_j = getattr(rtw, CAMS.get(name, "t_default_cam"))()
    out = jax_strided_step(tuple(planes), jnp.asarray(t.numpy()),
                           jnp.asarray(attrs_j.reshape(10, n)),
                           jax_pack(cam_j, W, H),
                           jnp.asarray(st.geom, jnp.int32), 0, SPP - 1, 0, 16,
                           K_STRIPS, interpret=True,
                           rng_u9=jnp.stack([pad(u) for u in u9.numpy()]))
    flat = [np.asarray(o).reshape(-1)[:n] for o in out]
    f_j, i_j, b_j = (np.stack(flat[:12]), np.stack(flat[12:19]),
                     np.stack(flat[19:]))
    S.shade_strided_fetch_ref(st.fstate, st.istate, st.buf, t, idx, tabs[2],
                              cc, st.geom, 0, 0, 0, 16, u9)

    def within(a, b, tol):
        return (np.abs(a - b) <= tol * np.maximum(1.0, np.abs(b))).all(0)

    ints = (st.istate.numpy() == i_j).all(0)
    assert ints.all()
    ok = within(st.fstate.numpy(), f_j, 1e-5) & within(st.buf.numpy(), b_j,
                                                       1e-5)
    assert (~ok).sum() <= max(1, int(0.001 * n)), (~ok).sum()
    assert within(st.fstate.numpy(), f_j, 1e-4).all()
    assert within(st.buf.numpy(), b_j, 1e-4).all()


def test_wrapper_rejects_other_devices():
    # Tensors on neither the CPU nor a card raise; nothing falls back.
    _, tabs, cc, st = _strided("2_spheres", 0)
    t, idx = I.sweep_hits(tabs, st.fstate[0:6], 1e-4, "plain")
    args = (st.fstate, st.istate, st.buf, t, idx, tabs[2], cc, st.geom, 1, 0,
            0, 16)
    meta = [x.to("meta") for x in args[:6]]
    with pytest.raises(ValueError):
        S.shade_strided_step(*meta, *args[6:])


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    # K2 on the card against the plain entry, bit for bit, with injected and
    # with Philox uniforms, one launch per call.
    scene, tabs, cc, st = _strided("random_spheres", 30, device=cuda_device)
    t, idx = K.sweep(st.fstate[0:6].contiguous(), tabs[1])
    g = torch.Generator(cuda_device).manual_seed(1)
    for u in (torch.rand((9, t.shape[0]), generator=g, device=cuda_device),
              None):
        ref = [x.clone() for x in (st.fstate, st.istate, st.buf)]
        kern = [x.clone() for x in ref]
        S.shade_strided_fetch_ref(*ref, t, idx, tabs[2], cc, st.geom, 5, 30,
                                  0, 16, u)
        n = S.launches
        S.shade_strided_step(*kern, t, idx, tabs[2], cc, st.geom, 5, 30, 0, 16,
                             u)
        torch.cuda.synchronize()
        assert S.launches == n + 1
        for a, b in zip(kern, ref):
            assert torch.equal(a, b)
