"""The camera ray that K2, K9 and K12 regenerate inside a step, against the
ray the host builds for the same pixel, sample and uniforms.

A lane that starts a sample in the strided step (K2: the same pixel's next
sample, or the next pixel of its strip) or in the pixel-pinned step (K9,
and the megakernel K12, which shares its body) builds its thin-lens camera
ray as ``init_strided_state`` and ``pinned_start_rays`` build the first
ones through ``camera.make_rays``: the film point by division, the jitter
times 1/W, ``make_rays``' sums and its ``1 / sqrt`` normalisation. Every
case compares origin and direction bit for bit, over every pixel of the
film (its edges and each strip's last pixel among them), for the centred
sample 0 and a jittered sample, on the flagship camera (a lens), the
default camera and the hollow-glass camera. Then the strided route with the
JAX package's draws, rebuilt by the port's threefry, against the JAX
package's goldens. Card-only: the kernels to the same rays."""

import os

import jax
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch import rng
from raytracingweekend_jl_tpu_torch.camera import film_point
from raytracingweekend_jl_tpu_torch.ops import integrator as I
from raytracingweekend_jl_tpu_torch.ops.cuda.regen_lanes import (KINDS,
                                                                 regen_lanes)
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens",
                      "persistent_interpret_64x36_spp4.npz")

CAMS = ("t_cam1", "t_default_cam", "hollow_glass_cam")
#: 48x27: half the film is 648 lanes, 13 rows and 24 pixels, so the
#: strided switch carries a row.
W, H = 48, 27


def regen_case(kind: str, cam_name: str, sample: int, kernels: bool,
               device="cpu", w: int = W, h: int = H) -> tuple:
    """``(regenerated [6, n], host-built [6, n])`` of
    :func:`regen_lanes.regen_lanes` on ``scene_4_spheres`` and the camera
    ``cam_name``: every ray ends in a miss."""
    return regen_lanes(kind, pt.scene_4_spheres(device=device),
                       getattr(pt, cam_name)(device=device), sample, kernels,
                       w, h)


@pytest.mark.parametrize("sample", [0, 3])
@pytest.mark.parametrize("cam_name", CAMS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_regen_ray_is_make_rays(kind, cam_name, sample):
    # The plain versions of K2 (shade_strided_fetch_ref, both ways a lane
    # starts a sample), K9 (shade_and_regen_fetch_ref) and K12
    # (mega_step_ref): every word of origin and direction equal.
    got, want = regen_case(kind, cam_name, sample, kernels=False)
    assert torch.equal(got, want), (got - want).abs().max()


def test_make_rays_normalises_in_one_order():
    # make_rays' normalize sums |d|^2 as (x*x + y*y) + z*z on every device,
    # as the kernels do (PyTorch's CUDA sum of [R, 3] rows adds x*x + z*z
    # first); on the CPU that is the order of PyTorch's own sum, so it is
    # the reduction's result there, bit for bit. 1 / sqrt is rounded once:
    # the square root and the division in float64, then to float32.
    from raytracingweekend_jl_tpu_torch.ops.vecmath import (normalize,
                                                            squared_length)

    def inv(x):
        return (1.0 / torch.sqrt(x.clamp(min=1e-20).double())).float()
    d = torch.randn((4099, 3), generator=torch.Generator().manual_seed(4)) * 3
    d[7] = 0.0
    sq = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
    want = d * inv(sq)[:, None]
    assert torch.equal(normalize(d), want)
    by_sum = d * inv(squared_length(d))[:, None]
    assert torch.equal(normalize(d), by_sum)
    assert torch.equal(normalize(d)[7], torch.zeros(3))


def test_regen_film_point_is_a_division():
    # Why the film point is a division: 1/W times (px + 1) differs from
    # (px + 1) / W in the last bit on most columns of the flagship film, and
    # the regenerated ray follows the division, as init_strided_state does.
    w = 1920
    px = torch.arange(1, w + 1, dtype=torch.float32)
    inv = torch.tensor(np.float32(1) / np.float32(w))
    assert int((px * inv != px / w).sum()) > w // 2
    assert torch.equal(film_point(px, w), px / w)


@pytest.mark.parametrize("name", ["4_spheres", "diel_spheres_hollow",
                                  "random_spheres"])
def test_strided_route_with_threefry_draws_meets_goldens(name):
    # test_strided_slice_matches_goldens with the JAX path's draws rebuilt
    # by the port's threefry (rng.reference_strided_draws, bit for bit the
    # JAX hooks: test_torch_threefry.py) in place of JAX's own, through the
    # repaired regeneration: the same shares of pixels within 1e-4 of the
    # interpret-mode goldens (4_spheres and diel_spheres_hollow 0.99,
    # random_spheres 0.60) and every channel mean within 1%.
    cases = {"4_spheres": (rtw.scene_4_spheres, "t_default_cam", 0.99),
                "diel_spheres_hollow": (rtw.scene_diel_spheres_hollow,
                                        "hollow_glass_cam", 0.99),
                "random_spheres": (lambda: rtw.scene_random_spheres(seed=1),
                                   "t_cam1", 0.60)}
    scene_fn, cam_name, share = cases[name]
    w, h, spp, k = 64, 36, 4, 4
    key = rng.key_from_numpy(np.asarray(jax.random.key_data(
        jax.random.PRNGKey(0))))
    u4, u9_fn = rng.reference_strided_draws(key, w * h, k)
    out = I.persistent_render_sum_strided(
        pt.scene_from_numpy(scene_fn()), getattr(pt, cam_name)(), w * h, 0,
        spp, 0, 16, 1e-4, float(w), float(h), k=k, init_u4=u4,
        rng_u9_fn=u9_fn).numpy()
    ref = np.load(GOLDEN)[f"{name}/strided"]
    assert out.shape == ref.shape and np.isfinite(out).all()
    close = (np.abs(out - ref) <= 1e-4).all(-1)
    assert close.mean() >= share, close.mean()
    np.testing.assert_allclose(out.mean(0), ref.mean(0), rtol=0.01)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_kernel_regen_ray_is_make_rays_on_card(kind):
    # K2, K9 and K12 on the card: the regenerated rays bit for bit the rays
    # make_rays builds on the card, on every camera, at the film above and
    # at the flagship film.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cam_name in CAMS:
        for sample in (0, 3):
            for w, h in ((W, H), (1920, 1080)):
                got, want = regen_case(kind, cam_name, sample, True, "cuda",
                                       w, h)
                assert torch.equal(got, want), (kind, cam_name, sample, w)
