"""Every direction the port normalises takes one helper, ``1 / sqrt`` of
``(x*x + y*y) + z*z`` rounded once to float32 (``vecmath.inv_length``; the
kernels' ``rtw_inv_length`` in csrc/shade_core.cuh, ``__frsqrt_rn``), and
its unit length carries no bias.

The approximate reciprocal square root the card offers (``rsqrtf``) leaves
``|d|^2 - 1`` at -6.5e-9 on average; the sweep takes a direction as unit,
so a biased length shifts every hit one way, and the persistent routes,
which normalised their scatter directions so, rendered darker than the
wavefront. PyTorch's float32 square root on the CPU is not correctly
rounded either (~0.7% of inputs), which biased a float32 ``1 / sqrt``
there by +1.1e-9; rounded once from float64, the plain version gives the
IEEE bits on every device. On the CPU the source scan and the
bit-for-bit checks below pin the helper; the card phases
``inv_length_exhaustive`` and ``scatter_unit`` in chip_smoke.py measure
the kernels."""

import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.ops.vecmath import normalize as jnormalize
from raytracingweekend_jl_tpu_torch import rng
from raytracingweekend_jl_tpu_torch.ops import materials as M
from raytracingweekend_jl_tpu_torch.ops import vecmath
from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
from raytracingweekend_jl_tpu_torch.ops.cuda import scatter_lanes as SL
from raytracingweekend_jl_tpu_torch.ops.cuda import shade_kernel as SK
from raytracingweekend_jl_tpu_torch.ops.sampling import unit_sphere_directions
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "raytracingweekend_jl_tpu_torch")


def _sources(suffixes):
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(suffixes):
                path = os.path.join(d, f)
                with open(path) as fh:
                    yield os.path.relpath(path, ROOT), fh.read()


@pytest.mark.parametrize("suffixes,pattern", [
    ((".cu", ".cuh"), r"\brsqrtf?\s*\(|rtw_rsqrt"),
    ((".cu", ".cuh"), r"1\.0f\s*/\s*sqrtf"),
    ((".py",), r"torch\.rsqrt|\.rsqrt\(|\b_rsqrt\b|rtw_rsqrt"),
])
def test_no_other_reciprocal_square_root_in_the_port(suffixes, pattern):
    # Neither the approximate intrinsics (rsqrtf, rsqrt) nor the
    # twice-rounded float form is left in the kernels (the correctly
    # rounded __frsqrt_rn is the helper), and no plain version calls
    # torch.rsqrt.
    found = [(path, m.group(0)) for path, src in _sources(suffixes)
             for m in re.finditer(pattern, src)]
    assert not found, found


def test_inv_length_rounds_once():
    # Float32 in: the float64 root and division rounded once to float32,
    # bit for bit, over 40 binades; a float32 root then division differs
    # by an ulp on a quarter of them. Float64 in: the float64 expression.
    g = torch.Generator().manual_seed(3)
    x = torch.exp2(torch.rand(200_000, generator=g) * 40 - 20)
    got = vecmath.inv_length(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, (1.0 / torch.sqrt(x.double())).float())
    twice = 1.0 / torch.sqrt(x)
    assert 0.1 < (got != twice).float().mean().item() < 0.5
    assert ((got.view(torch.int32) - twice.view(torch.int32)).abs() <= 1).all()
    xd = x.double()
    assert torch.equal(vecmath.inv_length(xd), 1.0 / torch.sqrt(xd))
    tiny = torch.tensor([0.0, 1e-30], dtype=torch.float32)
    assert torch.equal(vecmath.inv_length(tiny),
                       torch.full((2,), 1e10, dtype=torch.float64).float())


def test_inv_length_is_ieee_rounded_once():
    # On every 127th non-negative float bit pattern (16.8 million, +0 to
    # +inf): the bits of numpy's IEEE float64 square root and division
    # rounded once to float32, which __frsqrt_rn (the kernels' helper)
    # gives on the card. PyTorch's float64 square root on the CPU is not
    # always correctly rounded, but never by enough to move a float32.
    bad = 0
    for start in range(0, 0x7F800001, 127 << 21):
        b = np.arange(start, min(start + (127 << 21), 0x7F800001), 127,
                      dtype=np.int64).astype(np.int32)
        f = b.view(np.float32)
        want = (1.0 / np.sqrt(np.maximum(f, np.float32(1e-20)).astype(
            np.float64))).astype(np.float32)
        got = vecmath.inv_length(torch.from_numpy(f)).numpy()
        bad += int((got.view(np.int32) != want.view(np.int32)).sum())
    assert bad == 0


def test_inv_length_bits_plain_is_inv_length():
    # The exhaustive check's wrapper on CPU tensors: the plain version on
    # the floats of the bit patterns (here a run across 1.0).
    start = 0x3F800000 - 4096
    got = SL.inv_length_bits(start, 8192, "cpu")
    x = torch.arange(start, start + 8192, dtype=torch.int32).view(
        torch.float32)
    assert torch.equal(got, vecmath.inv_length(x))


@pytest.mark.cuda
def test_kernel_inv_length_is_plain_on_card():
    # rtw_inv_length (__frsqrt_rn) on the card, bit for bit the plain
    # version on 2^26 floats around 1 and on the small and large ends.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for start in (0x3F800000 - (1 << 25), 0, 0x7F800000 - (1 << 26) + 1):
        got = SL.inv_length_bits(start, 1 << 26, "cuda")
        x = torch.arange(start, start + (1 << 26), dtype=torch.int32,
                         device="cuda").view(torch.float32)
        assert torch.equal(got.view(torch.int32),
                           vecmath.inv_length(x).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("material", sorted(SL.MATERIALS))
def test_kernel_scatter_is_plain_on_card(material):
    # K2, K9, K12 and K7a scatter the hit lanes of the flagship film alike
    # and as their plain versions do, bit for bit, unit within 1e-6.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1, device="cuda"))
    lanes = SL.film_lanes(scene, pt.t_cam1(device="cuda"), 1920, 1080)
    amat = SL.material_table(scene, material)
    hit = lanes["hit"]
    first = SL.scatter_lanes("strided", amat, lanes, True)[:, hit]
    for kind in SL.KINDS:
        got = SL.scatter_lanes(kind, amat, lanes, True)[:, hit]
        assert torch.equal(got, first), kind
        plain = SL.scatter_lanes(kind, amat, lanes, False)[:, hit]
        assert torch.equal(got, plain), kind
    assert SL.unit_length_error(first)["max_abs"] < 1e-6


def _hit_lanes(n: int, material: float, seed: int = 0):
    """``n`` lanes that each hit a unit sphere at the origin at t = 0
    (origin on the sphere, so the normal is the origin, bit for bit) from
    outside, with random directions into it and five uniforms (the coin 1:
    a dielectric always refracts): ``(u5, t, attrs, o [3, n], d [3, n])``."""
    r = np.random.default_rng(seed)
    nrm = r.standard_normal((3 * n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    d = r.standard_normal((3 * n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    into = (d * nrm).sum(1) < -0.01
    o = torch.tensor(nrm[into][:n].T, dtype=torch.float32).contiguous()
    dd = torch.tensor(d[into][:n].T, dtype=torch.float32).contiguous()
    u5 = torch.tensor(r.random((5, n)), dtype=torch.float32)
    u5[4] = 1.0
    attrs = torch.zeros((10, n), dtype=torch.float32)
    attrs[3], attrs[4:7], attrs[7], attrs[8], attrs[9] = 1.0, 0.5, 0.5, 1.5, \
        material
    return u5, torch.zeros(n), attrs, o, dd


def _shade(u5, t, attrs, o, d):
    n = t.shape[0]
    z = torch.zeros(n)
    out = SK.shade_core(u5, t, attrs, *o, *d, *torch.ones(3, n),
                        torch.ones(n, dtype=torch.bool), z, z, z)
    return torch.stack(out[8:11])


def _spy(monkeypatch, module, real_calls: int | None = None) -> list:
    """Replace ``module.inv_length`` by one that records its arguments and
    returns ones after its first ``real_calls`` calls."""
    calls = []

    def spy(x):
        calls.append(x.clone())
        if real_calls is None or len(calls) <= real_calls:
            return vecmath.inv_length(x)
        return torch.ones_like(x)
    monkeypatch.setattr(module, "inv_length", spy)
    return calls


@pytest.mark.parametrize("material", sorted(SL.MATERIALS))
def test_shade_core_directions_are_v_times_inv_length(material, monkeypatch):
    # The plain shading core (K2, K4, K7a, K9, K12) returns each
    # material's direction as v * inv_length((x*x + y*y) + z*z) of its raw
    # vector v, bit for bit: v is what the core returns with every
    # normalisation but the unit vector's made 1.
    lanes = _hit_lanes(20_000, SL.MATERIALS[material])
    _spy(monkeypatch, SK, real_calls=1)
    raw = _shade(*lanes)
    monkeypatch.undo()
    calls = _spy(monkeypatch, SK)
    got = _shade(*lanes)
    sq = (raw[0] * raw[0] + raw[1] * raw[1]) + raw[2] * raw[2]
    want = raw * vecmath.inv_length(sq)
    if material == "lambertian":
        want = torch.where(sq < 1e-5, raw, want)
    assert torch.equal(got, want)
    # The first normalisation is the unit vector's: Box-Muller's normals.
    g0, g1, g2 = SK.gauss3(*lanes[0][:4])
    assert torch.equal(calls[0], g0 * g0 + g1 * g1 + g2 * g2)
    assert len(calls) == 4


def test_adjoint_recompute_normalises_as_the_shading_core(monkeypatch):
    # bounce_adjoint (the plain K5-K7 adjoint) recomputes the forward
    # directions with the same four inv_length calls on the same sums, bit
    # for bit, then differentiates par = -sqrt|S| through inv_length of
    # |S| clamped to 1e-12.
    n = 5_000
    for material in (0.0, 1.0, 2.0):
        u5, t, attrs, o, d = _hit_lanes(n, material, seed=1)
        fwd = _spy(monkeypatch, SK)
        _shade(u5, t, attrs, o, d)
        monkeypatch.undo()
        adj = _spy(monkeypatch, GK)
        ones = torch.ones(n)
        vals = [*o, *d, ones, ones, ones, t, *attrs]
        hit = torch.ones(n, dtype=torch.bool)
        GK.bounce_adjoint(u5, vals, (ones, ones, ones), [ones] * 9, hit,
                          ~hit)
        monkeypatch.undo()
        assert len(fwd) == 4 and len(adj) == 5
        for a, b in zip(fwd, adj[:4]):
            assert torch.equal(a, b)
        assert (adj[4] >= 1e-12).all()


def test_slot_draws_and_unit_sphere_directions_take_inv_length():
    # The fixed-depth record's unit vectors (slot_draws: K7a's draws) and
    # the wavefront's (unit_sphere_directions): v * inv_length((x*x + y*y)
    # + z*z), bit for bit.
    slots = torch.arange(4096, dtype=torch.int32)
    u, _ = M.slot_draws(9, 2, slots)
    u5 = rng.philox_uniforms(9, 2, 4096, 5, lanes=slots)
    g = torch.stack(SK.gauss3(u5[0], u5[1], u5[2], u5[3]), -1)
    sq = (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]) + g[:, 2] * g[:, 2]
    assert torch.equal(u, g * vecmath.inv_length(sq)[:, None])
    got = unit_sphere_directions((4096,), torch.Generator().manual_seed(4))
    g = torch.randn((4096, 3), generator=torch.Generator().manual_seed(4))
    sq = (g[:, 0] * g[:, 0] + g[:, 1] * g[:, 1]) + g[:, 2] * g[:, 2]
    assert torch.equal(got, g * vecmath.inv_length(sq)[:, None])


def test_normalize_matches_jax_within_three_ulps():
    # The JAX package's normalize (XLA's approximate rsqrt on the CPU, its
    # own summation order) and the port's on the same vectors: within 3
    # ulps a component, and equal on over three quarters (the twice-rounded
    # form: two thirds).
    v = np.random.default_rng(6).standard_normal((100_000, 3)).astype(
        np.float32) * 3
    want = np.asarray(jax.jit(jnormalize)(jnp.asarray(v)))
    got = vecmath.normalize(torch.from_numpy(v)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 3
    assert (ulps == 0).mean() > 0.75


@pytest.fixture(scope="module")
def film():
    # About 10^6 lanes: the flagship scene's camera rays at 1280x800.
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    lanes = SL.film_lanes(scene, pt.t_cam1(), 1280, 800)
    torch.set_num_threads(n)
    return scene, lanes


def test_plain_unit_vectors_have_unbiased_length(film):
    # The shading core's unit vectors over 1 024 000 lanes and the
    # wavefront's: mean |u|^2 - 1 within 1e-9 (the card's rsqrtf gives
    # about -6.5e-9, the CPU's float32 torch.sqrt then division +1.1e-9).
    _, lanes = film
    for u in (SL.unit_vectors(lanes["u9"]),
              unit_sphere_directions((1_024_000,),
                                     torch.Generator().manual_seed(8)).T):
        e = SL.unit_length_error(u)
        assert abs(e["mean"]) <= 1e-9, e


@pytest.mark.parametrize("material", sorted(SL.MATERIALS))
def test_plain_scatter_directions_have_unbiased_length(film, material):
    # The plain K2 step's scatter directions over the hit lanes of 1 024
    # 000 camera rays, every sphere made `material`: bit for bit the
    # wavefront's scatter (materials.scatter) of the same hits and draws;
    # mean |d|^2 - 1 within 1e-9 for the Lambertian and metal directions.
    # A refracted direction is unit before it is normalised, and a float32
    # scale near 1 rounds up more than down (the grid is twice as fine
    # below 1), so it keeps a floor of a few 1e-9, the wavefront's alike.
    scene, lanes = film
    amat = SL.material_table(scene, material)
    hit = lanes["hit"]
    d = SL.scatter_lanes("strided", amat, lanes, kernels=False)[:, hit]
    assert torch.equal(d, SL.wavefront_scatter(amat, lanes)[:, hit])
    e = SL.unit_length_error(d)
    assert e["lanes"] > 800_000
    assert abs(e["mean"]) <= (1e-9 if material != "dielectric" else 5e-9), e


@pytest.mark.parametrize("material", sorted(SL.MATERIALS))
def test_plain_steps_scatter_alike(material):
    # The four steps the card phase reads (K2, K9, K12, K7a; plain
    # versions) give the hit lanes of a film the same directions, bit for
    # bit, and leave them unit within 1e-6.
    scene = pt.scene_4_spheres()
    lanes = SL.film_lanes(scene, pt.t_default_cam(), 64, 36)
    amat = SL.material_table(scene, material)
    hit = lanes["hit"]
    assert 1000 < int(hit.sum()) < 64 * 36
    outs = [SL.scatter_lanes(k, amat, lanes, kernels=False)[:, hit]
            for k in SL.KINDS]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    assert SL.unit_length_error(outs[0])["max_abs"] < 1e-6
