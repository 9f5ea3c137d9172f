"""K4 with its winner fetch inside: the plain entry the record loop calls
(``persist_record_fetch_ref``: the gather, then the attribute-level step)
against the gather plus ``persist_record_step_ref``, for both record widths;
the full record's attribute planes on miss lanes; a card-only check of the
kernel against the plain entry."""

import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch.ops import materials
from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
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
S, DEPTH, N_ITERS = 4, 8, 12


def _setup(name, device="cpu", W=48, H=27):
    """The scene's tables and the record phase's starting planes for the
    camera rays of a ``W x H`` film (4 strips)."""
    scene = pt.trim_scene(pt.ALL_SCENES[name](device=device))
    cam = getattr(pt, CAMS.get(name, "t_default_cam"))(device=device)
    u, v = pt.pixel_coords(W, H, device=device)
    g = torch.Generator(device=device).manual_seed(5)
    o, d = pt.get_rays(cam, u, v, generator=g)
    return K.sphere_consts(scene), attr_mat(scene), PG.start_planes(o, d, S)


def _iterations(name, n_rec, device="cpu"):
    """Yield ``(it, t, idx, amat, strips, state)`` before each of
    ``N_ITERS`` record iterations, advancing the state by the plain entry
    (Philox draws)."""
    spheres, amat, (strips, sf, si, rad) = _setup(name, device)
    W = sf.shape[1]
    for it in range(N_ITERS):
        t, idx = K.sweep_masked_ref(sf[0:6], si[2], spheres)
        yield it, t, idx, amat, strips, (sf, si, rad)
        PK.persist_record_fetch_ref(t, idx, amat, strips, sf, si, rad,
                                    torch.empty((n_rec, W), device=device),
                                    77, it, DEPTH)


def _run(step, t, idx_or_attrs, amat, strips, state, n_rec, it, u5=None):
    """One record iteration on copies of ``state``: ``(sf, si, rad, slot)``
    (the slot starts as garbage: every word is written)."""
    sf, si, rad = (x.clone() for x in state)
    slot = torch.full((n_rec, sf.shape[1]), 7.0, device=sf.device)
    table = () if amat is None else (amat,)
    step(t, idx_or_attrs, *table, strips, sf, si, rad, slot, 77, it, DEPTH,
         u5)
    return sf, si, rad, slot


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


def _same(a, b):
    return all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


@pytest.mark.parametrize("n_rec", [PK.N_REC, PK.N_REC_LEAN])
@pytest.mark.parametrize("name", sorted(pt.STATIC_SCENES))
def test_fetch_entry_is_gather_plus_step_ref(name, n_rec):
    # The record loop's plain entry is the gather followed by the
    # attribute-level step, bit for bit (state, radiance and every record
    # word), on every scene and both record widths, over the first
    # iterations (live miss lanes, dead lanes and refills all occur), with
    # Philox and with injected draws; the CPU wrapper runs it.
    seen = np.zeros(3, dtype=bool)
    rng_np = np.random.default_rng(8)
    for it, t, idx, amat, strips, state in _iterations(name, n_rec):
        live = state[1][2] != 0
        u5 = torch.from_numpy(rng_np.random((5, t.shape[0]),
                                            dtype=np.float32))
        for u in (None, u5):
            entry = _run(PK.persist_record_fetch_ref, t, idx, amat, strips,
                         state, n_rec, it, u)
            gather = _run(PK.persist_record_step_ref, t,
                          fetch_attr_planes(idx, amat), None, strips, state,
                          n_rec, it, u)
            wrapper = _run(PK.persist_record_step, t, idx, amat, strips,
                           state, n_rec, it, u)
            assert _same(entry, gather) and _same(entry, wrapper)
        flags = PK.flags_of(entry[3])
        seen |= [bool((live & (t >= K.BIG)).any()), bool((~live).any()),
                 bool(((flags & PK.F_REGEN) != 0).any())]
    assert seen.all(), seen


@pytest.mark.parametrize("name", sorted(pt.STATIC_SCENES))
def test_full_record_holds_sphere0_row_on_miss(name):
    # Planes 11-20 of the full record are the winner's row on every live
    # lane: sphere 0's row where the ray missed (the sweep's index is 0
    # there, as the gather reads it), zeros on dead lanes.
    n_miss = 0
    for it, t, idx, amat, strips, state in _iterations(name, PK.N_REC):
        live = state[1][2] != 0
        slot = _run(PK.persist_record_fetch_ref, t, idx, amat, strips, state,
                    PK.N_REC, it)[3]
        miss = live & (t >= K.BIG)
        assert torch.equal(idx[miss], torch.zeros_like(idx[miss]))
        assert torch.equal(slot[11:21][:, miss],
                           amat[0][:, None].expand(10, int(miss.sum())))
        assert torch.equal(slot[11:21][:, live], amat[idx[live].long()].T)
        assert not slot[:, ~live].any()
        n_miss += int(miss.sum())
    assert n_miss > 0


def test_record_loop_gathers_only_in_plain_entry():
    # The record phase's kernel path passes the sweep's index to K4; on the
    # CPU the plain entry gathers once per iteration and nothing else does.
    spheres, amat, (strips, sf, si, rad) = _setup("2_spheres")
    before = materials.fetch_calls
    cfg = PG._Config(seed=3, max_depth=DEPTH, tmin=1e-4, n_strips=S,
                     n_iters=5, tail_compact=None, rec_attrs=True,
                     strict=True, impl="plain", u5_fn=None, fused_step=False,
                     stats=None)
    ph = PG._run_record_phase((spheres, amat), strips, sf, si, rad, 5, 0, cfg)
    assert materials.fetch_calls - before == int((ph.counts > 0).sum())


def test_wrapper_rejects_other_devices():
    # Tensors on neither the CPU nor a card raise; nothing falls back.
    for it, t, idx, amat, strips, state in _iterations("2_spheres", 21):
        meta = [x.to("meta") for x in (t, idx, amat, strips, *state)]
        with pytest.raises(ValueError):
            _run(PK.persist_record_step, *meta[:4], meta[4:], 21, it)
        break


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    # K4 on the card against the plain entry, bit for bit, both record
    # widths, injected and Philox draws, one launch per call.
    g = torch.Generator(cuda_device).manual_seed(4)
    for n_rec in (PK.N_REC, PK.N_REC_LEAN):
        for it, t, idx, amat, strips, state in _iterations(
                "random_spheres", n_rec, cuda_device):
            for u in (torch.rand((5, t.shape[0]), generator=g,
                                 device=cuda_device), None):
                ref = _run(PK.persist_record_fetch_ref, t, idx, amat, strips,
                           state, n_rec, it, u)
                n = PK.record_launches
                got = _run(PK.persist_record_step, t, idx, amat, strips,
                           state, n_rec, it, u)
                torch.cuda.synchronize()
                assert PK.record_launches == n + 1
                assert _same(got, ref)
