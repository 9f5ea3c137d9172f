"""K11's schedule (``persist_record_fused_step``, csrc/persist_record.cu)
through its plain mirror ``persist_record_fused_compact_ref``: each block's
live lanes packed in lane order and swept by P threads (K3's split loop and
per-block rule), the winner's row read by index, K4's state machine on the
packed lanes. At every P and at the block's own P, at several live shares,
on the mixed 4-sphere scene and on the flagship's 488-sphere table, the
mirror is bit for bit the unchanged plain version
``persist_record_fused_step_ref`` on every state word, record plane and
winner; on the states test_torch_fused_step.py holds against the JAX
package's fused record step it is that plain version bit for bit too.
Card-only: the kernel bit for bit K3 + K4 and its plain version."""

import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.cuda import mega_kernel as K12
from raytracingweekend_jl_tpu_torch.ops.cuda import persist_grad_kernel as PK
from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
from test_torch_fused_step import DEPTH, S, states  # noqa: F401
from test_torch_persist_grad import mixed_scene

SEED = 0x5EED
#: The record iterations held, by table: early (every lane live), middle,
#: late (a few live lanes).
ITERATIONS = (0, 4, 10)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _phase(table: str, W: int = 64, H: int = 36, device="cpu"):
    """The fused step's record phase (S = 4 strips, depth 8) of a ``W x H``
    film through the plain K11, Philox draws: ``(strips, spheres, amat,
    {iteration: (sf, si, rad)})`` before each of :data:`ITERATIONS`."""
    if table == "mixed":
        scene, cam = pt.scene_from_numpy(mixed_scene()), pt.t_default_cam()
    else:
        scene = pt.scene_random_spheres(seed=1)
        cam = pt.t_cam1()
    scene, cam = pt.trim_scene(scene).to(device), cam.to(device)
    u, v = pt.pixel_coords(W, H, device=device)
    o, d = pt.get_rays(cam, u, v,
                       generator=torch.Generator(device=device).manual_seed(9))
    strips, sf, si, rad = PG.start_planes(o, d, S)
    spheres, amat = K.sphere_consts(scene), attr_mat(scene)
    at = {}
    Wl = sf.shape[1]
    for it in range(max(ITERATIONS) + 1):
        if it in ITERATIONS:
            at[it] = (sf.clone(), si.clone(), rad.clone())
        PK.persist_record_fused_step_ref(
            strips, sf, si, rad, torch.zeros((PK.N_REC, Wl), device=device),
            torch.zeros(Wl, dtype=torch.int32, device=device), spheres, amat,
            SEED, it, DEPTH, 1e-4)
    return strips, spheres, amat, at


@pytest.fixture(scope="module", params=["mixed", "flagship"])
def phase(request):
    return request.param, _phase(request.param)


def _run(fn, strips, spheres, amat, sf, si, rad, it, u5=None, **kw):
    out = [sf.clone(), si.clone(), rad.clone(),
           torch.full((PK.N_REC, sf.shape[1]), 7.0, device=sf.device),
           torch.full((sf.shape[1],), 9, dtype=torch.int32,
                      device=sf.device)]
    fn(strips, *out, spheres, amat, SEED, it, DEPTH, 1e-4, u5, **kw)
    return out


def _bits(x):
    return x.view(torch.int32) if x.is_floating_point() else x


@pytest.mark.parametrize("it", ITERATIONS)
def test_compact_schedule_is_the_plain_step(phase, it):
    # Tolerance: none. Every state word, radiance plane, record plane and
    # winner bit for bit, at the blocks' own P and at every P up to the
    # table's cap, Philox draws; the live share falls from 1 to a few lanes.
    name, (strips, spheres, amat, at) = phase
    sf, si, rad = at[it]
    live = int((si[2] != 0).sum())
    assert 0 < live and (it == 0) == (live == si.shape[1])
    ref = _run(PK.persist_record_fused_step_ref, strips, spheres, amat, sf,
               si, rad, it)
    cap = K.parts_cap(spheres.shape[0])
    for parts in [0] + [p for p in (1, 2, 4, 8, 16, 32) if p <= cap]:
        got = _run(PK.persist_record_fused_compact_ref, strips, spheres,
                   amat, sf, si, rad, it, parts=parts)
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b)), (name, it, parts)


@pytest.mark.parametrize("it", [0, 4, 7])
def test_compact_schedule_on_the_jax_states(states, it):  # noqa: F811
    # The states (and injected uniforms) on which test_torch_fused_step.py
    # holds the plain version against the JAX package's fused record step
    # (interpret mode): the mirror bit for bit the plain version there, at
    # the blocks' own P and at 256-lane blocks. Tolerance: none.
    st = states
    sf, si, rad, u5 = st["states"][it]
    ref = _run(PK.persist_record_fused_step_ref, st["strips"], st["spheres"],
               st["amat"], sf, si, rad, it, u5)
    for block in (PK.FUSED_THREADS, 256):
        got = _run(PK.persist_record_fused_compact_ref, st["strips"],
                   st["spheres"], st["amat"], sf, si, rad, it, u5,
                   block=block)
        for a, b in zip(got, ref):
            assert torch.equal(_bits(a), _bits(b))


def test_block_parts_rule():
    # K11's P per block is K3's rule at 128-lane blocks: the largest power
    # of two <= min(cap, 16) with live * P <= 512.
    live = torch.tensor([128, 100, 64, 33, 32, 9, 1])
    assert K12.block_parts(live, 488, PK.FUSED_THREADS).tolist() == \
        [4, 4, 8, 8, 16, 16, 16]
    assert K12.block_parts(live, 4, PK.FUSED_THREADS).tolist() == \
        [4, 4, 4, 4, 4, 4, 4]


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["mixed", "flagship"])
def test_k11_kernel_is_k3_k4_on_card(cuda_device, table):
    # K11 at iterations 0, 4 and 10 of a 256x144 film's fused record phase
    # (65 536 rays), injected and Philox draws: every state word, record
    # plane and winner bit for bit K3 + K4's (the miss lanes' attribute
    # planes zeroed: K11 stores zeros there) and the plain version's; one
    # launch counted per call.
    dev = cuda_device
    strips, spheres, amat, at = _phase(table, 256, 144, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for it, (sf, si, rad) in at.items():
        for u5 in (torch.rand((5, sf.shape[1]), generator=g, device=dev),
                   None):
            n = PK.record_fused_launches
            got = _run(PK.persist_record_fused_step, strips, spheres, amat,
                       sf, si, rad, it, u5)
            torch.cuda.synchronize()
            assert PK.record_fused_launches == n + 1
            ref = _run(PK.persist_record_fused_step_ref, strips, spheres,
                       amat, sf, si, rad, it, u5)
            k34 = [sf.clone(), si.clone(), rad.clone(),
                   torch.zeros((PK.N_REC, sf.shape[1]), device=dev), None]
            t, idx = K.sweep_masked(k34[0][0:6], k34[1][2], spheres)
            PK.persist_record_step(t, idx, amat, strips, *k34[:4], SEED, it,
                                   DEPTH, u5)
            k34[3][11:21] = torch.where(t < K.BIG, k34[3][11:21],
                                        torch.zeros_like(k34[3][11:21]))
            k34[4] = idx
            for a, b, c in zip(got, k34, ref):
                assert torch.equal(_bits(a), _bits(b))
                assert torch.equal(_bits(a), _bits(c))
