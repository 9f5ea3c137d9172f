"""K7b, the per-bounce replay, after its redesign (``csrc/replay_bwd.cu``:
every load of a lane issued at once, its alive flag with them): the kept
previous kernel is the card's reference and no route's, and on the card
the new kernel gives the previous kernel's bits at every bounce of a walk.
The CPU side of K7b (its plain version against the JAX package) is in
``test_torch_fused_grad.py``."""

import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch.ops import fused_grad as FG
from raytracingweekend_jl_tpu_torch.ops.cuda import grad_kernel as GK
from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel as K
from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat
from test_torch_fused_grad import camera_rays, mixed_scene
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_previous_k7b_is_card_only_and_uncounted():
    # The kept kernel launches on CUDA tensors only (it has no plain
    # entry of its own: the plain version is replay_bwd_step_ref's), and
    # neither it nor a refused call counts a K7b launch.
    R = 16
    slot, g3, cot = (torch.zeros((GK.N_REC, R)), torch.zeros((3, R)),
                     torch.zeros((9, R)))
    before = GK.replay_step_launches
    with pytest.raises(ValueError, match="device"):
        GK.replay_bwd_step_previous(slot, g3, cot, 0, 0)
    GK.replay_bwd_step(slot, g3, cot, 0, 0)  # CPU: the plain version
    assert GK.replay_step_launches == before


@pytest.mark.cuda
def test_k7b_is_the_previous_kernel_bit_for_bit(cuda_device):
    # A 6-bounce record of the mixed scene at 256x128 rays (K3 + K7a), its
    # reverse walk by K7b and by the previous kernel, injected and Philox
    # draws: the carry after every bounce and every attribute row bit for
    # bit, a dead lane's rows +0.0 (the rows start as NaN).
    dev = cuda_device
    scene = pt.scene_from_numpy(mixed_scene(), device=dev)
    o, d, _ = camera_rays(rtw.default_camera(), 256, 128, seed=3)
    st = FG.start_state(torch.from_numpy(o).to(dev),
                        torch.from_numpy(d).to(dev))
    n = st.shape[1]
    spheres, amat = K.sphere_consts(scene), attr_mat(scene)
    rec = torch.zeros((6, GK.N_REC, n), device=dev)
    for b in range(6):
        t, idx = K.sweep_masked(st[0:6], st[12].view(torch.int32), spheres)
        GK.record_shade_step(t, idx, amat, st, rec[b], 5, b)
    g = torch.Generator(device=dev).manual_seed(2)
    g3 = torch.randn((3, n), generator=g, device=dev)
    for u5 in (torch.rand((6, 5, n), generator=g, device=dev), None):
        runs = []
        for step in (GK.replay_bwd_step, GK.replay_bwd_step_previous):
            cot = torch.zeros((9, n), device=dev)
            rows = torch.full((6, 9, n), float("nan"), device=dev)
            cots = []
            for b in reversed(range(6)):
                step(rec[b], g3, cot, 5, b, None if u5 is None else u5[b],
                     out=rows[b])
                cots.append(cot.clone())
            runs.append(torch.cat([torch.stack(cots), rows]))
        assert torch.equal(runs[0].view(torch.int32),
                           runs[1].view(torch.int32))
