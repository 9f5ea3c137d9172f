"""K12 — the megakernel, one whole pixel-pinned persistent iteration in one
launch (csrc/mega.cu) — and its plain version.

Counterpart of ``raytracingweekend_jl_tpu/ops/pallas/experimental/
mega_kernel.py`` (``_mega_kernel``, launched by ``mega_step``): the sweep
with the winner's attributes, then the pinned shade / scatter / regenerate
body of K9 (``shade_kernel.shade_and_regen``). The state is K9's:
``fstate`` float32 [12, R] (origin, direction, throughput, the pixel's
radiance sum) and ``istate`` int32 [3, R] (bounce, sample, active), both
contiguous and updated in place.

:func:`mega_step` launches the kernel on CUDA tensors and runs
:func:`mega_step_ref` on CPU tensors; nothing else.
"""

from __future__ import annotations

import torch

from . import build
from .intersect_kernel import sweep_fetch_ref
from .shade_kernel import N_FSTATE, N_PINNED_ISTATE, shade_and_regen_ref

#: Number of K12 launches since the last reset (incremented only where the
#: kernel is launched).
launches = 0


def mega_step_ref(fstate: torch.Tensor, istate: torch.Tensor,
                  spheres: torch.Tensor, amat: torch.Tensor,
                  film_u: torch.Tensor, film_v: torch.Tensor,
                  cam: torch.Tensor, seed: int, iteration: int,
                  last_sample: int, max_depth: int, tmin: float,
                  u9: torch.Tensor | None = None) -> None:
    """Plain PyTorch K12, in place on ``fstate``/``istate``: K1's sweep of
    the lanes' rays (``fstate[0:6]``) against ``spheres`` [N, 4]
    (``intersect_kernel.sphere_consts``) with the winners' rows of ``amat``
    [N, 10] (zeros on a miss; :func:`intersect_kernel.sweep_fetch_ref`), then
    K9's plain version (:func:`shade_kernel.shade_and_regen_ref`, which
    documents the other arguments and the draws)."""
    t, _, attrs = sweep_fetch_ref(fstate[0:6], spheres, amat, tmin)
    shade_and_regen_ref(fstate, istate, t, attrs, film_u, film_v, cam, seed,
                        iteration, last_sample, max_depth, u9)


def mega_step(fstate: torch.Tensor, istate: torch.Tensor,
              spheres: torch.Tensor, amat: torch.Tensor,
              film_u: torch.Tensor, film_v: torch.Tensor, cam: torch.Tensor,
              seed: int, iteration: int, last_sample: int, max_depth: int,
              tmin: float, u9: torch.Tensor | None = None) -> None:
    """K12: one pinned iteration in one launch, in place (arguments as
    :func:`mega_step_ref`).

    CPU tensors run :func:`mega_step_ref`. CUDA tensors launch the kernel
    on the current stream; anything it does not take raises."""
    global launches
    if fstate.device.type == "cpu":
        return mega_step_ref(fstate, istate, spheres, amat, film_u, film_v,
                             cam, seed, iteration, last_sample, max_depth,
                             tmin, u9)
    dev = fstate.device
    if dev.type != "cuda":
        raise ValueError(f"mega_step: unsupported device {dev}")
    n = fstate.shape[1] if fstate.dim() == 2 else -1
    n_sph = spheres.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, x, dtype, shape in (
            ("fstate", fstate, f32, (N_FSTATE, n)),
            ("istate", istate, i32, (N_PINNED_ISTATE, n)),
            ("spheres", spheres, f32, (n_sph, 4)),
            ("amat", amat, f32, (n_sph, 10)),
            ("film_u", film_u, f32, (n,)), ("film_v", film_v, f32, (n,)),
            ("cam", cam, f32, (21,))):
        build.check_arg(f"mega_step: {name}", x, dtype, shape, dev)
    if u9 is not None:
        build.check_arg("mega_step: u9", u9, f32, (9, n), dev)
    if n_sph * 56 > 227 * 1024:
        raise ValueError(f"mega_step: {n_sph} spheres exceed the kernel's "
                         f"shared-memory tables (max {227 * 1024 // 56})")
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.rtw_mega(
            fstate.data_ptr(), istate.data_ptr(), spheres.data_ptr(),
            amat.data_ptr(), n_sph, float(tmin), film_u.data_ptr(),
            film_v.data_ptr(), cam.data_ptr(),
            None if u9 is None else u9.data_ptr(), n, int(last_sample),
            int(max_depth), seed & 0xFFFFFFFF, iteration & 0xFFFFFFFF,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "mega_step")
    launches += 1
