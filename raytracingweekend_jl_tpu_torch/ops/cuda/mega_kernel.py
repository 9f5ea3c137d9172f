"""K12 — the megakernel, one whole pixel-pinned persistent iteration in one
launch (csrc/mega.cu) — and its plain version.

Counterpart of ``raytracingweekend_jl_tpu/ops/pallas/experimental/
mega_kernel.py`` (``_mega_kernel``, launched by ``mega_step``): the sweep
with the winner's attributes, then the pinned shade / scatter / regenerate
body of K9 (``shade_kernel.shade_and_regen_fetch``). The state is K9's:
``fstate`` float32 [12, R] (origin, direction, throughput, the pixel's
radiance sum) and ``istate`` int32 [3, R] (bounce, sample, active), both
contiguous and updated in place.

The kernel sweeps and shades only the active lanes: each block of
:data:`THREADS` lanes packs its active ones, sweeps them with K3's split
schedule (P per block from its active count) and shades the packed lanes;
an idle lane's state is left as it is, which is what the step gives it bit
for bit. :func:`mega_step_compact_ref` is the plain mirror of that
schedule, for the tests and ``chip_smoke.py``; no route runs it.

:func:`mega_step` launches the kernel on CUDA tensors and runs
:func:`mega_step_ref` on CPU tensors; nothing else.
"""

from __future__ import annotations

import torch

from ... import rng
from . import build
from .intersect_kernel import (_check_parts, _winner_rows, parts_cap,
                               sweep_fetch_ref, sweep_split_ref)
from .shade_kernel import N_FSTATE, N_PINNED_ISTATE, shade_and_regen_ref

#: Number of K12 launches since the last reset (incremented only where the
#: kernel is launched).
launches = 0

#: Lanes (and threads) per block of K12 (``RTW_MEGA_THREADS`` in
#: csrc/mega.cu).
THREADS = 128


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


def block_parts(n_active: torch.Tensor, n_spheres: int,
                block: int = THREADS) -> torch.Tensor:
    """K12's (and K3's) P per block from its active lanes ``n_active``
    [blocks]: the largest power of two <= min(:func:`parts_cap`, 16) with
    ``n_active * P <= 4 * block``, at least 1."""
    p = torch.full_like(n_active, min(parts_cap(n_spheres), 16))
    while True:
        over = (p > 1) & (n_active * p > 4 * block)
        if not bool(over.any()):
            return p
        p = torch.where(over, p // 2, p)


def mega_step_compact_ref(fstate: torch.Tensor, istate: torch.Tensor,
                          spheres: torch.Tensor, amat: torch.Tensor,
                          film_u: torch.Tensor, film_v: torch.Tensor,
                          cam: torch.Tensor, seed: int, iteration: int,
                          last_sample: int, max_depth: int, tmin: float,
                          u9: torch.Tensor | None = None,
                          block: int = THREADS, parts: int = 0) -> None:
    """Plain mirror of K12's schedule, in place (arguments as
    :func:`mega_step_ref`): each block of ``block`` lanes packs its active
    lanes (``istate[2] != 0``) in lane order and sweeps them with
    :func:`intersect_kernel.sweep_split_ref` at ``parts`` threads per lane,
    or with ``parts=0`` at the block's P (:func:`block_parts`); then the
    packed lanes read their winner's row by index (zeros on a miss), draw
    with their lane id as the Philox counter and take K9's plain step. Idle
    lanes are not touched. Bitwise :func:`mega_step_ref` wherever the step
    leaves idle lanes as they are."""
    _check_parts("mega_step_compact_ref", parts, allow_zero=True)
    n = fstate.shape[1]
    ids = torch.nonzero(istate[2] != 0)[:, 0]
    if ids.numel() == 0:
        return
    blk = ids // block
    if parts:
        p_lane = torch.full_like(ids, parts)
    else:
        n_act = torch.bincount(blk, minlength=-(-n // block))
        p_lane = block_parts(n_act, spheres.shape[0], block)[blk]
    t = torch.empty(ids.shape, dtype=fstate.dtype, device=fstate.device)
    idx = torch.empty(ids.shape, dtype=torch.int32, device=fstate.device)
    for p in torch.unique(p_lane).tolist():
        sel = p_lane == p
        t[sel], idx[sel] = sweep_split_ref(
            fstate[0:6, ids[sel]].contiguous(), spheres, p, tmin)
    u9 = (rng.philox_uniforms(seed, iteration, ids.numel(), 9,
                              device=fstate.device, lanes=ids)
          if u9 is None else u9[:, ids])
    fs, ist = fstate[:, ids], istate[:, ids]
    shade_and_regen_ref(fs, ist, t, _winner_rows(t, idx, amat), film_u[ids],
                        film_v[ids], cam, seed, iteration, last_sample,
                        max_depth, u9)
    fstate[:, ids] = fs
    istate[:, ids] = ist


def occupancy(n_spheres: int, device=None) -> dict:
    """``{"registers", "blocks_per_sm", "threads_per_block", "sm_count"}``
    of K12 on ``device`` (the current CUDA device by default), from the
    CUDA runtime, at its block size and shared memory for ``n_spheres``."""
    import ctypes
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = build.load().rtw_mega_occupancy(
            n_spheres, *(ctypes.byref(x) for x in out))
    build.check(err, "mega occupancy")
    regs, blocks, sms = (x.value for x in out)
    return {"registers": regs, "blocks_per_sm": blocks,
            "threads_per_block": THREADS, "sm_count": sms}


def mega_step(fstate: torch.Tensor, istate: torch.Tensor,
              spheres: torch.Tensor, amat: torch.Tensor,
              film_u: torch.Tensor, film_v: torch.Tensor, cam: torch.Tensor,
              seed: int, iteration: int, last_sample: int, max_depth: int,
              tmin: float, u9: torch.Tensor | None = None) -> None:
    """K12: one pinned iteration in one launch, in place (arguments as
    :func:`mega_step_ref`), each active lane swept by the P threads its
    block takes from its active lanes (:func:`block_parts`;
    :func:`mega_step_compact_ref` mirrors the schedule at every P).

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
    # the packed lane ids, winners and warp offsets take the rest
    table = 227 * 1024 - 4 * (3 * THREADS + THREADS // 32 + 1)
    if n_sph * 16 > table:
        raise ValueError(f"mega_step: {n_sph} spheres exceed the kernel's "
                         f"shared-memory table (max {table // 16})")
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
