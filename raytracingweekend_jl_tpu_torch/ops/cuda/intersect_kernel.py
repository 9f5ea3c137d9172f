"""K1 — the closest-hit sphere sweep —, K3 — its occupancy-masked form —
and K10 — the sweep fused with the winner's attribute fetch — (csrc/sweep.cu)
with their plain versions and the differentiable sweeps of the fixed-depth
wavefront.

Counterparts of ``raytracingweekend_jl_tpu/ops/pallas/intersect_kernel.py``
``_sweep_kernel``, ``_sweep_masked_kernel`` and ``_sweep_fetch_kernel``.
:func:`sweep`, :func:`sweep_masked` and :func:`sweep_fetch` launch the CUDA
kernels on CUDA tensors and run :func:`sweep_ref`, :func:`sweep_masked_ref`
and :func:`sweep_fetch_ref` on CPU tensors; nothing else.
:func:`sweep_into` launches K1 into outputs the caller keeps (the strided
loop's captured chunk).

K1, K3 and K10 split each ray's sweep over a group of P threads of one
warp and merge the parts on the lexicographic minimum of ``(t, idx)``,
which gives the one-thread loop's result bit for bit
(``csrc/sweep_core.cuh``). K1 and K10 take P from the ray count
(:func:`sweep_parts`), K3 per block from its live lanes; K10 then reads the
winner's row of the ``[N, 10]`` table by index. :func:`sweep_split_ref` and
:func:`sweep_fetch_split_ref` are the plain mirrors of those schedules, and
:func:`sweep_fetch_one_thread` launches the previous K10 (one thread per
ray), the independent reference the card checks hold the split kernels
against; no route runs any of the three.

K1m (``sweep_motion_kernel`` in csrc/sweep.cu) is K1 for a moving scene (book 2's motion blur;
no TPU kernel had a time): each ray carries a shutter time and each pair
moves its sphere to ``c0 + time * m`` and forms ``|c|^2 - r^2`` from it,
over the ``[N, 8]`` table of :func:`motion_sphere_table`, with K1's split
and merge. :func:`sweep_motion` and :func:`sweep_motion_into` launch it,
:func:`sweep_motion_ref` is its plain version; the strided route of a
``MovingScene`` is its only caller.

:func:`intersect_spheres_kernel` and :func:`intersect_fetch_kernel` (the
reference's ``intersect_spheres_pallas`` and ``intersect_fetch_pallas``)
wrap K1 and K10 in ``torch.autograd.Function`` s whose backward is the
reference's implicit differentiation at the winner (``_sweep_bwd``,
``_sweep_fetch_bwd``): plain PyTorch, as the reference's backward is XLA
code, with every sum onto the sphere rows through the ordered contraction
(``grad_kernel.dattr_contract``).
"""

from __future__ import annotations

import torch

from ...scene import Scene
from ..intersect import DEFAULT_TMIN, BIG, HitResult
from ..materials import attr_mat
from . import build
from .grad_kernel import dattr_contract

#: Number of K1 launches since the last reset (incremented only where the
#: kernel is launched).
launches = 0

#: Number of K3 launches since the last reset.
masked_launches = 0

#: Number of K10 launches since the last reset.
fetch_launches = 0

#: Number of K1m launches since the last reset.
motion_launches = 0

#: Threads per block of K1, K1m, K3 and K10 (``RTW_SWEEP_THREADS`` in
#: csrc/sweep.cu), and K3's lanes per block.
SWEEP_THREADS = 256

#: Threads per block of the one-thread reference kernel.
ONE_THREAD_THREADS = 128

#: The kernels of :func:`occupancy`.
OCCUPANCY_KERNELS = {"sweep": 0, "sweep_masked": 1, "sweep_fetch": 2,
                     "sweep_fetch_one_thread": 3, "sweep_motion": 4}


def sphere_consts(scene: Scene) -> torch.Tensor:
    """``[N, 4]`` float32 rows ``(cx, cy, cz, |c|^2 - r^2)``: the sphere
    table both sweeps read."""
    c = scene.center.to(torch.float32)
    r = scene.radius.to(torch.float32)
    ck = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - r * r
    return torch.stack([c[:, 0], c[:, 1], c[:, 2], ck], dim=1).contiguous()


def motion_sphere_table(scene) -> torch.Tensor:
    """``[N, 8]`` float32 rows ``(c0x, c0y, c0z, r^2, mx, my, mz, 0)`` of a
    :class:`~raytracingweekend_jl_tpu_torch.scene.MovingScene`: the table
    K1m reads, two float4 a sphere."""
    c = scene.center.to(torch.float32)
    r = scene.radius.to(torch.float32)
    m = scene.motion.to(torch.float32)
    return torch.cat([c, (r * r)[:, None], m, torch.zeros_like(r)[:, None]],
                     dim=1).contiguous()


def _sweep_pairs(rays: torch.Tensor, n: int, sphere, tmin: float) -> tuple:
    """``(t [R], idx [R] i32)`` of ``rays`` [6, R] over spheres ``0 ..
    n-1``, ``sphere(s)`` giving sphere ``s``'s ``(cx, cy, cz, ck)`` (scalars
    or [R] planes): the TPU kernel's expanded form, one sphere at a time
    with a running ``(best_t, best_idx)`` updated only on a strict ``t <
    best_t``."""
    ox, oy, oz, dx, dy, dz = rays
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    best_t = torch.full_like(ox, BIG)
    best_i = torch.zeros(ox.shape, dtype=torch.int32, device=ox.device)
    for s in range(n):
        cx, cy, cz, ck = sphere(s)
        cd = cx * dx + cy * dy + cz * dz
        oc = cx * ox + cy * oy + cz * oz
        hb = od - cd
        c = oo - 2.0 * oc + ck
        disc = hb * hb - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = -hb - sq
        t = torch.where(r1 >= tmin, r1, -hb + sq)
        ok = (disc > 0) & (t >= tmin) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, torch.full_like(best_i, s), best_i)
    return best_t, best_i


def sweep_ref(rays: torch.Tensor, spheres: torch.Tensor,
              tmin: float = DEFAULT_TMIN) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1: ``rays`` [6, R] planes (o.xyz, d.xyz), ``spheres``
    [N, 4] from :func:`sphere_consts`. Returns ``(t [R] f32, idx [R] i32)``
    (:func:`_sweep_pairs`)."""
    return _sweep_pairs(rays, spheres.shape[0], lambda s: spheres[s], tmin)


def sweep_motion_ref(rays: torch.Tensor, times: torch.Tensor,
                     spheres: torch.Tensor, tmin: float = DEFAULT_TMIN
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K1m: ``rays`` [6, R], their shutter ``times`` [R],
    ``spheres`` [N, 8] from :func:`motion_sphere_table`. Each pair moves
    the centre to ``c0 + time * m`` and forms ``|c|^2 - r^2`` from it, in
    the kernel's order, then :func:`sweep_ref`'s test. Returns ``(t [R]
    f32, idx [R] i32)``."""
    def sphere(s):
        c0x, c0y, c0z, r2, mx, my, mz, _ = spheres[s]
        cx = c0x + times * mx
        cy = c0y + times * my
        cz = c0z + times * mz
        return cx, cy, cz, cx * cx + cy * cy + cz * cz - r2
    return _sweep_pairs(rays, spheres.shape[0], sphere, tmin)


def sweep_masked_ref(rays: torch.Tensor, alive: torch.Tensor,
                     spheres: torch.Tensor, tmin: float = DEFAULT_TMIN
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K3: :func:`sweep_ref` with dead lanes (``alive`` [R]
    int32 == 0) set to the miss values ``(BIG, 0)``."""
    t, idx = sweep_ref(rays, spheres, tmin)
    live = alive != 0
    return (torch.where(live, t, torch.full_like(t, BIG)),
            torch.where(live, idx, torch.zeros_like(idx)))


def parts_cap(n_spheres: int) -> int:
    """The most parts a ray's sweep is split into: the largest power of two
    <= min(32, ``n_spheres``), so that every part has a sphere."""
    p = 1
    while p < 32 and 2 * p <= n_spheres:
        p *= 2
    return p


def sweep_parts(n_rays: int, n_spheres: int, resident_threads: int) -> int:
    """K1's P: the largest power of two up to :func:`parts_cap` with
    ``n_rays * P`` threads within ``resident_threads``, the threads the
    card holds at once (at least 1). On an H100 (132 SMs x 2 048 threads):
    8 at the flagship's 32 400 lanes, 1 at 262 144 rays and more."""
    p, cap = 1, parts_cap(n_spheres)
    while p < cap and n_rays * 2 * p <= resident_threads:
        p *= 2
    return p


def _check_parts(what: str, parts, allow_zero: bool = False) -> None:
    ok = isinstance(parts, int) and (
        (allow_zero and parts == 0)
        or (1 <= parts <= 32 and parts & (parts - 1) == 0))
    if not ok:
        raise ValueError(f"{what}: parts must be a power of two in [1, 32], "
                         f"got {parts!r}")


def sweep_split_ref(rays: torch.Tensor, spheres: torch.Tensor, parts: int,
                    tmin: float = DEFAULT_TMIN,
                    alive: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain mirror of K1's and K3's schedule: part ``p`` of ``parts`` (a
    power of two <= 32) sweeps spheres ``s == p (mod parts)`` with
    :func:`sweep_ref`'s expressions, and the parts merge pairwise, as the
    kernels' ``__shfl_xor_sync`` butterfly does, on the lexicographic
    minimum of ``(t, idx)``. With ``alive`` [R] int32, only the live lanes
    are swept, packed in lane order, and dead lanes get ``(BIG, 0)``.
    Bitwise :func:`sweep_ref` (:func:`sweep_masked_ref` with ``alive``).
    For the tests and ``chip_smoke.py``; no route runs it."""
    _check_parts("sweep_split_ref", parts)
    live = None if alive is None else torch.nonzero(alive != 0)[:, 0]
    ox, oy, oz, dx, dy, dz = rays if live is None else rays[:, live]
    od = ox * dx + oy * dy + oz * dz
    oo = ox * ox + oy * oy + oz * oz
    n = spheres.shape[0]
    part = torch.arange(parts, device=rays.device)
    best_t = torch.full((parts,) + ox.shape, BIG, dtype=ox.dtype,
                        device=ox.device)
    best_i = torch.zeros(best_t.shape, dtype=torch.int32, device=ox.device)
    for k in range(0, n, parts):  # sphere k + p for every part p at once
        s = k + part
        real = (s < n)[:, None]
        cx, cy, cz, ck = spheres[s.clamp(max=n - 1)].T[:, :, None]
        cd = cx * dx + cy * dy + cz * dz
        oc = cx * ox + cy * oy + cz * oz
        hb = od - cd
        c = oo - 2.0 * oc + ck
        disc = hb * hb - c
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        r1 = -hb - sq
        t = torch.where(r1 >= tmin, r1, -hb + sq)
        ok = real & (disc > 0) & (t >= tmin) & (t < best_t)
        best_t = torch.where(ok, t, best_t)
        best_i = torch.where(ok, s.to(torch.int32)[:, None], best_i)
    off = parts // 2
    while off:  # the butterfly: part p takes the smaller of p and p ^ off
        to, io = best_t[part ^ off], best_i[part ^ off]
        take = (to < best_t) | ((to == best_t) & (io < best_i))
        best_t = torch.where(take, to, best_t)
        best_i = torch.where(take, io, best_i)
        off //= 2
    if live is None:
        return best_t[0], best_i[0]
    t = torch.full((rays.shape[1],), BIG, dtype=rays.dtype, device=rays.device)
    idx = torch.zeros(rays.shape[1], dtype=torch.int32, device=rays.device)
    t[live], idx[live] = best_t[0], best_i[0]
    return t, idx


_RESIDENT = {}


def occupancy(kernel: str, n_spheres: int, device) -> dict:
    """``{"registers", "blocks_per_sm", "threads_per_block", "sm_count"}``
    of a sweep kernel (a key of :data:`OCCUPANCY_KERNELS`) on ``device``,
    from the CUDA runtime, at the launch's block size and shared memory for
    ``n_spheres`` spheres."""
    import ctypes
    out = [ctypes.c_int(0) for _ in range(3)]
    lib = build.load()
    with torch.cuda.device(device):
        err = lib.rtw_sweep_occupancy(OCCUPANCY_KERNELS[kernel], n_spheres,
                                      *(ctypes.byref(x) for x in out))
    build.check(err, "sweep occupancy")
    regs, blocks, sms = (x.value for x in out)
    return {"registers": regs, "blocks_per_sm": blocks,
            "threads_per_block": ONE_THREAD_THREADS
            if kernel == "sweep_fetch_one_thread" else SWEEP_THREADS,
            "sm_count": sms}


def _resident_threads(device, n_spheres: int, kernel: str = "sweep") -> int:
    """The threads of K1 (or ``kernel``: K10, K1m) that ``device`` holds at
    once (cached)."""
    key = (torch.device(device).index, n_spheres, kernel)
    if key not in _RESIDENT:
        o = occupancy(kernel, n_spheres, device)
        _RESIDENT[key] = o["blocks_per_sm"] * SWEEP_THREADS * o["sm_count"]
    return _RESIDENT[key]


def _check_sweep_args(what, rays, spheres, alive=None):
    if not (rays.is_cuda and spheres.device == rays.device):
        raise ValueError(f"{what}: rays on {rays.device}, spheres on "
                         f"{spheres.device}; both must be on one CUDA device")
    if rays.dtype != torch.float32 or spheres.dtype != torch.float32:
        raise TypeError(f"{what}: the CUDA kernel takes float32 only, got "
                        f"{rays.dtype} and {spheres.dtype}")
    if rays.dim() != 2 or rays.shape[0] != 6 or spheres.dim() != 2 \
            or spheres.shape[1] != 4:
        raise ValueError(f"{what}: rays must be [6, R] and spheres [N, 4], "
                         f"got {tuple(rays.shape)} and "
                         f"{tuple(spheres.shape)}")
    if not (rays.is_contiguous() and spheres.is_contiguous()):
        raise ValueError(f"{what}: rays and spheres must be contiguous")
    if alive is not None and (alive.device != rays.device
                              or alive.dtype != torch.int32
                              or tuple(alive.shape) != (rays.shape[1],)
                              or not alive.is_contiguous()):
        raise ValueError(f"{what}: alive must be a contiguous int32 [R] "
                         f"tensor on {rays.device}, got {alive.dtype} "
                         f"{tuple(alive.shape)} on {alive.device}")
    # K3 also keeps its live lane ids and warp offsets there (1 060 bytes)
    table = 227 * 1024 - (0 if alive is None else 4 * (SWEEP_THREADS + 9))
    if spheres.shape[0] * 16 > table:
        raise ValueError(f"{what}: {spheres.shape[0]} spheres exceed the "
                         f"kernel's shared-memory table (max {table // 16})")


def sweep(rays: torch.Tensor, spheres: torch.Tensor,
          tmin: float = DEFAULT_TMIN, parts: int | None = None
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1: closest hit of ``rays`` [6, R] against ``spheres`` [N, 4], each
    ray swept by ``parts`` threads (a power of two <= 32; by default
    :func:`sweep_parts` for this card). Every P gives the same result.

    CPU tensors run :func:`sweep_ref`. CUDA tensors launch the kernel on the
    current stream; anything the kernel does not take raises."""
    global launches
    if parts is not None:
        _check_parts("sweep", parts)
    if rays.device.type == "cpu" and spheres.device.type == "cpu":
        return sweep_ref(rays, spheres, tmin)
    _check_sweep_args("sweep", rays, spheres)
    n_rays, n_sph = rays.shape[1], spheres.shape[0]
    t = torch.empty(n_rays, dtype=torch.float32, device=rays.device)
    idx = torch.empty(n_rays, dtype=torch.int32, device=rays.device)
    _launch_sweep(rays, spheres, tmin, parts, t, idx)
    launches += 1
    return t, idx


def sweep_into(rays: torch.Tensor, spheres: torch.Tensor, t: torch.Tensor,
               idx: torch.Tensor, tmin: float = DEFAULT_TMIN,
               parts: int | None = None) -> None:
    """K1 as :func:`sweep`, on CUDA tensors, writing ``t`` [R] float32 and
    ``idx`` [R] int32 in place: the sweep of the strided loop's captured
    chunk, whose outputs keep their addresses. Not counted in
    :data:`launches`: the loop counts its chunk's replays."""
    if parts is not None:
        _check_parts("sweep_into", parts)
    _check_sweep_args("sweep_into", rays, spheres)
    n_rays = rays.shape[1]
    build.check_arg("sweep_into: t", t, torch.float32, (n_rays,), rays.device)
    build.check_arg("sweep_into: idx", idx, torch.int32, (n_rays,),
                    rays.device)
    _launch_sweep(rays, spheres, tmin, parts, t, idx)


def sweep_motion(rays: torch.Tensor, times: torch.Tensor,
                 spheres: torch.Tensor, tmin: float = DEFAULT_TMIN,
                 parts: int | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """K1m: closest hit of ``rays`` [6, R] at their shutter ``times`` [R]
    against the moving table ``spheres`` [N, 8], each ray swept by
    ``parts`` threads (by default :func:`sweep_parts` for K1m on this
    card). Every P gives the same result.

    CPU tensors run :func:`sweep_motion_ref`. CUDA tensors launch the
    kernel on the current stream, counted in :data:`motion_launches`;
    anything it does not take raises."""
    global motion_launches
    if rays.device.type == "cpu":
        return sweep_motion_ref(rays, times, spheres, tmin)
    t = torch.empty(rays.shape[1], dtype=torch.float32, device=rays.device)
    idx = torch.empty(rays.shape[1], dtype=torch.int32, device=rays.device)
    sweep_motion_into(rays, times, spheres, t, idx, tmin, parts)
    motion_launches += 1
    return t, idx


def sweep_motion_into(rays: torch.Tensor, times: torch.Tensor,
                      spheres: torch.Tensor, t: torch.Tensor,
                      idx: torch.Tensor, tmin: float = DEFAULT_TMIN,
                      parts: int | None = None) -> None:
    """K1m as :func:`sweep_motion`, on CUDA tensors, writing ``t`` and
    ``idx`` in place (the strided loop's captured chunk); not counted."""
    if parts is not None:
        _check_parts("sweep_motion", parts)
    dev = rays.device
    if dev.type != "cuda":
        raise ValueError(f"sweep_motion: unsupported device {dev}")
    n_rays, n_sph = (rays.shape[1] if rays.dim() == 2 else -1,
                     spheres.shape[0] if spheres.dim() == 2 else -1)
    f32 = torch.float32
    build.check_arg("sweep_motion: rays", rays, f32, (6, n_rays), dev)
    build.check_arg("sweep_motion: times", times, f32, (n_rays,), dev)
    build.check_arg("sweep_motion: spheres", spheres, f32, (n_sph, 8), dev)
    build.check_arg("sweep_motion: t", t, f32, (n_rays,), dev)
    build.check_arg("sweep_motion: idx", idx, torch.int32, (n_rays,), dev)
    if n_sph * 32 > 227 * 1024:
        raise ValueError(f"sweep_motion: {n_sph} spheres exceed the "
                         "kernel's shared-memory table (max 7264)")
    if parts is None:
        parts = sweep_parts(n_rays, n_sph,
                            _resident_threads(dev, n_sph, "sweep_motion"))
    with torch.cuda.device(dev):
        err = build.load().rtw_sweep_motion(
            rays.data_ptr(), times.data_ptr(), spheres.data_ptr(), n_rays,
            n_sph, float(tmin), t.data_ptr(), idx.data_ptr(), parts,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep_motion")


def _launch_sweep(rays, spheres, tmin, parts, t, idx) -> None:
    n_rays, n_sph = rays.shape[1], spheres.shape[0]
    if parts is None:
        parts = sweep_parts(n_rays, n_sph,
                            _resident_threads(rays.device, n_sph))
    lib = build.load()
    with torch.cuda.device(rays.device):  # the launch uses the current device
        err = lib.rtw_sweep(rays.data_ptr(), spheres.data_ptr(), n_rays, n_sph,
                            float(tmin), t.data_ptr(), idx.data_ptr(), parts,
                            torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep")


def sweep_masked(rays: torch.Tensor, alive: torch.Tensor,
                 spheres: torch.Tensor, tmin: float = DEFAULT_TMIN,
                 parts: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """K3: :func:`sweep` of the lanes whose ``alive`` [R] int32 is non-zero;
    dead lanes get ``(BIG, 0)``. Each block packs the live lanes of its 256
    lanes and sweeps them with ``parts`` threads per ray, or with
    ``parts=0`` the most, up to 16, that take at most 4 rounds of its 256
    threads.

    CPU tensors run :func:`sweep_masked_ref`. CUDA tensors launch the kernel
    on the current stream; anything the kernel does not take raises."""
    global masked_launches
    _check_parts("sweep_masked", parts, allow_zero=True)
    if rays.device.type == "cpu" and spheres.device.type == "cpu" \
            and alive.device.type == "cpu":
        return sweep_masked_ref(rays, alive, spheres, tmin)
    _check_sweep_args("sweep_masked", rays, spheres, alive)
    n_rays, n_sph = rays.shape[1], spheres.shape[0]
    t = torch.empty(n_rays, dtype=torch.float32, device=rays.device)
    idx = torch.empty(n_rays, dtype=torch.int32, device=rays.device)
    lib = build.load()
    with torch.cuda.device(rays.device):
        err = lib.rtw_sweep_masked(
            rays.data_ptr(), alive.data_ptr(), spheres.data_ptr(), n_rays,
            n_sph, float(tmin), t.data_ptr(), idx.data_ptr(), parts,
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep_masked")
    masked_launches += 1
    return t, idx


def sweep_fetch_ref(rays: torch.Tensor, spheres: torch.Tensor,
                    amat: torch.Tensor, tmin: float = DEFAULT_TMIN
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch K10: :func:`sweep_ref`, then the winner's row of
    ``amat`` [N, 10] (``materials.attr_mat``) as ``[10, R]`` planes, zeros
    on a miss (the kernel's raw outputs; the wrappers apply the miss
    defaults)."""
    t, idx = sweep_ref(rays, spheres, tmin)
    return t, idx, _winner_rows(t, idx, amat)


def _winner_rows(t, idx, amat):
    rows = amat.T[:, idx.long()]
    return torch.where(t < BIG, rows, torch.zeros_like(rows))


def sweep_fetch_split_ref(rays: torch.Tensor, spheres: torch.Tensor,
                          amat: torch.Tensor, parts: int,
                          tmin: float = DEFAULT_TMIN
                          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain mirror of K10's schedule: :func:`sweep_split_ref` with
    ``parts`` threads per ray, then the winner's row of ``amat`` read by
    index, zeros on a miss. Bitwise :func:`sweep_fetch_ref`. For the tests
    and ``chip_smoke.py``; no route runs it."""
    t, idx = sweep_split_ref(rays, spheres, parts, tmin)
    return t, idx, _winner_rows(t, idx, amat)


def _check_fetch_args(what, rays, spheres, amat):
    _check_sweep_args(what, rays, spheres)
    build.check_arg(f"{what}: amat", amat, torch.float32,
                    (spheres.shape[0], 10), rays.device)


def _fetch_outputs(rays):
    n_rays, dev = rays.shape[1], rays.device
    return (torch.empty(n_rays, dtype=torch.float32, device=dev),
            torch.empty(n_rays, dtype=torch.int32, device=dev),
            torch.empty((10, n_rays), dtype=torch.float32, device=dev))


def sweep_fetch(rays: torch.Tensor, spheres: torch.Tensor, amat: torch.Tensor,
                tmin: float = DEFAULT_TMIN, parts: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K10: :func:`sweep` of ``rays`` [6, R] against ``spheres`` [N, 4],
    each ray swept by ``parts`` threads (a power of two <= 32; by default
    :func:`sweep_parts` for this card), plus the winner's 10 attributes
    ``[10, R]`` read by index from ``amat`` [N, 10] (zeros on a miss). Every
    P gives the same result.

    CPU tensors run :func:`sweep_fetch_ref`. CUDA tensors launch the kernel
    on the current stream; anything the kernel does not take raises."""
    global fetch_launches
    if parts is not None:
        _check_parts("sweep_fetch", parts)
    if rays.device.type == "cpu" and spheres.device.type == "cpu" \
            and amat.device.type == "cpu":
        return sweep_fetch_ref(rays, spheres, amat, tmin)
    _check_fetch_args("sweep_fetch", rays, spheres, amat)
    n_rays, n_sph = rays.shape[1], spheres.shape[0]
    if parts is None:
        parts = sweep_parts(n_rays, n_sph, _resident_threads(
            rays.device, n_sph, "sweep_fetch"))
    t, idx, attrs = _fetch_outputs(rays)
    lib = build.load()
    with torch.cuda.device(rays.device):
        err = lib.rtw_sweep_fetch(
            rays.data_ptr(), spheres.data_ptr(), amat.data_ptr(), n_rays,
            n_sph, float(tmin), t.data_ptr(), idx.data_ptr(), attrs.data_ptr(),
            parts, torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep_fetch")
    fetch_launches += 1
    return t, idx, attrs


def sweep_fetch_one_thread(rays: torch.Tensor, spheres: torch.Tensor,
                           amat: torch.Tensor, tmin: float = DEFAULT_TMIN
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The previous K10 (``sweep_fetch_one_thread_kernel``): one thread per
    ray through the one-thread loop, both tables staged in shared memory.
    The independent reference that the card checks hold K1, K3, K10 and
    K12's sweep against bit for bit; no route runs it, and its launches are
    not counted.

    CPU tensors run :func:`sweep_fetch_ref`. CUDA tensors launch the kernel
    on the current stream; anything the kernel does not take raises."""
    if rays.device.type == "cpu" and spheres.device.type == "cpu" \
            and amat.device.type == "cpu":
        return sweep_fetch_ref(rays, spheres, amat, tmin)
    _check_fetch_args("sweep_fetch_one_thread", rays, spheres, amat)
    n_rays, n_sph = rays.shape[1], spheres.shape[0]
    if n_sph * 56 > 227 * 1024:
        raise ValueError(f"sweep_fetch_one_thread: {n_sph} spheres exceed "
                         f"the kernel's shared-memory tables (max "
                         f"{227 * 1024 // 56})")
    t, idx, attrs = _fetch_outputs(rays)
    lib = build.load()
    with torch.cuda.device(rays.device):
        err = lib.rtw_sweep_fetch_one_thread(
            rays.data_ptr(), spheres.data_ptr(), amat.data_ptr(), n_rays,
            n_sph, float(tmin), t.data_ptr(), idx.data_ptr(), attrs.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    build.check(err, "sweep_fetch_one_thread")
    return t, idx, attrs


# ---------------------------------------------------------------------------
# The differentiable sweeps (K1 and K10 with the reference's VJPs)
# ---------------------------------------------------------------------------

def _rays6(origin: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    return torch.cat([origin.T, direction.T]).to(torch.float32).contiguous()


def _winner_scale(origin, direction, center, t, idx, g_t):
    """The implicit derivative at the winner (``_sweep_bwd``): ``p = o +
    t d - c`` and ``scale = g_t / (p . d)`` on hits with ``|p . d| >
    1e-12``, else 0; ``t_safe`` is t on hits, else 0."""
    hit = t < BIG
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    p = origin + t_safe[:, None] * direction - center[idx.long()]
    pd = (p * direction).sum(-1)
    ok = hit & (pd.abs() > 1e-12)
    denom = torch.where(ok, pd, torch.ones_like(pd))
    scale = torch.where(ok, g_t / denom, torch.zeros_like(pd))
    return hit, t_safe, p, scale


class _Sweep(torch.autograd.Function):
    """K1 (or ``sweep_ref``) forward, or K3 (``sweep_masked_ref``) when the
    live lanes ``alive`` are given; the reference's ``_sweep_bwd``."""

    @staticmethod
    def forward(ctx, origin, direction, center, radius, tmin, plain, alive):
        spheres = sphere_consts(Scene(center, radius, None, None, None, None))
        rays = _rays6(origin, direction)
        if alive is None:
            t, idx = (sweep_ref if plain else sweep)(rays, spheres, tmin)
        else:
            run = sweep_masked_ref if plain else sweep_masked
            t, idx = run(rays, alive.to(torch.int32).contiguous(), spheres,
                         tmin)
        ctx.save_for_backward(origin, direction, center, radius, t, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx

    @staticmethod
    def backward(ctx, g_t, _g_idx):
        origin, direction, center, radius, t, idx = ctx.saved_tensors
        g_t = g_t.to(origin.dtype)
        _, t_safe, p, scale = _winner_scale(origin, direction, center, t, idx,
                                            g_t)
        rows = torch.cat([scale[:, None] * p,
                          (scale * radius[idx.long()])[:, None]], 1)
        d_sph = dattr_contract(rows.T.unsqueeze(0), idx.unsqueeze(0),
                               center.shape[0])
        return (-scale[:, None] * p, -(scale * t_safe)[:, None] * p,
                d_sph[:, 0:3], d_sph[:, 3], None, None, None)


class _SweepFetch(torch.autograd.Function):
    """K10 (or ``sweep_fetch_ref``) forward; the reference's
    ``_sweep_fetch_bwd``: the implicit derivative at the winner plus the
    attribute planes' cotangents, masked to hits, summed onto the winner's
    rows."""

    @staticmethod
    def forward(ctx, origin, direction, center, radius, albedo, fuzz, ir, mat,
                tmin, plain):
        scene = Scene(center, radius, albedo, fuzz, ir, mat)
        run = sweep_fetch_ref if plain else sweep_fetch
        t, idx, attrs = run(_rays6(origin, direction), sphere_consts(scene),
                            attr_mat(scene), tmin)
        ctx.save_for_backward(origin, direction, center, radius, t, idx)
        ctx.mark_non_differentiable(idx)
        return t, idx, attrs

    @staticmethod
    def backward(ctx, g_t, _g_idx, g_attrs):
        origin, direction, center, radius, t, idx = ctx.saved_tensors
        dt = origin.dtype
        g_t = g_t.to(dt)
        hit, t_safe, p, scale = _winner_scale(origin, direction, center, t,
                                              idx, g_t)
        m = hit.to(dt)
        g = g_attrs.to(dt) * m  # [10, R]; mat (row 9) gets none
        rows = torch.cat([g[0:3] + (scale[:, None] * p).T,
                          (g[3] + scale * radius[idx.long()])[None], g[4:9]])
        d_sph = dattr_contract(rows.unsqueeze(0), idx.unsqueeze(0),
                               center.shape[0])
        return (-scale[:, None] * p, -(scale * t_safe)[:, None] * p,
                d_sph[:, 0:3], d_sph[:, 3], d_sph[:, 4:7], d_sph[:, 7],
                d_sph[:, 8], None, None, None)


def intersect_spheres_kernel(origin: torch.Tensor, direction: torch.Tensor,
                             scene: Scene, tmin: float = DEFAULT_TMIN,
                             plain: bool = False,
                             alive: torch.Tensor | None = None) -> HitResult:
    """Closest hits of rays ``origin``/``direction`` [R, 3] float32 through
    K1 (``plain=True``, or CPU tensors: :func:`sweep_ref`), differentiable
    w.r.t. the rays and the scene's centers and radii (reference:
    ``intersect_spheres_pallas``). With ``alive`` [R] (bool or int) only
    the live lanes are swept, through K3 (:func:`sweep_masked`); the others
    read as misses."""
    t, idx = _Sweep.apply(origin, direction, scene.center, scene.radius,
                          float(tmin), bool(plain), alive)
    return HitResult(t=t, index=idx, hit=t < BIG)


def intersect_fetch_kernel(origin: torch.Tensor, direction: torch.Tensor,
                           scene: Scene, tmin: float = DEFAULT_TMIN,
                           plain: bool = False) -> tuple[HitResult, tuple]:
    """K10: the hits of :func:`intersect_spheres_kernel` and the winners'
    ``(center, radius, albedo, fuzz, ir, mat)`` rows that ``scatter`` takes,
    with the reference's miss defaults (center 0, radius 0, albedo 1, fuzz 0,
    ir 1, mat 0), differentiable w.r.t. the rays and the five fields
    (reference: ``intersect_fetch_pallas``)."""
    t, idx, a = _SweepFetch.apply(origin, direction, scene.center,
                                  scene.radius, scene.albedo, scene.fuzz,
                                  scene.ir, scene.mat, float(tmin),
                                  bool(plain))
    hit = t < BIG
    a = a.T.to(origin.dtype)  # [R, 10]
    h1 = hit[:, None]
    attrs = (torch.where(h1, a[:, 0:3], torch.zeros_like(a[:, 0:3])),
             torch.where(hit, a[:, 3], torch.zeros_like(a[:, 3])),
             torch.where(h1, a[:, 4:7], torch.ones_like(a[:, 4:7])),
             torch.where(hit, a[:, 7], torch.zeros_like(a[:, 7])),
             torch.where(hit, a[:, 8], torch.ones_like(a[:, 8])),
             torch.where(hit, a[:, 9], torch.zeros_like(a[:, 9])).to(
                 torch.int32))
    return HitResult(t=t, index=idx, hit=hit), attrs
