"""Multi-process rendering: ``torch.distributed`` set-up and per-rank strip
I/O — the counterpart of ``raytracingweekend_jl_tpu.parallel.multihost``.

The reference never crosses a process boundary (SURVEY.md §2.4). The port
runs one process per GPU, all running the same program (``torchrun
--nproc-per-node N``, Slurm or MPI): the ranks of the default group form
the ``(tiles, samples)`` mesh, tile shards in rank order, so contiguous
tile blocks live on one rank. Image assembly needs no collective: each rank
of sample shard 0 writes its own pixel strip and rank 0 reassembles them
after a barrier. The only collectives of a render are the ``samples``
reduction and the gather of :func:`shard.render_radiance_sharded`; a
training step adds the all-gather of its per-tile gradient rows.

Exercised in one process by the mesh of one, and across processes by
``tests/test_torch_multiprocess.py`` (two ranks over gloo on the CPU) and
``chip_smoke.py`` (two ranks on one card over gloo).
"""

from __future__ import annotations

import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import RenderMesh, make_render_mesh

#: How long a rendezvous or collective may wait before it raises.
DEFAULT_TIMEOUT = timedelta(seconds=300)

#: Environment variable naming the rendezvous (a ``torch.distributed``
#: init method such as ``file:///shared/rdzv`` or ``tcp://host:port``) for
#: :func:`initialize` with no arguments; ``env://`` (``MASTER_ADDR`` and
#: ``MASTER_PORT``, as ``torchrun`` sets them) when unset.
INIT_METHOD_ENV = "RTW_INIT_METHOD"

#: (world size, rank) variables of the launchers, in the order they are read.
_LAUNCHER_VARS = (("WORLD_SIZE", "RANK"), ("SLURM_NTASKS", "SLURM_PROCID"),
                  ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK"))


def _launch(environ) -> tuple[int, int] | None:
    """``(world_size, rank)`` of a multi-process launch in ``environ``, or
    None for a single process (a variable that is not an integer counts as
    absent)."""
    for size_var, rank_var in _LAUNCHER_VARS:
        try:
            size = int(environ.get(size_var, "1"))
            if size > 1:
                return size, int(environ.get(rank_var, ""))
        except ValueError:
            continue
    return None


def cluster_env_hint(environ=None) -> bool:
    """True when the environment says this process is one of several:
    ``WORLD_SIZE > 1`` (``torchrun``), ``SLURM_NTASKS > 1`` or
    ``OMPI_COMM_WORLD_SIZE > 1``. A single-rank ``torchrun`` (which also
    sets ``MASTER_ADDR``) is a single process."""
    return _launch(os.environ if environ is None else environ) is not None


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               timeout: timedelta = DEFAULT_TIMEOUT) -> bool:
    """Set up the default process group; True when one is set up.

    Three modes, as in the reference:

    - ``world_size > 1``: join ``init_method`` as ``rank`` of
      ``world_size``;
    - no arguments and a multi-process launch (:func:`cluster_env_hint`):
      world size and rank from the launcher's variables, the rendezvous
      from ``$RTW_INIT_METHOD`` or ``env://``;
    - otherwise a single process: nothing is set up, and a mesh of one
      needs nothing.

    ``backend`` is ``"nccl"`` unless the caller passes another
    (``"gloo"`` for ranks on the CPU, or for several ranks sharing one
    card); it is never switched for the caller. A rendezvous or collective
    that waits longer than ``timeout`` raises. Calling it again once a
    group exists returns True."""
    if dist.is_initialized():
        return True
    backend = "nccl" if backend is None else backend
    if world_size is not None and world_size > 1:
        if rank is None:
            raise ValueError("initialize(world_size > 1) needs rank")
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank,
                                timeout=timeout)
        return True
    launch = _launch(os.environ)
    if world_size is None and init_method is None and launch is not None:
        size, r = launch
        dist.init_process_group(
            backend, init_method=os.environ.get(INIT_METHOD_ENV, "env://"),
            world_size=size, rank=r, timeout=timeout)
        return True
    return False


def make_multihost_mesh(n_samples_axis: int = 1, device=None) -> RenderMesh:
    """The mesh over every rank: ``world / n_samples_axis`` tile shards,
    each of ``n_samples_axis`` consecutive ranks (on one host, when the
    launcher numbers a host's ranks together, so the ``samples`` reduction
    stays on the host's links)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world % n_samples_axis:
        raise ValueError(f"{world} ranks not divisible by samples axis "
                         f"{n_samples_axis}")
    return make_render_mesh(world // n_samples_axis, n_samples_axis, device)


def _rank_world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_local_rows(image_height: int, image_width: int,
                    tile_size: int) -> tuple[int, int]:
    """The ``[start, stop)`` pixel range whose tiles live on this rank when
    every rank holds a tile shard (a mesh of ``world x 1``): the tiles split
    as evenly as they go, the last rank's strip the shortest."""
    rank, world = _rank_world()
    n_pix = image_height * image_width
    tiles_total = -(-n_pix // tile_size)
    per_rank = -(-tiles_total // world)
    return (min(n_pix, rank * per_rank * tile_size),
            min(n_pix, (rank + 1) * per_rank * tile_size))


def strip_path(directory: str, process_index: int | None = None) -> str:
    """The strip file of rank ``process_index`` (this rank's by default)
    inside ``directory``."""
    idx = _rank_world()[0] if process_index is None else process_index
    return os.path.join(directory, f"strip_{idx:05d}.npz")


def local_strip(image, image_height: int, image_width: int,
                tile_size: int) -> tuple[int, int, np.ndarray]:
    """This rank's pixel strip ``(start, stop, [stop - start, 3])`` of a
    whole ``[H, W, 3]`` image (a tensor or an array): its
    :func:`host_local_rows`."""
    start, stop = host_local_rows(image_height, image_width, tile_size)
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    flat = np.asarray(image, np.float32).reshape(-1, 3)
    return start, stop, flat[start:stop]


def write_host_strip(image, image_height: int, image_width: int,
                     tile_size: int, directory: str,
                     strip: tuple[int, int, np.ndarray] | None = None
                     ) -> tuple[int, int]:
    """Save this rank's pixel strip of ``image`` (:func:`local_strip`), or
    ``strip = (start, stop, data)`` when the caller holds it already (the
    sharded drivers hold their tile shard's strip), to
    :func:`strip_path`. Returns the ``[start, stop)`` range written."""
    start, stop, data = (local_strip(image, image_height, image_width,
                                     tile_size) if strip is None else strip)
    os.makedirs(directory, exist_ok=True)
    path = strip_path(directory)
    tmp = path + ".tmp.npz"
    np.savez(tmp, start=start, stop=stop,
             strip=np.asarray(data, np.float32),
             image_height=image_height, image_width=image_width)
    os.replace(tmp, path)
    return start, stop


def assemble_strips(directory: str) -> np.ndarray:
    """The whole ``[H, W, 3]`` image from the strip files in ``directory``.
    Raises when the strips leave a gap, overlap, or do not cover the image
    (a missing rank's file is an error, not a black band)."""
    files = sorted(f for f in os.listdir(directory)
                   if f.startswith("strip_") and f.endswith(".npz")
                   and not f.endswith(".tmp.npz"))
    if not files:
        raise FileNotFoundError(f"no strip files in {directory}")
    parts = []
    for f in files:
        with np.load(os.path.join(directory, f)) as z:
            parts.append({k: z[k] for k in z.files})
    H = int(parts[0]["image_height"])
    W = int(parts[0]["image_width"])
    out = np.zeros((H * W, 3), parts[0]["strip"].dtype)
    covered = 0
    for z in sorted(parts, key=lambda z: int(z["start"])):
        start, stop = int(z["start"]), int(z["stop"])
        if start != covered:
            raise ValueError(f"strip gap/overlap at pixel {covered} "
                             f"(next strip starts at {start})")
        out[start:stop] = z["strip"]
        covered = stop
    if covered != H * W:
        raise ValueError(f"strips cover {covered} of {H * W} pixels")
    return out.reshape(H, W, 3)
