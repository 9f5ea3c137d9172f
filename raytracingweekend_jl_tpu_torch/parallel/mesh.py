"""The render mesh over the ranks of a process group — the counterpart of
``raytracingweekend_jl_tpu.parallel.mesh``.

The reference package lays its devices out on a named 2-D mesh ``('tiles',
'samples')``: pixel tiles are sharded over ``tiles``, samples per pixel
over ``samples``, and the partial radiance sums are reduced over
``samples``. The port runs one process per GPU (``torchrun``), so its mesh
is a grid of the ranks of the default ``torch.distributed`` group: rank
``r`` holds tile shard ``r // n_samples`` and sample shard ``r %
n_samples`` (the reference's row-major reshape of its device list), and
renders on its own device, ``cuda:{LOCAL_RANK}`` unless the caller names
one.

A mesh of one rank needs no process group: its collectives are identities.
Any larger mesh needs an initialized group
(:func:`parallel.multihost.initialize`, or ``torch.distributed`` set up by
the caller) and raises without one. Collectives over the gloo backend take
CUDA tensors through explicit host copies.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..render import _resolve_device

TILES_AXIS = "tiles"
SAMPLES_AXIS = "samples"


def local_rank(environ=None) -> int:
    """This process's index on its host, from the launcher's environment
    (``LOCAL_RANK`` from ``torchrun``, ``SLURM_LOCALID``,
    ``OMPI_COMM_WORLD_LOCAL_RANK``); 0 when none is set."""
    env = os.environ if environ is None else environ
    for var in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if var in env:
            return int(env[var])
    return 0


def rank_device(device=None) -> torch.device:
    """The device this rank renders on: ``cuda:{LOCAL_RANK}`` for ``None``,
    else ``device``; a CUDA device becomes the current one
    (``torch.cuda.set_device``). Raises without CUDA unless ``"cpu"``."""
    device = _resolve_device(f"cuda:{local_rank()}" if device is None
                             else device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device


def _all_gather(x: torch.Tensor, group) -> list:
    """``dist.all_gather`` of ``x`` over ``group``, in rank order. Gloo takes
    a CUDA tensor through an explicit copy to the host and back."""
    via_host = x.is_cuda and dist.get_backend(group) == "gloo"
    src = (x.detach().cpu() if via_host else x.detach()).contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(x.device) for o in out] if via_host else out


class RenderMesh:
    """A ``(tiles, samples)`` grid of ranks (the reference's ``Mesh``).

    ``shape[TILES_AXIS]`` and ``shape[SAMPLES_AXIS]`` are the axis sizes;
    ``tile_index`` and ``sample_index`` this rank's coordinates; ``device``
    where it renders. ``distributed`` says whether a process group is
    initialized: only then do :meth:`gather` and :meth:`barrier` call
    ``torch.distributed``."""

    def __init__(self, n_tiles: int, n_samples: int, device: torch.device,
                 rank: int = 0, samples_group=None):
        self.shape = {TILES_AXIS: n_tiles, SAMPLES_AXIS: n_samples}
        self.rank = rank
        self.tile_index, self.sample_index = divmod(rank, n_samples)
        self.device = device
        self.samples_group = samples_group
        self.distributed = dist.is_available() and dist.is_initialized()

    @property
    def size(self) -> int:
        return self.shape[TILES_AXIS] * self.shape[SAMPLES_AXIS]

    def gather(self, x: torch.Tensor, axis: str | None = None) -> list:
        """``x`` from every rank of the mesh (``axis=None``, rank order) or
        of this rank's ``samples`` row (``axis=SAMPLES_AXIS``, sample-shard
        order). A mesh of one, or a ``samples`` axis of one, returns
        ``[x]``."""
        if axis not in (None, SAMPLES_AXIS):
            raise ValueError(f"gather over axis {axis!r}: None (every rank) "
                             f"or {SAMPLES_AXIS!r}")
        if axis == SAMPLES_AXIS:
            if self.shape[SAMPLES_AXIS] == 1:
                return [x]
            return _all_gather(x, self.samples_group)
        if not self.distributed:
            return [x]
        return _all_gather(x, dist.group.WORLD)

    def barrier(self) -> None:
        """Wait for every rank (a no-op without a process group)."""
        if not self.distributed:
            return
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def __repr__(self) -> str:
        return (f"RenderMesh(tiles={self.shape[TILES_AXIS]}, samples="
                f"{self.shape[SAMPLES_AXIS]}, rank={self.rank}, "
                f"device={self.device})")


def make_render_mesh(n_tiles: int | None = None, n_samples: int = 1,
                     device=None) -> RenderMesh:
    """Build a ``(tiles, samples)`` mesh over the ranks of the default
    process group (one rank when there is none).

    ``n_tiles`` defaults to the world size over ``n_samples``; ``n_tiles *
    n_samples`` must equal the world size, else ``ValueError``. ``device``
    is this rank's device (:func:`rank_device`: ``cuda:{LOCAL_RANK}`` by
    default). With more than one sample shard, one ``samples`` subgroup is
    made per tile shard, by every rank, in tile order."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_samples < 1 or (n_tiles is not None and n_tiles < 1):
        raise ValueError(f"mesh axes must be >= 1, got tiles={n_tiles}, "
                         f"samples={n_samples}")
    if n_tiles is None:
        n_tiles = world // n_samples
    if n_tiles * n_samples != world:
        raise ValueError(
            f"mesh {n_tiles}x{n_samples} != {world} ranks"
            + ("" if initialized else
               " (no process group is initialized: a mesh of more than one "
               "rank needs parallel.multihost.initialize or torchrun)"))
    device = rank_device(device)
    samples_group = None
    if initialized and n_samples > 1:
        for t in range(n_tiles):
            g = dist.new_group(list(range(t * n_samples,
                                          (t + 1) * n_samples)))
            if t == rank // n_samples:
                samples_group = g
    return RenderMesh(n_tiles, n_samples, device, rank, samples_group)
