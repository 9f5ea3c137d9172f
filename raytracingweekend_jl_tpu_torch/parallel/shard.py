"""The mesh-sharded render and training step — the counterpart of
``raytracingweekend_jl_tpu.parallel.shard``.

Pixel *tiles* are sharded over the mesh's ``tiles`` axis and samples per
pixel over its ``samples`` axis (reference: the fork-join row loop of
src/render.jl:23-42, which the JAX package replaces with ``shard_map``).
Each rank runs its own body, :func:`shard_radiance_sums`: the tiles of its
tile shard, the samples of its sample shard, one :func:`tile_sum` each.
The collectives come after it, and every sum across ranks is taken in a
fixed order on every rank.

Determinism contract (as in the reference):

- tiles are blocks of ``tile_size`` pixels; global tile ``t`` starts at
  pixel ``t * tile_size`` and draws from ``purpose_seed(seed, PIXEL_JITTER
  + 0x10, t)``;
- sample shard ``s`` renders global samples from ``sample_offset + s *
  local_spp``, and only global sample 0 is centred;
- so the image is bit for bit the same for any ``tiles`` axis size at a
  fixed ``tile_size``. The ``samples`` reduction all-gathers the sample
  shards' sums and adds them in shard order on every rank: bitwise at a
  fixed mesh, and equal to float-order precision across sample-shard
  counts.

The last tiles may overrun the film (the tiles are padded to a multiple of
the tile shards): a tile renders only its pixels inside the film, and its
padding rows are zero; a tile wholly past the end renders nothing.

Per-tile routes: ``persistent=True`` tiles have a ``pixel_start``, so
float32 takes the strided integrator (K1 and K2) and float64 the plain
pixel-pinned body; ``persistent=False`` takes ``trace`` (K1) or the
gradient route flags. The training step's tiles take the fixed-depth
kernel pair (K3, K7a, K7c) below 2^17 pixels, the persistent-record pair
(K3, K4, K5) from there, or the recorded wavefront in float64
(:func:`_auto_grad_mode`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import rng
from ..camera import Camera
from ..grad import DIFF_FIELDS
from ..ops.integrator import DEFAULT_MAX_DEPTH
from ..ops.intersect import DEFAULT_TMIN
from ..render import (image_height_for, pick_samples_per_pass, pixel_coords,
                      render_tile_sum)
from ..scene import Scene, trim_scene
from .mesh import SAMPLES_AXIS, TILES_AXIS, RenderMesh

#: Default pixels per tile. Each tile's draws are keyed by its global id and
#: its pixels start at ``t * tile_size``, so the size is part of the image's
#: bits: it is the reference package's value, so both packages tile alike.
DEFAULT_TILE = 8192


def _padded_coords(image_width: int, image_height: int, tile_size: int,
                   n_tile_shards: int, dtype=torch.float32, device="cpu"):
    """Flattened film coordinates padded so that the tiles divide evenly
    across ``n_tile_shards``: ``(u, v, tiles_total, pad)``. Padding pixels
    hold the (0, 0) film corner and are never rendered (:func:`tile_sum`)."""
    u, v = pixel_coords(image_width, image_height, dtype=dtype, device=device)
    n_pix = image_width * image_height
    tiles_total = -(-n_pix // tile_size)
    tiles_total = -(-tiles_total // n_tile_shards) * n_tile_shards
    pad = tiles_total * tile_size - n_pix
    return F.pad(u, (0, pad)), F.pad(v, (0, pad)), tiles_total, pad


def tile_seed(seed: int, t: int) -> int:
    """Seed of global tile ``t``'s draws."""
    return rng.purpose_seed(seed, rng.PIXEL_JITTER + 0x10, t)


def tile_sum(scene: Scene, cam: Camera, u: torch.Tensor, v: torch.Tensor,
             t: int, tile_size: int, n_pix: int, seed: int, n_samples: int,
             sample_offset: int, max_depth: int, tmin: float, f32_w: float,
             f32_h: float, persistent: bool = False, impl: str | None = None,
             samples_per_pass: int = 1, **route) -> torch.Tensor:
    """Radiance sum ``[tile_size, 3]`` of global tile ``t`` over
    ``n_samples`` samples from ``sample_offset``, on the scene's device.

    ``u``/``v`` are the film's coordinates (any device; padded or not).
    Only the tile's pixels inside the film (``n_pix`` of them in all) are
    rendered, through :func:`render.render_tile_sum` with ``pixel_start =
    t * tile_size``; the rows past the film are zero. ``route`` takes the
    route flags of ``render_tile_sum``."""
    start = t * tile_size
    n_real = max(0, min(tile_size, n_pix - start))
    dev = scene.device
    if n_real == 0:
        return torch.zeros((tile_size, 3), dtype=u.dtype, device=dev)
    out = render_tile_sum(
        scene, cam, n_real, tile_seed(seed, t), n_samples, sample_offset,
        max_depth, tmin, f32_w, f32_h, persistent, pixel_start=start,
        impl=impl, u=u[start:start + n_real].to(dev),
        v=v[start:start + n_real].to(dev), samples_per_pass=samples_per_pass,
        **route)
    return F.pad(out, (0, 0, 0, tile_size - n_real))


def ordered_sum(parts) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, left to right: the same bits on every
    rank and for every grouping of the same list."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _local_spp(n_samples: int, n_sample_shards: int) -> int:
    if n_samples % n_sample_shards != 0:
        raise ValueError(f"n_samples={n_samples} must divide evenly over "
                         f"{n_sample_shards} sample shards")
    return n_samples // n_sample_shards


def shard_rows(mesh_shape: dict, tile_index: int, image_width: int,
               image_height: int, tile_size: int) -> tuple[int, int]:
    """The ``[start, stop)`` pixel range of tile shard ``tile_index``,
    clipped to the film."""
    n_pix = image_width * image_height
    tiles_total = -(-n_pix // tile_size)
    per_shard = -(-tiles_total // mesh_shape[TILES_AXIS])
    start = min(n_pix, tile_index * per_shard * tile_size)
    return start, min(n_pix, (tile_index + 1) * per_shard * tile_size)


def shard_radiance_sums(scene: Scene, cam: Camera, image_width: int,
                        image_height: int, n_samples: int, *,
                        mesh_shape: dict, tile_index: int, sample_index: int,
                        tile_size: int = DEFAULT_TILE,
                        max_depth: int = DEFAULT_MAX_DEPTH,
                        tmin: float = DEFAULT_TMIN, seed: int = 0,
                        persistent: bool = False, samples_per_pass: int = 1,
                        sample_offset: int = 0, impl: str | None = None,
                        **route) -> torch.Tensor:
    """One rank's body, with no collective: the radiance sums
    ``[tiles_per_shard * tile_size, 3]`` of tile shard ``tile_index`` over
    the ``n_samples // mesh_shape["samples"]`` samples of sample shard
    ``sample_index``, on the scene's device. Any process can run any
    rank's body (the tests run all of them in one)."""
    n_tile_shards = mesh_shape[TILES_AXIS]
    local_spp = _local_spp(n_samples, mesh_shape[SAMPLES_AXIS])
    u, v, tiles_total, _ = _padded_coords(image_width, image_height,
                                          tile_size, n_tile_shards,
                                          cam.origin.dtype, scene.device)
    per_shard = tiles_total // n_tile_shards
    n_pix = image_width * image_height
    fw, fh = float(image_width), float(image_height)
    offset = sample_offset + sample_index * local_spp
    return torch.cat([
        tile_sum(scene, cam, u, v, tile_index * per_shard + i, tile_size,
                 n_pix, seed, local_spp, offset, max_depth, tmin, fw, fh,
                 persistent, impl, samples_per_pass, **route)
        for i in range(per_shard)])


def render_strip_sharded(scene: Scene, cam: Camera, image_width: int,
                         n_samples: int, *, mesh: RenderMesh,
                         image_height: int | None = None,
                         tile_size: int = DEFAULT_TILE,
                         max_depth: int = DEFAULT_MAX_DEPTH,
                         tmin: float = DEFAULT_TMIN, seed: int = 0,
                         persistent: bool = False,
                         rays_per_pass: int | None = None,
                         sample_offset: int = 0, impl: str | None = None,
                         **route) -> tuple[int, int, torch.Tensor]:
    """This rank's strip of the sharded render: ``(start, stop, sums)``,
    the radiance sums ``[stop - start, 3]`` of its tile shard's pixels over
    all ``n_samples`` samples (its sample shard's body, then the ``samples``
    reduction), on ``mesh.device``. No tile crosses ranks. Forward only."""
    H = image_height if image_height is not None else image_height_for(
        image_width)
    W = image_width
    scene = trim_scene(scene.to(mesh.device))
    cam = cam.to(mesh.device)
    local_spp = _local_spp(n_samples, mesh.shape[SAMPLES_AXIS])
    spp_pass = 1 if rays_per_pass is None else pick_samples_per_pass(
        tile_size, max(local_spp, 1), rays_per_pass)
    with torch.no_grad():
        local = shard_radiance_sums(
            scene, cam, W, H, n_samples, mesh_shape=mesh.shape,
            tile_index=mesh.tile_index, sample_index=mesh.sample_index,
            tile_size=tile_size, max_depth=max_depth, tmin=tmin, seed=seed,
            persistent=persistent, samples_per_pass=spp_pass,
            sample_offset=sample_offset, impl=impl, **route)
        sums = ordered_sum(mesh.gather(local, SAMPLES_AXIS))
    start, stop = shard_rows(mesh.shape, mesh.tile_index, W, H, tile_size)
    return start, stop, sums[:stop - start]


def render_radiance_sharded(scene: Scene, cam: Camera, image_width: int = 400,
                            n_samples: int = 1, *, mesh: RenderMesh,
                            image_height: int | None = None,
                            tile_size: int = DEFAULT_TILE,
                            max_depth: int = DEFAULT_MAX_DEPTH,
                            tmin: float = DEFAULT_TMIN, seed: int = 0,
                            remat: bool = False, compact: bool = False,
                            persistent: bool = False,
                            rays_per_pass: int | None = None,
                            recorded: bool = False,
                            recorded_fused: bool = False,
                            recorded_persist: tuple | None = None,
                            sample_offset: int = 0,
                            reduce_mean: bool = True,
                            impl: str | None = None) -> torch.Tensor:
    """Mesh-sharded linear radiance ``[H, W, 3]`` on ``mesh.device``, the
    whole image on every rank: each rank's strip
    (:func:`render_strip_sharded`), then an all-gather of the strips in
    tile order. ``compact``, ``remat`` and the ``recorded*`` flags pick the
    per-tile route as in :func:`render.render_tile_sum`;
    ``sample_offset`` and ``reduce_mean=False`` serve the spp-chunked
    checkpoint driver (global samples ``[sample_offset, sample_offset +
    n_samples)``, the radiance sum). Forward only: the training step is
    :func:`sharded_train_step`."""
    H = image_height if image_height is not None else image_height_for(
        image_width)
    W = image_width
    route = dict(remat=remat, compact=compact, recorded=recorded,
                 recorded_fused=recorded_fused,
                 recorded_persist=recorded_persist)
    start, stop, sums = render_strip_sharded(
        scene, cam, W, n_samples, mesh=mesh, image_height=H,
        tile_size=tile_size, max_depth=max_depth, tmin=tmin, seed=seed,
        persistent=persistent, rays_per_pass=rays_per_pass,
        sample_offset=sample_offset, impl=impl, **route)
    n_pix, n_s = W * H, mesh.shape[SAMPLES_AXIS]
    # Every strip padded to the longest (tile shard 0's) for the gather.
    width = shard_rows(mesh.shape, 0, W, H, tile_size)[1]
    strips = mesh.gather(F.pad(sums, (0, 0, 0, width - (stop - start))))
    pieces = []
    for i in range(mesh.shape[TILES_AXIS]):
        a, b = shard_rows(mesh.shape, i, W, H, tile_size)
        pieces.append(strips[i * n_s][:b - a])
    out = torch.cat(pieces)[:n_pix].reshape(H, W, 3)
    return out / n_samples if reduce_mean else out


def _auto_grad_mode(dtype: torch.dtype, tile_size: int) -> str:
    """The training step's default gradient route per tile: float32 takes
    the fixed-depth kernel pair (``"fused"``) below 2^17 pixels and the
    persistent-record pair (``"persist"``) from there, the threshold
    ``grad.resolve_grad_path`` uses for whole images, on every device (the
    CPU runs the pairs' plain versions); float64 takes the recorded
    wavefront (``"recorded"``), since the pairs are float32."""
    if dtype != torch.float32:
        return "recorded"
    return "persist" if tile_size >= (1 << 17) else "fused"


def grad_route(grad_mode: str) -> dict:
    """``render_tile_sum`` route flags of a training step's ``grad_mode``."""
    if grad_mode not in ("fused", "persist", "recorded"):
        raise ValueError(f"unknown grad_mode {grad_mode!r}")
    return dict(recorded=True, recorded_fused=grad_mode == "fused",
                recorded_persist=(8, None) if grad_mode == "persist"
                else None)


def tile_loss_grads(scene: Scene, cam: Camera, u: torch.Tensor,
                    v: torch.Tensor, t: int, target: torch.Tensor,
                    tile_size: int, n_pix: int, seed: int, local_spp: int,
                    sample_offset: int, n_samples: int, max_depth: int,
                    tmin: float, f32_w: float, f32_h: float,
                    impl: str | None = None, reduce_samples=None,
                    **route) -> torch.Tensor:
    """Tile ``t``'s squared error and its gradient w.r.t. the scene's
    differentiable fields, as one row ``[1 + G]`` on the scene's device:
    the SSE, then the fields' gradients flattened in ``DIFF_FIELDS`` order.

    The tile's radiance sum over ``local_spp`` samples from
    ``sample_offset`` is rendered with the graph; ``reduce_samples(sum)``
    (detached; identity by default) gives the sum over all ``n_samples``;
    the backward takes the shared cotangent ``2 (img - target) /
    n_samples`` on this rank's sum, the transpose of the reference's
    ``psum``. ``target`` is the film's flattened target [n_pix, 3]. The
    records of the tile live only until its backward."""
    start = t * tile_size
    n_real = max(0, min(tile_size, n_pix - start))
    leaves = [getattr(scene, f).detach().requires_grad_(True)
              for f in DIFF_FIELDS]
    if n_real == 0:
        return torch.cat([torch.zeros(1, dtype=u.dtype, device=scene.device)]
                         + [torch.zeros_like(x).reshape(-1) for x in leaves])
    with torch.enable_grad():
        local = tile_sum(scene._replace(**dict(zip(DIFF_FIELDS, leaves))),
                         cam, u, v, t, tile_size, n_pix, seed, local_spp,
                         sample_offset, max_depth, tmin, f32_w, f32_h,
                         False, impl, **route)[:n_real]
    full = local.detach() if reduce_samples is None else reduce_samples(
        local.detach())
    diff = full / n_samples - target[start:start + n_real].to(full)
    sse = (diff * diff).sum()
    grads = torch.autograd.grad(local, leaves, 2.0 * diff / n_samples,
                                allow_unused=True)
    return torch.cat([sse.reshape(1)] + [
        (torch.zeros_like(x) if g is None else g).reshape(-1)
        for x, g in zip(leaves, grads)])


def reduce_tile_rows(rows, scene: Scene, n_pix: int, lr: float
                     ) -> tuple[torch.Tensor, Scene]:
    """The fixed-order reduction of per-tile rows (:func:`tile_loss_grads`),
    on the host: ``rows`` in global tile order (a tile's sample shards in
    shard order, their SSE taken from the first), summed left to right,
    then divided by ``3 * n_pix``. Returns ``(loss, scene - lr * grads)``
    with the scene on its own device. The same list of rows gives the same
    bits on every rank and in the elastic step."""
    denom = float(3 * n_pix)
    total = ordered_sum([r.cpu() for r in rows]) / denom
    new, at = {}, 1
    for f in DIFF_FIELDS:
        x = getattr(scene, f)
        g = total[at:at + x.numel()].reshape(x.shape)
        at += x.numel()
        new[f] = (x.detach().cpu() - lr * g).to(x.device)
    return total[0], scene._replace(**new)


def shard_tile_rows(scene: Scene, cam: Camera, target: torch.Tensor,
                    image_width: int, n_samples: int, *, mesh_shape: dict,
                    tile_index: int, sample_index: int,
                    tile_size: int = DEFAULT_TILE, seed: int = 0,
                    grad_mode: str | None = None,
                    max_depth: int = DEFAULT_MAX_DEPTH,
                    tmin: float = DEFAULT_TMIN, impl: str | None = None,
                    reduce_samples=None) -> torch.Tensor:
    """One rank's body of the training step: the rows ``[tiles_per_shard,
    1 + G]`` (:func:`tile_loss_grads`) of tile shard ``tile_index`` over
    sample shard ``sample_index``, tile after tile, on the scene's device.
    ``target`` is the flattened film target [n_pix, 3]; ``reduce_samples``
    is the ``samples`` reduction (needed above one sample shard)."""
    H, W = target.shape[0] // image_width, image_width
    n_pix = H * W
    dtype = cam.origin.dtype
    route = grad_route(_auto_grad_mode(dtype, tile_size)
                       if grad_mode is None else grad_mode)
    n_t = mesh_shape[TILES_AXIS]
    local_spp = _local_spp(n_samples, mesh_shape[SAMPLES_AXIS])
    u, v, tiles_total, _ = _padded_coords(W, H, tile_size, n_t, dtype,
                                          scene.device)
    per_shard = tiles_total // n_t
    return torch.stack([
        tile_loss_grads(scene, cam, u, v, tile_index * per_shard + i, target,
                        tile_size, n_pix, seed, local_spp,
                        sample_index * local_spp, n_samples, max_depth, tmin,
                        float(W), float(H), impl, reduce_samples, **route)
        for i in range(per_shard)])


def order_rows(by_rank, mesh_shape: dict, n_pix: int, tile_size: int
               ) -> list:
    """Every rank's rows (``by_rank[r]`` from rank ``r``'s
    :func:`shard_tile_rows`) as one list in global tile order, a tile's
    sample shards in shard order with the SSE kept only in the first; the
    tiles wholly past the film are left out."""
    n_t, n_s = mesh_shape[TILES_AXIS], mesh_shape[SAMPLES_AXIS]
    per_shard = by_rank[0].shape[0]
    ordered = []
    for t in range(-(-n_pix // tile_size)):
        shard, i = divmod(t, per_shard)
        for s in range(n_s):
            row = by_rank[shard * n_s + s][i]
            ordered.append(row if s == 0 else
                           torch.cat([row.new_zeros(1), row[1:]]))
    return ordered


def sharded_train_step(scene: Scene, cam: Camera, target: torch.Tensor,
                       image_width: int, n_samples: int, *, mesh: RenderMesh,
                       lr: float = 0.01, tile_size: int = DEFAULT_TILE,
                       seed: int = 0, grad_mode: str | None = None,
                       max_depth: int = DEFAULT_MAX_DEPTH,
                       tmin: float = DEFAULT_TMIN, impl: str | None = None
                       ) -> tuple[torch.Tensor, Scene]:
    """One sharded inverse-rendering SGD step on the mean squared error
    against ``target`` [H, W, 3]: ``(loss, updated scene)``, both the same
    on every rank; the scene is trimmed of its padding spheres and lies on
    ``mesh.device``.

    Each rank takes each tile of its tile shard in turn
    (:func:`shard_tile_rows`; with a ``samples`` axis above one, a tile's
    radiance sum is reduced over the sample shards before its backward),
    keeping one row per tile; then every rank's rows are all-gathered and
    reduced in global tile order (:func:`order_rows`,
    :func:`reduce_tile_rows`). So the loss and the scene are bit for bit
    the same for any ``tiles`` axis size at a fixed ``tile_size``, and equal
    to ``elastic_train_step``'s at the same ``tile_size``, seed and route.
    ``grad_mode``: ``"fused"``, ``"persist"`` or ``"recorded"``; default
    :func:`_auto_grad_mode`."""
    dev = mesh.device
    scene = trim_scene(scene.to(dev))
    cam = cam.to(dev)
    n_pix = target.shape[0] * image_width
    target = torch.as_tensor(target).to(dev).reshape(n_pix, 3)

    def reduce_samples(x):
        return ordered_sum(mesh.gather(x, SAMPLES_AXIS))

    rows = shard_tile_rows(scene, cam, target, image_width, n_samples,
                           mesh_shape=mesh.shape, tile_index=mesh.tile_index,
                           sample_index=mesh.sample_index,
                           tile_size=tile_size, seed=seed,
                           grad_mode=grad_mode, max_depth=max_depth,
                           tmin=tmin, impl=impl,
                           reduce_samples=reduce_samples)
    ordered = order_rows(mesh.gather(rows), mesh.shape, n_pix, tile_size)
    return reduce_tile_rows(ordered, scene, n_pix, lr)
