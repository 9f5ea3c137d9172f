"""raytracingweekend_jl_tpu_torch — the PyTorch/CUDA port of
``raytracingweekend_jl_tpu``.

Its main paths run end to end on the card, each through hand-written CUDA
kernels for Hopper built from ``csrc/`` at first use:

- the default render: ``render(scene, cam, width, spp)`` traces sample
  passes through the fixed-depth wavefront ``trace`` (the sphere sweep K1,
  or K10, the sweep fused with the winner's attribute fetch, with
  ``fused_attrs=True``), differentiably, as the JAX package's default does;
- the forward-only render, ``persistent=True``: the strided persistent
  integrator (K1 and the strided shade step K2), for a small image one
  launch of the inline kernel K8, and for a non-contiguous tile the
  pixel-pinned integrator (K1 and the pinned shade step K9);
- the gradient step: ``render_grads(scene, cam, target, width, spp)`` goes
  through the persistent-record kernel pair from 2^17 pixels (the masked
  sweep K3, the record step K4, the fused replay K5, and the per-slot
  replay K6 for lean records), and below through the fixed-depth pair (K3,
  the record step K7a, the fused replay K7c, or the per-bounce replay K7b);
  ``recorded=False, remat=True`` takes the remat twin instead, autograd
  through ``trace`` with each bounce recomputed (``remat_policy="dots"``
  keeps the winner fetches, ``tile_skip`` sweeps only live lanes through
  K3); ``recorded=True`` alone the recorded wavefront ``trace_recorded``
  (K1, a sweep-free backward), ``recorded_stage`` its staged form, and
  ``fused_stages`` the staged fixed-depth pair (K3, K7a, K7b);
- the inverse-rendering fit: ``fit_scene(scene0, cam, target, width, spp)``
  takes Adam steps on the gradient step's albedo gradients and SPSA probe
  renders for the centers, or with ``geom="edge"`` on autodiff of the
  boundary-aware edge render (``render_radiance_edge``, whose bounces
  sweep through K1); ``fit_scene_scan`` is the same fit with no host sync
  of its own per step.

Long renders: ``render_checkpointed`` renders an image in chunks,
checkpointed and resumable bit for bit, and the command line
(``python -m raytracingweekend_jl_tpu_torch.cli``, ``rtw-render-torch``)
renders a ``RenderConfig`` plainly, in chunks, or sharded.

Several GPUs (``parallel/``, on ``torch.distributed``, one process per GPU
under ``torchrun``): ``parallel.mesh.make_render_mesh`` lays the ranks out
as a ``(tiles, samples)`` mesh; ``parallel.shard.render_radiance_sharded``
renders fixed pixel tiles keyed by their global id (the strided route,
K1 and K2, for ``persistent=True``; ``trace``, K1, by default), bit for
bit the same on any number of tile shards, and
``parallel.shard.sharded_train_step`` takes the gradient step tile by tile
(the fixed-depth pair, K3, K7a, K7c) with the tiles' gradients reduced in
global tile order; ``parallel.elastic`` runs the same tiles on worker
threads with retry and quarantine, bit for bit the sharded results;
``parallel.multihost`` sets up the process group and the per-rank strip
files; ``utils.checkpoint.render_checkpointed_sharded`` checkpoints each
rank's strip. The CLI's ``--mesh-tiles``, ``--mesh-samples`` and
``--multihost`` drive them.

Float64 runs where the JAX package runs it off its TPU: the float32
kernels are not used for it, ``persistent=True`` takes the plain
pixel-pinned body and a gradient step with no path flag the recorded
wavefront; asking for a float32 kernel pair by name raises.

Every entry point runs on the card unless the caller passes
``device="cpu"``, and raises without CUDA. On the CPU the same paths run the
kernels' plain PyTorch versions. Module names follow the JAX package so each
counterpart is easy to find; this package never imports JAX.
"""

from .scene import (Scene, MovingScene, scene_moves, make_scene, trim_scene,
                    scene_from_numpy, sphere, lambertian, metal, dielectric,
                    LAMBERTIAN, METAL, DIELECTRIC)
from .camera import (Camera, default_camera, make_rays, get_rays,
                     camera_from_numpy, t_default_cam, t_cam1, t_cam2,
                     hollow_glass_cam)
from .render import (render, render_radiance, render_tile_sum,
                     image_height_for, pixel_coords)
from .grad import (render_loss, render_grads, SceneGrads, check_grads_sane,
                   GradSanityError, sgd_inverse_render_step, twin_ad_canary,
                   resolve_grad_path, DIFF_FIELDS)
from .optimize import FitResult, fit_scene, fit_scene_scan, movable_mask
from .ops.edge import render_radiance_edge, trace_edge
from .ops.persist_grad import trace_recorded_persist, persist_dropped_paths
from .ops.fused_grad import (trace_recorded_fused,
                             trace_recorded_fused_staged, DEFAULT_STAGES)
from .ops.grad_trace import trace_recorded, trace_recorded_staged
from .ops.cuda.inline_kernel import trace_inline
from .ops.integrator import (trace, trace_compacted, trace_occupancy,
                             persistent_render_sum,
                             persistent_render_sum_fused,
                             persistent_render_sum_strided, skycolor,
                             DEFAULT_MAX_DEPTH)
from .ops.materials import ScatterResult, scatter
from .ops.intersect import intersect_spheres, HitResult, DEFAULT_TMIN
from .ops.vecmath import (dot, squared_length, near_zero, normalize, reflect,
                          refract, reflectance, gamma2_encode,
                          color_vec3_in_rgb, NEAR_ZERO_EPS)
from .ops.sampling import (unit_sphere_directions, unit_disk_points,
                           concentric_disk_map, uniform_between)
from .models.scenes import (scene_2_spheres, scene_4_spheres,
                            scene_diel_spheres, scene_diel_spheres_hollow,
                            scene_blue_red_spheres, scene_random_spheres,
                            scene_random_spheres_reference,
                            scene_bouncing_spheres, save_scene, load_scene,
                            STATIC_SCENES, ALL_SCENES)
from .utils.config import RenderConfig
from .utils.checkpoint import (RenderState, StripState, render_checkpointed,
                               render_checkpointed_sharded)
from .utils.image import write_ppm, read_png

__version__ = "0.1.0"
