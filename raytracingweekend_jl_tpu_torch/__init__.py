"""raytracingweekend_jl_tpu_torch — the PyTorch/CUDA port of
``raytracingweekend_jl_tpu``.

Two main paths run end to end, each through hand-written CUDA kernels for
Hopper built from ``csrc/`` at first use:

- the flagship forward render: ``render(scene, cam, width, spp,
  device="cuda")`` goes through the strided persistent integrator (the
  sphere sweep K1 and the strided shade step K2);
- the flagship gradient step: ``render_grads(scene, cam, target, width,
  spp, device="cuda")`` goes through the persistent-record kernel pair (the
  masked sweep K3, the record step K4, the fused replay K5, and the
  per-slot replay K6 for lean records).

On the CPU the same paths run the kernels' plain PyTorch versions. Module
names follow the JAX package so each counterpart is easy to find; this
package never imports JAX.
"""

from .scene import (Scene, make_scene, trim_scene, scene_from_numpy, sphere,
                    lambertian, metal, dielectric, LAMBERTIAN, METAL,
                    DIELECTRIC)
from .camera import (Camera, default_camera, make_rays, get_rays,
                     camera_from_numpy, t_default_cam, t_cam1, t_cam2,
                     hollow_glass_cam)
from .render import (render, render_radiance, render_tile_sum,
                     image_height_for, pixel_coords)
from .grad import (render_loss, render_grads, SceneGrads, check_grads_sane,
                   GradSanityError, sgd_inverse_render_step, DIFF_FIELDS)
from .ops.persist_grad import trace_recorded_persist, persist_dropped_paths
from .ops.integrator import (persistent_render_sum_strided, skycolor,
                             DEFAULT_MAX_DEPTH)
from .ops.intersect import intersect_spheres, HitResult, DEFAULT_TMIN
from .ops.vecmath import (dot, squared_length, normalize, reflect, refract,
                          reflectance, gamma2_encode, NEAR_ZERO_EPS)
from .ops.sampling import (unit_sphere_directions, unit_disk_points,
                           concentric_disk_map)
from .models.scenes import (scene_2_spheres, scene_4_spheres,
                            scene_diel_spheres, scene_diel_spheres_hollow,
                            scene_blue_red_spheres, scene_random_spheres,
                            ALL_SCENES)

__version__ = "0.1.0"
