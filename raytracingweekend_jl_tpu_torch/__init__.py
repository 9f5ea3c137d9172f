"""raytracingweekend_jl_tpu_torch — the PyTorch/CUDA port of
``raytracingweekend_jl_tpu``.

The flagship forward render runs end to end: ``render(scene, cam, width,
spp, device="cuda")`` goes through the strided persistent integrator and two
hand-written CUDA kernels for Hopper (the sphere sweep and the strided shade
step, built from ``csrc/`` at first use). On the CPU the same path runs the
kernels' plain PyTorch versions. Module names follow the JAX package so each
counterpart is easy to find; this package never imports JAX.
"""

from .scene import (Scene, make_scene, trim_scene, scene_from_numpy, sphere,
                    lambertian, metal, dielectric, LAMBERTIAN, METAL,
                    DIELECTRIC)
from .camera import (Camera, default_camera, make_rays, get_rays,
                     camera_from_numpy, t_default_cam, t_cam1, t_cam2,
                     hollow_glass_cam)
from .render import (render, render_radiance, render_tile_sum,
                     image_height_for, pixel_coords)
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
