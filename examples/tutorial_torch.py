"""Chaptered walkthrough of the PyTorch/CUDA port — the chapters of
``examples/tutorial.py`` on ``raytracingweekend_jl_tpu_torch``. Each chapter
prints what it demonstrates and writes an image into ``--out-dir``.

Run:  python examples/tutorial_torch.py [--width 200] [--spp 16]
      python examples/tutorial_torch.py --device cpu --width 64 --spp 4

It renders on the CUDA card unless ``--device cpu`` is given. Images go to
``build/tutorial_torch/`` by default, never over the PNGs in ``examples/``.
"""

import argparse
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import raytracingweekend_jl_tpu_torch as pt  # noqa: E402
from raytracingweekend_jl_tpu_torch.utils.image import write_png  # noqa: E402


def chapter(n, title):
    print(f"\n=== Chapter {n}: {title} ===")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=200)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "build",
                                                      "tutorial_torch"))
    args = ap.parse_args(argv)
    W, spp, dev = args.width, args.spp, args.device
    os.makedirs(args.out_dir, exist_ok=True)

    def save(img, name):
        path = os.path.join(args.out_dir, name)
        write_png(img, path)
        return path

    chapter(1, "Rays and the sky")
    # A camera at the origin; an empty scene renders the sky gradient
    # (reference: skycolor, src/ray_color.jl:1-6).
    empty = pt.make_scene([])
    cam = pt.t_default_cam()
    print("sky gradient ->", save(pt.render(empty, cam, W, 1, device=dev),
                                  "ch1_sky.png"))

    chapter(2, "A sphere and surface normals")
    # One Lambertian sphere + ground (reference: scene_2_spheres,
    # src/scenes.jl:2-11).
    img = pt.render(pt.scene_2_spheres(), cam, W, spp, device=dev)
    print("diffuse spheres ->", save(img, "ch2_two_spheres.png"))

    chapter(3, "Metal with fuzz")
    img = pt.render(pt.scene_4_spheres(), cam, W, spp, device=dev)
    print("metal spheres ->", save(img, "ch3_metal.png"))

    chapter(4, "Dielectrics and the hollow glass sphere")
    # Negative radius = thin shell (reference: src/scenes.jl:35-36).
    img = pt.render(pt.scene_diel_spheres_hollow(), pt.hollow_glass_cam(), W,
                    spp, device=dev)
    print("hollow glass ->", save(img, "ch4_glass.png"))

    chapter(5, "Defocus blur")
    img = pt.render(pt.scene_diel_spheres(), pt.t_cam2(), W, spp, device=dev)
    print("defocus blur ->", save(img, "ch5_defocus.png"))

    chapter(6, "The book-1 final scene")
    scene = pt.scene_random_spheres(seed=1)
    t0 = time.time()
    img = pt.render(scene, pt.t_cam1(), W, spp, persistent=True, device=dev)
    img = img.cpu()  # the copy waits for the card
    print(f"rendered {W}x{W * 9 // 16}x{spp} in {time.time() - t0:.2f}s")
    print("final scene ->", save(img, "ch6_random_spheres.png"))

    chapter(7, "Differentiable rendering (no reference equivalent)")
    # Recover a sphere albedo from a target image by gradient descent.
    target_scene = pt.make_scene(
        [pt.lambertian((0, 0, -1), 0.5, (0.2, 0.8, 0.3)),
         pt.lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0))], pad_to=4)
    target = pt.render_radiance(target_scene, cam, 64, 4, seed=3,
                                device=dev)
    scene = pt.make_scene(
        [pt.lambertian((0, 0, -1), 0.5, (0.5, 0.5, 0.5)),
         pt.lambertian((0, -100.5, -1), 100.0, (0.8, 0.8, 0.0))], pad_to=4)
    for i in range(10):
        loss, scene = pt.sgd_inverse_render_step(scene, cam, target, 64, 4,
                                                 lr=2.0, seed=3, device=dev)
        if i % 3 == 0:
            print(f"  step {i}: loss {float(loss):.6f} albedo "
                  f"{scene.albedo[0].detach().cpu().numpy().round(3)}")
    print("  true albedo: [0.2 0.8 0.3]")

    chapter(8, "Sharded rendering on a device mesh")
    print("  not ported yet: multi-GPU is ROADMAP.md Queue 1, item 18")

    chapter(9, "The reference's exact scene (Xoroshiro replay)")
    # The scene instance the reference's own `reseed!();
    # scene_random_spheres` produces, replayed bit for bit in Python
    # (docs/PARITY.md section 4).
    ref_scene = pt.scene_random_spheres_reference()
    mats = ref_scene.mat.numpy()[ref_scene.radius.numpy() != 0]
    print(f"  {mats.size} spheres: {(mats == 0).sum()} diffuse / "
          f"{(mats == 1).sum()} metal / {(mats == 2).sum()} glass")

    chapter(10, "Checkpointed rendering (resumable bit for bit)")
    # The JAX package's sharded and elastic renders wait for multi-GPU;
    # the single-device checkpointed render is ported.
    ck = os.path.join(args.out_dir, "ch10_checkpoint.npz")
    if os.path.exists(ck):
        os.remove(ck)
    pt.render_checkpointed(pt.scene_2_spheres(), cam, 64, 2, seed=1,
                           spp_chunk=2, checkpoint_path=ck, device=dev)
    state = pt.render_checkpointed(pt.scene_2_spheres(), cam, 64, 4, seed=1,
                                   spp_chunk=2, checkpoint_path=ck,
                                   device=dev)
    whole = pt.render_checkpointed(pt.scene_2_spheres(), cam, 64, 4, seed=1,
                                   spp_chunk=2, device=dev)
    print(f"  resumed to {state.samples_done} samples; equal to the "
          f"uninterrupted run: "
          f"{bool(np.array_equal(state.radiance_sum, whole.radiance_sum))}")
    print("  checkpoint ->", ck)


if __name__ == "__main__":
    main()
