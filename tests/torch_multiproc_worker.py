"""One rank of the port's two-process test (tests/test_torch_multiprocess.py).

    python tests/torch_multiproc_worker.py RANK WORLD INIT_METHOD OUT_DIR \\
        [DEVICE [WIDTH HEIGHT SPP TILE]]

Joins a gloo process group at ``INIT_METHOD`` (a ``file://`` store), then
on a ``(world, 1)`` mesh: the sharded render (the whole image on every
rank), this rank's strip written to ``OUT_DIR/strips``, a checkpointed
render interrupted and resumed, and a training step; on a ``(1, world)``
mesh (the ``samples`` reduction across processes): the render and a
training step. Writes its images and updated albedos and centers to
``OUT_DIR/rank<RANK>.npz`` and prints one ``RESULT {json}`` line with the
rest. ``DEVICE`` is ``cpu`` (the default) or a CUDA device, which several
ranks may share: gloo takes the CUDA tensors through host copies. Imports
nothing of JAX.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

#: The configuration both ranks and the parent's references share: the
#: film, its samples and the tile size (unless given), and the seed.
SIZE = (64, 36, 2, 256)
SEED = 11


def main() -> None:
    rank, world = int(sys.argv[1]), int(sys.argv[2])
    init_method, out_dir = sys.argv[3], sys.argv[4]
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    W, H, SPP, TILE = map(int, sys.argv[6:10]) if len(sys.argv) > 9 else SIZE

    import numpy as np
    import torch
    torch.set_num_threads(1)
    import raytracingweekend_jl_tpu_torch as pt
    from raytracingweekend_jl_tpu_torch.parallel import multihost
    from raytracingweekend_jl_tpu_torch.parallel.mesh import make_render_mesh
    from raytracingweekend_jl_tpu_torch.parallel.shard import (
        render_radiance_sharded, render_strip_sharded, sharded_train_step)
    from raytracingweekend_jl_tpu_torch.utils.checkpoint import (
        render_checkpointed_sharded)

    assert multihost.initialize(init_method, world, rank, backend="gloo")
    mesh = multihost.make_multihost_mesh(1, device=device)
    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    kw = dict(image_height=H, tile_size=TILE, seed=SEED)

    img = render_radiance_sharded(scene, cam, W, SPP, mesh=mesh, **kw)
    start, stop, strip = render_strip_sharded(scene, cam, W, SPP, mesh=mesh,
                                              **kw)
    strip_dir = os.path.join(out_dir, "strips")
    multihost.write_host_strip(None, H, W, TILE, strip_dir,
                               strip=(start, stop,
                                      (strip / SPP).cpu().numpy()))
    rows = multihost.host_local_rows(H, W, TILE)

    ck = os.path.join(out_dir, "ck.npz")
    ck_kw = dict(mesh=mesh, spp_chunk=2, **kw)
    full = render_checkpointed_sharded(scene, cam, W, 4, **ck_kw)
    render_checkpointed_sharded(scene, cam, W, 2, checkpoint_path=ck,
                                **ck_kw)
    resumed = render_checkpointed_sharded(scene, cam, W, 4,
                                          checkpoint_path=ck, **ck_kw)

    target = img.cpu()
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.5, 0, 1))
    loss, new = sharded_train_step(bad, cam, target, W, SPP, mesh=mesh,
                                   lr=1.0, tile_size=TILE, seed=SEED)

    mesh_s = make_render_mesh(1, world, device=device)
    img_s = render_radiance_sharded(scene, cam, W, SPP, mesh=mesh_s, **kw)
    loss_s, new_s = sharded_train_step(bad, cam, target, W, SPP, mesh=mesh_s,
                                       lr=1.0, tile_size=TILE, seed=SEED)
    mesh.barrier()

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             image=img.cpu().numpy(), albedo=new.albedo.cpu().numpy(),
             center=new.center.cpu().numpy(),
             image_samples=img_s.cpu().numpy(),
             albedo_samples=new_s.albedo.cpu().numpy())
    out = {"rank": rank, "device": str(mesh.device),
           "strip": [start, stop], "host_local_rows": rows,
           "ckpt_resume_bitwise": bool(
               np.array_equal(full.strip_sum, resumed.strip_sum)
               and (full.start, full.stop) == (resumed.start, resumed.stop)
               and resumed.samples_done == 4),
           "loss": float(loss), "loss_samples": float(loss_s)}
    print("RESULT " + json.dumps(out), flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
