"""A real two-process run of the port's parallel layer: two ranks join a
gloo process group through a ``file://`` store under the test's temporary
directory (no TCP port, so parallel test workers cannot collide), each runs
``tests/torch_multiproc_worker.py`` on the CPU, and the parent checks the
uneven 5 + 4 tile split, the strips assembled bit for bit into the world
of one's image, the resume on both ranks, the training step's loss and
scene equal on both ranks and to the world of one's, and the ``samples``
reduction across the two processes. Counterpart of
``tests/test_multiprocess.py``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch.parallel import multihost, shard
from raytracingweekend_jl_tpu_torch.parallel.mesh import make_render_mesh
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
import torch_multiproc_worker as worker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Seconds a rank may take; the whole run takes ~25 s on the CPU.
TIMEOUT = 120


def launch(args_of_rank, n: int, cwd: str, env_of_rank=None,
           timeout: int = TIMEOUT) -> list:
    """Run ``n`` processes (``args_of_rank(r)`` each, with the launcher
    variables ``env_of_rank(r)`` if given) at once; their stdouts. A rank
    that fails, or outlives ``timeout``, fails the test and every rank is
    killed."""
    env = {**os.environ, "PYTHONPATH": ROOT}
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_NTASKS",
                "OMPI_COMM_WORLD_SIZE"):
        env.pop(var, None)
    procs = [subprocess.Popen(args_of_rank(r), cwd=cwd,
                              env={**env, **(env_of_rank(r) if env_of_rank
                                             else {})},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def test_two_rank_gloo_render_strips_resume_and_step(tmp_path):
    store = f"file://{tmp_path / 'store'}"
    outs = launch(lambda r: [sys.executable, worker.__file__, str(r), "2",
                             store, str(tmp_path)], 2, str(tmp_path))
    recs = {}
    for out in outs:
        line = [x for x in out.splitlines() if x.startswith("RESULT ")]
        assert line, out[-2000:]
        rec = json.loads(line[-1][len("RESULT "):])
        recs[rec["rank"]] = rec
    assert set(recs) == {0, 1}
    (W, H, SPP, TILE), SEED = worker.SIZE, worker.SEED
    n_pix = W * H

    # 2304 pixels in 256-pixel tiles: 9 tiles over 2 ranks, 5 + 4.
    assert recs[0]["strip"] == recs[0]["host_local_rows"] == [0, 5 * TILE]
    assert recs[1]["strip"] == recs[1]["host_local_rows"] == [5 * TILE,
                                                             n_pix]
    for r in (0, 1):
        assert recs[r]["ckpt_resume_bitwise"] is True

    scene, cam = pt.scene_2_spheres(), pt.t_default_cam()
    mesh1 = make_render_mesh(device="cpu")
    ref = shard.render_radiance_sharded(scene, cam, W, SPP, mesh=mesh1,
                                        image_height=H, tile_size=TILE,
                                        seed=SEED).numpy()
    arrays = {r: dict(np.load(tmp_path / f"rank{r}.npz")) for r in (0, 1)}
    for r in (0, 1):
        assert recs[r]["device"] == "cpu"
        assert np.array_equal(arrays[r]["image"], ref)
    assembled = multihost.assemble_strips(str(tmp_path / "strips"))
    assert np.array_equal(assembled, ref)

    # The step: every rank holds the same loss and scene, the world of
    # one's bit for bit (the same rows, reduced in global tile order).
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.5, 0, 1))
    loss, new = shard.sharded_train_step(bad, cam, torch.from_numpy(ref), W,
                                         SPP, mesh=mesh1, lr=1.0,
                                         tile_size=TILE, seed=SEED)
    for r in (0, 1):
        assert recs[r]["loss"] == float(loss)
        assert np.array_equal(arrays[r]["albedo"], new.albedo.numpy())
        assert np.array_equal(arrays[r]["center"], new.center.numpy())

    # A (1 x 2) mesh: each rank renders one sample shard and the samples
    # reduction crosses the processes; both ranks agree bit for bit, and
    # with the tiles-only image to float-order precision.
    assert recs[0]["loss_samples"] == recs[1]["loss_samples"]
    for key in ("image_samples", "albedo_samples"):
        assert np.array_equal(arrays[0][key], arrays[1][key]), key
    np.testing.assert_allclose(arrays[0]["image_samples"], ref, atol=1e-5)
    assert recs[0]["loss_samples"] == pytest.approx(float(loss), rel=1e-5)
