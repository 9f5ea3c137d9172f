"""The plain reference: what it imports, the inputs it builds against the
program's own scene and camera functions, its sweep against the program's
plain sweep."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness.spec import PKG, ROOT, load_json
from portbench.reference import tracer
from portbench.reference.camera import camera_arrays, camera_tensors
from portbench.reference.scene import padded, scene_arrays, scene_tensors

ALLOWED = {"__future__", "math", "importlib", "numpy", "torch"}


def _imports(path):
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(PKG, "reference")
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                assert set(_imports(os.path.join(dirpath, f))) <= ALLOWED, f
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.reference.tracer, portbench.reference.scenes."
            "random_spheres, portbench.reference.scenes.diel_spheres; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    assert "raytracingweekend_jl_tpu_torch" not in out
    assert "'jax'" not in out and "raytracingweekend_jl_tpu'" not in out


@pytest.mark.parametrize("config,make,cam", [
    ("book1_final", "scene_random_spheres", "t_cam1"),
    ("diel_defocus", "scene_diel_spheres", "t_cam2")])
def test_inputs_equal_the_programs_own_scenes(config, make, cam):
    from raytracingweekend_jl_tpu_torch import camera as pcam
    from raytracingweekend_jl_tpu_torch.models import scenes as pscenes
    from raytracingweekend_jl_tpu_torch.scene import trim_scene
    cfg = load_json(PKG, "configs", config + ".json")
    arrays = scene_arrays(cfg["scene"])
    assert arrays["radius"].shape[0] == cfg["n_spheres"]
    mine = scene_tensors(padded(arrays, cfg["pad_to"]), torch.float32, "cpu")
    theirs = trim_scene(getattr(pscenes, make)())
    for f in theirs._fields:
        assert torch.equal(mine[f], getattr(theirs, f)), f
    c = camera_tensors(camera_arrays(cfg["camera"]), torch.float32, "cpu")
    for f, x in getattr(pcam, cam)()._asdict().items():
        assert torch.equal(c[f], x), f


def test_the_sweep_is_the_programs_plain_sweep_bit_for_bit():
    """The reference's sweep rounds as the program's plain K1 does (the
    kernel's expanded form, every operation rounded on its own)."""
    from raytracingweekend_jl_tpu_torch.ops.cuda.intersect_kernel import (
        sphere_consts, sweep_ref)
    from raytracingweekend_jl_tpu_torch.scene import Scene
    cfg = load_json(PKG, "configs", "book1_final.json")
    sc = scene_tensors(scene_arrays(cfg["scene"]), torch.float32, "cpu")
    g = torch.Generator().manual_seed(0)
    o = torch.randn((4096, 3), generator=g) * 3 + torch.tensor([0., 2., 0.])
    d = torch.randn((4096, 3), generator=g)
    d = d / d.norm(dim=-1, keepdim=True)
    t, w, _ = tracer._sweep(o, d, sc, 1e-4)
    t_k, w_k = sweep_ref(torch.cat([o, d], 1).T.contiguous(),
                         sphere_consts(Scene(**sc)), 1e-4)
    hit = t_k < tracer.BIG
    assert torch.equal(t < tracer.BIG, hit) and int(hit.sum()) > 1000
    assert torch.equal(t[hit], t_k[hit])
    assert torch.equal(w[hit].to(torch.int32), w_k[hit])


def test_the_reference_image_is_the_programs_in_distribution():
    """Over 16 samples of a 48x27 film of the defocus scene, the program's
    plain strided render and the reference's agree in the mean radiance
    of each channel within 4 standard errors."""
    from raytracingweekend_jl_tpu_torch.camera import Camera
    from raytracingweekend_jl_tpu_torch.render import render_tile_sum
    from raytracingweekend_jl_tpu_torch.scene import Scene
    cfg = load_json(PKG, "configs", "diel_defocus.json")
    W, H, S = 48, 27, 16
    arrays = scene_arrays(cfg["scene"])
    sc = scene_tensors(arrays, torch.float32, "cpu")
    cam = camera_tensors(camera_arrays(cfg["camera"]), torch.float32, "cpu")
    prog = render_tile_sum(Scene(**scene_tensors(padded(arrays, 8),
                                                 torch.float32, "cpu")),
                           Camera(**cam), W * H, 5, S, 1, 16, 1e-4,
                           float(W), float(H), persistent=True,
                           inline=False) / S
    ref = torch.stack([tracer.render_sum(
        sc, cam, W, H, torch.Generator().manual_seed(k), 1, 1, 16, 1e-4)
        for k in range(S)])
    se = ref.std(0).pow(2).mean(0).sqrt() / np.sqrt(W * H) \
        * np.sqrt(1 / S + 1 / S)
    gap = (prog.mean(0) - ref.mean((0, 1))).abs()
    assert bool((gap < 4 * se).all()), (gap, se)
