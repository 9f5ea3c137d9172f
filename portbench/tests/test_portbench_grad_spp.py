"""The loop of a gradient step at several samples a pixel
(``loops/grad_spp.py``) on the CPU at tiny films, the program on its
kernels' plain versions: its reference step at one sample a pixel against
the reference's own step, and whole runs with the program sound, replaced
by its control, or broken underneath."""

import json

import pytest
import torch

from portbench.harness.main import main
from portbench.harness.seeds import generator
from portbench.harness.spec import load_cell
from portbench.reference import tracer
from portbench.reference.camera import (camera_arrays, camera_rays,
                                        camera_tensors)
from portbench.reference.grad_spp import grad_step_spp
from portbench.reference.scene import FLOAT_FIELDS, scene_arrays, scene_tensors

CELL = "book1_final.grad_1080p_spp4"
#: A tiny film and its check: 16 reference steps, as the cell takes.
TINY = {"width": 32, "height": 18, "check": {"reference_steps": 16}}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def test_one_sample_is_the_references_step():
    """At one sample a pixel, in one block, the step is
    :func:`tracer.grad_step`: the same draws and the same loss bit for bit;
    the gradients, summed in float64 before their one rounding, within a
    few float32 roundings of the reference's sums in float32."""
    cfg = load_cell(CELL).config
    scene = scene_tensors(scene_arrays(cfg["scene"]), torch.float32, "cpu")
    cam = camera_tensors(camera_arrays(cfg["camera"]), torch.float32, "cpu")
    target = torch.rand((18, 32, 3),
                        generator=torch.Generator().manual_seed(0))
    args = (scene, cam, 32, 18, target)
    loss, grads = tracer.grad_step(*args, generator(3, "step", "cpu"), 16,
                                   1e-4)
    loss_b, grads_b = grad_step_spp(*args, generator(3, "step", "cpu"), 16,
                                    1e-4, 1)
    assert torch.equal(_bits(loss), _bits(loss_b))
    for f in FLOAT_FIELDS:
        scale = float(grads[f].abs().max())
        assert torch.allclose(grads_b[f], grads[f], rtol=1e-5,
                              atol=1e-6 * scale), f


def test_the_trace_is_the_references_bit_for_bit():
    """:func:`grad_spp.trace` draws and returns what :func:`tracer.trace`
    does, bit for bit; only its gradients are summed otherwise."""
    from portbench.reference import grad_spp
    cfg = load_cell(CELL).config
    scene = scene_tensors(scene_arrays(cfg["scene"]), torch.float32, "cpu")
    cam = camera_tensors(camera_arrays(cfg["camera"]), torch.float32, "cpu")
    pixels = torch.arange(32 * 18)
    o, d = camera_rays(cam, 32, 18, pixels, generator(4, "rays", "cpu"),
                       True, torch.float32)
    a = tracer.trace(scene, o, d, generator(4, "t", "cpu"), 16, 1e-4,
                     differentiable=True)
    b = grad_spp.trace(scene, o, d, generator(4, "t", "cpu"), 16, 1e-4)
    assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("block_rays", [2 * 7, 2 * 144])
def test_blocks_cover_the_film_once(monkeypatch, block_rays):
    """With a tracer whose every path returns the first sphere's albedo,
    whatever the draws, the loss and its gradient are known exactly:
    blocks of a few pixels (the last one short) count every pixel once,
    each with its share of the mean."""
    from portbench.reference import grad_spp
    monkeypatch.setattr(grad_spp, "trace", lambda sc, o, *args, **kw:
                        torch.ones_like(o) * sc["albedo"][0])
    cfg = load_cell(CELL).config
    scene = scene_tensors(scene_arrays(cfg["scene"]), torch.float64, "cpu")
    cam = camera_tensors(camera_arrays(cfg["camera"]), torch.float64, "cpu")
    target = torch.rand((9, 16, 3), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(1))
    loss, grads = grad_step_spp(scene, cam, 16, 9, target,
                                generator(5, "a", "cpu"), 16, 1e-4, 2,
                                block_rays=block_rays)
    diff = scene["albedo"][0] - target
    assert float(loss) == pytest.approx(float((diff ** 2).mean()), rel=1e-12)
    want = 2.0 * diff.sum((0, 1)) / diff.numel()
    assert torch.allclose(grads["albedo"][0], want, rtol=1e-12, atol=0.0)
    assert not grads["albedo"][1:].any() and not grads["center"].any()


class _Clock:
    """Half a second a reading: a window of ``s`` seconds is ``s`` steps,
    on any machine."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 0.5
        return self.now


@pytest.fixture(autouse=True)
def _steps_not_seconds(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr("portbench.harness.main.time", clock)
    monkeypatch.setattr("portbench.loops.grad.time", clock)


@pytest.mark.parametrize("variant,seconds,correct", [
    ("port", 8.0, True), ("control", 8.0, False), ("unchanged", 3.0, False),
    ("half_batch", 3.0, False), ("altered", 3.0, False),
    ("constant", 3.0, False)])
def test_grad_spp_cell_is_correct_only_when_sound(capsys, variant, seconds,
                                                  correct):
    """The cell's loop at a tiny film, the program on the route and budget
    it picks by itself: correct when sound, not with the control or a
    fault underneath."""
    rc = main(["--workload", CELL, "--seed", "2300000417", "--seconds",
               str(seconds), "--trace", "0"], 0.0, allow_cpu=True,
              variant=variant, overrides=TINY)
    out, err = capsys.readouterr()
    assert rc == 0, err
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] is correct, r["checks"]
    assert set(r["metrics"]) == {"grad_mpaths_s", "setup_s"}
    mismatch = r["checks"]["constant_mismatch"]["value"]
    assert (mismatch > 0) is (variant == "constant"), r["checks"]
