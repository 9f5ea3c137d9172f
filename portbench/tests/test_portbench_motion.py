"""The moving scene's cell (``book2_motion.render_400px``): its loop on the
CPU at a tiny film, its faults, the reference of moving scenes against the
static reference, its roofline and the readers of its two metrics."""

import contextlib
import io
import json
import math
import types

import numpy as np
import pytest
import torch

from portbench.harness import profile
from portbench.harness.main import load_reader, main
from portbench.harness.peaks import least_time
from portbench.harness.spec import PKG, load_cell, load_json
from portbench.reference import motion, tracer
from portbench.reference.camera import camera_arrays, camera_tensors
from portbench.reference.scene import scene_arrays, scene_tensors
from portbench.roofline import render_motion

CELL = "book2_motion.render_400px"
#: A tiny film at 2 samples a call: blocks of 8 x 6 pixels.
TINY = {"width": 32, "height": 18, "spp_per_call": 2, "image_spp": 2,
        "check": {"blocks": [4, 3], "reference_jittered_spp": 4}}


class _Clock:
    """Half a second a reading: a window of ``s`` seconds is ``s`` calls."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 0.5
        return self.now


def _cell(grid_half: int | None = None):
    """The cell; with ``grid_half`` its lattice cut to ``(2 * grid_half)^2``
    grid cells, so that a traced run on the CPU, where every operation is
    recorded, takes seconds."""
    cell = load_cell(CELL)
    if grid_half is not None:
        cell.config = dict(cell.config, scene={
            "module": "bouncing_spheres",
            "args": {"seed": 1, "grid_half": grid_half}})
    return cell


def _run(variant="port", trace=0, grid_half=None):
    out, err = io.StringIO(), io.StringIO()
    cell = _cell(grid_half)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("portbench.harness.main.time", _Clock())
        mp.setattr("portbench.harness.main.load_cell",
                   lambda name, root: cell)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(["--workload", CELL, "--seed", "2300024017",
                       "--seconds", "1", "--trace", str(trace)], 0.0,
                      allow_cpu=True, variant=variant, overrides=TINY)
    assert rc == 0, err.getvalue()
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("variant,correct", [("port", True),
                                             ("control", False)])
def test_motion_cell_is_correct_only_when_sound(variant, correct):
    r = _run(variant)
    assert r["correct"] is correct, r["checks"]
    assert set(r["metrics"]) == {"render_mpaths_s", "setup_s"}


def test_traced_run_reads_the_motion_setup():
    from raytracingweekend_jl_tpu_torch.utils import profiling
    profiling.reset()
    r = _run(trace=1, grid_half=2)
    assert r["correct"] is True
    value = r["metrics"]["motion_setup_ms.render"]["value"]
    assert math.isfinite(value) and value > 0
    # No kernel runs on the CPU: the moving sweep's roofline reads nothing.
    assert "sweep_motion_roofline.render" not in r["metrics"]
    moving = int((motion.motion_array(_cell(2).config["scene"]) != 0)
                 .any(1).sum())
    s = profiling.summary()
    assert moving > 0 and s["counters"]["rtw.render.moving_spheres"] == \
        moving * s["spans"]["rtw.render.call"]["count"]


def test_the_loop_renders_the_moving_scene_and_frozen_zeroes_it(
        monkeypatch):
    """The program's scene is a ``MovingScene`` with the configuration's
    386 moving spheres; the ``frozen`` fault hands it the same scene with
    every motion zero."""
    import importlib
    from portbench.loops import render_motion as loop_mod
    R = importlib.import_module("raytracingweekend_jl_tpu_torch.render")
    seen = []
    monkeypatch.setattr(R, "render_tile_sum",
                        lambda scene, *a, **k: seen.append(scene))
    cell = load_cell(CELL)
    for variant in ("port", "frozen"):
        loop = loop_mod.Loop(cell, 5, "cpu", variant, TINY)
        loop.program(1, 0)
    port, frozen = seen
    assert type(port).__name__ == "MovingScene" and port.n_spheres == 488
    assert int((port.motion != 0).any(1).sum()) == 386
    assert torch.equal(frozen.motion, torch.zeros_like(port.motion))
    assert all(torch.equal(a, b) for a, b in zip(port[:6], frozen[:6]))


def test_still_motion_is_the_static_reference_bit_for_bit():
    """With every motion zero, the reference of moving scenes sweeps and
    traces as :mod:`reference.tracer` does, bit for bit, draw for draw."""
    cfg = load_json(PKG, "configs", "book1_final.json")
    arrays = scene_arrays(cfg["scene"])
    still = motion.moving_tensors(arrays, np.zeros((486, 3)), torch.float32,
                                  "cpu")
    static = scene_tensors(arrays, torch.float32, "cpu")
    cam = camera_tensors(camera_arrays(cfg["camera"]), torch.float32, "cpu")
    pixels = torch.arange(16 * 9)
    o, d = tracer.camera_rays(cam, 16, 9, pixels, torch.Generator()
                              .manual_seed(1), True, torch.float32)
    times = torch.rand(o.shape[0], generator=torch.Generator().manual_seed(2))
    t, w = motion.closest_hit(still, o, d, times, 1e-4)
    t_s, w_s, _ = tracer._sweep(o, d, static, 1e-4)
    assert torch.equal(t, t_s) and torch.equal(w, w_s)
    a = motion.trace(still, o, d, times, torch.Generator().manual_seed(3),
                     16, 1e-4)
    b = tracer.trace(static, o, d, torch.Generator().manual_seed(3), 16,
                     1e-4)
    assert torch.equal(a, b)


def test_the_configuration_is_book1s_lattice_and_camera():
    mine = load_json(PKG, "configs", "book2_motion.json")
    book1 = load_json(PKG, "configs", "book1_final.json")
    assert mine["camera"] == book1["camera"]
    assert mine["max_depth"] == 50 and mine["tmin"] == book1["tmin"]
    a = scene_arrays(mine["scene"])
    b = scene_arrays(book1["scene"])
    assert all(np.array_equal(a[f], b[f]) for f in b)
    m = motion.motion_array(mine["scene"])
    assert int((m != 0).any(1).sum()) == mine["n_moving"] == 386
    assert mine["segments_per_path"]["value"] > 1.0


def test_the_roofline_counts_the_moving_pair():
    loop = types.SimpleNamespace(segments_per_path=3.0, n_spheres=486,
                                 spp=100)
    w = render_motion.work(loop, 9_000_000)
    assert w["ops"] == pytest.approx(9e6 * 3.0 * (486 * 26 + 156))
    assert w["bytes"] == pytest.approx(9e6 / 100 * 12)
    s = render_motion.sweep_work(loop, 9_000_000)
    assert s["ops"] == pytest.approx(9e6 * 3.0 * 486 * 26)
    assert s["bytes"] == pytest.approx(9e6 * 3.0 * 36)
    assert least_time(s)["bound_by"] == "operations"


#: A traced window of 1 000 us: the moving sweep twice (250 us), K2m once.
TRACE = [
    {"ph": "X", "cat": "user_annotation", "name": "portbench.traced",
     "ts": 0.0, "dur": 1000.0, "tid": 1},
    {"ph": "X", "cat": "kernel", "ts": 10.0, "dur": 200.0, "tid": 7,
     "name": "sweep_motion_kernel(float const*, float const*, float4 "
             "const*, int, int, float, int, float*, int*)"},
    {"ph": "X", "cat": "kernel", "name": "shade_strided_motion_kernel",
     "ts": 300.0, "dur": 100.0, "tid": 7},
    {"ph": "X", "cat": "kernel", "ts": 500.0, "dur": 50.0, "tid": 7,
     "name": "sweep_motion_kernel(float const*, float const*, float4 "
             "const*, int, int, float, int, float*, int*)"},
    {"ph": "X", "cat": "kernel", "name": "sweep_kernel", "ts": 600.0,
     "dur": 100.0, "tid": 7},
]


def _traced_run(events, roofline=render_motion, kind="render"):
    loop = types.SimpleNamespace(segments_per_path=3.0, n_spheres=486,
                                 spp=100)
    return types.SimpleNamespace(kind=kind, traced=profile.summarize(events),
                                 traced_paths=4000, loop=loop,
                                 roofline=roofline)


def test_sweep_motion_roofline_reads_the_moving_sweeps_time():
    read = load_reader("sweep_motion_roofline.render").read
    got = read(_traced_run(TRACE))
    assert got == pytest.approx(100 * 4000 * 3.0 * 486 * 26 / 67e12
                                / 250e-6)
    # Nothing without the kernel (a static cell, or the parent), without a
    # moving roofline, or untraced.
    assert read(_traced_run([e for e in TRACE
                             if "motion" not in e["name"]])) is None
    from portbench.roofline import render
    assert read(_traced_run(TRACE, roofline=render)) is None
    assert read(types.SimpleNamespace(kind="render", traced=None)) is None
    assert read(_traced_run(TRACE, kind="grad")) is None


def test_motion_setup_reads_the_packing_span_a_call(monkeypatch):
    from raytracingweekend_jl_tpu_torch.utils import profiling
    read = load_reader("motion_setup_ms.render").read
    spans = {"rtw.render.call": {"count": 4, "total_s": 0.2, "self_s": 0.1},
             "rtw.render.motion_table": {"count": 4, "total_s": 0.002,
                                         "self_s": 0.002}}
    monkeypatch.setattr(profiling, "summary",
                        lambda: {"spans": spans, "counters": {}})
    run = types.SimpleNamespace(kind="render", traced=object())
    assert read(run) == pytest.approx(0.5)
    del spans["rtw.render.motion_table"]   # a static scene's calls
    assert read(run) is None
    assert read(types.SimpleNamespace(kind="render", traced=None)) is None
    monkeypatch.delattr(profiling, "summary")   # a program without spans
    assert read(run) is None
