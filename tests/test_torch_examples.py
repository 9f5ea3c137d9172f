"""The port's example and demo scripts run end to end on the CPU at a tiny
size: ``examples/tutorial_torch.py`` (every chapter) and
``scripts/torch_inverse_render.py`` (the SPSA fit and the edge fit through
``fit_scene_scan``), each writing only into the directory it is given."""

import importlib.util
import json
import os

import pytest

# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(rel):
    spec = importlib.util.spec_from_file_location(
        os.path.basename(rel)[:-3], os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tutorial_runs_every_chapter(tmp_path, capsys):
    out = tmp_path / "tut"
    _load("examples/tutorial_torch.py").main(
        ["--device", "cpu", "--width", "16", "--spp", "1", "--out-dir",
         str(out)])
    text = capsys.readouterr().out
    assert "=== Chapter 10" in text
    assert "equal to the uninterrupted run: True" in text
    assert sorted(p.name for p in out.iterdir()) == [
        "ch10_checkpoint.npz", "ch1_sky.png", "ch2_two_spheres.png",
        "ch3_metal.png", "ch4_glass.png", "ch5_defocus.png",
        "ch6_random_spheres.png"]


@pytest.mark.parametrize("extra", [[], ["--geom", "edge", "--scan"]])
def test_inverse_script_runs(extra, tmp_path, monkeypatch):
    # The history record goes to the working directory's port history.
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "inv"
    rec = _load("scripts/torch_inverse_render.py").main(
        ["--cpu", "--width", "24", "--height", "14", "--spp", "1",
         "--steps", "2", "--out-dir", str(out)] + extra)
    steps = [json.loads(line) for line in open(out / "loss_history.jsonl")]
    assert [s["step"] for s in steps] == [0, 1]
    names = {p.name for p in out.iterdir()}
    assert {"target.png", "initial.png", "final.png"} <= names
    assert rec["n_movable"] == 3 and rec["device"]["name"] is None
    hist = [json.loads(line) for line in open("bench_history_torch.jsonl")]
    assert hist[-1]["label"] == rec["label"]
