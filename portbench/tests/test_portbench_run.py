"""Whole runs of the harness: on the CPU at tiny films (the look for a card
skipped, the program on its kernels' plain versions), with the program
sound, replaced by its control, or broken underneath; the command's exits
where it must print no result; and one run on the card."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

from portbench.harness.main import FORBIDDEN, main
from portbench.harness.spec import ROOT

#: Tiny films: blocks of 16 x 12 pixels, few reference samples and steps.
SMALL = {"width": 64, "height": 36,
         "check": {"blocks": [4, 3], "reference_jittered_spp": 4,
                   "reference_steps": 6}}
TINY = dict(SMALL, width=32, height=18)


class _Clock:
    """A host clock that advances half a second a reading: the window's
    loop reads it twice a call, so a window of ``s`` seconds is ``s``
    calls on any machine, and a test's outcome is the same on each run."""

    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        self.now += 0.5
        return self.now


@pytest.fixture(autouse=True)
def _calls_not_seconds(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr("portbench.harness.main.time", clock)
    monkeypatch.setattr("portbench.loops.grad.time", clock)
    return clock


def _run(capsys, cell, variant="port", seconds=2.0, trace=0, seed=7,
         overrides=SMALL):
    rc = main(["--workload", cell, "--seed", str(seed), "--seconds",
               str(seconds), "--trace", str(trace)], 0.0,
              allow_cpu=True, variant=variant, overrides=overrides)
    out, err = capsys.readouterr()
    assert rc == 0, err
    result = json.loads(out.strip().splitlines()[-1])
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")
    return result


@pytest.mark.parametrize("variant,correct", [
    ("port", True), ("control", False), ("unchanged", False),
    ("half_batch", False), ("altered", False)])
def test_render_cell_is_correct_only_when_sound(capsys, variant, correct):
    r = _run(capsys, "diel_defocus.render_96px", variant)
    assert r["correct"] is correct, r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"render_mpaths_s", "setup_s"}


@pytest.mark.parametrize("variant,correct", [
    ("port", True), ("control", False), ("altered", False)])
def test_book1_render_cell(capsys, variant, correct):
    r = _run(capsys, "book1_final.render_1080p", variant, seconds=1.0,
             overrides=TINY)
    assert r["correct"] is correct, r["checks"]


@pytest.mark.parametrize("variant,correct", [
    ("port", True), ("control", False), ("unchanged", False),
    ("half_batch", False), ("altered", False), ("constant", False)])
def test_grad_cell_is_correct_only_when_sound(capsys, variant, correct):
    r = _run(capsys, "book1_final.grad_1080p", variant, seconds=8.0,
             overrides=dict(SMALL, check=dict(SMALL["check"],
                                              reference_steps=16)))
    assert r["correct"] is correct, r["checks"]
    assert set(r["metrics"]) == {"grad_mpaths_s", "setup_s"}
    mismatch = r["checks"]["constant_mismatch"]["value"]
    assert (mismatch > 0) is (variant == "constant"), r["checks"]


def test_setup_leaves_out_the_reference_target(capsys, monkeypatch,
                                               _calls_not_seconds):
    """The grad cell's target is the reference's work, not set-up: a target
    that takes 100 s of the clock leaves ``setup_s`` as it was."""
    from portbench.loops import grad
    plain = _run(capsys, "book1_final.grad_1080p", seconds=1.0)
    render_sum = grad.render_sum

    def slow(*args):
        _calls_not_seconds.now += 100.0
        return render_sum(*args)
    monkeypatch.setattr(grad, "render_sum", slow)
    _calls_not_seconds.now = 0.0
    r = _run(capsys, "book1_final.grad_1080p", seconds=1.0)
    setup = r["metrics"]["setup_s"]["value"]
    assert setup == plain["metrics"]["setup_s"]["value"] < 100.0


def test_traced_run_reports_the_per_layer_metrics_it_can_read(capsys):
    r = _run(capsys, "diel_defocus.render_96px", trace=1)
    assert r["correct"] is True
    assert "breakdown" in r and "window_s" in r["device"]
    assert "call_p95_ms.render" in r["metrics"]
    assert "setup_s" not in r["metrics"]


_CHILD = """
import json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
from portbench.harness.main import main
rc = main({argv!r}, t0, allow_cpu=True, overrides={over!r})
print("MODULES " + json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})),
      file=sys.stderr)
sys.exit(rc)
"""


def _child(cwd, argv, over=SMALL, root=ROOT):
    code = _CHILD.format(root=root, argv=argv, over=over)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_no_jax(tmp_path):
    """One cell's run in a process of its own: no loaded module's top-level
    name is JAX's or the JAX package's (the program's passes)."""
    p = _child(tmp_path, ["--workload", "diel_defocus.render_96px",
                          "--seed", "3", "--seconds", "1", "--trace", "0"])
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
    line = [x for x in p.stderr.splitlines() if x.startswith("MODULES ")][-1]
    top = set(json.loads(line[len("MODULES "):]))
    assert "raytracingweekend_jl_tpu_torch" in top
    assert not top & set(FORBIDDEN)


@pytest.mark.parametrize("where", ["reader", "check"])
def test_a_run_that_loads_jax_prints_no_result(capsys, monkeypatch, where):
    """A module named ``jax`` that a metric's reader or the check loads
    once the window has closed: the run exits 4 and prints no result."""
    import portbench.harness.main as harness
    from portbench.loops import render

    def load_jax():
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))

    if where == "reader":
        load = harness.load_reader

        def load_reader(name, pkg=harness.PKG):
            load_jax()
            return load(name, pkg)
        monkeypatch.setattr(harness, "load_reader", load_reader)
    else:
        check = render.Loop.check

        def planted(self):
            load_jax()
            return check(self)
        monkeypatch.setattr(render.Loop, "check", planted)
    rc = main(["--workload", "diel_defocus.render_96px", "--seed", "3",
               "--seconds", "1", "--trace", "0"], 0.0, allow_cpu=True,
              overrides=SMALL)
    out, err = capsys.readouterr()
    assert rc == 4 and out == "", out
    assert "jax" in err.splitlines()[-1]


def test_without_a_card_the_command_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "book1_final.render_1080p", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_a_directory_of_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    p = _child(tmp_path, ["--workload", "diel_defocus.render_96px",
                          "--seed", "3", "--seconds", "1", "--trace", "0"],
               root=str(tmp_path))
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "book1_final.render_1080p", "--seed", "11",
                        "--seconds", "2", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
