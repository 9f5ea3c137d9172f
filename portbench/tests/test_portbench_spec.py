"""BENCHMARK.json against the contract, and the files it names."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.harness import spec
from portbench.harness.main import Run, load_reader, loop_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_json(spec.ROOT, "BENCHMARK.json")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) < 65536


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        names += [w["name"], w["config"], w["traffic"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert all(NAME.match(n) for n in names)


def test_every_cell_reports_setup_an_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["end_to_end"]
                                  + BENCH["per_layer"]])
def test_every_metric_has_a_reader(name):
    assert callable(load_reader(name).read)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_names_files_that_exist(cell):
    c = spec.load_cell(cell)
    loop = loop_module(c)
    kind = getattr(loop, "KIND", c.traffic["loop"])
    assert kind in ("render", "grad") and Run(c).kind == kind
    assert callable(loop.Loop) and callable(Run(c).roofline.work)
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())
    assert c.config["segments_per_path"]["value"] > 1.0


#: A child process that runs cells of a checkout on the CPU at tiny films
#: (the program from this repository) and prints, as its last line, each
#: run's metric names and the roofline module of each cell.
_CHILD = """
import contextlib, io, json, sys, time
sys.path[:0] = [{root!r}, {repo!r}]
from portbench.harness.main import Run, main
from portbench.harness.spec import load_cell
out = {{}}
for cell in {cells!r}:
    for trace in (0, 1):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main(["--workload", cell, "--seed", "2300000413",
                       "--seconds", "1", "--trace", str(trace)],
                      time.perf_counter(), allow_cpu=True,
                      overrides={over!r})
        r = json.loads(buf.getvalue().strip().splitlines()[-1])
        out[cell + ":" + str(trace)] = [rc, r["correct"], sorted(r["metrics"])]
    out[cell + ":roofline"] = Run(load_cell(cell)).roofline.__file__
print(json.dumps(out))
"""


@pytest.mark.parametrize("case", ["config", "loop"])
def test_a_cell_config_and_metric_are_added_without_editing_a_file(
        tmp_path, case):
    """A new configuration, traffic mix, cell, limits and metric are new
    files and new entries of BENCHMARK.json alone (``config``); so is a new
    loop module of a known ``KIND`` with its own roofline, whose cell then
    reports what a cell of that kind reports, on the CPU (``loop``)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    pb = root / "portbench"
    new = {"config": ("diel_hollow", "540p", "calls_per_s"),
           "loop": ("render_again",)}[case]
    if case == "config":
        cfg = json.loads((pb / "configs" / "diel_defocus.json").read_text())
        cfg["name"] = "diel_hollow"
        cfg["scene"]["args"]["left_radius"] = -0.5
        (pb / "configs" / "diel_hollow.json").write_text(json.dumps(cfg))
        traffic = json.loads((pb / "traffic" / "render_1080p.json")
                             .read_text())
        traffic.update(width=960, height=540)
        (pb / "traffic" / "render_540p.json").write_text(json.dumps(traffic))
        (pb / "limits" / "diel_hollow.render_540p.json").write_text(
            json.dumps({"block_z_max": 6.0, "block_z2_mean": 2.0}))
        (pb / "metrics" / "calls_per_s.render.py").write_text(
            "def read(run):\n    return len(run.call_s) / run.window_s\n")
        bench["configs"].append({"name": "diel_hollow", "source": "x",
                                 "file": "portbench/configs/diel_hollow.json",
                                 "reduced": [], "why": "x"})
        cell_name = "diel_hollow.render_540p"
        bench["workloads"].append({"name": cell_name, "config": "diel_hollow",
                                   "traffic": "render_540p", "chips": 1,
                                   "why": "x"})
        bench["per_layer"].append({"name": "calls_per_s.render",
                                   "unit": "1/s", "better": "higher",
                                   "source": "host_clock", "layer": "entry",
                                   "moves": "render_mpaths_s",
                                   "workloads": [cell_name]})
    else:
        (pb / "loops" / "render_again.py").write_text(
            '"""The render loop in a file of its own."""\n'
            "from .render import Loop, VARIANTS  # noqa: F401\n"
            'KIND = "render"\n')
        (pb / "roofline" / "render_again.py").write_text(
            "from .render import work  # noqa: F401\n")
        traffic = json.loads((pb / "traffic" / "render_96px.json")
                             .read_text())
        traffic["loop"] = "render_again"
        (pb / "traffic" / "render_again_96px.json").write_text(
            json.dumps(traffic))
        cell_name = "diel_defocus.render_again_96px"
        (pb / "limits" / (cell_name + ".json")).write_bytes(
            (pb / "limits" / "diel_defocus.render_96px.json").read_bytes())
        bench["workloads"].append({"name": cell_name,
                                   "config": "diel_defocus",
                                   "traffic": "render_again_96px",
                                   "chips": 1, "why": "x"})
        for m in bench["per_layer"]:
            if m["name"].endswith(".render"):
                m["workloads"].append(cell_name)
    for m in bench["end_to_end"]:
        if m["name"] == "render_mpaths_s":
            m["workloads"].append(cell_name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file() and not any(n in p.name for n in new)}
    cell = spec.load_cell(cell_name, str(root))
    if case == "config":
        assert cell.config["scene"]["args"]["left_radius"] == -0.5
        assert cell.traffic["width"] == 960
        assert [m["name"] for m in cell.per_layer] == ["calls_per_s.render"]
        assert callable(load_reader("calls_per_s.render", str(pb)).read)
    else:
        old = "diel_defocus.render_96px"
        code = _CHILD.format(root=str(root), repo=spec.ROOT,
                             cells=[cell_name, old],
                             over={"width": 64, "height": 36,
                                   "check": {"blocks": [4, 3],
                                             "reference_jittered_spp": 4}})
        p = subprocess.run([sys.executable, "-c", code], cwd=root,
                           capture_output=True, text=True, timeout=600,
                           env=dict(os.environ, PYTHONDONTWRITEBYTECODE="1"))
        assert p.returncode == 0, p.stderr[-4000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out[cell_name + ":roofline"] == str(
            pb / "roofline" / "render_again.py")
        for trace in (0, 1):
            rc, correct, names = out[f"{cell_name}:{trace}"]
            assert rc == 0 and correct is True
            assert names == out[f"{old}:{trace}"][2]
        assert "render_mpaths_s" in out[cell_name + ":0"][2]
        traced = out[cell_name + ":1"][2]
        assert {"call_p95_ms.render", "setup_pct.render",
                "iter_host_us.render"} <= set(traced)
        assert all(n.endswith(".render") for n in traced)
    assert all(p.read_bytes() == b for p, b in before.items())
