"""BENCHMARK.json against the contract, and the files it names."""

import json
import os
import re
import shutil

import pytest

from portbench.harness import spec
from portbench.harness.main import load_reader

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
    assert c.traffic["loop"] in ("render", "grad")
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())
    assert c.config["segments_per_path"]["value"] > 1.0


def test_a_cell_config_and_metric_are_added_without_editing_a_file(tmp_path):
    """A new configuration, traffic mix, cell, limits and metric are new
    files and new entries of BENCHMARK.json alone."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "portbench"), root / "portbench")
    bench = json.loads(json.dumps(BENCH))
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "diel_defocus.json").read_text())
    cfg["name"] = "diel_hollow"
    cfg["scene"]["args"]["left_radius"] = -0.5
    (pb / "configs" / "diel_hollow.json").write_text(json.dumps(cfg))
    traffic = json.loads((pb / "traffic" / "render_1080p.json").read_text())
    traffic.update(width=960, height=540)
    (pb / "traffic" / "render_540p.json").write_text(json.dumps(traffic))
    (pb / "limits" / "diel_hollow.render_540p.json").write_text(
        json.dumps({"block_z_max": 6.0, "block_z2_mean": 2.0}))
    (pb / "metrics" / "calls_per_s.render.py").write_text(
        "def read(run):\n    return len(run.call_s) / run.window_s\n")
    bench["configs"].append({"name": "diel_hollow", "source": "x",
                             "file": "portbench/configs/diel_hollow.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "diel_hollow.render_540p",
                               "config": "diel_hollow",
                               "traffic": "render_540p", "chips": 1,
                               "why": "x"})
    bench["per_layer"].append({"name": "calls_per_s.render", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "render_mpaths_s",
                               "workloads": ["diel_hollow.render_540p"]})
    for m in bench["end_to_end"]:
        if m["name"] == "render_mpaths_s":
            m["workloads"].append("diel_hollow.render_540p")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file() and "diel_hollow" not in p.name
              and "540p" not in p.name and "calls_per_s" not in p.name}
    cell = spec.load_cell("diel_hollow.render_540p", str(root))
    assert cell.config["scene"]["args"]["left_radius"] == -0.5
    assert cell.traffic["width"] == 960
    assert [m["name"] for m in cell.per_layer] == ["calls_per_s.render"]
    assert callable(load_reader("calls_per_s.render", str(pb)).read)
    assert all(p.read_bytes() == b for p, b in before.items())
