"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix, limits and metrics, each found by name.

- configuration ``<config>``: ``portbench/configs/<config>.json``;
- traffic mix ``<traffic>``: ``portbench/traffic/<traffic>.json``, whose
  ``loop`` names the module ``portbench/loops/<loop>.py``: the loop, its
  plain reference's check, and its ``KIND`` (``"render"`` or ``"grad"``;
  the file name where it sets none), the kind of run whose metrics the
  cell reports;
- a cell's limits on the numbers that decide ``correct``:
  ``portbench/limits/<cell>.json``;
- metric ``<name>``: ``portbench/metrics/<name>.py`` (its ``read``);
- the work a loop counts for a roofline: ``portbench/roofline/<loop>.py``,
  by the loop's file name, not its kind.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the metric entries this cell reports, in order
    per_layer: list


def _reports(metric: dict, cell: str, reported: set | None = None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root, configs[w["config"]]["file"])
    pkg = os.path.join(root, "portbench")
    traffic = load_json(pkg, "traffic", w["traffic"] + ".json")
    limits = load_json(pkg, "limits", name + ".json")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name, int(w["chips"]), config, traffic, limits, e2e,
                per_layer)
