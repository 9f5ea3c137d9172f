"""The readers of the program's own spans and counters, on whole runs of the
harness at tiny films on the CPU (the program on its kernels' plain
versions): each reads a finite number in a traced run of its cell and
nothing untraced, and the program counted exactly the calls the harness
traced."""

import contextlib
import io
import json
import math
import re
import types

import pytest

from portbench.harness.main import Run, load_reader, main
from portbench.harness.spans import ROOTS
from portbench.harness.spec import ROOT, load_cell, load_json

#: Tiny films: blocks of 16 x 12 pixels, few reference samples and steps.
SMALL = {"width": 64, "height": 36,
         "check": {"blocks": [4, 3], "reference_jittered_spp": 4,
                   "reference_steps": 4}}
CELLS = {"render": "diel_defocus.render_96px",
         "grad": "book1_final.grad_1080p"}
READERS = {
    "setup_pct.render": "render", "iter_host_us.render": "render",
    "program_syncs_per_call.render": "render",
    "record_host_ms.grad": "grad", "backward_host_ms.grad": "grad",
    "program_syncs_per_step.grad": "grad", "record_iter_host_us.grad": "grad",
}


class _Clock:
    """Half a second a reading: a window of ``s`` seconds is ``s`` calls,
    the traced sub-window four. A reading of ``tick`` seconds makes the
    traced sub-window ``ceil(2 / tick)`` calls."""

    def __init__(self, tick: float = 0.5):
        self.now = 0.0
        self.tick = tick

    def perf_counter(self):
        self.now += self.tick
        return self.now


def _run(cell: str, trace: int, overrides: dict = SMALL,
         tick: float = 0.5) -> dict:
    """One run's result line, the calls it traced, and the program's
    summary right after it."""
    from raytracingweekend_jl_tpu_torch.utils import profiling
    profiling.reset()
    out, err = io.StringIO(), io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        clock = _Clock(tick)
        mp.setattr("portbench.harness.main.time", clock)
        mp.setattr("portbench.loops.grad.time", clock)
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = main(["--workload", cell, "--seed", "2300000411",
                       "--seconds", "1", "--trace", str(trace)], 0.0,
                      allow_cpu=True, overrides=overrides)
    assert rc == 0, err.getvalue()
    traced = re.search(r"traced (\d+) calls", err.getvalue())
    return {"result": json.loads(out.getvalue().strip().splitlines()[-1]),
            "traced_calls": int(traced.group(1)),
            "summary": profiling.summary()}


@pytest.fixture(scope="module")
def runs():
    return {(kind, trace): _run(cell, trace)
            for kind, cell in CELLS.items() for trace in (0, 1)}


def test_the_readers_are_the_benchmarks():
    """Each reader of the program's spans lists every cell whose loop is of
    its kind."""
    bench = load_json(ROOT, "BENCHMARK.json")
    metrics = {m["name"]: m for m in bench["per_layer"]}
    kinds = {w["name"]: Run(load_cell(w["name"])).kind
             for w in bench["workloads"]}
    for name, kind in READERS.items():
        assert metrics[name]["source"] in ("program_span", "program_counter")
        assert metrics[name]["workloads"] == [
            w for w, k in kinds.items() if k == kind]


def test_the_pass_loop_reads_every_grad_reader():
    """The gradient step at several samples a pixel, every pass's records
    kept (the route of ``book1_final.grad_1080p_spp4`` on the card; here 2
    samples of a 16x9 film, one step in the window and one traced): each
    ``*.grad`` reader reads a finite number, and the program counted the
    step traced."""
    run = _run("book1_final.grad_1080p_spp4", 1,
               dict(SMALL, width=16, height=9, spp=2), tick=2.0)
    for name, kind in READERS.items():
        if kind == "grad":
            value = run["result"]["metrics"][name]["value"]
            assert math.isfinite(value) and value > 0, name
    assert run["summary"]["spans"][ROOTS["grad"]]["count"] == \
        run["traced_calls"] >= 1


@pytest.mark.parametrize("name", sorted(READERS))
def test_a_traced_run_reads_a_finite_number(runs, name):
    r = runs[(READERS[name], 1)]["result"]
    value = r["metrics"][name]["value"]
    assert math.isfinite(value) and value > 0


@pytest.mark.parametrize("name", sorted(READERS))
def test_an_untraced_run_reads_nothing(runs, name):
    kind = READERS[name]
    assert name not in runs[(kind, 0)]["result"]["metrics"]
    untraced = types.SimpleNamespace(kind=kind, traced=None)
    other = types.SimpleNamespace(
        kind="grad" if kind == "render" else "render", traced=object())
    assert load_reader(name).read(untraced) is None
    assert load_reader(name).read(other) is None


def test_setup_is_the_call_less_its_loop_and_result(runs):
    run = runs[("render", 1)]
    spans = run["summary"]["spans"]
    call, loop, result = (spans[f"rtw.render.{k}"]["total_s"]
                          for k in ("call", "loop", "result"))
    assert 0 < loop + result < call
    assert run["result"]["metrics"]["setup_pct.render"]["value"] == \
        pytest.approx(100 * (call - loop - result) / call)


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_the_program_counted_the_traced_calls(runs, kind):
    run = runs[(kind, 1)]
    assert run["traced_calls"] >= 1
    assert run["summary"]["spans"][ROOTS[kind]]["count"] == \
        run["traced_calls"]
    assert runs[(kind, 0)]["summary"]["spans"] == {}


def test_readers_give_nothing_for_a_program_without_spans(monkeypatch):
    """A program older than its spans has no ``summary``: the readers
    return None and raise nothing."""
    from raytracingweekend_jl_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "summary")
    for name, kind in READERS.items():
        run = types.SimpleNamespace(kind=kind, traced=object())
        assert load_reader(name).read(run) is None
