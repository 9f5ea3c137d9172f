"""The program's spans and counters (``utils/profiling``) on the CPU, through
the kernels' plain versions: off, they cost a shared no-op and record
nothing; under ``torch.profiler`` the strided forward call and the recorded
persistent gradient step land in the Chrome trace, nested as the phases
run, with their iteration and sync counters, call ids and self times."""

import json
import math
import threading

import pytest
import torch

import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch.ops import integrator
from raytracingweekend_jl_tpu_torch.utils import profiling
from raytracingweekend_jl_tpu_torch.utils.metrics import PhaseTimer

W, H = 32, 18
PERSIST = dict(max_depth=4, recorded_persist=(2, None, (4, 16)),
               persist_strict=True)


@pytest.fixture(autouse=True)
def _fresh():
    """One intra-op thread, and no spans or counters from another test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    profiling.reset()
    yield
    profiling.reset()
    torch.set_num_threads(n)


def _recording():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _render():
    return pt.render_tile_sum(pt.scene_diel_spheres(), pt.t_cam2(), W * H, 3,
                              1, 0, 16, 1e-4, float(W), float(H),
                              persistent=True, inline=False)


def _grad_step():
    scene = pt.scene_diel_spheres()
    target = torch.full((9, 16, 3), 0.5)
    return pt.render_grads(scene, pt.t_cam2(), target, 16, 1, seed=4,
                           device="cpu", **PERSIST)


def _annotations(path) -> dict:
    """``{name: [(start, end)]}`` of the trace's program ranges."""
    with open(path) as f:
        data = json.load(f)
    out: dict = {}
    for e in data["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith("rtw."):
            t = float(e["ts"])
            out.setdefault(e["name"], []).append((t, t + float(e["dur"])))
    return out


def _inside(inner, outer) -> bool:
    return all(any(a <= c and d <= b for a, b in outer) for c, d in inner)


def test_off_is_the_shared_no_op_and_records_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered while not recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("rtw.x") is profiling._NO_SPAN
    assert profiling.span("rtw.x", root=True) is profiling._NO_SPAN
    assert profiling.sync("x") is profiling._NO_SPAN
    profiling.count("rtw.x", 3)
    out = _render()
    assert out.shape == (W * H, 3)
    s = profiling.summary()
    assert s["spans"] == {} and s["counters"] == {}
    assert profiling.spans() == []


def test_forward_call_spans_nest_in_the_chrome_trace(tmp_path):
    with profiling.profiler_trace(str(tmp_path)):
        _render()
    ann = _annotations(tmp_path / "trace.json")
    call = ann["rtw.render.call"]
    assert len(call) == 1
    for name in ("rtw.render.loop", "rtw.render.result"):
        assert len(ann[name]) == 1 and _inside(ann[name], call), name
    assert ann["rtw.render.loop"][0][1] <= ann["rtw.render.result"][0][0]
    assert _inside(ann["rtw.sync.active_check"], ann["rtw.render.loop"])
    # Set-up is the call before its loop: its reads lie there.
    for site in ("film_coords", "film_scale", "camera_consts"):
        assert _inside(ann["rtw.sync." + site], call), site
        assert ann["rtw.sync." + site][-1][1] <= ann["rtw.render.loop"][0][0]


def test_grad_step_spans_nest_in_the_chrome_trace(tmp_path):
    with profiling.profiler_trace(str(tmp_path)):
        _grad_step()
    ann = _annotations(tmp_path / "trace.json")
    step = ann["rtw.grad.step"]
    assert len(step) == 1
    for name in ("rtw.grad.plan", "rtw.rays", "rtw.grad.record",
                 "rtw.grad.loss", "rtw.grad.backward"):
        assert _inside(ann[name], step), name
    record = ann["rtw.grad.record"]
    for name in ("rtw.grad.record.phase1", "rtw.grad.boundary",
                 "rtw.grad.record.phase2"):
        assert len(ann[name]) == 1 and _inside(ann[name], record), name
    backward = ann["rtw.grad.backward"]
    for name in ("rtw.grad.replay.phase2", "rtw.grad.replay.phase1"):
        assert len(ann[name]) == 1 and _inside(ann[name], backward), name
    assert ann["rtw.grad.replay.phase2"][0][1] <= \
        ann["rtw.grad.replay.phase1"][0][0]
    assert len(ann["rtw.grad.contract"]) == 2
    assert _inside(ann["rtw.grad.contract"],
                   ann["rtw.grad.replay.phase2"]
                   + ann["rtw.grad.replay.phase1"])
    assert _inside(ann["rtw.sync.boundary"], ann["rtw.grad.boundary"])
    assert _inside(ann["rtw.sync.replay_walk"], backward)


def test_iteration_and_active_check_counters(monkeypatch):
    steps = []
    real = integrator.strided_step

    def counted(*a, **k):
        steps.append(1)
        return real(*a, **k)

    monkeypatch.setattr(integrator, "strided_step", counted)
    with _recording():
        _render()
    c = profiling.summary()["counters"]
    iters = c["rtw.render.iters"]
    # The loop stopped at an active check that found no lane active: that
    # pass ran no step.
    assert iters == len(steps) + 1
    assert c["rtw.sync.active_check"] == math.ceil(iters / 8)
    assert profiling.summary()["spans"]["rtw.render.call"]["count"] == 1


def test_record_iterations_and_syncs_of_a_step():
    with _recording():
        _grad_step()
    s = profiling.summary()
    c = s["counters"]
    assert 2 <= c["rtw.grad.record_iters"] <= 8
    assert c["rtw.sync.boundary"] == 1
    assert c["rtw.sync.replay_walk"] == 2
    assert c["rtw.sync.poison"] == 4
    for name, n in c.items():
        if name.startswith("rtw.sync."):
            assert s["spans"][name]["count"] == n, name


def test_every_span_of_a_step_carries_its_id():
    with _recording():
        _grad_step()
        _grad_step()
    recs = profiling.spans()
    steps = [r for r in recs if r.name == "rtw.grad.step"]
    assert len(steps) == 2 and steps[0].call_id != steps[1].call_id
    for st in steps:
        inside = [r for r in recs
                  if st.start_ns <= r.start_ns and r.end_ns <= st.end_ns]
        assert len(inside) > 10
        assert {r.call_id for r in inside} == {st.call_id}


def test_another_threads_span_takes_the_open_id():
    got = []

    def worker():
        with profiling.span("rtw.worker"):
            pass
        got.extend(r for r in profiling.spans() if r.name == "rtw.worker")

    with _recording():
        with profiling.span("rtw.root", root=True):
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    root = [r for r in profiling.spans() if r.name == "rtw.root"][0]
    (w,) = got
    assert w.call_id == root.call_id
    assert w.parent_id is None and w.thread != root.thread


class _Clock:
    def __init__(self, ticks):
        self.ticks = iter(ticks)

    def perf_counter_ns(self):
        return next(self.ticks)


def test_self_time_is_total_less_children(monkeypatch):
    # a [0, 100] holds b [10, 30] and c [40, 90]; c holds d [50, 60]
    monkeypatch.setattr(profiling, "time",
                        _Clock([0, 10, 30, 40, 50, 60, 90, 100]))
    with _recording():
        with profiling.span("a"):
            with profiling.span("b"):
                pass
            with profiling.span("c"):
                with profiling.span("d"):
                    pass
    s = profiling.summary()["spans"]
    ns = {k: (v["total_s"] * 1e9, v["self_s"] * 1e9) for k, v in s.items()}
    assert ns["a"] == pytest.approx((100, 30))
    assert ns["b"] == pytest.approx((20, 20))
    assert ns["c"] == pytest.approx((50, 40))
    assert ns["d"] == pytest.approx((10, 10))
    parents = {r.name: r.parent_id for r in profiling.spans()}
    ids = {r.name: r.span_id for r in profiling.spans()}
    assert parents == {"a": None, "b": ids["a"], "c": ids["a"],
                       "d": ids["c"]}


def test_spanned_makes_each_call_a_span():
    @profiling.spanned("rtw.wrapped", root=True)
    def add(a, b=1):
        """Adds."""
        return a + b

    assert add.__name__ == "add" and add.__doc__ == "Adds."
    assert add(2, b=3) == 5
    assert profiling.spans() == []            # off: nothing recorded
    with _recording():
        assert add(1) == 2
        assert add(4) == 5
    recs = profiling.spans()
    assert [r.name for r in recs] == ["rtw.wrapped", "rtw.wrapped"]
    assert recs[0].call_id != recs[1].call_id


def test_summary_holds_spans_and_counters_alone():
    with _recording():
        with profiling.span("rtw.a"):
            profiling.count("rtw.n", 2)
    assert set(profiling.summary()) == {"spans", "counters"}
    assert profiling.summary()["counters"] == {"rtw.n": 2}


def test_reset_keeps_the_launch_counters():
    from raytracingweekend_jl_tpu_torch.ops.cuda import intersect_kernel
    before = intersect_kernel.launches
    with _recording():
        with profiling.sync("x"):
            pass
    assert profiling.summary()["counters"] == {"rtw.sync.x": 1}
    profiling.reset()
    assert profiling.summary()["spans"] == {}
    assert profiling.summary()["counters"] == {}
    assert intersect_kernel.launches == before


def test_a_span_closed_early_ends_there():
    with _recording():
        with profiling.span("rtw.outer", root=True):
            with profiling.span("rtw.first") as first:
                first.close()
                with profiling.span("rtw.second"):
                    pass
    recs = {r.name: r for r in profiling.spans()}
    assert recs["rtw.first"].end_ns <= recs["rtw.second"].start_ns
    assert recs["rtw.second"].parent_id == recs["rtw.outer"].span_id
    assert [r.name for r in profiling.spans()].count("rtw.first") == 1


def test_phase_timer_runs_on_the_checkpoint_spans():
    t = PhaseTimer()
    t.start("trace")
    t.stop("trace")
    assert profiling.spans() == []            # off: totals only
    with _recording():
        t.start("trace")
        t.stop("trace")
        t.start("fetch")
        t.discard("fetch")
        t.start("checkpoint")
        t.stop("checkpoint")
    assert [r.name for r in profiling.spans()] == [
        "rtw.ckpt.trace", "rtw.ckpt.fetch", "rtw.ckpt.checkpoint"]
    assert set(t.as_dict()) == {"trace", "checkpoint"}
    assert t.totals["trace"] >= 0.0
