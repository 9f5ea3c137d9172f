"""Each metric reader on a recorded profile: a Chrome trace of a few calls
(host ranges, runtime calls, kernels, copies) reduced by
``harness.profile.summarize``."""

import types

import pytest
import torch

from portbench.harness import profile
from portbench.harness.main import load_reader
from portbench.harness.spec import load_json, ROOT

TRACE = [
    {"ph": "X", "cat": "user_annotation", "name": "portbench.traced",
     "ts": 0.0, "dur": 1000.0, "tid": 1},
    {"ph": "X", "cat": "user_annotation", "name": "portbench.call",
     "ts": 10.0, "dur": 900.0, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "ts": 20.0, "dur": 5.0, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
     "ts": 300.0, "dur": 5.0, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cuLaunchKernel",
     "ts": 310.0, "dur": 5.0, "tid": 1},
    {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 500.0,
     "dur": 300.0, "tid": 1},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
     "ts": 520.0, "dur": 250.0, "tid": 1},
    {"ph": "X", "cat": "kernel", "name": "sweep_kernel", "ts": 30.0,
     "dur": 200.0, "tid": 7},
    {"ph": "X", "cat": "kernel", "name": "shade_strided_kernel",
     "ts": 320.0, "dur": 100.0, "tid": 7},
    {"ph": "X", "cat": "kernel", "name": "sweep_kernel", "ts": 400.0,
     "dur": 100.0, "tid": 7},
    {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH (Device -> Pinned)",
     "ts": 760.0, "dur": 10.0, "tid": 7},
    {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000.0,
     "dur": 10.0, "tid": 7},
]


def test_summary_of_a_recorded_trace():
    s = profile.summarize(TRACE)
    assert s.window_s == pytest.approx(1e-3)
    # kernels 30-230, 320-500 (two, merged), copy 760-770
    assert s.busy_s == pytest.approx((200 + 180 + 10) * 1e-6)
    assert s.launches == 3
    assert s.syncs == {"stream_sync": 1, "device_sync": 0, "memcpy_dtoh": 1}
    assert s.device_ops[0] == ["sweep_kernel", pytest.approx(300e-6)]
    gaps = dict(s.idle_gaps)
    # gaps 0-30, 230-320 and 770-1000 fall in the call's own range (the
    # launches at 20 and 300 do not hold their middles); 500-760 in the
    # synchronise inside aten::item
    assert gaps["portbench.call"] == pytest.approx((30 + 90 + 230) * 1e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(260e-6)


def _run(kind):
    s = profile.summarize(TRACE)
    loop = types.SimpleNamespace(segments_per_path=3.0, n_spheres=486, spp=4)
    from portbench.roofline import grad, render
    roof = {"render": render, "grad": grad}[kind]
    run = types.SimpleNamespace(
        kind=kind, traced=s, traced_paths=4000, traced_calls=2,
        call_s=[0.1, 0.2, 0.3], window_s=2.0, paths=8_000_000,
        setup_s=9.5, step_peak_bytes=3 * 2**30, loop=loop)
    from portbench.harness.peaks import least_time
    run.least_time_s = lambda paths: least_time(roof.work(loop, paths))
    return run


@pytest.mark.parametrize("metric", [
    m["name"] for m in load_json(ROOT, "BENCHMARK.json")["per_layer"]
    + load_json(ROOT, "BENCHMARK.json")["end_to_end"]
    if m["source"] in ("host_clock", "device_trace")])
def test_each_reader_on_the_recorded_trace(metric):
    """The readers of the host's clock and the profile; those of the
    program's own spans and counters are test_portbench_program_spans.py's."""
    kind = "grad" if "grad" in metric else "render"
    got = load_reader(metric).read(_run(kind))
    other = load_reader(metric).read(_run("render" if kind == "grad"
                                          else "grad"))
    assert got is not None and got > 0
    if metric != "setup_s":
        assert other is None          # a reader reads only its own kind
    expect = {
        "setup_s": 9.5, "render_mpaths_s": 4.0, "grad_mpaths_s": 4.0,
        "grad_peak_gib": 3.0, "call_p95_ms.render": 290.0,
        "step_p95_ms.grad": 290.0,
        "host_launches_per_mpath.render": 3 / 4000 * 1e6,
        "host_syncs_per_mpath.render": 2 / 4000 * 1e6,
        "host_launches_per_step.grad": 1.5,
        "device_idle_pct.render": 100 * (1 - 0.39),
        "device_idle_pct.grad": 100 * (1 - 0.39),
        "kernels_roofline.render": 100 * 4000 * 3 * 9870 / 67e12 / 390e-6,
        "kernels_roofline.grad": 100 * 4000 * 3 * 10270 / 67e12 / 390e-6,
        "step_mfu.render": 100 * 4000 * 3 * 9870 / 67e12 / 1e-3,
        "step_mfu.grad": 100 * 4000 * 3 * 10270 / 67e12 / 1e-3,
    }[metric]
    assert got == pytest.approx(expect)


def test_a_real_profile_has_the_traced_range():
    res = {}
    with profile.traced(res):
        torch.ones(1000).sum()
    s = res["summary"]
    assert s.window_s > 0 and s.busy_s == 0.0 and s.launches == 0
