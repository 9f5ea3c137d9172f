"""The roofline counts: the work of a cell's paths from its inputs."""

import types

import pytest

from portbench.harness import peaks
from portbench.roofline import grad, render


def test_render_work_is_operations_bound():
    loop = types.SimpleNamespace(segments_per_path=3.0, n_spheres=486, spp=4)
    w = render.work(loop, 8_294_400)
    assert w["ops"] == pytest.approx(8_294_400 * 3.0 * (486 * 20 + 150))
    assert w["bytes"] == pytest.approx(8_294_400 / 4 * 12)
    t = peaks.least_time(w)
    assert t["bound_by"] == "operations"
    assert t["seconds"] == pytest.approx(w["ops"] / 67e12)


def test_grad_work_adds_the_adjoint():
    loop = types.SimpleNamespace(segments_per_path=2.0, n_spheres=4, spp=1)
    w = grad.work(loop, 1000)
    assert w["ops"] == pytest.approx(1000 * 2.0 * (4 * 20 + 150 + 400))


def test_least_time_picks_the_larger_bound():
    t = peaks.least_time({"ops": 1.0, "bytes": 3.35e12})
    assert t == {"seconds": pytest.approx(1.0), "bound_by": "bytes"}
