"""The port's single-device checkpointed render (``utils/checkpoint.py``):
an interrupted and resumed render is the uninterrupted chunked one bit for
bit; every mismatched setting, a JAX-written file and an over-long checkpoint
are refused for resume; a failed chunk is retried; and the image agrees with
the JAX package's ``render_checkpointed`` statistically."""

import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.utils import checkpoint as jck
from raytracingweekend_jl_tpu_torch.utils import checkpoint as ck
from raytracingweekend_jl_tpu_torch.utils.metrics import PhaseTimer
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

W = 48  # 48 x 27 pixels


def _render(n, path=None, **kw):
    args = dict(seed=5, spp_chunk=4, device="cpu")
    args.update(kw)
    scene = args.pop("scene", pt.scene_2_spheres())
    cam = args.pop("cam", pt.t_default_cam())
    return pt.render_checkpointed(scene, cam, args.pop("width", W), n,
                                  checkpoint_path=path, **args)


@pytest.mark.parametrize("persistent", [True, False])
def test_resume_is_bitwise_the_uninterrupted_run(persistent, tmp_path):
    # Two chunks of 4 in one run, against one chunk, a stop, and a resume
    # on the same checkpoint: the sums are equal bit for bit.
    p = str(tmp_path / "ck.npz")
    full = _render(8, persistent=persistent)
    first = _render(4, p, persistent=persistent)
    assert first.samples_done == 4
    resumed = _render(8, p, persistent=persistent)
    assert resumed.samples_done == 8 and full.samples_done == 8
    assert resumed.radiance_sum.dtype == np.float64
    assert np.array_equal(resumed.radiance_sum, full.radiance_sum)
    assert np.array_equal(resumed.image, full.image)
    on_disk = ck.load_state(p)
    assert on_disk.samples_done == 8 and on_disk.rng == "philox"
    assert np.array_equal(on_disk.radiance_sum, full.radiance_sum)
    # A second chunk differs from the first (its draws are keyed by its
    # first sample), so the resume did render new samples.
    assert not np.array_equal(first.radiance_sum * 2, full.radiance_sum)
    # Resuming a finished render renders nothing more.
    again = _render(8, p, persistent=persistent)
    assert np.array_equal(again.radiance_sum, full.radiance_sum)


def test_render_checkpointed_matches_tile_sum():
    # One chunk is the whole-film render_tile_sum of those samples.
    st = _render(4, spp_chunk=4)
    ref = pt.render_tile_sum(pt.trim_scene(pt.scene_2_spheres()),
                             pt.t_default_cam(), W * 27, 5, 4, 0, 16, 1e-4,
                             float(W), 27.0, True)
    assert np.array_equal(st.radiance_sum,
                          ref.numpy().astype(np.float64).reshape(27, W, 3))


MISMATCHES = {
    "width": dict(width=64),
    "seed": dict(seed=6),
    "spp_chunk": dict(spp_chunk=2),
    "max_depth": dict(max_depth=8),
    "tmin": dict(tmin=1e-3),
    "persistent": dict(persistent=False),
    "compact": dict(compact=True),
    "rays_per_pass": dict(rays_per_pass=1 << 20),
    "scene": dict(scene=pt.scene_4_spheres()),
    "scene_dtype": dict(scene=pt.scene_2_spheres(dtype=torch.float64)),
    "camera": dict(cam=pt.t_cam2()),
}


@pytest.mark.parametrize("what", sorted(MISMATCHES))
def test_resume_refuses_other_settings(what, tmp_path):
    p = str(tmp_path / "ck.npz")
    _render(4, p)
    with pytest.raises(ValueError, match="configuration"):
        _render(8, p, **MISMATCHES[what])
    assert ck.load_state(p).samples_done == 4  # the file is untouched


def test_resume_refuses_other_rng_and_too_many_samples(tmp_path):
    p = str(tmp_path / "ck.npz")
    st = _render(4, p)
    with pytest.raises(ValueError, match="more than"):
        _render(2, p)
    st.rng = "threefry"
    ck.save_state(st, p)
    with pytest.raises(ValueError, match="rng"):
        _render(8, p)


def test_jax_written_file_loads_and_is_refused(tmp_path):
    # The JAX package's file (threefry streams, no settings) loads, its
    # settings None, and a resume from it raises.
    p = str(tmp_path / "jax.npz")
    radiance = np.random.default_rng(0).uniform(0, 1, (27, W, 3))
    jck.save_state(jck.RenderState(radiance, 4, W, 27, 5), p)
    st = ck.load_state(p)
    assert (st.samples_done, st.image_width, st.image_height, st.seed) == \
        (4, W, 27, 5)
    assert np.array_equal(st.radiance_sum, radiance)
    assert st.rng is None and st.spp_chunk is None and st.scene_digest is None
    with pytest.raises(ValueError, match="rng=None"):
        _render(8, p)
    # And the port's file loads in the JAX package.
    q = str(tmp_path / "port.npz")
    _render(4, q)
    back = jck.load_state(q)
    assert back.samples_done == 4 and back.image_width == W


def test_state_roundtrip(tmp_path):
    st = ck.RenderState(np.ones((2, 3, 3)), 7, 3, 2, 9, spp_chunk=7,
                        max_depth=16, tmin=1e-4, persistent=True,
                        compact=False, rays_per_pass=1 << 21,
                        scene_digest="ab", rng="philox")
    p = str(tmp_path / "s.npz")
    ck.save_state(st, p)
    back = ck.load_state(p)
    for f in ("samples_done", "image_width", "image_height", "seed",
              "spp_chunk", "max_depth", "tmin", "persistent", "compact",
              "rays_per_pass", "scene_digest", "rng"):
        assert getattr(back, f) == getattr(st, f), f
        assert type(getattr(back, f)) is type(getattr(st, f)), f
    assert np.array_equal(back.radiance_sum, st.radiance_sum)


def test_retry_after_a_fault_gives_the_same_image(monkeypatch):
    # One simulated device fault in the second chunk is retried on the same
    # route, and the image is the fault-free run's bit for bit.
    clean = _render(8, spp_chunk=2)
    calls = {"n": 0}
    real = ck.render_tile_sum

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("simulated device fault")
        return real(*a, **k)

    monkeypatch.setattr(ck, "render_tile_sum", flaky)
    timer = PhaseTimer()
    st = _render(8, spp_chunk=2, timer=timer)
    assert calls["n"] == 5
    assert np.array_equal(st.radiance_sum, clean.radiance_sum)
    assert set(timer.as_dict()) == {"trace", "fetch"}


def test_retry_gives_up_after_max_retries(monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("simulated device fault")

    monkeypatch.setattr(ck, "render_tile_sum", broken)
    with pytest.raises(RuntimeError, match="simulated"):
        _render(4, max_retries=1)


def test_float64_only_on_the_fixed_depth_route():
    kw = dict(scene=pt.scene_2_spheres(dtype=torch.float64),
              cam=pt.t_default_cam(dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        _render(2, spp_chunk=2, **kw)
    st = _render(2, spp_chunk=2, persistent=False, **kw)
    assert np.isfinite(st.image).all()


def test_needs_cuda_unless_cpu():
    # No fallback: without CUDA, the default device raises.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        _render(2, device=None)


def test_matches_jax_statistically():
    # Independent streams on the same scene and film (the JAX package's
    # threefry against the port's keyed generators and Philox): each
    # channel's mean difference lies within 3 standard errors of the
    # per-pixel difference.
    w, spp = 64, 8
    a = jck.render_checkpointed(rtw.scene_4_spheres(), rtw.t_default_cam(),
                                w, spp, seed=0, spp_chunk=4).image
    b = pt.render_checkpointed(pt.scene_4_spheres(), pt.t_default_cam(), w,
                               spp, seed=0, spp_chunk=4, device="cpu").image
    assert a.shape == b.shape == (36, w, 3)
    d = (b - a).reshape(-1, 3)
    se = d.std(0) / np.sqrt(d.shape[0])
    assert (np.abs(d.mean(0)) < 3 * se).all(), (d.mean(0), se)

