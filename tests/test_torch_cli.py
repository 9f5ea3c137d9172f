"""The port's command line and its utilities against the JAX
package's: ``RenderConfig`` (fields, defaults, the scenes and cameras it
builds), the parser (every option, default and choice), the metrics records
and history file, the profiling helpers, and the CLI end to end on the CPU
(``--device cpu``): PNG and PPM output, the record's keys, the chunked
phases, ``--stats``, the refusals and the float64 route. Card-only: the
CLI's chunked resume bit for bit. Each test that writes files runs in its
own temporary directory, so no history file lands in the repository."""

import dataclasses
import json
import os
import subprocess
import sys
import tomllib

import jax
import numpy as np
import pytest
import torch

from raytracingweekend_jl_tpu import cli as jcli
from raytracingweekend_jl_tpu.utils import config as jconfig
from raytracingweekend_jl_tpu.utils import metrics as jmetrics
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu_torch import cli
from raytracingweekend_jl_tpu_torch.parallel import shard
from raytracingweekend_jl_tpu_torch.parallel.mesh import make_render_mesh
from raytracingweekend_jl_tpu_torch.utils import config, metrics, profiling
from raytracingweekend_jl_tpu_torch.utils.checkpoint import load_state
from raytracingweekend_jl_tpu_torch.utils.image import read_png, to_uint8
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--scene", "2_spheres", "--camera", "default", "--width", "48",
         "--device", "cpu"]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# -- config -------------------------------------------------------------------

def test_render_config_fields_match_jax():
    # The JAX fields in their order with their defaults, then `device`.
    jf = [(f.name, f.default) for f in dataclasses.fields(
        jconfig.RenderConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(
        config.RenderConfig)]
    assert pf == jf + [("device", None)]
    assert config.CAMERA_PRESETS == jconfig.CAMERA_PRESETS
    assert config.RenderConfig(precision="f64").dtype() == torch.float64
    assert config.RenderConfig().dtype() == torch.float32


@pytest.mark.parametrize("precision", ["f32", "f64"])
def test_config_builds_the_jax_scenes_and_cameras(precision):
    # Every scene and camera preset, in both precisions, equal to the JAX
    # package's arrays (float64 under JAX's x64 mode), built on the CPU.
    from raytracingweekend_jl_tpu.models.scenes import ALL_SCENES
    with jax.enable_x64(precision == "f64"):
        for name in sorted(ALL_SCENES):
            a = jconfig.RenderConfig(scene=name, precision=precision,
                                     scene_seed=3).build_scene()
            b = config.RenderConfig(scene=name, precision=precision,
                                    scene_seed=3).build_scene()
            assert b.center.device.type == "cpu"
            for f in a._fields:
                x, y = _np(getattr(a, f)), _np(getattr(b, f))
                assert x.dtype == y.dtype, (name, f)
                np.testing.assert_array_equal(x, y, err_msg=f"{name}.{f}")
        for cam in config.CAMERA_PRESETS:
            a = jconfig.RenderConfig(camera=cam,
                                     precision=precision).build_camera()
            b = config.RenderConfig(camera=cam,
                                    precision=precision).build_camera()
            for f in a._fields:
                x, y = _np(getattr(a, f)), _np(getattr(b, f))
                assert x.dtype == y.dtype, (cam, f)
                np.testing.assert_array_equal(x, y, err_msg=f"{cam}.{f}")
    with pytest.raises(ValueError):
        config.RenderConfig(scene="nope").build_scene()
    with pytest.raises(ValueError):
        config.RenderConfig(camera="nope").build_camera()


# -- parser ---------------------------------------------------------------------

def _options(parser):
    return {tuple(a.option_strings): a for a in parser._actions
            if a.option_strings and a.dest != "help"}


def test_parser_has_every_jax_option():
    # Every option string of the JAX parser, with its destination, default,
    # choices and type; plus --device (default None: the card). --scene
    # also takes the port's moving presets (book 2), which the JAX package
    # has not.
    jo, po = _options(jcli.build_parser()), _options(cli.build_parser())
    assert set(po) == set(jo) | {("--device",)}
    moving = set(pt.ALL_SCENES) - set(pt.STATIC_SCENES)
    assert moving == {"bouncing_spheres"}
    for opts, a in jo.items():
        b = po[opts]
        assert (b.dest, b.default, b.type, b.nargs, b.const) == \
            (a.dest, a.default, a.type, a.nargs, a.const), opts
        want = set(a.choices) if a.choices else None
        if opts == ("--scene",):
            want |= moving
        assert (sorted(b.choices) if b.choices else None) == \
            (sorted(want) if want else None), opts
    assert po[("--device",)].default is None


@pytest.mark.parametrize("argv", [
    [],
    ["--scene", "random_spheres_reference", "--camera", "cam2", "--width",
     "96", "--height", "40", "--spp", "3", "--depth", "5", "--seed", "7",
     "--scene-seed", "4", "--precision", "f64", "--compact",
     "--no-persistent", "--rays-per-pass", "1024", "--spp-chunk", "2",
     "--checkpoint", "c.npz", "-o", "x.ppm", "--stats"],
    ["--mesh-tiles", "2", "--mesh-samples", "3", "--tile-size", "64",
     "--multihost", "--strip-dir", "s"],
])
def test_same_argv_same_config(argv):
    a = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    b = cli.config_from_args(cli.build_parser().parse_args(argv))
    assert b.to_dict() == {**a.to_dict(), "device": None}
    b = cli.config_from_args(cli.build_parser().parse_args(
        argv + ["--device", "cpu"]))
    assert b.device == "cpu"


def test_parser_refusals():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--scene", "nonexistent"])
    with pytest.raises(SystemExit):
        cli.config_from_args(cli.build_parser().parse_args(
            ["--compact", "--no-compact"]))


def test_console_script_is_named():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    assert scripts["rtw-render-torch"] == \
        "raytracingweekend_jl_tpu_torch.cli:main"
    assert scripts["rtw-render"] == "raytracingweekend_jl_tpu.cli:main"


# -- metrics and profiling --------------------------------------------------------

@pytest.mark.parametrize("wall,paths", [(2.0, 4_000_000),
                                        (1.23456789, 12_345_678),
                                        (0.0333337, 2_073_600)])
def test_throughput_record_matches_jax(wall, paths):
    extra = {"config": {"a": 1}, "phases": {"trace": 0.5}}
    a = jmetrics.throughput_record("lbl", wall, paths, extra=dict(extra))
    b = metrics.throughput_record("lbl", wall, paths, extra=dict(extra),
                                  device="cpu")
    assert set(b) == set(a) | {"device"}
    for k in set(a) - {"ts", "host"}:
        assert b[k] == a[k], k
    assert b["device"] == {"name": None, "power_limit_w": None}


def test_history_file_is_the_ports(tmp_path, monkeypatch):
    # The default history is not the JAX package's bench_history.jsonl,
    # whose rows are read as TPU rows.
    import inspect
    default = inspect.signature(metrics.append_history).parameters[
        "path"].default
    assert default == "bench_history_torch.jsonl" != "bench_history.jsonl"
    monkeypatch.chdir(tmp_path)
    metrics.append_history({"x": 1})
    metrics.append_history({"x": 2})
    rows = [json.loads(line) for line in open(default)]
    assert rows == [{"x": 1}, {"x": 2}]
    assert not os.path.exists("bench_history.jsonl")


def test_phase_timer_matches_jax():
    a, b = jmetrics.PhaseTimer(), metrics.PhaseTimer()
    for t in (a, b):
        t.totals = {"trace": 1.234567, "fetch": 0.00004}
        t.start("x")
        t.discard("x")
        t.start("checkpoint")
        t.stop("checkpoint")
    assert list(b.as_dict()) == list(a.as_dict()) == \
        ["checkpoint", "fetch", "trace"]
    assert b.as_dict()["trace"] == a.as_dict()["trace"] == 1.2346


def test_profiling_helpers(tmp_path):
    with profiling.profiler_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    assert "traceEvents" in trace


# -- the CLI end to end on the CPU ------------------------------------------------

def test_cli_writes_png_and_ppm(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cli.main(SMALL + ["--spp", "2", "-o", "out.png"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    cli.main(SMALL + ["--spp", "2", "-o", "out.ppm"])
    assert rec["paths"] == 48 * 27 * 2
    assert rec["label"] == "2_spheres_48x27x2"
    png = read_png("out.png")
    assert png.shape == (27, 48, 3)
    ppm = open("out.ppm", "rb").read()
    head = b"P6\n48 27\n255\n"
    assert ppm.startswith(head) and len(ppm) == len(head) + 48 * 27 * 3
    # The same render: the PPM's bytes are the PNG's pixels.
    pix = np.frombuffer(ppm[len(head):], np.uint8).reshape(27, 48, 3)
    np.testing.assert_array_equal(pix / 255.0, png)
    hist = [json.loads(line) for line in open("bench_history_torch.jsonl")]
    assert [h["label"] for h in hist] == ["2_spheres_48x27x2"] * 2
    assert not os.path.exists("bench_history.jsonl")


def test_cli_record_has_the_jax_keys(tmp_path, monkeypatch):
    # Every key of the JAX CLI's record (and of its config), plus device.
    monkeypatch.chdir(tmp_path)
    argv = ["--scene", "2_spheres", "--camera", "default", "--width", "32",
            "--spp", "1", "-o", "j.png"]
    a = jcli.run(jcli.config_from_args(jcli.build_parser().parse_args(argv)))
    b = cli.run(cli.config_from_args(cli.build_parser().parse_args(
        argv[:-1] + ["p.png", "--device", "cpu"])))
    assert set(b) == set(a) | {"device"}
    assert set(b["config"]) == set(a["config"]) | {"device"}
    assert (b["label"], b["paths"]) == (a["label"], a["paths"])


def test_cli_chunked_reports_phases_and_resumes(tmp_path, monkeypatch):
    # The chunked run reports trace and fetch (and checkpoint) phases; a
    # render stopped at 2 samples and resumed to 4 writes the image of the
    # uninterrupted chunked render.
    monkeypatch.chdir(tmp_path)
    chunk = SMALL + ["--spp-chunk", "2"]
    rec = cli.run(cli.config_from_args(cli.build_parser().parse_args(
        chunk + ["--spp", "4", "-o", "full.png"])))
    assert rec["phases"]["trace"] > 0 and "fetch" in rec["phases"]
    cli.main(chunk + ["--spp", "2", "--checkpoint", "ck.npz", "-o", "a.png"])
    assert load_state("ck.npz").samples_done == 2
    rec2 = cli.run(cli.config_from_args(cli.build_parser().parse_args(
        chunk + ["--spp", "4", "--checkpoint", "ck.npz", "-o", "b.png"])))
    assert "checkpoint" in rec2["phases"]
    assert load_state("ck.npz").samples_done == 4
    # The resumed run's rate counts the 2 samples it rendered.
    assert (rec["paths"], rec2["paths"]) == (48 * 27 * 4, 48 * 27 * 2)
    np.testing.assert_array_equal(read_png("b.png"), read_png("full.png"))


def test_cli_stats_prints_occupancy(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    cli.main(SMALL + ["--spp", "1", "--stats", "--depth", "6", "-o", "s.png"])
    lines = capsys.readouterr().out.strip().splitlines()
    occ = json.loads(lines[0])
    assert len(occ["bounce_occupancy"]) == 6
    assert occ["bounce_occupancy"][0] == 1.0
    assert all(a >= b for a, b in zip(occ["bounce_occupancy"],
                                      occ["bounce_occupancy"][1:]))
    assert occ["active_tiles"][0] == 1 and occ["mean_path_length"] >= 1.0


@pytest.mark.parametrize("flags", [["--mesh-tiles", "2"],
                                   ["--mesh-samples", "2"],
                                   ["--multihost"],
                                   ["--mesh-tiles", "2", "--stats"]])
def test_cli_refuses_sharded_renders(flags, tmp_path, monkeypatch):
    # Without a launcher the world is one rank: --multihost renders on a
    # mesh of one (the image the plain sharded render gives), and a mesh
    # larger than the world exits non-zero naming both, rendering and
    # writing nothing.
    monkeypatch.chdir(tmp_path)
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    argv = SMALL + ["--spp", "1", "--tile-size", "256", "-o", "m.png"]
    if flags == ["--multihost"]:
        cli.main(argv + flags)
        rec = json.loads(open("bench_history_torch.jsonl").readline())
        assert rec["mesh"] == {"tiles": 1, "samples": 1}
        ref = shard.render_radiance_sharded(
            pt.scene_2_spheres(), pt.t_default_cam(), 48, 1,
            mesh=make_render_mesh(device="cpu"), tile_size=256,
            persistent=True).numpy()
        assert np.array_equal(read_png("m.png"),
                              to_uint8(np.sqrt(np.clip(ref, 0, None)))
                              / 255.0)
        return
    with pytest.raises(SystemExit, match=r"must equal the ranks.*!= 1 ranks"):
        cli.main(argv + flags)
    assert os.listdir(tmp_path) == []


def test_cli_two_ranks_over_gloo(tmp_path):
    # A launch of two ranks (the launcher's variables, a file:// store):
    # each renders its tile shard, writes its strip, and rank 0 assembles
    # the image and alone writes it and the record; the image is the world
    # of one's bit for bit.
    from test_torch_multiprocess import launch
    store = f"file://{tmp_path / 'store'}"
    argv = [sys.executable, "-m", "raytracingweekend_jl_tpu_torch.cli",
            *SMALL, "--spp", "2", "--tile-size", "256", "--mesh-tiles", "2",
            "-o", "two.png"]
    outs = launch(lambda r: argv, 2, str(tmp_path),
                  env_of_rank=lambda r: {"WORLD_SIZE": "2", "RANK": str(r),
                                         "RTW_INIT_METHOD": store})
    rec = json.loads(outs[0].strip().splitlines()[-1])
    assert rec["mesh"] == {"tiles": 2, "samples": 1}
    assert outs[1].strip() == ""  # rank 1 writes no record
    ref = shard.render_radiance_sharded(
        pt.scene_2_spheres(), pt.t_default_cam(), 48, 2,
        mesh=make_render_mesh(device="cpu"), tile_size=256,
        persistent=True).numpy()
    assert np.array_equal(read_png(str(tmp_path / "two.png")),
                          to_uint8(np.sqrt(np.clip(ref, 0, None))) / 255.0)
    strips = sorted(os.listdir(tmp_path / "two.png.strips"))
    assert strips == ["strip_00000.npz", "strip_00001.npz"]
    with open(tmp_path / "bench_history_torch.jsonl") as f:
        assert len(f.readlines()) == 1


def test_cli_f64_only_with_no_persistent(tmp_path, monkeypatch):
    # --precision f64 runs end to end on every route: the default
    # persistent one (the plain pixel-pinned body in float64), chunked and
    # resumed bit for bit, and --no-persistent; the image is the float64
    # render's.
    monkeypatch.chdir(tmp_path)
    f64 = SMALL + ["--spp", "2", "--precision", "f64"]
    cli.main(f64 + ["-o", "a.png"])
    ref = pt.render_radiance(pt.scene_2_spheres(dtype=torch.float64),
                             pt.t_default_cam(dtype=torch.float64), 48, 2,
                             persistent=True, device="cpu").numpy()
    assert np.array_equal(read_png("a.png"),
                          to_uint8(np.sqrt(np.clip(ref, 0, None))) / 255.0)
    cli.main(f64 + ["--spp-chunk", "1", "--checkpoint", "full.npz", "-o",
                    "full.png"])
    cli.main(SMALL + ["--spp", "1", "--precision", "f64", "--spp-chunk",
                      "1", "--checkpoint", "ck.npz", "-o", "half.png"])
    cli.main(f64 + ["--spp-chunk", "1", "--checkpoint", "ck.npz", "-o",
                    "resumed.png"])
    assert np.array_equal(load_state("ck.npz").radiance_sum,
                          load_state("full.npz").radiance_sum)
    assert np.array_equal(read_png("full.png"), read_png("resumed.png"))
    cli.main(f64 + ["--no-persistent", "-o", "b.png"])
    assert np.isfinite(read_png("b.png")).all()


def test_cli_needs_cuda_unless_cpu(tmp_path, monkeypatch):
    # Without --device cpu the CLI renders on the card, and without CUDA it
    # raises: no fallback to the CPU.
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(SMALL[:-2] + ["--spp", "1", "-o", "x.png"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(SMALL[:-2] + ["--spp", "1", "--stats", "-o", "x.png"])


def test_cli_runs_as_a_module(tmp_path):
    env = {**os.environ, "PYTHONPATH": ROOT}
    out = subprocess.run(
        [sys.executable, "-m", "raytracingweekend_jl_tpu_torch.cli",
         *SMALL, "--spp", "1", "--width", "16", "-o", "m.png"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["paths"] == 16 * 9 and (tmp_path / "m.png").exists()


@pytest.mark.cuda
def test_cli_chunked_resume_on_card(tmp_path, monkeypatch):
    # The CLI's chunked render on the card at 96 x 54 (the inline kernel
    # K8): stopped at 4 samples and resumed to 8, bit for bit the
    # uninterrupted chunked render, and the PNG reads back as written.
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.chdir(tmp_path)
    base = ["--scene", "4_spheres", "--camera", "default", "--width", "96",
            "--spp-chunk", "4"]
    cli.main(base + ["--spp", "8", "--checkpoint", "full.npz", "-o", "f.png"])
    cli.main(base + ["--spp", "4", "--checkpoint", "ck.npz", "-o", "a.png"])
    cli.main(base + ["--spp", "8", "--checkpoint", "ck.npz", "-o", "b.png"])
    full, resumed = load_state("full.npz"), load_state("ck.npz")
    assert resumed.samples_done == full.samples_done == 8
    assert np.array_equal(resumed.radiance_sum, full.radiance_sum)
    img = np.sqrt(np.clip(full.image, 0.0, None))
    np.testing.assert_array_equal(read_png("b.png"), to_uint8(img) / 255.0)
    rec = json.loads(open("bench_history_torch.jsonl").readlines()[-1])
    assert rec["device"]["name"] == torch.cuda.get_device_name(0)
