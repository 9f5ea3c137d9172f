"""The port's reference-scene replay, scene files and image I/O against the
JAX package: the Xoroshiro128Plus stream, ``scene_random_spheres_reference``
bit for bit (float32, float64 and the committed fixture), ``save_scene`` /
``load_scene`` across the two packages, ``write_ppm``'s bytes and the stdlib
``read_png`` against the JAX package's PIL reader."""

import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracingweekend_jl_tpu as rtw
import raytracingweekend_jl_tpu_torch as pt
from raytracingweekend_jl_tpu.utils import image as jimage
from raytracingweekend_jl_tpu.utils.xoroshiro import Xoroshiro128Plus as JX
from raytracingweekend_jl_tpu_torch.utils import image as timage
from raytracingweekend_jl_tpu_torch.utils.xoroshiro import Xoroshiro128Plus
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401

FIXTURE = os.path.join(os.path.dirname(__file__), "goldens",
                       "reference_scene_xoroshiro.npz")
FIELDS = ("center", "radius", "albedo", "fuzz", "ir", "mat")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _assert_scene_equal(a, b, what=""):
    for f in FIELDS:
        x, y = _np(getattr(a, f)), _np(getattr(b, f))
        assert x.dtype == y.dtype, (what, f, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}.{f}")


@pytest.mark.parametrize("seed", [1, 2, 12345, (1 << 64) + 7, (1 << 127) + 3])
@pytest.mark.parametrize("warmup,low52", [(2, False), (0, False), (2, True)])
def test_xoroshiro_stream_matches_jax(seed, warmup, low52):
    # The port's copy gives the JAX module's words and floats, in every
    # seeding and conversion variant.
    a, b = JX(seed, warmup, low52), Xoroshiro128Plus(seed, warmup, low52)
    assert [a.next_uint64() for _ in range(40)] == \
        [b.next_uint64() for _ in range(40)]
    assert [a.rand() for _ in range(40)] == [b.rand() for _ in range(40)]
    assert [a.rand_between(0.5, 1.0) for _ in range(8)] == \
        [b.rand_between(0.5, 1.0) for _ in range(8)]


def test_xoroshiro_zero_seed_raises():
    with pytest.raises(ValueError):
        Xoroshiro128Plus(0)


def test_reference_scene_matches_jax_f32_and_fixture():
    # Bit for bit the JAX package's scene, and the committed fixture on all
    # 512 rows.
    b = pt.scene_random_spheres_reference()
    _assert_scene_equal(rtw.scene_random_spheres_reference(), b, "jax")
    fix = np.load(FIXTURE)
    assert b.n_spheres == fix["center"].shape[0] == 512
    for f in FIELDS:
        np.testing.assert_array_equal(_np(getattr(b, f)), fix[f],
                                      err_msg=f"fixture.{f}")
    assert pt.ALL_SCENES["random_spheres_reference"] is \
        pt.scene_random_spheres_reference


def test_reference_scene_matches_jax_f64():
    # The float64 geometry is Julia's, cast once: both packages agree bit
    # for bit, and the float32 scene is its cast.
    with jax.enable_x64(True):
        a = rtw.scene_random_spheres_reference(dtype=jnp.float64)
        a = {f: np.asarray(getattr(a, f)) for f in FIELDS}
    b = pt.scene_random_spheres_reference(dtype=torch.float64)
    assert b.center.dtype == torch.float64
    for f in FIELDS:
        np.testing.assert_array_equal(a[f], _np(getattr(b, f)), err_msg=f)
    b32 = pt.scene_random_spheres_reference()
    np.testing.assert_array_equal(_np(b.center).astype(np.float32),
                                  _np(b32.center))


@pytest.mark.parametrize("warmup,low52", [(0, False), (2, True)])
def test_reference_scene_variants_match_jax(warmup, low52):
    _assert_scene_equal(
        rtw.scene_random_spheres_reference(warmup=warmup, low52=low52),
        pt.scene_random_spheres_reference(warmup=warmup, low52=low52))


@pytest.mark.parametrize("name", sorted(pt.ALL_SCENES))
def test_scene_files_cross_load(name, tmp_path):
    # A file the JAX package saves loads in the port, and one the port saves
    # loads in the JAX package, with equal arrays.
    j = rtw.ALL_SCENES[name]()
    rtw.save_scene(j, str(tmp_path / "j.npz"))
    _assert_scene_equal(j, pt.load_scene(str(tmp_path / "j.npz")), "jax->pt")
    p = pt.ALL_SCENES[name]()
    pt.save_scene(p, str(tmp_path / "p.npz"))
    _assert_scene_equal(p, rtw.load_scene(str(tmp_path / "p.npz")), "pt->jax")
    _assert_scene_equal(p, pt.load_scene(str(tmp_path / "p.npz")), "pt->pt")


def test_load_scene_dtype_and_device(tmp_path):
    pt.save_scene(pt.scene_4_spheres(), str(tmp_path / "s.npz"))
    s = pt.load_scene(str(tmp_path / "s.npz"), dtype=torch.float64,
                      device="cpu")
    assert s.center.dtype == torch.float64 and s.mat.dtype == torch.int32


def _image(seed, h=16, w=24, dtype=np.float32):
    # Radiance as it comes off the card: float32, a few values outside
    # [0, 1] on both sides.
    g = np.random.default_rng(seed)
    return g.uniform(-0.1, 1.2, (h, w, 3)).astype(dtype)


@pytest.mark.parametrize("gamma2", [False, True])
def test_write_ppm_bytes_match_jax(gamma2, tmp_path, monkeypatch):
    # The JAX writer takes its native library where it is built (float32
    # arithmetic, nearbyintf) and numpy otherwise (float64, rint); the
    # port's writer is numpy. Its bytes equal both on the card's float32
    # radiance.
    img = _image(3)
    pt_path, j_path = str(tmp_path / "p.ppm"), str(tmp_path / "j.ppm")
    timage.write_ppm(img, pt_path, gamma2=gamma2)
    jimage.write_ppm(img, j_path, gamma2=gamma2)
    data = open(pt_path, "rb").read()
    assert data == open(j_path, "rb").read()
    assert data.startswith(b"P6\n24 16\n255\n")
    monkeypatch.setattr(jimage, "_native_lib", lambda: None)
    jimage.write_ppm(img, j_path, gamma2=gamma2)
    assert data == open(j_path, "rb").read()
    # A tensor writes as its numpy array.
    timage.write_ppm(torch.from_numpy(img), pt_path, gamma2=gamma2)
    assert data == open(pt_path, "rb").read()


def _chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode_png(arr, path, filters, depth=8, interlace=0, colour=None):
    """A PNG of uint8 ``arr`` [H, W, C] with row ``y`` filtered by
    ``filters[y % len(filters)]`` (0-4), written independently of both
    packages' encoders."""
    h, w, c = arr.shape
    bpp, rows, prev = c, [], bytes(w * c)
    for y in range(h):
        kind, line = filters[y % len(filters)], arr[y].tobytes()
        out = bytearray()
        for i, x in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            b = prev[i]
            cc = prev[i - bpp] if i >= bpp else 0
            p = (0, a, b, (a + b) >> 1, _paeth(a, b, cc))[kind]
            out.append((x - p) & 0xFF)
        rows.append(bytes([kind]) + bytes(out))
        prev = line
    colour = {3: 2, 4: 6}[c] if colour is None else colour
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(b"".join(rows)))
                + _chunk(b"IEND", b""))


def test_read_png_matches_jax_reader(tmp_path, monkeypatch):
    # PNGs from the JAX writer (native, then PIL with the native library
    # off), its pure-Python encoder and the port's writer decode exactly as
    # the JAX package's PIL reader decodes them.
    img = _image(5).astype(np.float64)
    paths = {"jax_native": tmp_path / "n.png", "jax_pure": tmp_path / "u.png",
             "port": tmp_path / "p.png", "jax_pil": tmp_path / "l.png"}
    jimage.write_png(img, str(paths["jax_native"]))
    jimage._write_png_pure(jimage.to_uint8(img), str(paths["jax_pure"]))
    timage.write_png(img, str(paths["port"]))
    monkeypatch.setattr(jimage, "_native_lib", lambda: None)
    jimage.write_png(img, str(paths["jax_pil"]))
    for name, p in paths.items():
        ours, theirs = timage.read_png(str(p)), jimage.read_png(str(p))
        assert ours.shape == (16, 24, 3) and ours.dtype == np.float64, name
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
        np.testing.assert_array_equal(ours, timage.to_uint8(img) / 255.0)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,),
                                     (4, 3, 2, 1, 0)])
@pytest.mark.parametrize("channels", [3, 4])
def test_read_png_row_filters(filters, channels, tmp_path):
    # Each of the five row filters, on RGB and RGBA (alpha dropped), against
    # the JAX package's PIL reader.
    g = np.random.default_rng(11)
    arr = g.integers(0, 256, (7, 9, channels), dtype=np.uint8)
    p = str(tmp_path / "f.png")
    _encode_png(arr, p, filters)
    ours = timage.read_png(p)
    np.testing.assert_array_equal(ours, jimage.read_png(p))
    np.testing.assert_array_equal(ours, arr[..., :3] / 255.0)


@pytest.mark.parametrize("what", ["depth16", "interlaced", "grey",
                                  "not_png"])
def test_read_png_refuses_other_files(what, tmp_path):
    p = str(tmp_path / "x.png")
    arr = np.zeros((2, 3, 3), dtype=np.uint8)
    if what == "depth16":
        _encode_png(arr, p, (0,), depth=16)
    elif what == "interlaced":
        _encode_png(arr, p, (0,), interlace=1)
    elif what == "grey":
        _encode_png(arr[..., :1], p, (0,), colour=0)
    else:
        with open(p, "wb") as f:
            f.write(b"P6\n3 2\n255\n" + arr.tobytes())
    with pytest.raises(ValueError):
        timage.read_png(p)
