"""The port's threefry streams (``rng.threefry_*``, ``rng.purpose_key``)
against ``jax.random`` and the JAX package's ``rng.purpose_key`` on the same
seeds: key data, ``fold_in`` (one key, and one key per lane as JAX's
``vmap`` gives them), ``split``, 32-bit random bits and ``uniform`` bit for
bit; ``normal`` within 4 ulps (XLA's float32 ``erf_inv`` takes ``log1p``
from its own library); and the JAX draws that the goldens' tests inject,
rebuilt by the port, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from raytracingweekend_jl_tpu import rng as jrng
from raytracingweekend_jl_tpu_torch import rng
# One intra-op torch thread per test module (an autouse fixture).
from test_torch_scene_camera import _one_torch_thread  # noqa: F401
from test_torch_pinned import KEY as PINNED_KEY, _jax_hooks
from test_torch_render import _jax_uniform_hooks

SEEDS = st.one_of(st.sampled_from([0, 1, 2**31 - 1, 2**31, 2**32 - 1,
                                   2**32, 2**32 + 5, 2**40 + 7]),
                  st.integers(0, 2**48))
DATA = st.integers(0, 2**32 - 1)
SHAPES = st.sampled_from([(1,), (5,), (3, 7), (9, 2, 128), (9, 64, 128),
                          (2, 3, 4)])
SETTINGS = settings(max_examples=12, deadline=None)
#: Few distinct lane counts: each new shape costs JAX a compile.
LANES = st.sampled_from([1, 37, 300])


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _data(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@SETTINGS
@given(seed=SEEDS, data=DATA)
def test_key_and_fold_in_match_jax(seed, data):
    key = rng.threefry_key(seed)
    np.testing.assert_array_equal(key.numpy(), _data(_jkey(seed)))
    np.testing.assert_array_equal(
        rng.threefry_fold_in(key, data).numpy(),
        _data(jax.random.fold_in(_jkey(seed), data)))


@SETTINGS
@given(seed=SEEDS, n=LANES)
def test_per_lane_fold_in_matches_vmap(seed, n):
    # One key folded with n lane ids, then each lane's key with its own
    # datum: JAX's vmap(fold_in, (None, 0)) and vmap(fold_in).
    g = np.random.default_rng(seed % 2**32)
    lanes = g.integers(0, 2**31 - 1, n, dtype=np.int64)
    more = g.integers(0, 2**31 - 1, n, dtype=np.int64)
    keys = rng.threefry_fold_in(rng.threefry_key(seed), torch.from_numpy(lanes))
    keys2 = rng.threefry_fold_in(keys, torch.from_numpy(more))
    jkeys = jax.vmap(jax.random.fold_in, (None, 0))(
        _jkey(seed), jnp.asarray(lanes, jnp.int32))
    jkeys2 = jax.vmap(jax.random.fold_in)(jkeys, jnp.asarray(more, jnp.int32))
    assert keys.shape == (n, 2)
    np.testing.assert_array_equal(keys.numpy(), _data(jkeys))
    np.testing.assert_array_equal(keys2.numpy(), _data(jkeys2))


@SETTINGS
@given(seed=SEEDS, num=st.sampled_from([1, 2, 3, 40]))
def test_split_matches_jax(seed, num):
    np.testing.assert_array_equal(
        rng.threefry_split(rng.threefry_key(seed), num).numpy(),
        _data(jax.random.split(_jkey(seed), num)))


@SETTINGS
@given(seed=SEEDS, shape=SHAPES)
def test_bits_and_uniform_match_jax(seed, shape):
    key = rng.threefry_key(seed)
    np.testing.assert_array_equal(
        rng.threefry_bits(key, shape).numpy(),
        np.asarray(jax.random.bits(_jkey(seed), shape)).astype(np.int64))
    got = rng.threefry_uniform(key, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax.random.uniform(_jkey(seed), shape)))


@SETTINGS
@given(seed=SEEDS, lo=st.floats(-10, 10, width=32),
       span=st.floats(0.0625, 20, width=32))
def test_uniform_range_matches_jax(seed, lo, span):
    # max(lo, u * (hi - lo) + lo), which XLA fuses into one multiply-add.
    hi = float(np.float32(lo + span))
    got = rng.threefry_uniform(rng.threefry_key(seed), (4096,), lo, hi)
    want = np.asarray(jax.random.uniform(_jkey(seed), (4096,), minval=lo,
                                         maxval=hi))
    np.testing.assert_array_equal(got.numpy(), want)


@SETTINGS
@given(seed=SEEDS, n=LANES)
def test_per_lane_uniform_matches_vmap(seed, n):
    # [n, 2] keys, 4 draws each: the JAX package's per_ray_uniforms
    # (vmap of uniform over per-ray keys).
    keys = rng.threefry_fold_in(rng.threefry_key(seed), torch.arange(n))
    jkeys = jax.vmap(jax.random.fold_in, (None, 0))(
        _jkey(seed), jnp.arange(n, dtype=jnp.int32))
    want = jax.vmap(lambda k: jax.random.uniform(k, (4,)))(jkeys)
    np.testing.assert_array_equal(rng.threefry_uniform(keys, (4,)).numpy(),
                                  np.asarray(want))


@SETTINGS
@given(seed=SEEDS, shape=st.sampled_from([(1000,), (7, 129), (20000,)]))
def test_normal_within_4_ulps_of_jax(seed, shape):
    # The same uniforms through XLA's erf_inv polynomial: measured at most
    # 3 ulps apart (98-99% of draws equal) over 60 seeds and shapes up to
    # 200 000 draws; torch.erfinv would be 91 ulps off in the tails, where
    # XLA's float32 polynomial is 6e-6 from the true value.
    got = rng.threefry_normal(rng.threefry_key(seed), shape).numpy().ravel()
    want = np.asarray(jax.random.normal(_jkey(seed), shape)).ravel()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 4, ulps.max()
    assert (got == want).mean() >= 0.95


@SETTINGS
@given(seed=SEEDS, purpose=st.integers(1, 5),
       coords=st.lists(DATA, max_size=3))
def test_purpose_key_matches_jax_package(seed, purpose, coords):
    key = rng.key_from_numpy(np.asarray(jax.random.key_data(_jkey(seed))))
    np.testing.assert_array_equal(
        rng.purpose_key(key, purpose, *coords).numpy(),
        _data(jrng.purpose_key(_jkey(seed), purpose, *coords)))


def test_purpose_key_per_lane_coords():
    # Tensor coordinates give one key per lane, as vmap over the JAX
    # package's purpose_key does.
    key = rng.threefry_key(9)
    lanes = torch.arange(37)
    got = rng.purpose_key(key, rng.PIXEL_JITTER, lanes, 4)
    want = jax.vmap(lambda c: jrng.purpose_key(_jkey(9), jrng.PIXEL_JITTER,
                                               c, 4))(jnp.arange(37))
    np.testing.assert_array_equal(got.numpy(), _data(want))


def test_key_from_numpy_refuses_other_layouts():
    with pytest.raises(ValueError):
        rng.key_from_numpy(np.zeros(2, np.int32))
    with pytest.raises(ValueError):
        rng.key_from_numpy(np.zeros((3,), np.uint32))
    assert rng.key_from_numpy(np.array([1, 2], np.uint32)).tolist() == [1, 2]


@pytest.mark.parametrize("n_pix,k,offset", [(64 * 36, 4, 0), (64 * 36, 1, 0),
                                            (48 * 27, 4, 8)])
def test_strided_hooks_rebuilt_bit_for_bit(n_pix, k, offset):
    # tests/test_torch_render.py's _jax_uniform_hooks (u4 of the strip-0
    # rays, u9 of each iteration over the padded (rows, 128) layout),
    # rebuilt from the port's threefry.
    u4, u9_fn = _jax_uniform_hooks(n_pix, k, sample_offset=offset)
    key = rng.key_from_numpy(np.asarray(jax.random.key_data(
        jax.random.PRNGKey(0))))
    p4, p9_fn = rng.reference_strided_draws(key, n_pix, k, offset)
    assert torch.equal(p4, u4)
    for it in (0, 1, 5, 63):
        assert torch.equal(p9_fn(it), u9_fn(it))


@pytest.mark.parametrize("n,offset", [(48 * 27, 0), (1000, 4)])
def test_pinned_hooks_rebuilt_bit_for_bit(n, offset):
    # tests/test_torch_pinned.py's _jax_hooks, rebuilt from the port's
    # threefry.
    u4, u9_fn = _jax_hooks(n, sample_offset=offset)
    key = rng.key_from_numpy(np.asarray(jax.random.key_data(PINNED_KEY)))
    p4, p9_fn = rng.reference_pinned_draws(key, n, offset)
    assert torch.equal(p4, u4)
    for it in (0, 2, 40):
        assert torch.equal(p9_fn(it), u9_fn(it))
