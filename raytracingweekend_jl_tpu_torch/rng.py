"""Counter-based random streams for the port.

The reference package derives every stream by folding a purpose tag and the
(chunk, sample, bounce) coordinates into a threefry key. The port keeps the
purpose tags and the folding structure but not threefry's bits:

- seeds are Python integers, folded with a 64-bit mixer (:func:`fold_in`);
- host-side draws (strip-0 camera jitter and lens samples) come from an
  explicit ``torch.Generator`` seeded from such a fold (:func:`generator`);
- the strided step's in-kernel draws are Philox4x32-10 keyed by
  ``(seed, iteration)`` with the lane as the counter. :func:`philox_uniforms`
  is the plain PyTorch version of those draws; the CUDA kernel
  (csrc/philox.cuh) produces the same bits.

The reference package's own streams are JAX's threefry2x32 keys. The port
reproduces them bit for bit (:func:`threefry_key`, :func:`threefry_fold_in`,
:func:`threefry_split`, :func:`threefry_bits`, :func:`threefry_uniform`,
:func:`threefry_normal` and :func:`purpose_key`), so a check can feed a
route the reference package's draws without JAX. No program stream uses
them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Static purpose tags — one per consumption site class (as in the reference).
PIXEL_JITTER = 0x01  # src/render.jl:34-35
LENS = 0x02          # src/camera.jl:44
SCATTER_DIR = 0x03   # src/material.jl:14,32
SCHLICK = 0x04       # src/material.jl:47
SCENE_GEN = 0x05     # src/scenes.jl:57-70

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def fold_in(seed: int, data: int) -> int:
    """A new 64-bit seed from ``seed`` and one integer coordinate."""
    return _splitmix64((_splitmix64(seed & _M64) ^ (data & _M64)) & _M64)


def purpose_seed(seed: int, purpose: int, *coords: int) -> int:
    """Seed of the stream for one (purpose, coords...) consumption site."""
    s = fold_in(seed, purpose)
    for c in coords:
        s = fold_in(s, c)
    return s


def generator(seed: int, purpose: int, *coords: int,
              device="cpu") -> torch.Generator:
    """An explicit ``torch.Generator`` on ``device`` for one consumption site."""
    g = torch.Generator(device=device)
    g.manual_seed(purpose_seed(seed, purpose, *coords) & ((1 << 63) - 1))
    return g


def persistent_seed(seed: int, sample_offset: int) -> int:
    """32-bit Philox key word of the strided step's in-kernel draws. Folds in
    both the render seed and ``sample_offset`` (the chunk's first global
    sample), so spp chunks draw decorrelated streams."""
    return purpose_seed(seed, SCATTER_DIR, sample_offset) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3")
# ---------------------------------------------------------------------------

_PHILOX_M0 = 0xD2511F53
_PHILOX_M1 = 0xCD9E8D57
_PHILOX_W0 = 0x9E3779B9
_PHILOX_W1 = 0xBB67AE85
_M32 = 0xFFFFFFFF


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of ``a * b`` for a constant ``a`` and int64
    tensors holding uint32 values; 16-bit halves keep every product < 2^48."""
    b_lo = b & 0xFFFF
    b_hi = b >> 16
    p_lo = a * b_lo
    p_hi = a * b_hi
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _M32
    return hi, lo


def philox4x32(ctr: tuple, key: tuple) -> tuple:
    """Philox4x32-10 over int64 tensors (or ints) holding uint32 words.
    Returns the four output words as int64 tensors."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (in int64) -> float32 in [0, 1): the top 24 bits times
    2^-24. A logical shift on unsigned words, so no sign extension."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def philox_uniforms(seed: int, iteration, n_lanes: int, n: int = 9,
                    device="cpu", lanes: torch.Tensor | None = None,
                    coords: tuple = (0, 0)) -> torch.Tensor:
    """``[n, n_lanes]`` float32 uniforms of one strided iteration: Philox
    keyed by ``(seed, iteration)``, counter ``(lane, block, 0, 0)``; uniform
    ``j`` is word ``j % 4`` of block ``j // 4``. Independent of launch shape.
    ``lanes`` ([n_lanes] integer ids) replaces the counters ``0..n_lanes-1``:
    a ray keyed by its slot draws the same numbers wherever it sits.
    ``coords`` (two ints or [n_lanes] integer tensors) fill the counter's
    last two words, e.g. a ray's sample and bounce. ``iteration`` may be an
    integer tensor [D, 1]: the draws of D iterations at once, ``[n, D,
    n_lanes]``, each row the bits of its iteration's own call."""
    lane = (torch.arange(n_lanes, dtype=torch.int64, device=device)
            if lanes is None else lanes.to(torch.int64) & _M32)
    zero = torch.zeros_like(lane)
    c2, c3 = ((zero + c if isinstance(c, int) else c.to(torch.int64)) & _M32
              for c in coords)
    key = (seed & _M32, iteration & _M32)
    words = []
    for blk in range(-(-n // 4)):
        words.extend(philox4x32((lane, zero + blk, c2, c3), key))
    return torch.stack([bits_to_uniform(w) for w in words[:n]])


# ---------------------------------------------------------------------------
# threefry2x32: the reference package's key streams (jax/_src/prng.py)
# ---------------------------------------------------------------------------
#
# A key is an int64 tensor ``[..., 2]`` holding two uint32 words, JAX's
# ``key_data`` layout; a batch of keys (``[n, 2]``) acts as JAX's ``vmap``
# over them. Everything follows JAX with ``jax_threefry_partitionable`` on
# (its default since jax 0.5) and 64-bit types off (its default).

_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_THREEFRY_PARITY = 0x1BD11BDA


def _rotl32(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(key: tuple, x0, x1) -> tuple:
    """Threefry-2x32 with 20 rounds over int64 tensors (or ints) holding
    uint32 words: ``key`` = (k0, k1), counter words ``x0``, ``x1`` (all
    broadcast together). Returns the two output words (JAX's
    ``threefry2x32_p``, jax/_src/prng.py:883 ``_threefry2x32_lowering``,
    which ``threefry_2x32`` at :1092 applies to a flat counter's halves)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _THREEFRY_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _words(key: torch.Tensor) -> tuple:
    return key[..., 0], key[..., 1]


def threefry_key(seed: int, device="cpu") -> torch.Tensor:
    """JAX's ``PRNGKey(seed)`` as key data ``[2]`` (``threefry_seed``,
    jax/_src/prng.py:802): with 64-bit types off JAX first takes the seed
    to 32 bits, so the words are ``(0, seed mod 2^32)``."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def key_from_numpy(data, device="cpu") -> torch.Tensor:
    """A key from the reference package, given as its ``key_data`` (a
    numpy uint32 ``[..., 2]`` array): the int64 key data of this module."""
    arr = np.asarray(data)
    if arr.shape[-1:] != (2,) or arr.dtype != np.uint32:
        raise ValueError(f"key data must be uint32 [..., 2], got "
                         f"{arr.dtype} {arr.shape}")
    return torch.as_tensor(arr.astype(np.int64), device=device)


def threefry_fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """JAX's ``fold_in(key, data)`` (``_threefry_fold_in``,
    jax/_src/prng.py:1168): threefry of the counter ``(0, data)``. ``data``
    is an int or an integer tensor ``[n]``; a tensor gives one key per
    entry, as ``vmap(fold_in)`` does (``key`` one key ``[2]`` or one per
    entry ``[n, 2]``)."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=key.device, dtype=torch.int64) & _M32
        zero = torch.zeros_like(data)
    else:
        data, zero = int(data) & _M32, 0
    y0, y1 = threefry2x32(_words(key), zero, data)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def _flat_counters(shape: tuple, device) -> tuple:
    """JAX's ``iota_2x32_shape``: the row-major flat index of every element
    of ``shape`` as (high, low) uint32 words."""
    i = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=device).reshape(shape)
    return i >> 32, i & _M32


def threefry_split(key: torch.Tensor, num=2) -> torch.Tensor:
    """JAX's ``split(key, num)`` (``_threefry_split_foldlike``,
    jax/_src/prng.py:1143-1161): key ``j`` is the threefry of counter
    ``j``, shape ``(*key.shape[:-1], *num, 2)``; ``num`` an int or a
    shape."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    hi, lo = _flat_counters(shape, key.device)
    k0, k1 = (w.reshape(w.shape + (1,) * len(shape)) for w in _words(key))
    return torch.stack(threefry2x32((k0, k1), hi, lo), -1)


def threefry_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """JAX's 32-bit ``random_bits(key, 32, shape)``
    (``_threefry_random_bits_partitionable``, jax/_src/prng.py:1184): the
    counter of each element is its flat index as (high, low) words, the
    bits ``y0 ^ y1``. Shape ``(*key.shape[:-1], *shape)``, int64 holding
    uint32 words."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    hi, lo = _flat_counters(shape, key.device)
    k0, k1 = (w.reshape(w.shape + (1,) * len(shape)) for w in _words(key))
    y0, y1 = threefry2x32((k0, k1), hi, lo)
    return y0 ^ y1


def threefry_uniform(key: torch.Tensor, shape, minval: float = 0.0,
                     maxval: float = 1.0) -> torch.Tensor:
    """JAX's float32 ``uniform(key, shape, minval=, maxval=)``
    (jax/_src/random.py ``_uniform``): the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, then ``max(minval, u * (maxval - minval) +
    minval)`` in float32."""
    bits = threefry_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(_fma(f, float(hi - lo), float(lo)), float(lo))


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as XLA's CPU code contracts it:
    the product of two float32 is exact in float64, so the sum is formed
    there (a second rounding differs from a fused one only where the
    float64 sum lands exactly halfway between two float32)."""
    return (a.double() * b + c).to(torch.float32)


#: Giles' single-precision erfinv polynomials ("Approximating the erfinv
#: function", 2010), which XLA's float32 erf_inv evaluates: for w < 5, and
#: for w >= 5 in sqrt(w).
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613, 0.00943887047,
               1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv``: ``w = -log1p(-x * x)``, then a degree-8
    polynomial in ``w - 2.5`` or ``sqrt(w) - 3`` by Horner steps (fused, as
    XLA's CPU code runs them), times ``x``; +-inf at +-1."""
    w = -torch.log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, float(np.float32(_ERFINV_LT5[i])),
                           float(np.float32(_ERFINV_GE5[i]))).to(x.dtype)

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = (p.double() * w.double() + coef(i).double()).to(x.dtype)
    return torch.where(x.abs() == 1, x * math.inf, p * x)


def threefry_normal(key: torch.Tensor, shape) -> torch.Tensor:
    """JAX's float32 ``normal(key, shape)`` (``_normal_real``): a uniform
    in (-1, 1) through ``sqrt(2) * erf_inv``, with XLA's erf_inv
    polynomial. Within a few ulps of JAX's values (``torch.log1p`` is not
    XLA's), not bit for bit."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = threefry_uniform(key, shape, lo, 1.0)
    return float(np.float32(np.sqrt(2.0))) * _erfinv_f32(u)


def purpose_key(key: torch.Tensor, purpose: int, *coords) -> torch.Tensor:
    """The reference package's ``rng.purpose_key``: ``key`` folded with the
    purpose tag, then each coordinate in turn (ints, or integer tensors for
    one key per entry)."""
    key = threefry_fold_in(key, purpose)
    for c in coords:
        key = threefry_fold_in(key, c)
    return key


def _first_ray_uniforms(key: torch.Tensor, n: int,
                        sample_offset: int) -> torch.Tensor:
    """``[n, 4]``: the reference package's first-ray draws of lanes (or
    slots) ``0..n-1``, one key each, ``fold_in(fold_in(purpose_key(key,
    PIXEL_JITTER), lane), sample_offset)``."""
    lanes = torch.arange(n, dtype=torch.int64, device=key.device)
    keys = threefry_fold_in(purpose_key(key, PIXEL_JITTER), lanes)
    return threefry_uniform(threefry_fold_in(keys, sample_offset), (4,))


def reference_strided_draws(key: torch.Tensor, n_pix: int, k: int,
                            sample_offset: int = 0) -> tuple:
    """``(init_u4 [n_lanes, 4], rng_u9_fn)``: the draws of the reference
    package's strided integrator on a whole image from pixel 0 with ``k``
    pixels a lane (its interpret path, which the port's strided loop takes
    as ``init_u4`` and ``rng_u9_fn``). Iteration ``it`` draws ``uniform(
    fold_in(fold_in(key, sample_offset), it), (9, rows, 128))`` over the
    reference's padded lane layout (rows a multiple of 64), cut to the
    port's ``[9, n_lanes]``."""
    n_lanes = -(-n_pix // k)
    padded = -(-(-(-n_lanes // 128)) // 64) * 64 * 128
    k0 = threefry_fold_in(key, sample_offset)

    def u9(it: int) -> torch.Tensor:
        return threefry_uniform(threefry_fold_in(k0, it),
                                (9, padded))[:, :n_lanes].contiguous()

    return _first_ray_uniforms(key, n_lanes, sample_offset), u9


def reference_pinned_draws(key: torch.Tensor, n: int,
                           sample_offset: int = 0) -> tuple:
    """``(init_u4 [n, 4], rng_u9_fn)``: the draws of the reference
    package's pixel-pinned route over ``n`` pixels (its interpret path):
    iteration ``it`` draws ``uniform(fold_in(fold_in(key, sample_offset),
    it), (9, n))``."""
    k0 = threefry_fold_in(key, sample_offset)

    def u9(it: int) -> torch.Tensor:
        return threefry_uniform(threefry_fold_in(k0, it), (9, n))

    return _first_ray_uniforms(key, n, sample_offset), u9
