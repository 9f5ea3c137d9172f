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

A bit-exact threefry is future work; tests that compare against the reference
package inject its uniforms instead.
"""

from __future__ import annotations

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
