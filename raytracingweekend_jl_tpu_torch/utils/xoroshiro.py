"""Pure-Python replay of the reference's scene RNG — Xoroshiro128Plus.

The port's own copy of ``raytracingweekend_jl_tpu.utils.xoroshiro`` (the
port imports nothing of the JAX package); the two give the same stream.

The reference builds ``scene_random_spheres`` by drawing from per-thread
``Xoroshiro128Plus`` generators (RandomNumbers.jl v1.5.3; reference:
src/init.jl:8-10, src/rand.jl:5-13). Scene construction is single-threaded on
thread 1 and the canonical flow re-seeds first (src/proto/proto.jl:198-199:
``reseed!(); scene_random_spheres(...)``), so the *exact* scene instance
behind the committed render ``img/scene_random_spheres_1920x1080.png`` is
reconstructible from a fresh seed-1 stream — no Julia needed. This module
replays that stream bit-exactly so same-scene image parity against the
reference PNG is possible (docs/PARITY.md).

Semantics replicated from RandomNumbers.jl v1.5.3 (the version pinned by the
reference's src/proto/Manifest.toml):

- state: two UInt64 (x, y); ``Xoroshiro128Plus(seed)`` splits
  ``seed % UInt128`` into (low, high) 64-bit words, then runs TWO warm-up
  steps (``seed!`` calls ``xorshift_next`` twice before first use);
- step: ``p = x + y; s1 = x ⊻ y; x = rotl(x,55) ⊻ s1 ⊻ (s1 << 14);
  y = rotl(s1, 36); return p`` — the 2016 xoroshiro128+ constants
  (55, 14, 36), not the 2018 (24, 16, 37) revision;
- ``rand(rng, Float64)``: RandomNumbers.jl's own Close1Open2 conversion —
  the HIGH 52 bits of the output word into a [1,2) mantissa, minus 1
  (``reinterpret(Float64, 0x3ff<<52 | u >> 12) - 1.0``). The ``low52`` flag
  keeps the Base-style low-bit variant selectable for experiments.

Empirical caveat (docs/PARITY.md "Scene replay"): a 16-variant search over
(seeding, warm-up, bit-mapping) against the committed reference render shows
NO variant reproduces the PNG's scene instance (all per-pixel scores ~14x the
matched-scene floor) — the committed image predates the reference's "fixed,
per-thread RNGs with fixed seeds" change (src/proto/proto.jl optimization
log) and is therefore not reconstructible in principle. The replay below is
the CANONICAL deterministic instance of the reference's generator under its
pinned RandomNumbers.jl semantics, fixed as a committed fixture
(tests/goldens/reference_scene_xoroshiro.npz).
"""

from __future__ import annotations

_M64 = (1 << 64) - 1


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _M64


class Xoroshiro128Plus:
    """Bit-exact xoroshiro128+ as instantiated by RandomNumbers.jl v1.5.3."""

    def __init__(self, seed: int, warmup: int = 2, low52: bool = False):
        s = seed % (1 << 128)
        self.x = s & _M64
        self.y = (s >> 64) & _M64
        if self.x == 0 and self.y == 0:
            raise ValueError("0 cannot be the seed of xoroshiro128+")
        self._low52 = low52
        for _ in range(warmup):
            self.next_uint64()

    def next_uint64(self) -> int:
        x, y = self.x, self.y
        p = (x + y) & _M64
        s1 = x ^ y
        self.x = _rotl(x, 55) ^ s1 ^ ((s1 << 14) & _M64)
        self.y = _rotl(s1, 36)
        return p

    def rand(self) -> float:
        """U[0,1) Float64 — Julia ``rand(rng)`` / ``trand(Float64)``."""
        u = self.next_uint64()
        bits52 = (u & ((1 << 52) - 1)) if self._low52 else (u >> 12)
        # [1,2) mantissa trick, then shift to [0,1).
        import struct

        f = struct.unpack("<d", struct.pack("<Q", 0x3FF0000000000000 | bits52))[0]
        return f - 1.0

    def rand_between(self, lo: float, hi: float) -> float:
        """reference ``random_between`` (src/rand.jl:24): trand*(max-min)+min."""
        return self.rand() * (hi - lo) + lo
