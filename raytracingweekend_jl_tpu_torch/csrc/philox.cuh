// Philox4x32-10 counter-based generator (Salmon, Moraes, Dror, Shaw,
// "Parallel random numbers: as easy as 1, 2, 3", SC'11), as in Random123.
//
// Replaces the TPU's in-kernel hardware PRNG (pltpu.prng_seed /
// prng_random_bits in raytracingweekend_jl_tpu/ops/pallas/shade_kernel.py),
// which was seeded per (block, iteration) and so tied the draws to the launch
// shape. Here a draw is a pure function of (key, counter): the strided step
// keys by (seed, iteration) and counts by lane, so the same lane draws the
// same numbers whatever the block size. The plain PyTorch version is
// raytracingweekend_jl_tpu_torch/rng.py::philox4x32; both pass the Random123
// known-answer vectors.

#pragma once

#include <stdint.h>

struct RtwU4 {
  uint32_t x, y, z, w;
};

__device__ __forceinline__ RtwU4 rtw_philox4x32_10(RtwU4 c, uint32_t k0,
                                                   uint32_t k1) {
  const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
  const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += W0;
      k1 += W1;
    }
    const uint32_t hi0 = __umulhi(M0, c.x), lo0 = M0 * c.x;
    const uint32_t hi1 = __umulhi(M1, c.z), lo1 = M1 * c.z;
    RtwU4 n;
    n.x = hi1 ^ c.y ^ k0;
    n.y = lo1;
    n.z = hi0 ^ c.w ^ k1;
    n.w = lo0;
    c = n;
  }
  return c;
}

// Top 24 bits of an unsigned word times 2^-24: exactly representable, in
// [0, 1). A logical shift of an unsigned value: no sign extension.
__device__ __forceinline__ float rtw_u01(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

// The first N uniforms of one lane's draws keyed by (seed, iteration):
// counter (lane, block, 0, 0), uniform j = word j % 4 of block j / 4. The
// plain PyTorch version is rng.py::philox_uniforms.
template <int N>
__device__ __forceinline__ void rtw_uniforms(uint32_t seed, uint32_t iteration,
                                             uint32_t lane, float* u) {
#pragma unroll
  for (int blk = 0; blk < (N + 3) / 4; ++blk) {
    RtwU4 c = {lane, (uint32_t)blk, 0u, 0u};
    RtwU4 r = rtw_philox4x32_10(c, seed, iteration);
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * blk + q < N) u[4 * blk + q] = rtw_u01(w[q]);
  }
}
