// K7b and K7c: the replay (backward) kernels of the fixed-depth record for
// Hopper (sm_90a).
//
// K7c replaces raytracingweekend_jl_tpu/ops/pallas/grad_kernel.py ::
// _replay_bwd_fused_kernel (launched by replay_bwd_fused), the whole reverse
// bounce walk in one launch, the default. K7b replaces _replay_bwd_kernel
// (launched by replay_bwd_step), one reverse bounce per launch, the route
// with the fused replay off. Both run the bounce adjoint of
// bounce_adjoint.cuh on each recorded bounce. The plain PyTorch versions are
// replay_bwd_fused_ref and replay_bwd_step_ref in
// raytracingweekend_jl_tpu_torch/ops/cuda/grad_kernel.py.
//
// Per lane and bounce: a slot whose alive flag is 0 writes zero attribute
// rows and passes the carried cotangent through unchanged (the TPU kernels
// did this per dead (64, 128) block; the adjoint of a dead lane's
// pass-through is the identity). A live slot redraws the record kernel's 5
// uniforms, takes hit = t < BIG, and runs the bounce adjoint with hit lanes
// advancing and missing lanes banking the sky: the carried (o, d, T)
// cotangent of the bounce's outputs becomes that of its inputs, and the 9
// cotangent rows of the winner's (center, radius, albedo, fuzz, ir) are
// written. The fixed-depth chain is never cut: a path that died keeps its
// carry, which is zero there because nothing after its death depends on it.
//
// What bounds them on the card: memory traffic. Per live lane and bounce
// the replay reads the 21 record words and writes 9 attribute rows (~120
// bytes) and runs ~400 flops with five transcendental calls; a dead slot
// reads its flag and writes 9 zero rows. The demo's 16-slot walk at 22 400
// lanes (64 217 of 358 400 slots live) moves ~21 MB, ~6.4 us of HBM time.
//
// Design: one thread per lane. K7c walks its lane's bounces newest first
// with the 9 carried cotangents and the 3 radiance cotangents in registers
// for the whole walk, as the TPU kernel kept them resident in VMEM over a
// (block, bounce) grid; only the record streams in and the attribute rows
// stream out, each a coalesced [plane, lane] access. K7b carries the
// cotangent through device memory between launches. The draws are the
// record kernel's own: Philox4x32-10 keyed by (seed, bounce) with the lane
// as the counter, or read from u5. Offsets into the record are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_adjoint.cuh"
#include "philox.cuh"

// One reverse bounce of one live lane. r: the record's o3 d3 T3 t; a: the
// winner's 10 attributes; g: the lane's radiance cotangent; cot: the carry,
// updated; d9: the attribute rows.
__device__ __forceinline__ void rtw_fixed_replay(const float* u, const float* r,
                                                 const float* a, const float* g,
                                                 float* cot, float* d9) {
  const bool hit = r[9] < RTW_BIG;
  rtw_bounce_adjoint(u, r, a, g, cot, hit, !hit, d9);
}

// Loads slot `rs` [21, n] of lane i and replays it; returns false (and
// writes nothing) for a dead slot.
__device__ __forceinline__ bool rtw_replay_slot(
    const float* __restrict__ rs, const float* __restrict__ us, size_t n,
    int i, uint32_t seed, uint32_t bounce, const float* g, float* cot,
    float* d9) {
  if (__float_as_int(rs[10 * n + i]) == 0) return false;
  float u[5];
  if (us) {
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = us[j * n + i];
  } else {
    rtw_uniforms<5>(seed, bounce, (uint32_t)i, u);
  }
  float r[10], a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) r[j] = rs[j * n + i];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = rs[(11 + j) * n + i];
  rtw_fixed_replay(u, r, a, g, cot, d9);
  return true;
}

// K7c. rec [n_slots, 21, n]; g3 [3, n]; cot [9, n] in place (the carry
// before the newest slot, then after slot 0); dattr [n_slots, 9, n]
// written; u5 [n_slots, 5, n] or NULL.
__global__ void replay_bwd_fused_kernel(const float* __restrict__ rec,
                                        const float* __restrict__ g3,
                                        float* __restrict__ cot_io,
                                        float* __restrict__ dattr,
                                        const float* __restrict__ u5,
                                        int n_lanes, int n_slots,
                                        uint32_t seed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  float cot[9], g[3], d9[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = g3[j * n + i];
  for (int slot = n_slots - 1; slot >= 0; --slot) {
    const float* us = u5 ? u5 + (size_t)slot * 5 * n : nullptr;
    float* da = dattr + (size_t)slot * 9 * n;
    if (rtw_replay_slot(rec + (size_t)slot * 21 * n, us, n, i, seed,
                        (uint32_t)slot, g, cot, d9)) {
#pragma unroll
      for (int j = 0; j < 9; ++j) da[j * n + i] = d9[j];
    } else {
#pragma unroll
      for (int j = 0; j < 9; ++j) da[j * n + i] = 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) cot_io[j * n + i] = cot[j];
}

// K7b. One slot: rec [21, n] of bounce `bounce`; g3 [3, n]; cot [9, n] in
// place; dattr [9, n] written; u5 [5, n] or NULL.
__global__ void replay_bwd_step_kernel(const float* __restrict__ rec,
                                       const float* __restrict__ g3,
                                       float* __restrict__ cot_io,
                                       float* __restrict__ dattr,
                                       const float* __restrict__ u5,
                                       int n_lanes, uint32_t seed,
                                       uint32_t bounce) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  float cot[9], g[3], d9[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = g3[j * n + i];
  if (rtw_replay_slot(rec, u5, n, i, seed, bounce, g, cot, d9)) {
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      cot_io[j * n + i] = cot[j];
      dattr[j * n + i] = d9[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 9; ++j) dattr[j * n + i] = 0.0f;
  }
}

extern "C" int rtw_replay_bwd_fused(const float* rec, const float* g3,
                                    float* cot, float* dattr, const float* u5,
                                    int n_lanes, int n_slots,
                                    unsigned int seed, void* stream) {
  if (n_lanes <= 0 || n_slots <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  replay_bwd_fused_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      rec, g3, cot, dattr, u5, n_lanes, n_slots, seed);
  return (int)cudaGetLastError();
}

extern "C" int rtw_replay_bwd_step(const float* rec, const float* g3,
                                   float* cot, float* dattr, const float* u5,
                                   int n_lanes, unsigned int seed,
                                   unsigned int bounce, void* stream) {
  if (n_lanes <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  replay_bwd_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      rec, g3, cot, dattr, u5, n_lanes, seed, bounce);
  return (int)cudaGetLastError();
}
