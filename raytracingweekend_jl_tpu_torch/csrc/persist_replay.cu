// K5 and K6: the replay (backward) kernels of the persistent-record gradient
// path for Hopper (sm_90a).
//
// K5 replaces raytracingweekend_jl_tpu/ops/pallas/persist_grad_kernel.py ::
// _persist_replay_fused_kernel (launched by persist_replay_fused), the whole
// reverse walk of one record phase in one launch. K6 replaces
// _persist_replay_kernel (launched by persist_replay_step), one reverse slot
// per launch, used for the lean 11-plane record whose winner attributes the
// host code refetches. Both run the per-iteration core _replay_iter_core
// (rtw_replay_iter below) over the shared bounce adjoint
// (bounce_adjoint.cuh). The plain PyTorch versions are
// persist_replay_fused_ref and persist_replay_step_ref in
// raytracingweekend_jl_tpu_torch/ops/cuda/persist_grad_kernel.py.
//
// Per lane and slot: decode the flags; at a regeneration, deposit the
// carried (o, d) cotangent as the cotangent of the strip's camera ray; cut
// the chain where the forward did (termination, inactive lane); take the
// radiance cotangent of the lane's current strip; run the bounce adjoint;
// write the 9 per-lane cotangent rows of the winner's attributes. A slot
// whose flags lack `act` writes zero rows and leaves the carry alone.
//
// What bounds them on the card: memory traffic. Per live lane and slot K5
// reads the 21 record words and writes 9 attribute rows (~120 bytes) and
// runs ~400 flops with five transcendental calls; at the flagship width one
// slot of 262 144 lanes moves ~32 MB, ~10 us of HBM time.
//
// Design: one thread per lane walks the slots newest to oldest. The 9
// carried cotangents stay in registers for the whole walk, as the TPU kept
// its carry windows resident in VMEM; only the record streams in and the
// attribute rows stream out, each a coalesced [plane, lane] access. The
// strip deposits are written to device memory in place, at the one slot
// where each strip starts (a strip starts once per lane), so they need no
// registers. The draws are the record kernel's own: Philox4x32-10 keyed by
// (seed, i0 + slot) with the lane as the counter, or read from u5.
// Offsets into the record are 64-bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_adjoint.cuh"
#include "philox.cuh"

#define RTW_F_ACT 1
#define RTW_F_HIT 2
#define RTW_F_TERM 4
#define RTW_F_REGEN 8
#define RTW_F_STRIP_SHIFT 4

// One reverse iteration of one active lane (flags has RTW_F_ACT).
// r: the record's o3 d3 T3 t; a: the winner's 10 attributes; cot: the
// carry, updated; gs: [3S, n] radiance cotangent strips; dep: [6S, n]
// deposit planes, written at a regeneration.
__device__ __forceinline__ void rtw_replay_iter(
    const float* u, const float* r, const float* a, int flags, float* cot,
    const float* __restrict__ gs, float* __restrict__ dep, size_t n, int i,
    int S, float* dattr) {
  const bool act = (flags & RTW_F_ACT) != 0;
  const bool hit = (flags & RTW_F_HIT) != 0;
  const bool term = (flags & RTW_F_TERM) != 0;
  const bool regen = (flags & RTW_F_REGEN) != 0;
  const int sp = flags >> RTW_F_STRIP_SHIFT;

  // The carried (o, d) cotangent is that of the camera ray the regeneration
  // started (strip sp + 1); its initial throughput is the constant 1.
  if (regen && sp + 1 < S) {
    float* d = dep + (size_t)(6 * (sp + 1)) * n + i;
#pragma unroll
    for (int j = 0; j < 6; ++j) d[j * n] = cot[j];
  }
  // Cut the chain where the forward did.
  if (term || !act) {
#pragma unroll
    for (int j = 0; j < 9; ++j) cot[j] = 0.0f;
  }
  float g[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = gs[(size_t)(3 * sp + j) * n + i];
  const bool adv = hit && !term;   // state advanced (hit and continued)
  const bool inject = act && !hit;  // banked T * sky(d) this iteration
  rtw_bounce_adjoint(u, r, a, g, cot, adv, inject, dattr);
}

// K5. cot [9, n] and dep [6S, n] are updated in place; rec is
// [n_slots, 21, n]; dattr [n_slots, 9, n] is written; u5 [n_slots, 5, n]
// or NULL.
__global__ void persist_replay_fused_kernel(
    float* __restrict__ cot_io, float* __restrict__ dep,
    const float* __restrict__ rec, const float* __restrict__ gs,
    float* __restrict__ dattr, const float* __restrict__ u5, int n_lanes,
    int S, int n_slots, uint32_t seed, uint32_t i0) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  float cot[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];

  for (int slot = n_slots - 1; slot >= 0; --slot) {
    const float* rs = rec + (size_t)slot * 21 * n;
    float* da = dattr + (size_t)slot * 9 * n;
    const int flags = __float_as_int(rs[10 * n + i]);
    if (!(flags & RTW_F_ACT)) {
#pragma unroll
      for (int j = 0; j < 9; ++j) da[j * n + i] = 0.0f;
      continue;
    }
    float u[5];
    if (u5) {
      const float* us = u5 + (size_t)slot * 5 * n;
#pragma unroll
      for (int j = 0; j < 5; ++j) u[j] = us[j * n + i];
    } else {
      rtw_uniforms<5>(seed, i0 + (uint32_t)slot, (uint32_t)i, u);
    }
    float r[10], a[10], d9[9];
#pragma unroll
    for (int j = 0; j < 10; ++j) r[j] = rs[j * n + i];
#pragma unroll
    for (int j = 0; j < 10; ++j) a[j] = rs[(11 + j) * n + i];
    rtw_replay_iter(u, r, a, flags, cot, gs, dep, n, i, S, d9);
#pragma unroll
    for (int j = 0; j < 9; ++j) da[j * n + i] = d9[j];
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) cot_io[j * n + i] = cot[j];
}

// K6. One slot: rec [n_rec, n] (21 planes, or 11 with the winner
// attributes in attrs [10, n]); cot and dep in place; dattr [9, n] written.
__global__ void persist_replay_step_kernel(
    float* __restrict__ cot_io, float* __restrict__ dep,
    const float* __restrict__ rec, const float* __restrict__ attrs,
    const float* __restrict__ gs, float* __restrict__ dattr,
    const float* __restrict__ u5, int n_lanes, int S, uint32_t seed,
    uint32_t iteration) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  const int flags = __float_as_int(rec[10 * n + i]);
  if (!(flags & RTW_F_ACT)) {
#pragma unroll
    for (int j = 0; j < 9; ++j) dattr[j * n + i] = 0.0f;
    return;
  }
  float u[5];
  if (u5) {
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = u5[j * n + i];
  } else {
    rtw_uniforms<5>(seed, iteration, (uint32_t)i, u);
  }
  const float* ap = attrs ? attrs : rec + 11 * n;
  float cot[9], r[10], a[10], d9[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];
#pragma unroll
  for (int j = 0; j < 10; ++j) r[j] = rec[j * n + i];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = ap[j * n + i];
  rtw_replay_iter(u, r, a, flags, cot, gs, dep, n, i, S, d9);
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    cot_io[j * n + i] = cot[j];
    dattr[j * n + i] = d9[j];
  }
}

extern "C" int rtw_persist_replay_fused(float* cot, float* dep,
                                        const float* rec, const float* gs,
                                        float* dattr, const float* u5,
                                        int n_lanes, int S, int n_slots,
                                        unsigned int seed, unsigned int i0,
                                        void* stream) {
  if (n_lanes <= 0 || n_slots <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  persist_replay_fused_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cot, dep, rec, gs, dattr, u5, n_lanes, S, n_slots, seed, i0);
  return (int)cudaGetLastError();
}

extern "C" int rtw_persist_replay_step(float* cot, float* dep,
                                       const float* rec, const float* attrs,
                                       const float* gs, float* dattr,
                                       const float* u5, int n_lanes, int S,
                                       unsigned int seed,
                                       unsigned int iteration, void* stream) {
  if (n_lanes <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  persist_replay_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cot, dep, rec, attrs, gs, dattr, u5, n_lanes, S, seed, iteration);
  return (int)cudaGetLastError();
}
