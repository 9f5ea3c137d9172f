// K5 and K6: the replay (backward) kernels of the persistent-record gradient
// path for Hopper (sm_90a).
//
// K5 replaces raytracingweekend_jl_tpu/ops/pallas/persist_grad_kernel.py ::
// _persist_replay_fused_kernel (launched by persist_replay_fused), the whole
// reverse walk of one record phase in one launch. K6 replaces
// _persist_replay_kernel (launched by persist_replay_step), one reverse slot
// per launch, used for the lean 11-plane record: it takes the slot's winner
// indices and the [N, 10] attribute table and reads each winner's row
// itself (no gather before it). Both run the per-iteration core
// _replay_iter_core (rtw_replay_iter below) over the shared bounce adjoint
// (bounce_adjoint.cuh). The plain PyTorch versions are
// persist_replay_fused_ref and persist_replay_step_fetch_ref in
// raytracingweekend_jl_tpu_torch/ops/cuda/persist_grad_kernel.py.
//
// Per lane and slot: decode the flags; at a regeneration, deposit the
// carried (o, d) cotangent as the cotangent of the strip's camera ray; cut
// the chain where the forward did (termination, inactive lane); take the
// radiance cotangent of the lane's current strip; run the bounce adjoint;
// write the 9 per-lane cotangent rows of the winner's attributes. A slot
// whose flags lack `act` writes zero rows and leaves the carry alone.
//
// What bounds them on the card. By bytes: per live lane and slot K5 reads
// the 21 record words and the strip's 3 radiance cotangents and writes 9
// attribute rows, and a dead lane writes 9 zero rows; K6 reads 11 record
// words, the winner index and its row (40 bytes of the table, from L1). By
// instructions: the adjoint's ~400 flops, five transcendental calls and two
// Philox blocks per live lane, issued for a whole warp while any of its
// lanes lives (at the flagship step's phase 1, 93% of warp slots against
// 57% of lane slots). K5's walk with the adjoint left out, and its adjoint
// with the record cache-resident, each take about three quarters of its
// time (scripts/torch_k5_k6_variants.py, probes).
//
// Design: one thread per lane walks the slots newest to oldest. The 9
// carried cotangents stay in registers for the whole walk, as the TPU kept
// its carry windows resident in VMEM; only the record streams in and the
// attribute rows stream out, each a coalesced [plane, lane] access. The
// walk is serial per lane, so K5 stages the words of the next three slots
// into shared memory (cp.async, four buffers) while it replays one, with
// their flags already in registers, so a dead lane stages nothing; this
// hides the loads' latency where few warps share an SM (the tail-compacted
// phase), and the buffers' 46 KB hold an SM to 4 resident blocks, which
// the full-width phase runs faster at than 6. The flags are loaded
// evict-first and the attribute rows stored streaming (read and written
// once). The strip deposits are written to device memory in place, at the
// one slot where each strip starts (a strip starts once per lane), so they
// need no registers. The draws are the record kernel's own: Philox4x32-10
// keyed by (seed, i0 + slot) with the lane as the counter, or read from
// u5. Offsets into the record are 64-bit.
//
// K5 reads a miss lane's attributes from the record, and so every lane's:
// a miss lane's attribute cotangent rows are zeros whose signs follow the
// attributes, and the record kernels store different rows there (K4
// sphere 0's, K11 zeros). A hit lane's row fetched by index, which would
// save 40 bytes, measured slower (a gather of 10 words per lane).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_adjoint.cuh"
#include "philox.cuh"

#define RTW_F_ACT 1
#define RTW_F_HIT 2
#define RTW_F_TERM 4
#define RTW_F_REGEN 8
#define RTW_F_STRIP_SHIFT 4

#define RTW_K5_THREADS 128
#define RTW_K6_THREADS 128

// The radiance cotangent of the lane's current strip (flags' strip field).
__device__ __forceinline__ void rtw_strip_cot(const float* __restrict__ gs,
                                              int flags, size_t n, int i,
                                              float* g) {
  const int sp = flags >> RTW_F_STRIP_SHIFT;
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = gs[(size_t)(3 * sp + j) * n + i];
}

// One reverse iteration of one active lane (flags has RTW_F_ACT).
// r: the record's o3 d3 T3 t; a: the winner's 10 attributes; g: the
// radiance cotangent of the lane's strip; cot: the carry, updated; dep:
// [6S, n] deposit planes, written at a regeneration.
__device__ __forceinline__ void rtw_replay_iter(
    const float* u, const float* r, const float* a, const float* g,
    int flags, float* cot, float* __restrict__ dep, size_t n, int i, int S,
    float* dattr) {
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
  const bool adv = hit && !term;   // state advanced (hit and continued)
  const bool inject = act && !hit;  // banked T * sky(d) this iteration
  rtw_bounce_adjoint(u, r, a, g, cot, adv, inject, dattr);
}

// -- K5 ----------------------------------------------------------------------

// Slots whose words are in flight while one is replayed, and the words a
// live lane stages per slot: o d T t (0-9), the winner's attributes
// (10-19), the strip's radiance cotangent (20-22). Four buffers of 128
// lanes take 46 KB of shared memory.
#define RTW_K5_AHEAD 3
#define RTW_K5_BUFS (RTW_K5_AHEAD + 1)
#define RTW_STAGE 23

// One word copied from device memory into shared memory by the copy
// engine of the SM, without passing through registers.
__device__ __forceinline__ void rtw_cp4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void rtw_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The calling thread's copies are complete (and visible to it) but for
// those of its N newest groups.
template <int N>
__device__ __forceinline__ void rtw_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Issue the copies of a live lane's words of slot `rs` ([21, n]) into its
// column of the stage buffer `st` (plane stride RTW_K5_THREADS).
__device__ __forceinline__ void rtw_stage_slot(float* st, const float* rs,
                                               const float* gs, int flags,
                                               size_t n, int i) {
  constexpr int T = RTW_K5_THREADS;
#pragma unroll
  for (int j = 0; j < 10; ++j) rtw_cp4(st + j * T, rs + j * n + i);
#pragma unroll
  for (int j = 0; j < 10; ++j)
    rtw_cp4(st + (10 + j) * T, rs + (11 + j) * n + i);
  const int sp = flags >> RTW_F_STRIP_SHIFT;
#pragma unroll
  for (int j = 0; j < 3; ++j)
    rtw_cp4(st + (20 + j) * T, gs + (size_t)(3 * sp + j) * n + i);
}

// K5. cot [9, n] and dep [6S, n] are updated in place; rec is
// [n_slots, 21, n]; dattr [n_slots, 9, n] is written; u5 [n_slots, 5, n]
// or NULL.
__global__ void __launch_bounds__(RTW_K5_THREADS) persist_replay_fused_kernel(
    float* __restrict__ cot_io, float* __restrict__ dep,
    const float* __restrict__ rec, const float* __restrict__ gs,
    float* __restrict__ dattr, const float* __restrict__ u5, int n_lanes,
    int S, int n_slots, uint32_t seed, uint32_t i0) {
  __shared__ float stage[RTW_K5_BUFS][RTW_STAGE][RTW_K5_THREADS];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;  // no barrier below: each lane stages its own
  const size_t n = n_lanes;
  const int tx = threadIdx.x;
  auto flags_of = [&](int s) {
    return s < 0 ? 0
                 : __float_as_int(__ldcs(rec + ((size_t)s * 21 + 10) * n + i));
  };
  float cot[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];

  // fl[k]: the flags of slot `slot - k`; the newest RTW_K5_AHEAD slots are
  // staged before the walk, one group each.
  const int top = n_slots - 1;
  int fl[RTW_K5_AHEAD + 1];
#pragma unroll
  for (int k = 0; k <= RTW_K5_AHEAD; ++k) fl[k] = flags_of(top - k);
#pragma unroll
  for (int k = 0; k < RTW_K5_AHEAD; ++k) {
    if (fl[k] & RTW_F_ACT)
      rtw_stage_slot(&stage[k][0][tx], rec + (size_t)(top - k) * 21 * n, gs,
                     fl[k], n, i);
    rtw_cp_commit();
  }

  for (int slot = top, b = 0; slot >= 0; --slot, b = (b + 1) % RTW_K5_BUFS) {
    // Stage slot - RTW_K5_AHEAD while this one is replayed.
    const int ahead = slot - RTW_K5_AHEAD;
    if (fl[RTW_K5_AHEAD] & RTW_F_ACT)
      rtw_stage_slot(&stage[(b + RTW_K5_AHEAD) % RTW_K5_BUFS][0][tx],
                     rec + (size_t)ahead * 21 * n, gs, fl[RTW_K5_AHEAD], n,
                     i);
    rtw_cp_commit();
    const int f_new = flags_of(ahead - 1);
    float* da = dattr + (size_t)slot * 9 * n + i;
    if (!(fl[0] & RTW_F_ACT)) {
#pragma unroll
      for (int j = 0; j < 9; ++j) __stcs(da + j * n, 0.0f);
    } else {
      float u[5];
      if (u5) {
        const float* us = u5 + (size_t)slot * 5 * n;
#pragma unroll
        for (int j = 0; j < 5; ++j) u[j] = us[j * n + i];
      } else {
        rtw_uniforms<5>(seed, i0 + (uint32_t)slot, (uint32_t)i, u);
      }
      rtw_cp_wait<RTW_K5_AHEAD>();  // this slot's group
      const float* st = &stage[b][0][tx];
      constexpr int T = RTW_K5_THREADS;
      float r[10], a[10], g[3], d9[9];
#pragma unroll
      for (int j = 0; j < 10; ++j) r[j] = st[j * T];
#pragma unroll
      for (int j = 0; j < 10; ++j) a[j] = st[(10 + j) * T];
#pragma unroll
      for (int j = 0; j < 3; ++j) g[j] = st[(20 + j) * T];
      rtw_replay_iter(u, r, a, g, fl[0], cot, dep, n, i, S, d9);
#pragma unroll
      for (int j = 0; j < 9; ++j) __stcs(da + j * n, d9[j]);
    }
#pragma unroll
    for (int k = 0; k < RTW_K5_AHEAD; ++k) fl[k] = fl[k + 1];
    fl[RTW_K5_AHEAD] = f_new;
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) cot_io[j * n + i] = cot[j];
}

// -- K6 ----------------------------------------------------------------------

// K6. One slot of the lean record: rec [11, n], idx [n] the slot's
// winners, amat [N, 10]; cot and dep in place; dattr [9, n] written.
__global__ void __launch_bounds__(RTW_K6_THREADS) persist_replay_step_kernel(
    float* __restrict__ cot_io, float* __restrict__ dep,
    const float* __restrict__ rec, const int* __restrict__ idx,
    const float* __restrict__ amat, const float* __restrict__ gs,
    float* __restrict__ dattr, const float* __restrict__ u5, int n_lanes,
    int S, uint32_t seed, uint32_t iteration) {
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
  float cot[9], r[10], a[10], g[3], d9[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];
#pragma unroll
  for (int j = 0; j < 10; ++j) r[j] = rec[j * n + i];
  rtw_fetch_row(idx, amat, i, a);
  rtw_strip_cot(gs, flags, n, i, g);
  rtw_replay_iter(u, r, a, g, flags, cot, dep, n, i, S, d9);
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
  const int threads = RTW_K5_THREADS;
  const int blocks = (n_lanes + threads - 1) / threads;
  persist_replay_fused_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cot, dep, rec, gs, dattr, u5, n_lanes, S, n_slots, seed, i0);
  return (int)cudaGetLastError();
}

extern "C" int rtw_persist_replay_step(float* cot, float* dep,
                                       const float* rec, const int* idx,
                                       const float* amat, const float* gs,
                                       float* dattr, const float* u5,
                                       int n_lanes, int S, unsigned int seed,
                                       unsigned int iteration, void* stream) {
  if (n_lanes <= 0) return 0;
  const int threads = RTW_K6_THREADS;
  const int blocks = (n_lanes + threads - 1) / threads;
  persist_replay_step_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cot, dep, rec, idx, amat, gs, dattr, u5, n_lanes, S, seed, iteration);
  return (int)cudaGetLastError();
}
