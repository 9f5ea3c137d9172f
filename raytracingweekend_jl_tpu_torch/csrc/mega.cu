// K12: the megakernel — one whole pixel-pinned persistent iteration (sweep,
// winner attributes, shade, scatter, continue or regenerate) in one launch,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel
// raytracingweekend_jl_tpu/ops/pallas/experimental/mega_kernel.py ::
// _mega_kernel (launched by mega_step). The plain PyTorch version is
// raytracingweekend_jl_tpu_torch/ops/cuda/mega_kernel.py :: mega_step_ref.
//
// What it computes, per lane (one lane pinned to each pixel): K1's
// closest hit over the sphere table, the winner's 10 attributes (zeros on a
// miss, the TPU kernel's running-select start), then K9's body
// (pinned_core.cuh): shade, bank the sky on a miss, continue with the
// scatter or start the pixel's next sample. The pinned route (K1, then K9
// reading the winner's row by index) and the previous three-launch route
// (K1, the gather, the previous K9) compute the same function; on a miss
// they read sphere 0's row, which no hit-gated expression of the body
// uses, so the routes give the same bits.
//
// What bounds it on the card: arithmetic on the active lanes, as K1: ~20
// flops per active lane and sphere, against 128 bytes of state traffic per
// active lane and a flag read per idle one.
//
// Design: the step leaves an idle lane's 15 state words as they are (its
// 0/1 blends give back each word: tests/test_torch_mega_compact.py counts
// the idle lanes a step changes over whole renders, and finds none), so the
// kernel sweeps and shades only the active lanes, which fall from every lane
// at the first iteration to a tail of a few percent:
//   - Compact. Each block takes 128 lanes and packs the ids of its active
//     ones in lane order (__ballot_sync, __popc and a warp scan of the 4
//     per-warp counts, as K3). A block with none returns at once: no table
//     staging, no state read or written.
//   - Sweep. Only the sphere table is staged (7.8 KB at 488 spheres). A
//     group of P threads of a warp sweeps each packed lane (rtw_sweep_part,
//     the roots behind `disc > 0`, then rtw_merge_closest), with P chosen
//     per block as K3 chooses it: the largest P <= min(p_cap, 16) with
//     n_active * P <= 4 * 128 (p_cap: the most parts the table fills).
//     The group's first thread keeps (t, idx) in shared memory at the
//     lane's packed position.
//   - Shade. Thread j < n_active shades packed lane ids[j]: the winner's
//     row by index from the [N, 10] table through the read-only path (zeros
//     on a miss), the draws with the lane id as the Philox counter, and
//     rtw_pinned_step. Every thread of a block shades, not one in P, and the
//     active lanes of a block fill its first warps.
//   - 128-lane blocks, at least 12 resident per SM (40 registers, 100
//     bytes spilled to L1): 1-6% less time an iteration and 3% less per
//     render than the 64 registers the code takes without a cap (8 blocks
//     per SM), 5% less per render than 256-lane blocks
//     (scripts/torch_k10_k12_variants.py, PERF.md).
// The ballot, the merge's shuffles and the barriers are reached by every
// thread of the block: the sweep's round count is block-uniform, and a
// thread with no lane joins the merge holding (BIG, 0).
// Draws: 9 uniforms per lane and iteration, Philox4x32-10 keyed by (seed,
// iteration) with the lane as the counter, exactly K9's, or read from `u9`.
// Built with --fmad=false, as K1 and K9.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "pinned_core.cuh"
#include "sweep_core.cuh"

#define RTW_MEGA_THREADS 128
#define RTW_MEGA_MIN_BLOCKS 12

__global__ void __launch_bounds__(RTW_MEGA_THREADS, RTW_MEGA_MIN_BLOCKS)
    mega_kernel(float* __restrict__ fs, int* __restrict__ is,
                const float4* __restrict__ spheres,
                const float* __restrict__ amat, int n_spheres, float tmin,
                const float* __restrict__ fu, const float* __restrict__ fv,
                const float* __restrict__ cam, const float* __restrict__ u9,
                int n, int last_sample, int max_depth, uint32_t seed,
                uint32_t iteration, int p_cap) {
  constexpr int NW = RTW_MEGA_THREADS / 32;
  extern __shared__ float4 sph[];
  __shared__ int ids[RTW_MEGA_THREADS];
  __shared__ float win_t[RTW_MEGA_THREADS];
  __shared__ int win_i[RTW_MEGA_THREADS];
  __shared__ int base[NW + 1];  // per-warp offsets; base[NW] = total
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // Each warp counts its active lanes.
  const int i0 = blockIdx.x * RTW_MEGA_THREADS + threadIdx.x;
  const bool act = i0 < n && is[2 * n + i0] != 0;
  const unsigned m = __ballot_sync(0xffffffffu, act);
  if (lane == 0) base[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the NW per-warp counts
    const int v = lane < NW ? base[lane] : 0;
    int incl = v;
    for (int off = 1; off < NW; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    if (lane < NW) base[lane] = incl - v;
    if (lane == NW - 1) base[NW] = incl;
  }
  __syncthreads();
  const int n_act = base[NW];
  if (n_act == 0) return;  // an idle block: no staging, no state traffic

  // Pack the active lane ids in lane order, and stage the sphere table.
  if (act) ids[base[warp] + __popc(m & ((1u << lane) - 1u))] = i0;
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) sph[s] = spheres[s];
  __syncthreads();

  // Sweep the packed lanes, P threads each, in block-uniform rounds.
  int P = p_cap < 16 ? p_cap : 16;
  while (P > 1 && n_act * P > 4 * RTW_MEGA_THREADS) P >>= 1;
  const int log2p = __ffs(P) - 1;
  const int per_round = RTW_MEGA_THREADS >> log2p;
  const int p = threadIdx.x & (P - 1);
  for (int r0 = 0; r0 < n_act; r0 += per_round) {
    const int j = r0 + (threadIdx.x >> log2p);
    float best_t = RTW_BIG;
    int best_i = 0;
    if (j < n_act) {
      const int i = ids[j];
      rtw_sweep_part(sph, n_spheres, p, P, fs[0 * n + i], fs[1 * n + i],
                     fs[2 * n + i], fs[3 * n + i], fs[4 * n + i],
                     fs[5 * n + i], tmin, best_t, best_i);
    }
    rtw_merge_closest(best_t, best_i, P);  // every lane of the warp
    if (j < n_act && p == 0) {
      win_t[j] = best_t;
      win_i[j] = best_i;
    }
  }
  __syncthreads();

  // Shade the packed lanes, one thread each.
  if (threadIdx.x >= n_act) return;
  const int i = ids[threadIdx.x];
  const float t = win_t[threadIdx.x];
  const bool hit = t < RTW_BIG;
  const float* row = amat + 10 * (size_t)win_i[threadIdx.x];
  float a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = hit ? __ldg(row + j) : 0.0f;

  float u[9];
  if (u9) {
#pragma unroll
    for (int j = 0; j < 9; ++j) u[j] = u9[j * n + i];
  } else {
    rtw_uniforms<9>(seed, iteration, (uint32_t)i, u);
  }
  rtw_pinned_step(i, n, fs, is, t, a, u, fu[i], fv[i], cam, last_sample,
                  max_depth);
}

// fstate [12, n] f32 and istate [3, n] i32 are updated in place; spheres
// [N, 4] f32 (cx, cy, cz, ck), amat [N, 10] f32; film u [n], v [n], cam
// [21]; u9 [9, n] f32 may be NULL (in-kernel Philox).
extern "C" int rtw_mega(float* fstate, int* istate, const float* spheres,
                        const float* amat, int n_spheres, float tmin,
                        const float* fu, const float* fv, const float* cam,
                        const float* u9, int n, int last_sample, int max_depth,
                        unsigned int seed, unsigned int iteration,
                        void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + RTW_MEGA_THREADS - 1) / RTW_MEGA_THREADS;
  const size_t smem = (size_t)n_spheres * sizeof(float4);
  cudaError_t e = rtw_reserve_smem((const void*)mega_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  mega_kernel<<<blocks, RTW_MEGA_THREADS, smem, (cudaStream_t)stream>>>(
      fstate, istate, reinterpret_cast<const float4*>(spheres), amat,
      n_spheres, tmin, fu, fv, cam, u9, n, last_sample, max_depth, seed,
      iteration, rtw_parts_cap(n_spheres));
  return (int)cudaGetLastError();
}

// K12's registers per thread, the blocks of it that one SM holds at its
// block size and shared memory for `n_spheres`, and the device's SM count.
extern "C" int rtw_mega_occupancy(int n_spheres, int* regs,
                                  int* blocks_per_sm, int* sm_count) {
  const size_t smem = (size_t)n_spheres * sizeof(float4);
  cudaFuncAttributes a = {};
  cudaError_t e = cudaFuncGetAttributes(&a, mega_kernel);
  if (e == cudaSuccess) e = rtw_reserve_smem((const void*)mega_kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, mega_kernel, RTW_MEGA_THREADS, smem);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  *regs = a.numRegs;
  return (int)e;
}
