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
// closest-hit loop (sweep_core.cuh) over the sphere table, the winner's 10
// attributes (zeros on a miss, the TPU kernel's running-select start), then
// K9's body (pinned_core.cuh): shade, bank the sky on a miss, continue with
// the scatter or start the pixel's next sample. The three-launch pinned
// route (K1, the gather, K9) computes the same function; on a miss its
// gather reads sphere 0's row, which no hit-gated expression of the body
// uses, so the two routes give the same bits.
//
// What bounds it on the card: arithmetic, as K1: ~20 flops per lane and
// sphere, against K9's 172 bytes of state traffic per lane less the t and
// attribute words that no longer go through device memory.
//
// Design: one thread per lane. The sphere table (float4 rows) and the
// attribute table (10 floats per sphere) are staged once per block into
// shared memory (27 KB for the flagship's 488 spheres); the sweep loop reads
// one broadcast float4 per sphere, and after it each thread reads its
// winner's row: no running selects in the loop (the TPU's VPU had no gather
// and carried ten). The state is read and written in place, coalesced.
// Draws: 9 uniforms per lane and iteration, Philox4x32-10 keyed by (seed,
// iteration) with the lane as the counter, exactly K9's, or read from `u9`.
// Built with --fmad=false, as K1 and K9.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "pinned_core.cuh"
#include "sweep_core.cuh"

__global__ void mega_kernel(float* __restrict__ fs, int* __restrict__ is,
                            const float4* __restrict__ spheres,
                            const float* __restrict__ amat, int n_spheres,
                            float tmin, const float* __restrict__ fu,
                            const float* __restrict__ fv,
                            const float* __restrict__ cam,
                            const float* __restrict__ u9, int n,
                            int last_sample, int max_depth, uint32_t seed,
                            uint32_t iteration) {
  extern __shared__ float4 sph[];
  float* sattr = reinterpret_cast<float*>(sph + n_spheres);
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) sph[s] = spheres[s];
  for (int j = threadIdx.x; j < 10 * n_spheres; j += blockDim.x)
    sattr[j] = amat[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float best_t;
  int best_i;
  rtw_sweep_closest(sph, n_spheres, fs[0 * n + i], fs[1 * n + i],
                    fs[2 * n + i], fs[3 * n + i], fs[4 * n + i],
                    fs[5 * n + i], tmin, best_t, best_i);
  const bool hit = best_t < RTW_BIG;
  const float* row = sattr + 10 * best_i;
  float a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = hit ? row[j] : 0.0f;

  float u[9];
  if (u9) {
#pragma unroll
    for (int j = 0; j < 9; ++j) u[j] = u9[j * n + i];
  } else {
    rtw_uniforms<9>(seed, iteration, (uint32_t)i, u);
  }
  rtw_pinned_step(i, n, fs, is, best_t, a, u, fu[i], fv[i], cam, last_sample,
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
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)n_spheres * (sizeof(float4) + 10 * sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        mega_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  mega_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      fstate, istate, reinterpret_cast<const float4*>(spheres), amat,
      n_spheres, tmin, fu, fv, cam, u9, n, last_sample, max_depth, seed,
      iteration);
  return (int)cudaGetLastError();
}
