// K9: one pixel-pinned persistent iteration (shade, scatter, continue or
// regenerate the same pixel's next sample) for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/shade_kernel.py
// :: _shade_kernel (launched by shade_and_regen), with the math of
// _shade_math: the shading core (shade_core.cuh), then the continue /
// exhaust / regenerate bookkeeping and the thin-lens camera ray of the
// lane's own pixel, from its film coordinates (u, v).
//
// What it computes, per lane (one lane per pixel, pinned): sky on a miss;
// the hit point, facing normal and the three materials' scatter directions;
// a continuing ray takes the scatter (origin and direction blended by the
// 0/1 continue flag, as the TPU kernel writes them) and T *= albedo; a ray
// that missed or reached max_depth starts the pixel's next sample when one
// is left (jittered film point, thin-lens origin; a sample id of 0 would be
// centred), and the lane goes idle after its last sample.
//
// What bounds it on the card: memory traffic. A lane reads its 15 state
// words, t, 10 attributes and 2 film coordinates (112 bytes) and writes the
// 15 state words (60 bytes), with ~250 flops of live-lane work; at the
// flagship film (2 073 600 lanes) one launch moves ~357 MB, ~0.11 ms of HBM
// time, more than the arithmetic's ~0.008 ms.
//
// Design: one thread per lane, every [plane, lane] array read and written
// coalesced, the state updated in place (the TPU kernel aliased its 15 state
// inputs to its outputs for the same reason). Draws: 9 uniforms per lane and
// iteration, Philox4x32-10 keyed by (seed, iteration) with the lane as the
// counter, as K2's, or read from `u9` when it is given, so the plain PyTorch
// version (shade_kernel.py::shade_and_regen_ref) can be fed the same
// numbers. Built with --fmad=false: each expression is evaluated as written,
// in the plain version's order. The body is pinned_core.cuh's, shared with
// the megakernel (mega.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "pinned_core.cuh"

__global__ void shade_pinned_kernel(
    float* __restrict__ fs, int* __restrict__ is,
    const float* __restrict__ t_in, const float* __restrict__ attrs,
    const float* __restrict__ fu, const float* __restrict__ fv,
    const float* __restrict__ cam, const float* __restrict__ u9, int n,
    int last_sample, int max_depth, uint32_t seed, uint32_t iteration) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float u[9];
  if (u9) {
#pragma unroll
    for (int j = 0; j < 9; ++j) u[j] = u9[j * n + i];
  } else {
    rtw_uniforms<9>(seed, iteration, (uint32_t)i, u);
  }
  float a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = attrs[j * n + i];
  rtw_pinned_step(i, n, fs, is, t_in[i], a, u, fu[i], fv[i], cam, last_sample,
                  max_depth);
}

// fstate [12, n] f32 and istate [3, n] i32 are updated in place; t [n],
// attrs [10, n], film u [n], v [n], cam [21]; u9 [9, n] f32 may be NULL
// (in-kernel Philox).
extern "C" int rtw_shade_pinned(float* fstate, int* istate, const float* t,
                                const float* attrs, const float* fu,
                                const float* fv, const float* cam,
                                const float* u9, int n, int last_sample,
                                int max_depth, unsigned int seed,
                                unsigned int iteration, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  shade_pinned_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      fstate, istate, t, attrs, fu, fv, cam, u9, n, last_sample, max_depth,
      seed, iteration);
  return (int)cudaGetLastError();
}
