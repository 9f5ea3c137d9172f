// K9: one pixel-pinned persistent iteration (winner fetch, shade, scatter,
// continue or regenerate the same pixel's next sample) for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/shade_kernel.py
// :: _shade_kernel (launched by shade_and_regen), with the math of
// _shade_math: the shading core (shade_core.cuh), then the continue /
// exhaust / regenerate bookkeeping and the thin-lens camera ray of the
// lane's own pixel, from its film coordinates (u, v); and the winner fetch
// that the TPU ran before it in XLA (materials.fetch_attr_planes).
//
// What it computes, per lane (one lane per pixel, pinned): sky on a miss;
// the hit point, facing normal and the three materials' scatter directions;
// a continuing ray takes the scatter (origin and direction blended by the
// 0/1 continue flag, as the TPU kernel writes them) and T *= albedo; a ray
// that missed or reached max_depth starts the pixel's next sample when one
// is left (jittered film point, thin-lens origin; a sample id of 0 would be
// centred), and the lane goes idle after its last sample.
//
// What bounds it on the card: memory traffic on the active lanes. An active
// lane reads its 15 state words, t, the winner's index, its film
// coordinates and the winner's 40-byte row, and writes the 15 state words
// (176 bytes, ~250 flops); an idle lane only has its flag read. The
// pinned film's active share falls from every lane at the first iterations
// to a tail of a few percent (9.2% at iteration 24 of the flagship film).
//
// Design (shade_pinned_fetch_kernel, the pinned route's K9):
//   - The step leaves an idle lane's 15 state words as they are (its 0/1
//     blends give back each word: tests/test_torch_mega_compact.py counts
//     the idle lanes a step changes over whole renders, and finds none), so
//     an idle lane reads nothing past its flag, draws nothing and writes
//     nothing.
//   - Compact, as the megakernel K12 does: each block takes 128 lanes and
//     packs the ids of its active ones in lane order (__ballot_sync, __popc
//     and a warp scan of the 4 per-warp counts); thread j shades packed
//     lane ids[j], so the active lanes fill a block's first warps, and a
//     block with none returns at once.
//   - The winner's row is read by index from the [N, 10] table through the
//     read-only path (19.5 KB for the flagship's 488 spheres, resident in
//     L1 and L2), in place of a gather launch that wrote ten [R] planes for
//     the kernel to read back. On a miss the sweep's index is 0 and the
//     lane reads sphere 0's row, as the gather does; no hit-gated
//     expression of the body uses it.
//   A plain early exit per thread (one thread per lane, an idle lane
//   returning after its flag) gives the same bits;
//   scripts/torch_k9_k13_variants.py builds and times both (PERF.md).
// Draws: 9 uniforms per lane and iteration, Philox4x32-10 keyed by (seed,
// iteration) with the lane as the counter, as K2's, or read from `u9` when
// it is given, so the plain PyTorch version
// (shade_kernel.py::shade_and_regen_fetch_ref) can be fed the same numbers.
// Built with --fmad=false: each expression is evaluated as written, in the
// plain version's order. The body is pinned_core.cuh's, shared with the
// megakernel (mega.cu).
//
// shade_pinned_kernel is the kernel before the redesign, kept on no route
// as the bitwise reference of the new one on the card (the megakernel's
// checks also hold K12 against it): one thread per lane over every lane,
// the winner's attributes from ten gathered [R] planes.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "pinned_core.cuh"

#define RTW_PINNED_THREADS 128

__global__ void __launch_bounds__(RTW_PINNED_THREADS)
    shade_pinned_fetch_kernel(
        float* __restrict__ fs, int* __restrict__ is,
        const float* __restrict__ t_in, const int* __restrict__ idx,
        const float* __restrict__ amat, const float* __restrict__ fu,
        const float* __restrict__ fv, const float* __restrict__ cam,
        const float* __restrict__ u9, int n, int last_sample, int max_depth,
        uint32_t seed, uint32_t iteration) {
  constexpr int NW = RTW_PINNED_THREADS / 32;
  __shared__ int ids[RTW_PINNED_THREADS];
  __shared__ int base[NW + 1];  // per-warp offsets; base[NW] = total
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // Each warp counts its active lanes.
  const int i0 = blockIdx.x * RTW_PINNED_THREADS + threadIdx.x;
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
  if (n_act == 0) return;  // an idle block: no state traffic at all

  // Pack the active lane ids in lane order; shade them, one thread each.
  if (act) ids[base[warp] + __popc(m & ((1u << lane) - 1u))] = i0;
  __syncthreads();
  if (threadIdx.x >= n_act) return;
  const int i = ids[threadIdx.x];
  const float* row = amat + 10 * (size_t)idx[i];
  float a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = __ldg(row + j);

  float u[9];
  if (u9) {
#pragma unroll
    for (int j = 0; j < 9; ++j) u[j] = u9[j * n + i];
  } else {
    rtw_uniforms<9>(seed, iteration, (uint32_t)i, u);
  }
  rtw_pinned_step(i, n, fs, is, t_in[i], a, u, fu[i], fv[i], cam, last_sample,
                  max_depth);
}

// fstate [12, n] f32 and istate [3, n] i32 are updated in place; t [n],
// idx [n] i32 (the sweep's winners, 0 on a miss), amat [N, 10], film u [n],
// v [n], cam [21]; u9 [9, n] f32 may be NULL (in-kernel Philox).
extern "C" int rtw_shade_pinned_fetch(float* fstate, int* istate,
                                      const float* t, const int* idx,
                                      const float* amat, const float* fu,
                                      const float* fv, const float* cam,
                                      const float* u9, int n, int last_sample,
                                      int max_depth, unsigned int seed,
                                      unsigned int iteration, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + RTW_PINNED_THREADS - 1) / RTW_PINNED_THREADS;
  shade_pinned_fetch_kernel<<<blocks, RTW_PINNED_THREADS, 0,
                              (cudaStream_t)stream>>>(
      fstate, istate, t, idx, amat, fu, fv, cam, u9, n, last_sample,
      max_depth, seed, iteration);
  return (int)cudaGetLastError();
}

// -- the kernel before the redesign, kept as the reference ------------------

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
