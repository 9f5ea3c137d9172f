// K2: one strided persistent iteration (winner fetch, shade, scatter, fold,
// pixel switch, regenerate) for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/shade_kernel.py
// :: _shade_strided_kernel (launched by shade_strided_step), with the math of
// _shade_core (shade_core.cuh) and the helpers _uniforms, _gauss3 and
// _concentric, and the winner fetch that the TPU ran before it in XLA
// (materials.fetch_attr_planes, a one-hot matrix product there).
//
// What it computes, per lane (each lane serves k pixels spaced n_lanes
// apart, one at a time): the winner's 10 attributes from the sweep's index;
// sky on miss; the hit point and facing normal; Lambertian, metal and
// dielectric scatter directions from shared draws with the Schlick coin;
// the continue-or-exhaust decision at max_depth; when a pixel has all its
// samples, the fold of its accumulator into buf[strip] and the switch to
// the lane's next pixel; and a thin-lens camera ray for every lane that
// starts a sample.
//
// What bounds it on the card: launch latency and the lane's dependent
// chain, not bandwidth. A lane reads ~88 bytes (state, t, idx; its 40-byte
// table row comes from L1) and writes ~72, with ~250 flops and four
// transcendental calls; at the flagship width (32 400 lanes) one launch
// moves ~5 MB, under 2 us of HBM time, and fills ~12% of the card's
// resident threads.
//
// Design: one thread per lane; neighbouring threads read neighbouring words
// of each [plane, lane] array, so every load and store is coalesced. The
// winner's row is read from the [N, 10] table through the read-only path
// (19.5 KB for the flagship's 488 spheres, resident in L1 and L2), in place
// of a gather launch that wrote ten planes for the kernel to read back.
// Two other designs gave the same bits and measured slower at the
// flagship's widths (scripts/torch_k2_k4_variants.py builds and times
// them): a copy of the table in each block's shared memory, and a lane's
// Philox blocks, Box-Muller branches and lens disk split over 2, 4 or 8
// threads of a warp and exchanged by shuffles. The state is updated in
// place (the TPU kernel aliased its state planes to its outputs for the
// same reason: no second copy of the state). The TPU had to fold with a
// masked add over all k strip buffers (3k planes read and written per
// lane); here a lane touches only buf[strip], 3 floats, guarded by
// strip < k. Draws are Philox4x32-10 keyed by (seed, iteration) with the
// lane as counter, or, when `u9` is given, read from it, so the plain
// PyTorch version (shade_strided_step_ref) can be fed the same numbers.
// Built with --fmad=false: each expression is evaluated as written, in the
// same order as the plain version.
//
// K2m, the step of a moving scene (book 2's motion blur, Ray Tracing: The
// Next Week §2; no TPU kernel had a time), is the same lane with three
// additions, under `if constexpr (kMoving)` in rtw_shade_strided_lane:
//   - the lane carries its ray's shutter time in a 13th float plane
//     (fs[12]); a scattered ray keeps it;
//   - the table has 13 columns a sphere, attr_mat's 10 and the motion m:
//     the winner's centre is moved to c0 + time * m before shading, so the
//     hit normal is (p - c(t)) / r at the centre that K1m hit;
//   - a lane that starts a sample draws a 10th uniform, the new ray's time:
//     word 1 of the third Philox block, which K2 computes and drops. The
//     other nine uniforms are K2's, stream and counter.
// Each form is its own __global__ function, so each keeps its name in a
// trace; K2's instantiation gives the bits K2 gave before K2m shared it.
//
// The strided loop runs its passes in chunks of 8, each chunk one replay of
// a captured CUDA graph (ops/integrator.py): there K2 reads the call's
// scalars from a parameter block (`params`), so that one capture serves
// every call of its shape, and a chunk ends in rtw_strided_chunk_end, which
// leaves the any-lane-active flag where the host reads it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "shade_core.cuh"

// The graphed loop's parameter block (int32, ops/cuda/shade_kernel.py
// PARAMS_*): the call's Philox seed, first sample and p_end, the iteration
// of the chunk's first pass (advanced at each chunk's end) and iter_limit.
#define RTW_P_SEED 0
#define RTW_P_FIRST_SAMPLE 1
#define RTW_P_END 2
#define RTW_P_BASE 3
#define RTW_P_LIMIT 4

// The lane of K2 (kMoving false) and of K2m (true). u9 holds 9 uniforms a
// lane for K2, 10 for K2m, or is NULL (in-kernel Philox).
template <bool kMoving>
__device__ __forceinline__ void rtw_shade_strided_lane(
    float* __restrict__ fs, int* __restrict__ is, float* __restrict__ buf,
    const float* __restrict__ t_in, const int* __restrict__ idx,
    const float* __restrict__ amat, const float* __restrict__ cam,
    const float* __restrict__ u9, int n, int k, int W, int H, int dpx,
    int dpy, int p_end, int first_sample, int max_depth, uint32_t seed,
    uint32_t iteration, const int* __restrict__ params) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (params) {
    // A pass of the graphed loop's chunk: `iteration` is its place in the
    // chunk, and the call's scalars are read from the parameter block. A
    // pass at or past the loop's end changes nothing.
    iteration += (uint32_t)params[RTW_P_BASE];
    if ((int)iteration >= params[RTW_P_LIMIT]) return;
    seed = (uint32_t)params[RTW_P_SEED];
    first_sample = params[RTW_P_FIRST_SAMPLE];
    p_end = params[RTW_P_END];
  }

  float ox = fs[0 * n + i], oy = fs[1 * n + i], oz = fs[2 * n + i];
  float dx = fs[3 * n + i], dy = fs[4 * n + i], dz = fs[5 * n + i];
  float tx = fs[6 * n + i], ty = fs[7 * n + i], tz = fs[8 * n + i];
  float cx = fs[9 * n + i], cy = fs[10 * n + i], cz = fs[11 * n + i];
  float time = 0.0f;  // the ray's shutter time (K2m)
  if constexpr (kMoving) time = fs[12 * n + i];
  int bo = is[0 * n + i], sa = is[1 * n + i], strip = is[2 * n + i];
  int pxi = is[3 * n + i], pyi = is[4 * n + i];
  bool active = is[5 * n + i] != 0;
  const int lane_lim = is[6 * n + i];

  constexpr int NU = kMoving ? 10 : 9;
  float u[NU];
  if (u9) {
#pragma unroll
    for (int j = 0; j < NU; ++j) u[j] = u9[j * n + i];
  } else {
    rtw_uniforms<NU>(seed, iteration, (uint32_t)i, u);
  }

  const float t = t_in[i];
  float a[10];
  if constexpr (kMoving) {
    // The winner's row, its centre moved to the ray's time.
    const float* row = amat + 13 * (size_t)__ldg(idx + i);
#pragma unroll
    for (int j = 0; j < 10; ++j) a[j] = __ldg(row + j);
    a[0] = a[0] + time * __ldg(row + 10);
    a[1] = a[1] + time * __ldg(row + 11);
    a[2] = a[2] + time * __ldg(row + 12);
  } else {
    rtw_fetch_row(idx, amat, i, a);
  }

  const RtwShade s = rtw_shade_core(u, t, a, ox, oy, oz, dx, dy, dz, tx, ty,
                                    tz, active, cx, cy, cz);

  // Continue bouncing (the scattered ray keeps the time).
  const int newb = bo + 1;
  const bool cont = s.hitm && (newb < max_depth);
  if (cont) {
    ox = s.px; oy = s.py; oz = s.pz;
    dx = s.ndx; dy = s.ndy; dz = s.ndz;
    tx = tx * a[4]; ty = ty * a[5]; tz = tz * a[6];
    bo = newb;
  }

  // Ray finished: next sample of this pixel, or fold and switch pixels.
  const bool need = s.miss || (s.hitm && !cont);
  const int nxt = sa + 1;
  const bool same_pix = need && (nxt <= lane_lim);
  const bool done_pix = need && !same_pix;
  if (done_pix) {
    if (strip < k) {
      float* b = buf + (size_t)(3 * strip) * n + i;
      b[0] = b[0] + cx;
      b[n] = b[n] + cy;
      b[2 * n] = b[2 * n] + cz;
    }
    cx = 0.0f; cy = 0.0f; cz = 0.0f;
  }

  // Advance pixel coordinates by n_lanes (dpx, dpy precomputed; one carry).
  int npx = pxi + dpx;
  const int carry = npx >= W ? 1 : 0;
  npx = npx - W * carry;
  const int npy = pyi + dpy + carry;
  const int new_strip = strip + 1;
  if (done_pix) {
    pxi = npx; pyi = npy; strip = new_strip;
  }
  sa = done_pix ? first_sample : (same_pix ? nxt : sa);
  const bool valid_new = (npy * W + npx) < p_end;
  const bool start = same_pix || (done_pix && (new_strip < k) && valid_new);

  if (start) {
    // The thin-lens camera ray of the lane's pixel, built as
    // init_strided_state builds a strip-0 ray: the film point by division.
    float da, db;
    rtw_lens_disk(u[7], u[8], da, db);
    rtw_camera_ray(cam, (float)(pxi + 1) / (float)W,
                   (float)(H - 1 - pyi) / (float)H, sa == 0, u[5], u[6], da,
                   db, ox, oy, oz, dx, dy, dz);
    tx = 1.0f; ty = 1.0f; tz = 1.0f;
    bo = 0;
    if constexpr (kMoving) time = u[9];  // the new ray's shutter time
  }
  active = (active && !need) || start;

  fs[0 * n + i] = ox; fs[1 * n + i] = oy; fs[2 * n + i] = oz;
  fs[3 * n + i] = dx; fs[4 * n + i] = dy; fs[5 * n + i] = dz;
  fs[6 * n + i] = tx; fs[7 * n + i] = ty; fs[8 * n + i] = tz;
  fs[9 * n + i] = cx; fs[10 * n + i] = cy; fs[11 * n + i] = cz;
  if constexpr (kMoving) fs[12 * n + i] = time;
  is[0 * n + i] = bo; is[1 * n + i] = sa; is[2 * n + i] = strip;
  is[3 * n + i] = pxi; is[4 * n + i] = pyi; is[5 * n + i] = active ? 1 : 0;
}

__global__ void shade_strided_kernel(
    float* __restrict__ fs, int* __restrict__ is, float* __restrict__ buf,
    const float* __restrict__ t_in, const int* __restrict__ idx,
    const float* __restrict__ amat, const float* __restrict__ cam,
    const float* __restrict__ u9, int n, int k, int W, int H, int dpx,
    int dpy, int p_end, int first_sample, int max_depth, uint32_t seed,
    uint32_t iteration, const int* __restrict__ params) {
  rtw_shade_strided_lane<false>(fs, is, buf, t_in, idx, amat, cam, u9, n, k,
                                W, H, dpx, dpy, p_end, first_sample,
                                max_depth, seed, iteration, params);
}

__global__ void shade_strided_motion_kernel(
    float* __restrict__ fs, int* __restrict__ is, float* __restrict__ buf,
    const float* __restrict__ t_in, const int* __restrict__ idx,
    const float* __restrict__ amat, const float* __restrict__ cam,
    const float* __restrict__ u10, int n, int k, int W, int H, int dpx,
    int dpy, int p_end, int first_sample, int max_depth, uint32_t seed,
    uint32_t iteration, const int* __restrict__ params) {
  rtw_shade_strided_lane<true>(fs, is, buf, t_in, idx, amat, cam, u10, n, k,
                               W, H, dpx, dpy, p_end, first_sample,
                               max_depth, seed, iteration, params);
}

// The one launch of K2, or of K2m where `moving`. params: NULL (every
// scalar from the arguments), or the graphed loop's parameter block.
static int rtw_launch_shade_strided(bool moving, float* fstate, int* istate,
                                    float* buf, const float* t,
                                    const int* idx, const float* amat,
                                    const float* cam, const float* u9, int n,
                                    int k, int W, int H, int dpx, int dpy,
                                    int p_end, int first_sample,
                                    int max_depth, unsigned int seed,
                                    unsigned int iteration,
                                    const int* params, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  if (moving) {
    shade_strided_motion_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        fstate, istate, buf, t, idx, amat, cam, u9, n, k, W, H, dpx, dpy,
        p_end, first_sample, max_depth, seed, iteration, params);
  } else {
    shade_strided_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        fstate, istate, buf, t, idx, amat, cam, u9, n, k, W, H, dpx, dpy,
        p_end, first_sample, max_depth, seed, iteration, params);
  }
  return (int)cudaGetLastError();
}

// fstate [12, n] f32 and istate [7, n] i32 are updated in place; buf [3k, n]
// f32 is accumulated in place. idx [n] i32: the sweep's winners, rows of
// amat [N, 10] f32. u9 [9, n] f32 may be NULL (in-kernel Philox).
extern "C" int rtw_shade_strided(float* fstate, int* istate, float* buf,
                                 const float* t, const int* idx,
                                 const float* amat, const float* cam,
                                 const float* u9, int n,
                                 int k, int W, int H, int dpx, int dpy,
                                 int p_end, int first_sample, int max_depth,
                                 unsigned int seed, unsigned int iteration,
                                 void* stream) {
  return rtw_launch_shade_strided(false, fstate, istate, buf, t, idx, amat,
                                  cam, u9, n, k, W, H, dpx, dpy, p_end,
                                  first_sample, max_depth, seed, iteration,
                                  nullptr, stream);
}

// K2 as pass `pass` of a graphed chunk: the state as rtw_shade_strided's,
// in-kernel Philox, and seed, first sample, p_end and the iteration
// (params[RTW_P_BASE] + pass) read from params [5] i32 when it runs.
extern "C" int rtw_shade_strided_pass(float* fstate, int* istate, float* buf,
                                      const float* t, const int* idx,
                                      const float* amat, const float* cam,
                                      const int* params, int n, int k, int W,
                                      int H, int dpx, int dpy, int max_depth,
                                      unsigned int pass, void* stream) {
  return rtw_launch_shade_strided(false, fstate, istate, buf, t, idx, amat,
                                  cam, nullptr, n, k, W, H, dpx, dpy, 0, 0,
                                  max_depth, 0u, pass, params, stream);
}

// K2m, arguments as rtw_shade_strided's: fstate [13, n] f32 (K2's 12
// planes, then the time); amat [N, 13] f32 (attr_mat's 10 columns, then the
// motion); u10 [10, n] f32 or NULL.
extern "C" int rtw_shade_strided_motion(
    float* fstate, int* istate, float* buf, const float* t, const int* idx,
    const float* amat, const float* cam, const float* u10, int n, int k,
    int W, int H, int dpx, int dpy, int p_end, int first_sample,
    int max_depth, unsigned int seed, unsigned int iteration, void* stream) {
  return rtw_launch_shade_strided(true, fstate, istate, buf, t, idx, amat,
                                  cam, u10, n, k, W, H, dpx, dpy, p_end,
                                  first_sample, max_depth, seed, iteration,
                                  nullptr, stream);
}

// K2m as pass `pass` of a graphed chunk, as rtw_shade_strided_pass.
extern "C" int rtw_shade_strided_motion_pass(
    float* fstate, int* istate, float* buf, const float* t, const int* idx,
    const float* amat, const float* cam, const int* params, int n, int k,
    int W, int H, int dpx, int dpy, int max_depth, unsigned int pass,
    void* stream) {
  return rtw_launch_shade_strided(true, fstate, istate, buf, t, idx, amat,
                                  cam, nullptr, n, k, W, H, dpx, dpy, 0, 0,
                                  max_depth, 0u, pass, params, stream);
}

// The end of a graphed chunk of `passes` passes, chunk c = params[BASE] /
// passes: flags[c & 1] = c + 1 where any lane is still active (each block
// that holds one writes it; the slot keeps chunk c - 2's c - 1 otherwise,
// or the zeros a call starts from), then params[BASE] += passes, in a
// second kernel, once every block has read it.
__global__ void strided_chunk_flag_kernel(const int* __restrict__ active,
                                          int n,
                                          const int* __restrict__ params,
                                          int passes, int* __restrict__ flags) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (__syncthreads_or(i < n && active[i] != 0) && threadIdx.x == 0) {
    const int c = params[RTW_P_BASE] / passes;
    flags[c & 1] = c + 1;
  }
}

__global__ void strided_chunk_advance_kernel(int* params, int passes) {
  params[RTW_P_BASE] += passes;
}

// active: istate's active plane [n] i32; params [5] i32; flags [2] i32 on
// the card; host_flags [2] i32 in pinned host memory, which gets a copy of
// flags. Three operations on `stream`, all of which a graph can capture.
extern "C" int rtw_strided_chunk_end(const int* active, int n, int* params,
                                     int passes, int* flags, int* host_flags,
                                     void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n > 0)
    strided_chunk_flag_kernel<<<(n + 255) / 256, 256, 0, s>>>(
        active, n, params, passes, flags);
  strided_chunk_advance_kernel<<<1, 1, 0, s>>>(params, passes);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyAsync(host_flags, flags, 2 * sizeof(int),
                              cudaMemcpyDeviceToHost, s);
}
