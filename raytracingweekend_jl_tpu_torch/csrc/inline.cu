// K8: the whole small-image render in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/inline_kernel.py
// :: _inline_kernel (launched by trace_inline), with its sweep
// _sweep_select. The plain PyTorch version is
// raytracingweekend_jl_tpu_torch/ops/cuda/inline_kernel.py ::
// trace_inline_ref.
//
// What it computes, per (pixel, sample) lane: the radiance of one camera
// ray over `max_depth` bounces. Each bounce sweeps every sphere with the
// half-b quadratic and K1's tmin rule (csrc/sweep.cu), keeping a running
// select of the winner's distance and 10 attributes, then shades it
// (shade_core.cuh: a miss banks T * sky(d), a hit scatters) and advances a
// hit. A lane that missed is done; a path still alive after the last bounce
// reads black (the reference's depth budget).
//
// What bounds it on the card: arithmetic. A live lane does ~20 flops per
// sphere per bounce in the sweep and ~150 in the shade; it reads 24 bytes
// and writes 12. At the inverse demo's 179 200 lanes over 8 spheres and 16
// bounces the work is a few hundred MFLOP, microseconds at the card's
// float32 rate, and the render is one launch instead of the strided
// integrator's three per iteration.
//
// Design: one thread per lane; the whole bounce loop runs in the kernel with
// the lane's state in registers. The sphere table is staged once per block
// into shared memory as 11 planes (cx, cy, cz, ck, r, albedo rgb, fuzz, ir,
// mat), as the TPU kernel held it in SMEM scalars; a warp reads each sphere
// as a broadcast. The sweep's arithmetic is K1's expression for
// expression on the same (cx, cy, cz, ck) values, so a hit gets K1's bits.
// The TPU kernel kept sweeping dead lanes to the end of its fixed-trip loop;
// here a lane leaves the loop once it is dead, which changes nothing it
// outputs. Draws: 5 uniforms per bounce, Philox4x32-10 keyed by (seed,
// bounce) with the lane as the counter, or read from u5 [depth, 5, R].

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "shade_core.cuh"

#define RTW_INLINE_PLANES 11

__global__ void inline_kernel(const float* __restrict__ rays,
                              const float* __restrict__ spheres,
                              float* __restrict__ rad_out,
                              const float* __restrict__ u5, int n_lanes,
                              int n_spheres, int max_depth, float tmin,
                              uint32_t seed) {
  extern __shared__ float sph[];  // [11, n_spheres]
  for (int k = threadIdx.x; k < RTW_INLINE_PLANES * n_spheres;
       k += blockDim.x)
    sph[k] = spheres[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  const float* scx = sph;
  const float* scy = sph + n_spheres;
  const float* scz = sph + 2 * n_spheres;
  const float* sck = sph + 3 * n_spheres;
  const float* sattr = sph + 4 * n_spheres;  // r, ar, ag, ab, fz, ir, mt

  float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  float dx = rays[3 * n + i], dy = rays[4 * n + i], dz = rays[5 * n + i];
  float tx = 1.0f, ty = 1.0f, tz = 1.0f;
  float rx = 0.0f, ry = 0.0f, rz = 0.0f;

  for (int b = 0; b < max_depth; ++b) {
    // Closest hit with a running select of the winner's attributes.
    const float od = ox * dx + oy * dy + oz * dz;
    const float oo = ox * ox + oy * oy + oz * oz;
    float bt = RTW_BIG;
    float a[10] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f,
                   0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < n_spheres; ++s) {
      const float cx = scx[s], cy = scy[s], cz = scz[s];
      const float cd = cx * dx + cy * dy + cz * dz;
      const float oc = cx * ox + cy * oy + cz * oz;
      const float hb = od - cd;
      const float c = oo - 2.0f * oc + sck[s];
      const float disc = hb * hb - c;
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float r1 = -hb - sq;
      const float t = r1 >= tmin ? r1 : -hb + sq;
      if (disc > 0.0f && t >= tmin && t < bt) {
        bt = t;
        a[0] = cx;
        a[1] = cy;
        a[2] = cz;
#pragma unroll
        for (int j = 0; j < 7; ++j) a[3 + j] = sattr[j * n_spheres + s];
      }
    }

    float u[5];
    if (u5) {
      const float* us = u5 + (size_t)b * 5 * n;
#pragma unroll
      for (int j = 0; j < 5; ++j) u[j] = us[j * n + i];
    } else {
      rtw_uniforms<5>(seed, (uint32_t)b, (uint32_t)i, u);
    }
    const RtwShade sh = rtw_shade_core(u, bt, a, ox, oy, oz, dx, dy, dz, tx,
                                       ty, tz, true, rx, ry, rz);
    if (!sh.hitm) break;  // banked the sky: nothing more changes
    ox = sh.px; oy = sh.py; oz = sh.pz;
    dx = sh.ndx; dy = sh.ndy; dz = sh.ndz;
    tx = tx * a[4]; ty = ty * a[5]; tz = tz * a[6];
  }
  rad_out[i] = rx;
  rad_out[n + i] = ry;
  rad_out[2 * n + i] = rz;
}

// rays [6, R] f32 (o xyz, d xyz); spheres [11, N] f32 planes (cx, cy, cz,
// ck, r, albedo rgb, fuzz, ir, mat); rad [3, R] f32 written; u5
// [max_depth, 5, R] f32 or NULL (in-kernel Philox).
extern "C" int rtw_inline(const float* rays, const float* spheres, float* rad,
                          const float* u5, int n_lanes, int n_spheres,
                          int max_depth, float tmin, unsigned int seed,
                          void* stream) {
  if (n_lanes <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  const size_t smem = (size_t)RTW_INLINE_PLANES * n_spheres * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        inline_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  inline_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      rays, spheres, rad, u5, n_lanes, n_spheres, max_depth, tmin, seed);
  return (int)cudaGetLastError();
}
