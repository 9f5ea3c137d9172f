// The closest-hit loops of the sphere sweeps.
//
// rtw_sweep_closest: one thread sweeps one ray over the whole table. It is
// the loop of the one-thread reference kernel that the split loop is
// checked against (sweep.cu, sweep_fetch_one_thread_kernel); the cluster
// sweep K13 (grid_sweep.cu) runs its pair test, rtw_sweep_one.
//
// rtw_sweep_part + rtw_merge_closest: the split loop of K1, K3 and K10
// (sweep.cu), of the megakernel K12 (mega.cu) and of the fused record step
// K11 (persist_record.cu). A group of P threads of
// one warp sweeps one ray, part p taking spheres s == p (mod P), and the
// parts merge on the lexicographic minimum of (t, idx). rtw_sweep_closest
// accepts only a strictly smaller t, in increasing index order, so its
// winner is the least accepted t and, among equal t, the least index:
// exactly that minimum, whatever the order of the parts. A part that accepts nothing holds (BIG, 0); a NaN t
// is accepted by neither loop. So both loops give (t, idx) bit for bit.
//
// The TPU kernel's expanded form of the half-b quadratic for unit
// directions (a == 1), raytracingweekend_jl_tpu/ops/pallas/intersect_kernel.py
// :: _sweep_kernel:
//     od = o.d, oo = |o|^2, ck = |c|^2 - r^2 (precomputed per sphere)
//     hb = od - c.d,  c = oo - 2 o.c + ck,  disc = hb^2 - c
//     t  = near root if >= tmin, else far root
//     accept if disc > 0 and t >= tmin and t < best_t (strict: ties keep the
//     first index)
// Built with --fmad=false, so each expression is evaluated as written, in
// the plain version's order (intersect_kernel.py::sweep_ref).
//
// rtw_sweep_pair_motion + rtw_sweep_part_motion: the pair and part of the
// moving sweep K1m (sweep.cu), whose sphere is centred at
// c0 + time * m at the ray's shutter time: the centre and ck are formed per
// pair, then rtw_sweep_pair.

#pragma once

#include <cuda_runtime.h>

#ifndef RTW_BIG
#define RTW_BIG 3.0e38f
#endif

// One sphere (cx, cy, cz, ck) against one ray, given od = o.d and oo = |o|^2:
// updates (best_t, best_i) to (t, s) on an accepted, strictly closer root.
__device__ __forceinline__ void rtw_sweep_one(float4 c4, int s, float ox,
                                              float oy, float oz, float dx,
                                              float dy, float dz, float od,
                                              float oo, float tmin,
                                              float& best_t, int& best_i) {
  const float cd = c4.x * dx + c4.y * dy + c4.z * dz;
  const float oc = c4.x * ox + c4.y * oy + c4.z * oz;
  const float hb = od - cd;
  const float c = oo - 2.0f * oc + c4.w;
  const float disc = hb * hb - c;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  const float r1 = -hb - sq;
  const float t = r1 >= tmin ? r1 : -hb + sq;
  if (disc > 0.0f && t >= tmin && t < best_t) {
    best_t = t;
    best_i = s;
  }
}

// The closest hit of one ray against spheres [0, n) of `sph` (shared or
// global memory): (BIG, 0) on a miss.
__device__ __forceinline__ void rtw_sweep_closest(const float4* sph, int n,
                                                  float ox, float oy,
                                                  float oz, float dx,
                                                  float dy, float dz,
                                                  float tmin, float& best_t,
                                                  int& best_i) {
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;
  best_t = RTW_BIG;
  best_i = 0;
#pragma unroll 8
  for (int s = 0; s < n; ++s)
    rtw_sweep_one(sph[s], s, ox, oy, oz, dx, dy, dz, od, oo, tmin, best_t,
                  best_i);
}

// rtw_sweep_one with the roots behind `disc > 0`: the same expressions in
// the same order, so the same (t, idx) bit for bit (a pair with disc <= 0,
// or NaN, is never accepted, and for disc > 0 fmaxf(disc, 0) is disc). Most
// pairs miss, and a warp whose pairs all miss skips the square root.
__device__ __forceinline__ void rtw_sweep_pair(float4 c4, int s, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz, float od,
                                               float oo, float tmin,
                                               float& best_t, int& best_i) {
  const float cd = c4.x * dx + c4.y * dy + c4.z * dz;
  const float oc = c4.x * ox + c4.y * oy + c4.z * oz;
  const float hb = od - cd;
  const float c = oo - 2.0f * oc + c4.w;
  const float disc = hb * hb - c;
  if (disc > 0.0f) {
    const float sq = sqrtf(disc);
    const float r1 = -hb - sq;
    const float t = r1 >= tmin ? r1 : -hb + sq;
    if (t >= tmin && t < best_t) {
      best_t = t;
      best_i = s;
    }
  }
}

// Part p of P (a power of two) of one ray's sweep: spheres p, p + P, ...
// of [0, n). (BIG, 0) when the part accepts nothing.
__device__ __forceinline__ void rtw_sweep_part(const float4* sph, int n,
                                               int p, int P, float ox,
                                               float oy, float oz, float dx,
                                               float dy, float dz,
                                               float tmin, float& best_t,
                                               int& best_i) {
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;
  best_t = RTW_BIG;
  best_i = 0;
#pragma unroll 4
  for (int s = p; s < n; s += P)
    rtw_sweep_pair(sph[s], s, ox, oy, oz, dx, dy, dz, od, oo, tmin, best_t,
                   best_i);
}

// The moving sweep's pair (K1m, sweep.cu): sphere s, centred at
// c0 + time * m at the ray's shutter time, against one ray. c4 holds
// (c0x, c0y, c0z, r^2) and m4 (mx, my, mz, 0). The centre and its
// |c|^2 - r^2 are formed per pair, in the plain version's order
// (intersect_kernel.py::sweep_motion_ref), then rtw_sweep_pair takes them as
// the static pair takes a precomputed (cx, cy, cz, ck): with m = 0 the same
// bits as the static pair of that sphere.
__device__ __forceinline__ void rtw_sweep_pair_motion(
    float4 c4, float4 m4, int s, float time, float ox, float oy, float oz,
    float dx, float dy, float dz, float od, float oo, float tmin,
    float& best_t, int& best_i) {
  const float cx = c4.x + time * m4.x;
  const float cy = c4.y + time * m4.y;
  const float cz = c4.z + time * m4.z;
  const float ck = cx * cx + cy * cy + cz * cz - c4.w;
  rtw_sweep_pair(make_float4(cx, cy, cz, ck), s, ox, oy, oz, dx, dy, dz, od,
                 oo, tmin, best_t, best_i);
}

// rtw_sweep_part over the moving table: sph holds two float4 a sphere,
// (c0, r^2) at 2s and (m, 0) at 2s + 1.
__device__ __forceinline__ void rtw_sweep_part_motion(
    const float4* sph, int n, int p, int P, float time, float ox, float oy,
    float oz, float dx, float dy, float dz, float tmin, float& best_t,
    int& best_i) {
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;
  best_t = RTW_BIG;
  best_i = 0;
#pragma unroll 4
  for (int s = p; s < n; s += P)
    rtw_sweep_pair_motion(sph[2 * s], sph[2 * s + 1], s, time, ox, oy, oz, dx,
                          dy, dz, od, oo, tmin, best_t, best_i);
}

// Merges the parts of each group of P aligned lanes of a warp (P a power of
// two <= 32): afterwards every lane of the group holds the group's
// lexicographic minimum of (t, idx). Every lane of the warp must call it.
__device__ __forceinline__ void rtw_merge_closest(float& t, int& idx, int P) {
  for (int off = P >> 1; off > 0; off >>= 1) {
    const float to = __shfl_xor_sync(0xffffffffu, t, off);
    const int io = __shfl_xor_sync(0xffffffffu, idx, off);
    if (to < t || (to == t && io < idx)) {
      t = to;
      idx = io;
    }
  }
}

// -- host side of the split sweeps (K1, K3, K10, K12) -----------------------

// The largest power of two <= min(32, n_spheres): every part has a sphere.
static inline int rtw_parts_cap(int n_spheres) {
  int p = 1;
  while (p < 32 && 2 * p <= n_spheres) p *= 2;
  return p;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory. By default it
// may take 48 KB less its static shared memory; past that the limit is
// raised first.
static inline cudaError_t rtw_reserve_smem(const void* kernel, size_t smem) {
  cudaFuncAttributes a = {};
  cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess || smem <= (size_t)a.maxDynamicSharedSizeBytes)
    return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}
