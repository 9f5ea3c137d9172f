// The closest-hit loop of K1 (sweep.cu), shared by every kernel that sweeps
// a ray against a sphere table: K3 and K10 (sweep.cu), the fused record
// step K11 (persist_record.cu), the megakernel K12 (mega.cu) and the cluster
// sweep K13 (grid_sweep.cu). One definition keeps their (t, idx) bit for bit
// K1's.
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

#pragma once

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
