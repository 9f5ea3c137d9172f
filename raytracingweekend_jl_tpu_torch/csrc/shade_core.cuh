// The shading core shared by the strided forward step (K2, shade_strided.cu)
// and the persistent record step (K4, persist_record.cu), the winner fetch
// both take from the sweep's index (rtw_fetch_row), and the camera ray that
// K2 and the pixel-pinned step (pinned_core.cuh) rebuild (rtw_camera_ray).
//
// Replaces the value-level helpers of the TPU kernels in
// raytracingweekend_jl_tpu/ops/pallas/shade_kernel.py: _shade_core (sky on
// miss, hit point and facing normal, the three materials' scatter directions
// with the Schlick coin, the material dispatch) and _gauss3 (three normals by
// Box-Muller). The plain PyTorch version is
// raytracingweekend_jl_tpu_torch/ops/cuda/shade_kernel.py::shade_core, written
// expression for expression like this file; both are built or run without
// FMA contraction, so they agree bit for bit.
//
// The TPU core adds `miss * T * sky` to its radiance accumulators; here a
// miss adds `T * sky` and other lanes leave them alone. The two give the same
// bits (1 * x == x, r + 0 == r) for every finite input.

#pragma once

#ifndef RTW_BIG
#define RTW_BIG 3.0e38f
#endif

// 1 / sqrt(x), x clamped to a tiny floor, correctly rounded: __frsqrt_rn
// rounds the exact value once to the nearest float. It normalises every
// direction the kernels build (the camera ray, the unit vector, the three
// materials' scatter directions) and the adjoint's d sqrt|S|. Its plain
// version, ops/vecmath.py::inv_length (the square root and the division in
// double, then one rounding to float), gives the same bits on every
// non-negative float, on the card and on the CPU (chip_smoke.py's
// inv_length_exhaustive). The approximate reciprocal square root intrinsic
// it replaces differs on a sixth of the floats and leaves directions short
// (|d|^2 - 1 averages -6.5e-9 over camera rays); the sweep takes a
// direction as unit (sweep_core.cuh: no a term), so that biased the hits.
__device__ __forceinline__ float rtw_inv_length(float x) {
  return __frsqrt_rn(fmaxf(x, 1e-20f));
}

// The concentric square -> disk map of two uniforms: the lens point (da, db)
// of a camera ray (sampling.concentric_disk_map).
__device__ __forceinline__ void rtw_lens_disk(float u7, float u8, float& da,
                                              float& db) {
  const float ca = 2.0f * u7 - 1.0f, cb = 2.0f * u8 - 1.0f;
  const bool use_a = fabsf(ca) > fabsf(cb);
  const float rr = use_a ? ca : cb;
  const float qp = 0.7853981633974483f, hp = 1.5707963267948966f;
  const float safe_a = ca == 0.0f ? 1.0f : ca;
  const float safe_b = cb == 0.0f ? 1.0f : cb;
  float theta = use_a ? qp * (cb / safe_a) : hp - qp * (ca / safe_b);
  if (ca == 0.0f && cb == 0.0f) theta = 0.0f;
  da = rr * cosf(theta);
  db = rr * sinf(theta);
}

// The thin-lens camera ray (src/camera.jl) of film point (fu, fv), jitter
// uniforms u5, u6 and lens point (da, db), as camera.make_rays builds it,
// the one camera ray that K2 and the pixel-pinned step (K9, K12) rebuild:
// the jitter times 1/W and 1/H (none for a centred sample), make_rays'
// sums, then rtw_inv_length of (x*x + y*y) + z*z (vecmath.normalize).
// cam: the 21 packed camera constants. The plain version is
// ops/cuda/shade_kernel.py::camera_ray.
__device__ __forceinline__ void rtw_camera_ray(
    const float* __restrict__ cam, float fu, float fv, bool centered,
    float u5, float u6, float da, float db, float& ox, float& oy, float& oz,
    float& dx, float& dy, float& dz) {
  const float s_f = fu + (centered ? 0.0f : u5 * cam[19]);
  const float t_f = fv + (centered ? 0.0f : u6 * cam[20]);
  const float rdx = cam[18] * da, rdy = cam[18] * db;
  const float offx = rdx * cam[12] + rdy * cam[15];
  const float offy = rdx * cam[13] + rdy * cam[16];
  const float offz = rdx * cam[14] + rdy * cam[17];
  const float gdx = cam[3] + s_f * cam[6] + t_f * cam[9] - cam[0] - offx;
  const float gdy = cam[4] + s_f * cam[7] + t_f * cam[10] - cam[1] - offy;
  const float gdz = cam[5] + s_f * cam[8] + t_f * cam[11] - cam[2] - offz;
  const float inv = rtw_inv_length(gdx * gdx + gdy * gdy + gdz * gdz);
  ox = cam[0] + offx; oy = cam[1] + offy; oz = cam[2] + offz;
  dx = gdx * inv; dy = gdy * inv; dz = gdz * inv;
}

// Three standard normals from four uniforms (Box-Muller).
__device__ __forceinline__ void rtw_gauss3(float u0, float u1, float u2,
                                           float u3, float& g0, float& g1,
                                           float& g2) {
  const float r0g = sqrtf(-2.0f * logf(fmaxf(u0, 1e-12f)));
  const float r1g = sqrtf(-2.0f * logf(fmaxf(u2, 1e-12f)));
  const float two_pi = 6.283185307179586f;
  const float a0 = two_pi * u1, a1 = two_pi * u3;
  g0 = r0g * cosf(a0);
  g1 = r0g * sinf(a0);
  g2 = r1g * cosf(a1);
}

// The winner's 10 attributes (materials.attr_mat column order): row idx[i]
// of the [N, 10] table, read through the read-only data path. This is
// materials.fetch_attr_planes' gather: a miss lane (idx 0) reads sphere 0's
// row, as the gather does.
__device__ __forceinline__ void rtw_fetch_row(const int* __restrict__ idx,
                                              const float* __restrict__ amat,
                                              int i, float* a) {
  const float* row = amat + 10 * (size_t)__ldg(idx + i);
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = __ldg(row + j);
}

struct RtwShade {
  bool hitm, miss;
  float px, py, pz;     // hit point
  float ndx, ndy, ndz;  // scatter direction of the winner's material
};

// One bounce of shading for one lane. u: the first 5 uniforms (4 for the
// unit vector, 1 for the Schlick coin). a: the winner's 10 attributes in
// materials.attr_mat column order. rx, ry, rz: radiance accumulators that a
// miss banks T * sky(d) into.
__device__ __forceinline__ RtwShade rtw_shade_core(
    const float* u, float t, const float* a, float ox, float oy, float oz,
    float dx, float dy, float dz, float tx, float ty, float tz, bool active,
    float& rx, float& ry, float& rz) {
  const float acx = a[0], acy = a[1], acz = a[2], arr = a[3];
  const float afz = a[7], air = a[8], amt = a[9];
  RtwShade s;
  s.hitm = (t < RTW_BIG) && active;
  s.miss = active && !s.hitm;

  // Sky on miss (reference: src/ray_color.jl:1-6,35-37).
  const float st = 0.5f * (dy + 1.0f);
  const float skyr = (1.0f - st) + st * 0.5f;
  const float skyg = (1.0f - st) + st * 0.7f;
  const float skyb = (1.0f - st) + st * 1.0f;
  if (s.miss) {
    rx = rx + tx * skyr;
    ry = ry + ty * skyg;
    rz = rz + tz * skyb;
  }

  // Hit point and facing normal (src/hit.jl:3,6-10,32-34).
  const float ts = s.hitm ? t : 1.0f;
  s.px = ox + ts * dx;
  s.py = oy + ts * dy;
  s.pz = oz + ts * dz;
  const float inv_r = arr == 0.0f ? 0.0f : 1.0f / arr;
  float nx = (s.px - acx) * inv_r, ny = (s.py - acy) * inv_r,
        nz = (s.pz - acz) * inv_r;
  const float ddn = dx * nx + dy * ny + dz * nz;
  const bool front = ddn < 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  nx = nx * sgn;
  ny = ny * sgn;
  nz = nz * sgn;

  // Three normals by Box-Muller -> a uniform unit vector.
  float g0, g1, g2;
  rtw_gauss3(u[0], u[1], u[2], u[3], g0, g1, g2);
  const float gn = rtw_inv_length(g0 * g0 + g1 * g1 + g2 * g2);
  const float ux = g0 * gn, uy = g1 * gn, uz = g2 * gn;
  const float xi = u[4];

  // Lambertian (src/material.jl:13-23).
  const float lx = nx + ux, ly = ny + uy, lz = nz + uz;
  const float lsq = lx * lx + ly * ly + lz * lz;
  const bool degen = lsq < 1e-5f;
  const float lno = rtw_inv_length(lsq);
  const float lamx = degen ? nx : lx * lno;
  const float lamy = degen ? ny : ly * lno;
  const float lamz = degen ? nz : lz * lno;

  // Metal (src/material.jl:25-34).
  const float dn = dx * nx + dy * ny + dz * nz;
  const float refx = dx - 2.0f * dn * nx;
  const float refy = dy - 2.0f * dn * ny;
  const float refz = dz - 2.0f * dn * nz;
  const float mx = refx + afz * ux, my = refy + afz * uy, mz = refz + afz * uz;
  const float mno = rtw_inv_length(mx * mx + my * my + mz * mz);
  const float metx = mx * mno, mety = my * mno, metz = mz * mno;

  // Dielectric (src/material.jl:41-53, src/light.jl:12-25).
  const float safe_ir = air == 0.0f ? 1.0f : air;
  const float eta = front ? 1.0f / safe_ir : safe_ir;
  const float cos_t = fminf(-(dx * nx + dy * ny + dz * nz), 1.0f);
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const bool cannot = eta * sin_t > 1.0f;
  float r0 = (1.0f - eta) / (1.0f + eta);
  r0 = r0 * r0;
  const float omc = 1.0f - cos_t;
  const float omc2 = omc * omc;
  const float schlick = r0 + (1.0f - r0) * omc2 * omc2 * omc;
  const bool choose_reflect = cannot || (schlick > xi);
  const float rpx = eta * (dx + cos_t * nx);
  const float rpy = eta * (dy + cos_t * ny);
  const float rpz = eta * (dz + cos_t * nz);
  const float par = -sqrtf(fabsf(1.0f - (rpx * rpx + rpy * rpy + rpz * rpz)));
  const float fx = rpx + par * nx, fy = rpy + par * ny, fz = rpz + par * nz;
  const float fno = rtw_inv_length(fx * fx + fy * fy + fz * fz);
  const float dielx = choose_reflect ? refx : fx * fno;
  const float diely = choose_reflect ? refy : fy * fno;
  const float dielz = choose_reflect ? refz : fz * fno;

  // Material dispatch (0 lambert / 1 metal / 2 dielectric).
  const bool is_lam = amt == 0.0f, is_met = amt == 1.0f;
  s.ndx = is_lam ? lamx : (is_met ? metx : dielx);
  s.ndy = is_lam ? lamy : (is_met ? mety : diely);
  s.ndz = is_lam ? lamz : (is_met ? metz : dielz);
  return s;
}
