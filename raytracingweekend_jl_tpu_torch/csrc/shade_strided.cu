// K2: one strided persistent iteration (shade, scatter, fold, pixel switch,
// regenerate) for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/shade_kernel.py
// :: _shade_strided_kernel (launched by shade_strided_step), with the math of
// _shade_core and the helpers _uniforms, _gauss3 and _concentric.
//
// What it computes, per lane (each lane serves k pixels spaced n_lanes
// apart, one at a time): sky on miss; the hit point and facing normal;
// Lambertian, metal and dielectric scatter directions from shared draws with
// the Schlick coin; the continue-or-exhaust decision at max_depth; when a
// pixel has all its samples, the fold of its accumulator into buf[strip]
// and the switch to the lane's next pixel; and a thin-lens camera ray for
// every lane that starts a sample.
//
// What bounds it on the card: memory traffic and launch latency. A lane reads
// ~124 bytes (state, hit, attributes) and writes ~72, with ~250 flops and
// four transcendental calls; at the flagship width (32 400 lanes) one launch
// moves ~6 MB, a few microseconds of HBM time, so the fixed cost of a launch
// is of the same order.
//
// Design: one thread per lane; neighbouring threads read neighbouring words
// of each [plane, lane] array, so every load and store is coalesced. The
// state is updated in place (the TPU kernel aliased its state planes to its
// outputs for the same reason: no second copy of the state). The TPU had
// to fold with a masked add over all k strip buffers (3k planes read and
// written per lane); here a lane touches only buf[strip], 3 floats, guarded by
// strip < k. Draws are Philox4x32-10 keyed by (seed, iteration) with the lane
// as counter, or, when `u9` is given, read from it, so the plain PyTorch
// version (shade_strided_step_ref) can be fed the same numbers. Built with
// --fmad=false: each expression is evaluated as written, in the same order as
// the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

#define RTW_BIG 3.0e38f

__device__ __forceinline__ float rtw_rsqrt(float x) {
  return rsqrtf(fmaxf(x, 1e-20f));
}

__global__ void shade_strided_kernel(
    float* __restrict__ fs, int* __restrict__ is, float* __restrict__ buf,
    const float* __restrict__ t_in, const float* __restrict__ attrs,
    const float* __restrict__ cam, const float* __restrict__ u9, int n, int k,
    int W, int H, int dpx, int dpy, int p_end, int first_sample,
    int max_depth, uint32_t seed, uint32_t iteration) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float ox = fs[0 * n + i], oy = fs[1 * n + i], oz = fs[2 * n + i];
  float dx = fs[3 * n + i], dy = fs[4 * n + i], dz = fs[5 * n + i];
  float tx = fs[6 * n + i], ty = fs[7 * n + i], tz = fs[8 * n + i];
  float cx = fs[9 * n + i], cy = fs[10 * n + i], cz = fs[11 * n + i];
  int bo = is[0 * n + i], sa = is[1 * n + i], strip = is[2 * n + i];
  int pxi = is[3 * n + i], pyi = is[4 * n + i];
  bool active = is[5 * n + i] != 0;
  const int lane_lim = is[6 * n + i];

  float u[9];
  if (u9) {
#pragma unroll
    for (int j = 0; j < 9; ++j) u[j] = u9[j * n + i];
  } else {
#pragma unroll
    for (int blk = 0; blk < 3; ++blk) {
      RtwU4 c = {(uint32_t)i, (uint32_t)blk, 0u, 0u};
      RtwU4 r = rtw_philox4x32_10(c, seed, iteration);
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (4 * blk + q < 9) u[4 * blk + q] = rtw_u01(w[q]);
    }
  }

  const float t = t_in[i];
  const float acx = attrs[0 * n + i], acy = attrs[1 * n + i],
              acz = attrs[2 * n + i], arr = attrs[3 * n + i];
  const float aar = attrs[4 * n + i], aag = attrs[5 * n + i],
              aab = attrs[6 * n + i], afz = attrs[7 * n + i];
  const float air = attrs[8 * n + i], amt = attrs[9 * n + i];

  const bool hitm = (t < RTW_BIG) && active;
  const bool miss = active && !hitm;

  // Sky on miss (reference: src/ray_color.jl:1-6,35-37).
  const float st = 0.5f * (dy + 1.0f);
  const float skyr = (1.0f - st) + st * 0.5f;
  const float skyg = (1.0f - st) + st * 0.7f;
  const float skyb = (1.0f - st) + st * 1.0f;
  if (miss) {
    cx = cx + tx * skyr;
    cy = cy + ty * skyg;
    cz = cz + tz * skyb;
  }

  // Hit point and facing normal (src/hit.jl:3,6-10,32-34).
  const float ts = hitm ? t : 1.0f;
  const float px = ox + ts * dx, py = oy + ts * dy, pz = oz + ts * dz;
  const float inv_r = arr == 0.0f ? 0.0f : 1.0f / arr;
  float nx = (px - acx) * inv_r, ny = (py - acy) * inv_r,
        nz = (pz - acz) * inv_r;
  const float ddn = dx * nx + dy * ny + dz * nz;
  const bool front = ddn < 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  nx = nx * sgn;
  ny = ny * sgn;
  nz = nz * sgn;

  // Three normals by Box-Muller -> a uniform unit vector.
  const float r0g = sqrtf(-2.0f * logf(fmaxf(u[0], 1e-12f)));
  const float r1g = sqrtf(-2.0f * logf(fmaxf(u[2], 1e-12f)));
  const float two_pi = 6.283185307179586f;
  const float a0 = two_pi * u[1], a1 = two_pi * u[3];
  const float g0 = r0g * cosf(a0), g1 = r0g * sinf(a0), g2 = r1g * cosf(a1);
  const float gn = rtw_rsqrt(g0 * g0 + g1 * g1 + g2 * g2);
  const float ux = g0 * gn, uy = g1 * gn, uz = g2 * gn;
  const float xi = u[4];

  // Lambertian (src/material.jl:13-23).
  const float lx = nx + ux, ly = ny + uy, lz = nz + uz;
  const float lsq = lx * lx + ly * ly + lz * lz;
  const bool degen = lsq < 1e-5f;
  const float lno = rtw_rsqrt(lsq);
  const float lamx = degen ? nx : lx * lno;
  const float lamy = degen ? ny : ly * lno;
  const float lamz = degen ? nz : lz * lno;

  // Metal (src/material.jl:25-34).
  const float dn = dx * nx + dy * ny + dz * nz;
  const float refx = dx - 2.0f * dn * nx;
  const float refy = dy - 2.0f * dn * ny;
  const float refz = dz - 2.0f * dn * nz;
  const float mx = refx + afz * ux, my = refy + afz * uy, mz = refz + afz * uz;
  const float mno = rtw_rsqrt(mx * mx + my * my + mz * mz);
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
  const float fno = rtw_rsqrt(fx * fx + fy * fy + fz * fz);
  const float dielx = choose_reflect ? refx : fx * fno;
  const float diely = choose_reflect ? refy : fy * fno;
  const float dielz = choose_reflect ? refz : fz * fno;

  // Material dispatch (0 lambert / 1 metal / 2 dielectric).
  const bool is_lam = amt == 0.0f, is_met = amt == 1.0f;
  const float ndx = is_lam ? lamx : (is_met ? metx : dielx);
  const float ndy = is_lam ? lamy : (is_met ? mety : diely);
  const float ndz = is_lam ? lamz : (is_met ? metz : dielz);

  // Continue bouncing.
  const int newb = bo + 1;
  const bool cont = hitm && (newb < max_depth);
  if (cont) {
    ox = px; oy = py; oz = pz;
    dx = ndx; dy = ndy; dz = ndz;
    tx = tx * aar; ty = ty * aag; tz = tz * aab;
    bo = newb;
  }

  // Ray finished: next sample of this pixel, or fold and switch pixels.
  const bool need = miss || (hitm && !cont);
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
    // Thin-lens camera ray from integer pixel coordinates (src/camera.jl).
    const float inv_w = cam[19], inv_h = cam[20];
    const float u_f = (float)(pxi + 1) * inv_w;
    const float v_f = (float)(H - 1 - pyi) * inv_h;
    const bool centered = sa == 0;
    const float ju = centered ? 0.0f : u[5] * inv_w;
    const float jv = centered ? 0.0f : u[6] * inv_h;
    const float s_f = u_f + ju;
    const float t_f = v_f + jv;
    // Concentric square -> disk map.
    const float ca = 2.0f * u[7] - 1.0f, cb = 2.0f * u[8] - 1.0f;
    const bool use_a = fabsf(ca) > fabsf(cb);
    const float rr = use_a ? ca : cb;
    const float qp = 0.7853981633974483f, hp = 1.5707963267948966f;
    const float safe_a = ca == 0.0f ? 1.0f : ca;
    const float safe_b = cb == 0.0f ? 1.0f : cb;
    float theta = use_a ? qp * (cb / safe_a) : hp - qp * (ca / safe_b);
    if (ca == 0.0f && cb == 0.0f) theta = 0.0f;
    const float da = rr * cosf(theta), db = rr * sinf(theta);
    const float rdx = cam[18] * da, rdy = cam[18] * db;
    const float offx = rdx * cam[12] + rdy * cam[15];
    const float offy = rdx * cam[13] + rdy * cam[16];
    const float offz = rdx * cam[14] + rdy * cam[17];
    const float gdx = cam[3] + s_f * cam[6] + t_f * cam[9] - cam[0] - offx;
    const float gdy = cam[4] + s_f * cam[7] + t_f * cam[10] - cam[1] - offy;
    const float gdz = cam[5] + s_f * cam[8] + t_f * cam[11] - cam[2] - offz;
    const float gno = rtw_rsqrt(gdx * gdx + gdy * gdy + gdz * gdz);
    ox = cam[0] + offx; oy = cam[1] + offy; oz = cam[2] + offz;
    dx = gdx * gno; dy = gdy * gno; dz = gdz * gno;
    tx = 1.0f; ty = 1.0f; tz = 1.0f;
    bo = 0;
  }
  active = (active && !need) || start;

  fs[0 * n + i] = ox; fs[1 * n + i] = oy; fs[2 * n + i] = oz;
  fs[3 * n + i] = dx; fs[4 * n + i] = dy; fs[5 * n + i] = dz;
  fs[6 * n + i] = tx; fs[7 * n + i] = ty; fs[8 * n + i] = tz;
  fs[9 * n + i] = cx; fs[10 * n + i] = cy; fs[11 * n + i] = cz;
  is[0 * n + i] = bo; is[1 * n + i] = sa; is[2 * n + i] = strip;
  is[3 * n + i] = pxi; is[4 * n + i] = pyi; is[5 * n + i] = active ? 1 : 0;
}

// fstate [12, n] f32 and istate [7, n] i32 are updated in place; buf [3k, n]
// f32 is accumulated in place. u9 [9, n] f32 may be NULL (in-kernel Philox).
extern "C" int rtw_shade_strided(float* fstate, int* istate, float* buf,
                                 const float* t, const float* attrs,
                                 const float* cam, const float* u9, int n,
                                 int k, int W, int H, int dpx, int dpy,
                                 int p_end, int first_sample, int max_depth,
                                 unsigned int seed, unsigned int iteration,
                                 void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  shade_strided_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      fstate, istate, buf, t, attrs, cam, u9, n, k, W, H, dpx, dpy, p_end,
      first_sample, max_depth, seed, iteration);
  return (int)cudaGetLastError();
}
