// The pixel-pinned persistent step of one lane: K9's body (shade_pinned.cu),
// shared with the megakernel K12 (mega.cu).
//
// Replaces the value-level math of the TPU kernels
// raytracingweekend_jl_tpu/ops/pallas/shade_kernel.py :: _shade_math: the
// shading core (shade_core.cuh), then the continue / exhaust / regenerate
// bookkeeping and the thin-lens camera ray of the lane's own pixel, from
// its film coordinates (u, v). The plain PyTorch version is
// raytracingweekend_jl_tpu_torch/ops/cuda/shade_kernel.py ::
// shade_and_regen_ref, written expression for expression like this file;
// both run without FMA contraction.

#pragma once

#include "shade_core.cuh"

// Lane i of n: reads its 12 float and 3 int state words from fs/is, shades
// the bounce (hit distance t, winner attributes a[10], uniforms u[9]),
// continues or regenerates the pixel (film point fu, fv) and writes the
// state back. cam: the 21 packed camera constants.
__device__ __forceinline__ void rtw_pinned_step(
    int i, int n, float* __restrict__ fs, int* __restrict__ is, float t,
    const float* a, const float* u, float fu, float fv,
    const float* __restrict__ cam, int last_sample, int max_depth) {
  float ox = fs[0 * n + i], oy = fs[1 * n + i], oz = fs[2 * n + i];
  float dx = fs[3 * n + i], dy = fs[4 * n + i], dz = fs[5 * n + i];
  float tx = fs[6 * n + i], ty = fs[7 * n + i], tz = fs[8 * n + i];
  float rx = fs[9 * n + i], ry = fs[10 * n + i], rz = fs[11 * n + i];
  int bo = is[0 * n + i], sa = is[1 * n + i];
  bool active = is[2 * n + i] != 0;
  const RtwShade s = rtw_shade_core(u, t, a, ox, oy, oz, dx, dy, dz, tx, ty,
                                    tz, active, rx, ry, rz);

  // Continue bouncing: the TPU kernel's 0/1 blend of origin and direction.
  const int newb = bo + 1;
  const bool cont = s.hitm && (newb < max_depth);
  const bool exhausted = s.hitm && !cont;
  const float cf = cont ? 1.0f : 0.0f;
  const float ncf = 1.0f - cf;
  ox = cf * s.px + ncf * ox;
  oy = cf * s.py + ncf * oy;
  oz = cf * s.pz + ncf * oz;
  dx = cf * s.ndx + ncf * dx;
  dy = cf * s.ndy + ncf * dy;
  dz = cf * s.ndz + ncf * dz;
  if (cont) {
    tx = tx * a[4]; ty = ty * a[5]; tz = tz * a[6];
    bo = newb;
  }

  // Regenerate: the same pixel's next sample, in place, built as
  // pinned_start_rays builds the first.
  const bool need = s.miss || exhausted;
  const int nxt = sa + 1;
  const bool can = need && (nxt <= last_sample);
  float da, db, gox, goy, goz, gdx, gdy, gdz;
  rtw_lens_disk(u[7], u[8], da, db);
  rtw_camera_ray(cam, fu, fv, nxt == 0, u[5], u[6], da, db, gox, goy, goz,
                 gdx, gdy, gdz);

  const float canf = can ? 1.0f : 0.0f;
  const float ncanf = 1.0f - canf;
  ox = canf * gox + ncanf * ox;
  oy = canf * goy + ncanf * oy;
  oz = canf * goz + ncanf * oz;
  dx = canf * gdx + ncanf * dx;
  dy = canf * gdy + ncanf * dy;
  dz = canf * gdz + ncanf * dz;
  if (can) {
    tx = 1.0f; ty = 1.0f; tz = 1.0f;
    bo = 0;
    sa = nxt;
  }
  active = (active && !need) || can;

  fs[0 * n + i] = ox; fs[1 * n + i] = oy; fs[2 * n + i] = oz;
  fs[3 * n + i] = dx; fs[4 * n + i] = dy; fs[5 * n + i] = dz;
  fs[6 * n + i] = tx; fs[7 * n + i] = ty; fs[8 * n + i] = tz;
  fs[9 * n + i] = rx; fs[10 * n + i] = ry; fs[11 * n + i] = rz;
  is[0 * n + i] = bo; is[1 * n + i] = sa; is[2 * n + i] = active ? 1 : 0;
}
