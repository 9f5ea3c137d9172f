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
// in the plain version's order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "shade_core.cuh"

__global__ void shade_pinned_kernel(
    float* __restrict__ fs, int* __restrict__ is,
    const float* __restrict__ t_in, const float* __restrict__ attrs,
    const float* __restrict__ fu, const float* __restrict__ fv,
    const float* __restrict__ cam, const float* __restrict__ u9, int n,
    int last_sample, int max_depth, uint32_t seed, uint32_t iteration) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float ox = fs[0 * n + i], oy = fs[1 * n + i], oz = fs[2 * n + i];
  float dx = fs[3 * n + i], dy = fs[4 * n + i], dz = fs[5 * n + i];
  float tx = fs[6 * n + i], ty = fs[7 * n + i], tz = fs[8 * n + i];
  float rx = fs[9 * n + i], ry = fs[10 * n + i], rz = fs[11 * n + i];
  int bo = is[0 * n + i], sa = is[1 * n + i];
  bool active = is[2 * n + i] != 0;

  float u[9];
  if (u9) {
#pragma unroll
    for (int j = 0; j < 9; ++j) u[j] = u9[j * n + i];
  } else {
    rtw_uniforms<9>(seed, iteration, (uint32_t)i, u);
  }

  const float t = t_in[i];
  float a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = attrs[j * n + i];

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

  // Regenerate: the same pixel's next sample, in place.
  const bool need = s.miss || exhausted;
  const int nxt = sa + 1;
  const bool can = need && (nxt <= last_sample);
  const float inv_w = cam[19], inv_h = cam[20];
  const bool centered = nxt == 0;
  const float ju = centered ? 0.0f : u[5] * inv_w;
  const float jv = centered ? 0.0f : u[6] * inv_h;
  const float s_f = fu[i] + ju;
  const float t_f = fv[i] + jv;
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
  const float gox = cam[0] + offx, goy = cam[1] + offy, goz = cam[2] + offz;
  float gdx = cam[3] + s_f * cam[6] + t_f * cam[9] - cam[0] - offx;
  float gdy = cam[4] + s_f * cam[7] + t_f * cam[10] - cam[1] - offy;
  float gdz = cam[5] + s_f * cam[8] + t_f * cam[11] - cam[2] - offz;
  const float gno = rtw_rsqrt(gdx * gdx + gdy * gdy + gdz * gdz);
  gdx = gdx * gno; gdy = gdy * gno; gdz = gdz * gno;

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
