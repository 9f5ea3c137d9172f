// K7a: one bounce of the fixed-depth record (the forward of the small-image
// gradient path) for Hopper (sm_90a), with the sweep winner's fetch inside.
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/grad_kernel.py
// :: _record_shade_kernel (launched by record_shade_step), and the gather
// that fed it its winner's attributes (materials.fetch_attr_planes; a
// one-hot matrix product in XLA on the TPU). The plain PyTorch version is
// raytracingweekend_jl_tpu_torch/ops/cuda/grad_kernel.py ::
// record_shade_fetch_ref: that gather, then record_shade_step_ref.
//
// What it computes, per lane: the bounce after the masked sweep. It reads
// the winner's 10 attributes, row idx[i] of the [N, 10] table (a live lane
// that missed has idx 0 and reads sphere 0's row, as the gather does), writes
// slot `bounce` of the residual record (the bounce's inputs o, d, T, the hit
// distance t, the alive flag, the winner's 10 attributes), shades the bounce
// (shade_core.cuh: a miss banks T * sky(d) into the radiance), and advances
// a hit: o = p, d = the material's scatter direction, T = T * albedo. The
// new alive flag is the hit mask: a miss or a dead lane is done, and a path
// still alive after the last bounce reads black.
//
// Dead lanes: the TPU kernel skipped a (64, 128) block whose lanes were all
// dead, passed its state through and wrote af = 0 into the record. Here the
// same contract holds per lane: a dead lane passes its state through and
// writes a zero record slot (af = 0, which is all the replay reads of it).
//
// State and record are updated in place, as the TPU kernel aliased its state
// and record inputs to its outputs. The alive flag is stored bit for bit in
// a float plane (plane 12 of the state, plane 10 of the record), as K4 keeps
// its flag word.
//
// What bounds it on the card: memory traffic. A live lane reads ~60 bytes
// (state, hit distance, winner index; the table is a few hundred bytes that
// every lane shares through the read-only cache) and writes ~136 (state and
// 21 record words); a dead lane reads its flag and writes the zero slot. At
// bounce 2 of the inverse demo (22 400 lanes, 9 295 live) one launch moves
// ~3 MB, ~1 us of HBM time: the launch and one lane's load -> draw -> shade
// -> store chain cost more than the bytes.
//
// Design: one thread per lane, [plane, lane] layout so a warp's accesses are
// one coalesced segment per plane; the winner's row through the read-only
// path (rtw_fetch_row), which takes the gather, its index cast and its copy
// off the bounce: three launches fewer per bounce. The record is stored
// evict-first (__stcs), as K4 stores its record. Draws: 5 uniforms,
// Philox4x32-10 keyed by (seed, bounce) with the lane as the counter, so the
// replay kernels redraw exactly these numbers at any launch shape; or read
// from `u5` when given. scripts/torch_k7a_k8_variants.py holds the designs
// this one was chosen over (block sizes, a shared-memory table, default
// stores, the draws issued first), each bit for bit this kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "shade_core.cuh"

#define RTW_K7A_THREADS 128

// One word of the record slot, stored evict-first: nothing reads the
// record before the replay, after the last bounce.
__device__ __forceinline__ void rtw_rec_store(float* p, float v) {
  __stcs(p, v);
}

__global__ void __launch_bounds__(RTW_K7A_THREADS) record_shade_kernel(
    const float* __restrict__ t_in, const int* __restrict__ idx,
    const float* __restrict__ amat, float* __restrict__ st,
    float* __restrict__ rec, const float* __restrict__ u5, int n_lanes,
    uint32_t seed, uint32_t bounce) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  if (__float_as_int(st[12 * n + i]) == 0) {
#pragma unroll
    for (int p = 0; p < 21; ++p) rtw_rec_store(rec + p * n + i, 0.0f);
    return;
  }

  float ox = st[0 * n + i], oy = st[1 * n + i], oz = st[2 * n + i];
  float dx = st[3 * n + i], dy = st[4 * n + i], dz = st[5 * n + i];
  float tx = st[6 * n + i], ty = st[7 * n + i], tz = st[8 * n + i];
  float rx = st[9 * n + i], ry = st[10 * n + i], rz = st[11 * n + i];

  float u[5];
  if (u5) {
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = u5[j * n + i];
  } else {
    rtw_uniforms<5>(seed, bounce, (uint32_t)i, u);
  }
  const float t = t_in[i];
  float a[10];
  rtw_fetch_row(idx, amat, i, a);

  // Residual record: this bounce's inputs.
  const float r10[10] = {ox, oy, oz, dx, dy, dz, tx, ty, tz, t};
#pragma unroll
  for (int j = 0; j < 10; ++j) rtw_rec_store(rec + j * n + i, r10[j]);
  rtw_rec_store(rec + 10 * n + i, __int_as_float(1));
#pragma unroll
  for (int j = 0; j < 10; ++j) rtw_rec_store(rec + (11 + j) * n + i, a[j]);

  const RtwShade s = rtw_shade_core(u, t, a, ox, oy, oz, dx, dy, dz, tx, ty,
                                    tz, true, rx, ry, rz);
  if (s.hitm) {
    ox = s.px; oy = s.py; oz = s.pz;
    dx = s.ndx; dy = s.ndy; dz = s.ndz;
    tx = tx * a[4]; ty = ty * a[5]; tz = tz * a[6];
  }
  st[0 * n + i] = ox; st[1 * n + i] = oy; st[2 * n + i] = oz;
  st[3 * n + i] = dx; st[4 * n + i] = dy; st[5 * n + i] = dz;
  st[6 * n + i] = tx; st[7 * n + i] = ty; st[8 * n + i] = tz;
  st[9 * n + i] = rx; st[10 * n + i] = ry; st[11 * n + i] = rz;
  st[12 * n + i] = __int_as_float(s.hitm ? 1 : 0);
}

// t [R] f32, idx [R] int32 (the sweep's winners), amat [N, 10] f32; st
// [13, R] f32 (o, d, T, radiance, alive flag bits) is updated in place; rec
// points at one record slot [21, R], written. u5 [5, R] f32 may be NULL
// (in-kernel Philox).
extern "C" int rtw_record_shade(const float* t, const int* idx,
                                const float* amat, float* st, float* rec,
                                const float* u5, int n_lanes,
                                unsigned int seed, unsigned int bounce,
                                void* stream) {
  if (n_lanes <= 0) return 0;
  const int blocks = (n_lanes + RTW_K7A_THREADS - 1) / RTW_K7A_THREADS;
  record_shade_kernel<<<blocks, RTW_K7A_THREADS, 0, (cudaStream_t)stream>>>(
      t, idx, amat, st, rec, u5, n_lanes, seed, bounce);
  return (int)cudaGetLastError();
}
