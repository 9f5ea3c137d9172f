// K8: the whole small-image render in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/inline_kernel.py
// :: _inline_kernel (launched by trace_inline), with its sweep
// _sweep_select. The plain PyTorch version is
// raytracingweekend_jl_tpu_torch/ops/cuda/inline_kernel.py ::
// trace_inline_ref; the plain mirror of this kernel's schedule is ::
// trace_inline_queue_ref.
//
// What it computes, per (pixel, sample) lane: the radiance of one camera
// ray over `max_depth` bounces. Each bounce sweeps every sphere with the
// half-b quadratic and K1's tmin rule (csrc/sweep.cu), shades the winner
// (shade_core.cuh: a miss banks T * sky(d), a hit scatters) and advances a
// hit. A lane that missed is done; a path still alive after the last bounce
// reads black (the reference's depth budget).
//
// What bounds it on the card: arithmetic. A live lane does ~20 flops per
// sphere per bounce in the sweep and ~150 in the shade; it reads 24 bytes
// and writes 12. At the inverse demo's 179 200 lanes over 8 spheres a lane
// runs 2.9 bounces on average and the work is a few hundred MFLOP,
// microseconds at the card's float32 rate.
//
// What held the one-thread-per-lane loop back: a lane that left the loop
// idled until the last lane of its warp finished. A warp ran as many
// bounces as its longest path (8.1 on average against 2.9 per lane), so
// only 36% of the lane-bounce slots the warps issued were live.
//
// Design: a persistent kernel with a lane work queue.
//   - Only resident blocks are launched: the occupancy API's blocks per SM,
//     at most RTW_K8_WARPS_PER_SM warps' worth, times the SMs
//     (rtw_inline_occupancy). The kernel is issue-bound, and the queue only
//     thins the idle slots when each thread runs several lanes: with every
//     resident slot filled (36 warps per SM) the demo's 179 200 lanes make
//     1.2 lanes a thread and the warps stay as sparse as the one-thread
//     loop's; at 16 warps per SM a thread runs 2.7 lanes and half the
//     issued lane-bounce slots are live.
//   - Each warp loops. Its lanes whose path has ended take the next lane
//     ids from one global counter: one atomicAdd per warp per refill, each
//     idle lane's rank from __ballot_sync / __popc. A lane carries its lane
//     id i and its bounce b; its arithmetic depends on (i, b) alone
//     (Philox keyed by (seed, b) with i as the counter, or u5[b, :, i]), so
//     every lane's radiance is bit for bit what any schedule gives.
//   - The ballots and the shuffle sit at the loop's top, where the whole
//     warp has converged; the loop ends when every lane of the warp is idle
//     after a refill, a warp-uniform test.
//   - The sweep keeps the winner's index, not a running select of 10
//     attributes, and reads the winner's 7 table attributes from shared
//     memory after the loop; a miss gets zeros, as the running select
//     leaves them.
// The sphere table is staged once per block into shared memory as 11
// planes (cx, cy, cz, ck, r, albedo rgb, fuzz, ir, mat), as the TPU kernel
// held it in SMEM scalars; a warp reads each sphere as a broadcast. The
// sweep's arithmetic is K1's expression for expression on the same (cx,
// cy, cz, ck) values, so a hit gets K1's bits. The counter is a zeroed
// int32 that the caller allocates for each launch.
// scripts/torch_k7a_k8_variants.py holds the designs this one was chosen
// over (the one-thread loop, the queue or the index alone, a refill only
// when half the warp is idle, other block sizes), each bit for bit it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "shade_core.cuh"

#define RTW_INLINE_PLANES 11
#define RTW_K8_THREADS 128
// Resident warps per SM, at most: enough to keep the SM's four schedulers
// issuing, few enough that each thread runs several lanes from the queue.
#define RTW_K8_WARPS_PER_SM 16
// A warp refills when at least this many of its lanes are idle.
#define RTW_K8_REFILL 1

// The closest hit of the ray (o, d) over the staged table `sph` [11, N]:
// its distance `bt` (RTW_BIG on a miss) and the winner's 10 attributes in
// materials.attr_mat column order (zeros on a miss).
__device__ __forceinline__ void rtw_inline_sweep(
    const float* sph, int n_spheres, float tmin, float ox, float oy,
    float oz, float dx, float dy, float dz, float& bt, float* a) {
  const float* scx = sph;
  const float* scy = sph + n_spheres;
  const float* scz = sph + 2 * n_spheres;
  const float* sck = sph + 3 * n_spheres;
  const float* sattr = sph + 4 * n_spheres;  // r, ar, ag, ab, fz, ir, mt
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;
  bt = RTW_BIG;
  int bi = -1;
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
      bi = s;
    }
  }
  if (bi >= 0) {
    a[0] = scx[bi];
    a[1] = scy[bi];
    a[2] = scz[bi];
#pragma unroll
    for (int j = 0; j < 7; ++j) a[3 + j] = sattr[j * n_spheres + bi];
  } else {
#pragma unroll
    for (int j = 0; j < 10; ++j) a[j] = 0.0f;
  }
}

__global__ void __launch_bounds__(RTW_K8_THREADS) inline_kernel(
    const float* __restrict__ rays, const float* __restrict__ spheres,
    float* __restrict__ rad_out, const float* __restrict__ u5,
    int* __restrict__ next, int n_lanes, int n_spheres, int max_depth,
    float tmin, uint32_t seed) {
  extern __shared__ float sph[];  // [11, n_spheres]
  for (int k = threadIdx.x; k < RTW_INLINE_PLANES * n_spheres;
       k += blockDim.x)
    sph[k] = spheres[k];
  __syncthreads();

  const size_t n = n_lanes;
  const unsigned full = 0xffffffffu;
  const unsigned lane = threadIdx.x & 31u;
  int i = -1, b = 0;   // the lane id this thread runs (-1: idle), its bounce
  bool more = true;    // warp-uniform: the queue may still hold lanes
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tx = 1.0f, ty = 1.0f, tz = 1.0f, rx = 0.0f, ry = 0.0f, rz = 0.0f;

  for (;;) {
    const unsigned idle = __ballot_sync(full, i < 0);
    const int n_idle = __popc(idle);
    if (more && n_idle >= RTW_K8_REFILL) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next, n_idle);
      base = __shfl_sync(full, base, 0);
      more = base + n_idle < n_lanes;
      const int j = base + __popc(idle & ((1u << lane) - 1u));
      if (i < 0 && j < n_lanes) {
        i = j;
        b = 0;
        ox = rays[i]; oy = rays[n + i]; oz = rays[2 * n + i];
        dx = rays[3 * n + i]; dy = rays[4 * n + i]; dz = rays[5 * n + i];
        tx = 1.0f; ty = 1.0f; tz = 1.0f;
        rx = 0.0f; ry = 0.0f; rz = 0.0f;
      }
    }
    if (__all_sync(full, i < 0)) break;
    if (i < 0) continue;

    bool done = b >= max_depth;
    if (!done) {
      float bt, a[10];
      rtw_inline_sweep(sph, n_spheres, tmin, ox, oy, oz, dx, dy, dz, bt, a);
      float u[5];
      if (u5) {
        const float* us = u5 + (size_t)b * 5 * n;
#pragma unroll
        for (int j = 0; j < 5; ++j) u[j] = us[j * n + i];
      } else {
        rtw_uniforms<5>(seed, (uint32_t)b, (uint32_t)i, u);
      }
      const RtwShade sh = rtw_shade_core(u, bt, a, ox, oy, oz, dx, dy, dz,
                                         tx, ty, tz, true, rx, ry, rz);
      if (sh.hitm) {
        ox = sh.px; oy = sh.py; oz = sh.pz;
        dx = sh.ndx; dy = sh.ndy; dz = sh.ndz;
        tx = tx * a[4]; ty = ty * a[5]; tz = tz * a[6];
        done = ++b >= max_depth;
      } else {
        done = true;  // banked the sky: nothing more changes
      }
    }
    if (done) {
      rad_out[i] = rx;
      rad_out[n + i] = ry;
      rad_out[2 * n + i] = rz;
      i = -1;
    }
  }
}

static size_t rtw_inline_smem(int n_spheres) {
  return (size_t)RTW_INLINE_PLANES * n_spheres * sizeof(float);
}

// The kernel's registers, the blocks per SM a launch keeps resident with the
// table of `n_spheres` spheres staged, and the card's SM count.
extern "C" int rtw_inline_occupancy(int n_spheres, int* regs,
                                    int* blocks_per_sm, int* sm_count) {
  const size_t smem = rtw_inline_smem(n_spheres);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(inline_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  cudaFuncAttributes attr = {};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, inline_kernel);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, inline_kernel, RTW_K8_THREADS, smem);
  const int cap = RTW_K8_WARPS_PER_SM * 32 / RTW_K8_THREADS;
  *blocks_per_sm = per_sm < cap ? per_sm : cap;
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  *regs = attr.numRegs;
  return (int)e;
}

// rays [6, R] f32 (o xyz, d xyz); spheres [11, N] f32 planes (cx, cy, cz,
// ck, r, albedo rgb, fuzz, ir, mat); rad [3, R] f32 written; u5
// [max_depth, 5, R] f32 or NULL (in-kernel Philox); next [1] int32, zero at
// launch (the lane queue's head).
extern "C" int rtw_inline(const float* rays, const float* spheres, float* rad,
                          const float* u5, int* next, int n_lanes,
                          int n_spheres, int max_depth, float tmin,
                          unsigned int seed, void* stream) {
  if (n_lanes <= 0) return 0;
  int regs = 0, per_sm = 0, sms = 0;
  const int e = rtw_inline_occupancy(n_spheres, &regs, &per_sm, &sms);
  if (e != 0) return e;
  const int need = (n_lanes + RTW_K8_THREADS - 1) / RTW_K8_THREADS;
  const int blocks = per_sm * sms < need ? per_sm * sms : need;
  if (blocks <= 0) return (int)cudaErrorInvalidConfiguration;
  inline_kernel<<<blocks, RTW_K8_THREADS, rtw_inline_smem(n_spheres),
                  (cudaStream_t)stream>>>(rays, spheres, rad, u5, next,
                                          n_lanes, n_spheres, max_depth,
                                          tmin, seed);
  return (int)cudaGetLastError();
}
