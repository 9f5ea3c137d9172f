// K1: closest-hit ray-sphere sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/intersect_kernel.py
// :: _sweep_kernel (launched by _sweep_forward), forward only.
//
// What it computes: for each ray, the closest sphere hit in [tmin, inf) with
// the half-b quadratic for unit directions (a == 1), in the TPU kernel's
// expanded form:
//     od = o.d, oo = |o|^2, ck = |c|^2 - r^2 (precomputed per sphere)
//     hb = od - c.d,  c = oo - 2 o.c + ck,  disc = hb^2 - c
//     t  = near root if >= tmin, else far root
//     accept if disc > 0 and t >= tmin and t < best_t (strict: ties keep the
//     first index)
// Misses return t = BIG and index 0.
//
// What bounds it on the card: arithmetic. Each ray reads 24 bytes and writes
// 8, then does ~20 flops per sphere; at the flagship width (32 400 rays x 488
// spheres) that is ~0.3 GFLOP per launch against ~1 MB of traffic. The sphere
// table is the only shared operand.
//
// Design: one thread per ray, ray state in registers. The sphere table
// (cx, cy, cz, ck) is staged once per block into shared memory as float4
// (488 spheres = 7.8 KB), so the inner loop issues one 16-byte shared load
// per sphere, broadcast to the whole warp, and no global traffic. The
// TPU kernel held spheres in SMEM scalars and rays in vector tiles; here the
// same split falls out of the thread model. Built with --fmad=false so its
// arithmetic matches the plain PyTorch version (sweep_ref) operation for
// operation. The loop itself is sweep_core.cuh's, shared with every kernel
// that sweeps.

#include <cuda_runtime.h>

#include "sweep_core.cuh"

__global__ void sweep_kernel(const float* __restrict__ rays,
                             const float4* __restrict__ spheres,
                             int n_rays, int n_spheres, float tmin,
                             float* __restrict__ t_out,
                             int* __restrict__ idx_out) {
  extern __shared__ float4 sph[];
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) sph[s] = spheres[s];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const float ox = rays[i], oy = rays[n_rays + i], oz = rays[2 * n_rays + i];
  const float dx = rays[3 * n_rays + i], dy = rays[4 * n_rays + i],
              dz = rays[5 * n_rays + i];

  float best_t;
  int best_i;
  rtw_sweep_closest(sph, n_spheres, ox, oy, oz, dx, dy, dz, tmin, best_t,
                    best_i);
  t_out[i] = best_t;
  idx_out[i] = best_i;
}

// rays: [6, n_rays] f32 planes (ox, oy, oz, dx, dy, dz); spheres: [n, 4] f32
// rows (cx, cy, cz, ck). Launches on `stream`; returns the launch's error.
extern "C" int rtw_sweep(const float* rays, const float* spheres, int n_rays,
                         int n_spheres, float tmin, float* t_out, int* idx_out,
                         void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  const size_t smem = (size_t)n_spheres * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweep_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      rays, reinterpret_cast<const float4*>(spheres), n_rays, n_spheres, tmin,
      t_out, idx_out);
  return (int)cudaGetLastError();
}

// K3: the occupancy-masked sweep of the gradient path's record phases.
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/intersect_kernel.py
// :: _sweep_masked_kernel (launched by sweep_masked_planes). The TPU kernel
// skipped a (64, 128) tile whose lanes were all dead and swept every lane of
// a live tile; its host code then masked dead lanes per lane off the TPU
// (persist_grad_kernel.py:955-958). Here the mask is per lane: a dead lane
// returns (BIG, 0) and does not sweep, and a block whose lanes are all dead
// skips the staging of the sphere table as well (__syncthreads_or). Live
// lanes run K1's loop, so they get K1's (t, idx) bit for bit.
//
// What bounds it: as K1, arithmetic per live lane; the record phase's
// occupancy falls from 1 to a few percent, and dead lanes cost one load and
// two stores.
__global__ void sweep_masked_kernel(const float* __restrict__ rays,
                                    const int* __restrict__ alive,
                                    const float4* __restrict__ spheres,
                                    int n_rays, int n_spheres, float tmin,
                                    float* __restrict__ t_out,
                                    int* __restrict__ idx_out) {
  extern __shared__ float4 sph[];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n_rays && alive[i] != 0;
  if (!__syncthreads_or(live)) {  // the whole block is dead
    if (i < n_rays) {
      t_out[i] = RTW_BIG;
      idx_out[i] = 0;
    }
    return;
  }
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) sph[s] = spheres[s];
  __syncthreads();
  if (i >= n_rays) return;
  if (!live) {
    t_out[i] = RTW_BIG;
    idx_out[i] = 0;
    return;
  }
  const size_t n = n_rays;
  const float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  const float dx = rays[3 * n + i], dy = rays[4 * n + i],
              dz = rays[5 * n + i];

  float best_t;
  int best_i;
  rtw_sweep_closest(sph, n_spheres, ox, oy, oz, dx, dy, dz, tmin, best_t,
                    best_i);
  t_out[i] = best_t;
  idx_out[i] = best_i;
}

// rays: [6, n_rays] f32 planes; alive: [n_rays] i32; spheres: [n, 4] f32.
extern "C" int rtw_sweep_masked(const float* rays, const int* alive,
                                const float* spheres, int n_rays,
                                int n_spheres, float tmin, float* t_out,
                                int* idx_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  const size_t smem = (size_t)n_spheres * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_masked_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweep_masked_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      rays, alive, reinterpret_cast<const float4*>(spheres), n_rays,
      n_spheres, tmin, t_out, idx_out);
  return (int)cudaGetLastError();
}

// K10: the closest-hit sweep fused with the fetch of the winner's attributes.
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/intersect_kernel.py
// :: _sweep_fetch_kernel (launched by _sweep_fetch_forward), the
// `fused_attrs=True` route of the fixed-depth wavefront.
//
// What it computes: K1's (t, idx), with K1's expressions in K1's order, so t
// and idx are K1's bit for bit; then the winner's 10 attributes in
// materials.attr_mat column order (center xyz, radius, albedo rgb, fuzz, ir,
// mat as a float). A miss writes (BIG, 0) and ten zeros, the TPU kernel's
// raw outputs; the wrapper applies the miss defaults.
//
// What bounds it: as K1, arithmetic (~20 flops per ray and sphere); it
// writes 40 more bytes per ray than K1.
//
// Design: the TPU carried ten running selects per sphere because its vector
// unit had no gather. Here the loop is K1's, and after it one thread reads
// its winner's row from the attribute table staged in shared memory beside
// the sphere table (56 bytes per sphere, 27 KB for the flagship's 488): the
// same function with ten fewer live registers in the loop.
__global__ void sweep_fetch_kernel(const float* __restrict__ rays,
                                   const float4* __restrict__ spheres,
                                   const float* __restrict__ amat,
                                   int n_rays, int n_spheres, float tmin,
                                   float* __restrict__ t_out,
                                   int* __restrict__ idx_out,
                                   float* __restrict__ attrs_out) {
  extern __shared__ float4 sph[];
  float* sattr = reinterpret_cast<float*>(sph + n_spheres);
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) sph[s] = spheres[s];
  for (int j = threadIdx.x; j < 10 * n_spheres; j += blockDim.x)
    sattr[j] = amat[j];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_rays) return;
  const size_t n = n_rays;
  const float ox = rays[i], oy = rays[n + i], oz = rays[2 * n + i];
  const float dx = rays[3 * n + i], dy = rays[4 * n + i],
              dz = rays[5 * n + i];

  float best_t;
  int best_i;
  rtw_sweep_closest(sph, n_spheres, ox, oy, oz, dx, dy, dz, tmin, best_t,
                    best_i);
  t_out[i] = best_t;
  idx_out[i] = best_i;
  const bool hit = best_t < RTW_BIG;
  const float* row = sattr + 10 * best_i;
#pragma unroll
  for (int j = 0; j < 10; ++j) attrs_out[j * n + i] = hit ? row[j] : 0.0f;
}

// rays: [6, n_rays] f32 planes; spheres: [n, 4] f32 rows (cx, cy, cz, ck);
// amat: [n, 10] f32 rows (materials.attr_mat); attrs: [10, n_rays] f32.
extern "C" int rtw_sweep_fetch(const float* rays, const float* spheres,
                               const float* amat, int n_rays, int n_spheres,
                               float tmin, float* t_out, int* idx_out,
                               float* attrs_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_rays + threads - 1) / threads;
  const size_t smem = (size_t)n_spheres * (sizeof(float4) + 10 * sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sweep_fetch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sweep_fetch_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      rays, reinterpret_cast<const float4*>(spheres), amat, n_rays, n_spheres,
      tmin, t_out, idx_out, attrs_out);
  return (int)cudaGetLastError();
}

extern "C" const char* rtw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
