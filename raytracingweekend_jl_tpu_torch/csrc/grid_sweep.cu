// K13: the two-level (cluster-bounded) closest-hit sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel
// raytracingweekend_jl_tpu/ops/pallas/experimental/grid_kernel.py ::
// _grid_sweep_kernel (launched by grid_sweep). The plain PyTorch version is
// raytracingweekend_jl_tpu_torch/ops/cuda/grid_kernel.py :: grid_sweep_ref;
// the host-side tables come from ops/experimental/grid.py :: build_grid.
//
// What it computes, per ray: K1's closest hit (sweep_core.cuh) over a
// permuted sphere table laid out as [global spheres..., cluster 0's P
// slots..., cluster 1's...], where padding slots carry ck = 1e30 and never
// hit. The global spheres are swept unconditionally. Each cluster has a
// bounding sphere (bx, by, bz, bk); a cluster's P slots are swept only if
// some ray of the warp can still reach its bound: disc > 0, exit >= tmin
// and entry < that ray's best t so far. The bound contains its members, so
// no hit is culled and the winners are the flat sweep's. The winner's slot
// maps back through `im` to its index in the scene (0 on a miss). `skips`
// counts, per warp of 32 consecutive rays, the clusters it culled.
//
// What bounds it on the card: arithmetic, as K1: ~20 flops per ray and
// swept sphere (the global ones, every cluster's bound and the slots of the
// clusters a warp runs) against 32 bytes of ray traffic per ray.
// --fmad=false holds a sweep near half the bound (one FADD or FMUL per
// flop, where the card's peak counts an FMA as two).
//
// Design (grid_sweep_kernel): one thread per ray, 128-ray blocks, the
// permuted table and the cluster bounds staged into each block's shared
// memory (12.2 KB at the flagship's 724 slots and 36 clusters). The TPU
// kernel decided per block of 8 192 rays with a vector any(); a GPU thread
// can branch on its own, but a warp executes a branch for all its lanes, so
// the unit of culling here is the warp: __any_sync over the bound test. A
// lane past the end of the rays takes part in the vote with reach = false.
// Every pair (global spheres, cluster slots) takes rtw_sweep_pair, and the
// bound test takes its square root behind `disc > 0`: a warp whose pairs
// all miss skips the roots. The same bits: a pair with disc <= 0 is never
// accepted, and `reach` is false whenever disc <= 0. That alone made the
// sweep 1.6-1.9x faster than the previous kernel on the flagship's rays.
// The index map is read once per ray, from global memory.
// Other designs give the same bits and measured slower
// (scripts/torch_k9_k13_variants.py builds and times them; PERF.md):
// persistent blocks, as many as the card holds, staging the table once and
// looping over tiles (their static split of the tiles leaves a tail);
// 256- and 512-ray blocks; the tables read through the read-only path
// without staging; each ray split over Q = 2 or 4 threads (rtw_sweep_part's
// interleave, the parts' best t merged before each bound test, the unit's
// vote across its warps with __syncthreads_or).
// Built with --fmad=false, as K1.
//
// grid_sweep_all_roots_kernel is the kernel before the redesign, kept on
// no route as the bitwise reference of the new one on the card: one block
// per 128 rays staging the table and the index map, rtw_sweep_one on every
// pair, the bound's root before its `disc > 0` test.

#include <cuda_runtime.h>

#include "sweep_core.cuh"

#define RTW_GRID_THREADS 128

__global__ void __launch_bounds__(RTW_GRID_THREADS)
    grid_sweep_kernel(const float* __restrict__ rays,
                      const float4* __restrict__ sph,
                      const int* __restrict__ im,
                      const float4* __restrict__ bnd, int n_rays,
                      int n_global, int K, int P, float tmin,
                      float* __restrict__ t_out, int* __restrict__ idx_out,
                      int* __restrict__ skips) {
  extern __shared__ float4 smem[];
  const int total = n_global + K * P;
  float4* s_sph = smem;
  float4* s_bnd = smem + total;
  for (int s = threadIdx.x; s < total; s += blockDim.x) s_sph[s] = sph[s];
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_bnd[k] = bnd[k];
  __syncthreads();

  const int i = blockIdx.x * RTW_GRID_THREADS + threadIdx.x;
  const bool valid = i < n_rays;
  const size_t n = n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (valid) {
    ox = rays[i]; oy = rays[n + i]; oz = rays[2 * n + i];
    dx = rays[3 * n + i]; dy = rays[4 * n + i]; dz = rays[5 * n + i];
  }
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;

  float best_t = RTW_BIG;
  int best_s = 0;
  for (int s = 0; s < n_global; ++s)
    rtw_sweep_pair(s_sph[s], s, ox, oy, oz, dx, dy, dz, od, oo, tmin, best_t,
                   best_s);

  int culled = 0;
  for (int k = 0; k < K; ++k) {
    const float4 b = s_bnd[k];
    const float cd = b.x * dx + b.y * dy + b.z * dz;
    const float oc = b.x * ox + b.y * oy + b.z * oz;
    const float hb = od - cd;
    const float cq = oo - 2.0f * oc + b.w;
    const float disc = hb * hb - cq;
    bool reach = false;
    if (valid && disc > 0.0f) {
      const float sq = sqrtf(disc);
      reach = -hb + sq >= tmin && -hb - sq < best_t;
    }
    if (__any_sync(0xffffffffu, reach)) {
      const int base = n_global + k * P;
#pragma unroll 4
      for (int j = 0; j < P; ++j)
        rtw_sweep_pair(s_sph[base + j], base + j, ox, oy, oz, dx, dy, dz, od,
                       oo, tmin, best_t, best_s);
    } else {
      ++culled;
    }
  }
  if (!valid) return;
  t_out[i] = best_t;
  idx_out[i] = best_t < RTW_BIG ? __ldg(im + best_s) : 0;
  if ((threadIdx.x & 31) == 0) skips[i >> 5] = culled;
}

static inline size_t rtw_grid_smem(int n_global, int K, int P) {
  return ((size_t)n_global + (size_t)K * P + K) * sizeof(float4);
}

// rays [6, R] f32 planes; sph [n_global + K*P, 4] f32 rows (cx, cy, cz, ck)
// in the grid's slot order; im [n_global + K*P] i32; bnd [K, 4] f32
// (bx, by, bz, bk); t [R] f32, idx [R] i32, skips [ceil(R / 32)] i32.
extern "C" int rtw_grid_sweep(const float* rays, const float* sph,
                              const int* im, const float* bnd, int n_rays,
                              int n_global, int K, int P, float tmin,
                              float* t_out, int* idx_out, int* skips,
                              void* stream) {
  if (n_rays <= 0) return 0;
  const size_t smem = rtw_grid_smem(n_global, K, P);
  cudaError_t e = rtw_reserve_smem((const void*)grid_sweep_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n_rays + RTW_GRID_THREADS - 1) / RTW_GRID_THREADS;
  grid_sweep_kernel<<<blocks, RTW_GRID_THREADS, smem, (cudaStream_t)stream>>>(
      rays, reinterpret_cast<const float4*>(sph), im,
      reinterpret_cast<const float4*>(bnd), n_rays, n_global, K, P, tmin,
      t_out, idx_out, skips);
  return (int)cudaGetLastError();
}

// K13's registers per thread, the blocks of it that one SM holds at its
// block size and shared memory for these tables, and the device's SM count.
extern "C" int rtw_grid_sweep_occupancy(int n_global, int K, int P, int* regs,
                                        int* blocks_per_sm, int* sm_count) {
  const size_t smem = rtw_grid_smem(n_global, K, P);
  cudaFuncAttributes a = {};
  cudaError_t e = cudaFuncGetAttributes(&a, grid_sweep_kernel);
  if (e == cudaSuccess)
    e = rtw_reserve_smem((const void*)grid_sweep_kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, grid_sweep_kernel, RTW_GRID_THREADS, smem);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  *regs = a.numRegs;
  return (int)e;
}

// -- the kernel before the redesign, kept as the reference ------------------

__global__ void grid_sweep_all_roots_kernel(
    const float* __restrict__ rays, const float4* __restrict__ sph,
    const int* __restrict__ im, const float4* __restrict__ bnd, int n_rays,
    int n_global, int K, int P, float tmin, float* __restrict__ t_out,
    int* __restrict__ idx_out, int* __restrict__ skips) {
  extern __shared__ float4 smem[];
  const int total = n_global + K * P;
  float4* s_sph = smem;
  float4* s_bnd = smem + total;
  int* s_im = reinterpret_cast<int*>(s_bnd + K);
  for (int s = threadIdx.x; s < total; s += blockDim.x) {
    s_sph[s] = sph[s];
    s_im[s] = im[s];
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) s_bnd[k] = bnd[k];
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = i < n_rays;
  const size_t n = n_rays;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  if (valid) {
    ox = rays[i]; oy = rays[n + i]; oz = rays[2 * n + i];
    dx = rays[3 * n + i]; dy = rays[4 * n + i]; dz = rays[5 * n + i];
  }
  const float od = ox * dx + oy * dy + oz * dz;
  const float oo = ox * ox + oy * oy + oz * oz;

  float best_t = RTW_BIG;
  int best_s = 0;
  for (int s = 0; s < n_global; ++s)
    rtw_sweep_one(s_sph[s], s, ox, oy, oz, dx, dy, dz, od, oo, tmin, best_t,
                  best_s);

  int culled = 0;
  for (int k = 0; k < K; ++k) {
    const float4 b = s_bnd[k];
    const float cd = b.x * dx + b.y * dy + b.z * dz;
    const float oc = b.x * ox + b.y * oy + b.z * oz;
    const float hb = od - cd;
    const float cq = oo - 2.0f * oc + b.w;
    const float disc = hb * hb - cq;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const bool reach = valid && disc > 0.0f && -hb + sq >= tmin &&
                       -hb - sq < best_t;
    if (__any_sync(0xffffffffu, reach)) {
      const int base = n_global + k * P;
#pragma unroll 4
      for (int j = 0; j < P; ++j)
        rtw_sweep_one(s_sph[base + j], base + j, ox, oy, oz, dx, dy, dz, od,
                      oo, tmin, best_t, best_s);
    } else {
      ++culled;
    }
  }
  if (!valid) return;
  t_out[i] = best_t;
  idx_out[i] = best_t < RTW_BIG ? s_im[best_s] : 0;
  if ((threadIdx.x & 31) == 0) skips[i >> 5] = culled;
}

// Arguments as rtw_grid_sweep's.
extern "C" int rtw_grid_sweep_all_roots(const float* rays, const float* sph,
                                        const int* im, const float* bnd,
                                        int n_rays, int n_global, int K, int P,
                                        float tmin, float* t_out, int* idx_out,
                                        int* skips, void* stream) {
  if (n_rays <= 0) return 0;
  const int threads = 128;  // whole warps: every lane votes
  const int blocks = (n_rays + threads - 1) / threads;
  const size_t total = (size_t)n_global + (size_t)K * P;
  const size_t smem = total * (sizeof(float4) + sizeof(int)) + K * sizeof(float4);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        grid_sweep_all_roots_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  grid_sweep_all_roots_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      rays, reinterpret_cast<const float4*>(sph), im,
      reinterpret_cast<const float4*>(bnd), n_rays, n_global, K, P, tmin,
      t_out, idx_out, skips);
  return (int)cudaGetLastError();
}
