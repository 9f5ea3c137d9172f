// K1, K3 and K10: the closest-hit ray-sphere sweep, its occupancy-masked
// form and its form fused with the winner's attribute fetch, for Hopper
// (sm_90a); and K1m, K1 for a moving scene.
//
// K1 replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/
// intersect_kernel.py :: _sweep_kernel (launched by _sweep_forward),
// forward only; K3 replaces :: _sweep_masked_kernel (launched by
// sweep_masked_planes); K10 replaces :: _sweep_fetch_kernel (below).
//
// What they compute: for each ray (each live lane, for K3), the closest
// sphere hit in [tmin, inf) with the half-b quadratic for unit directions
// (a == 1), in the TPU kernel's expanded form (sweep_core.cuh). Misses and
// K3's dead lanes return t = BIG and index 0.
//
// What bounds them on this card: operations. Each (ray, sphere) pair costs
// ~20 float32 operations against 32 bytes of traffic per ray, so at 488
// spheres a ray does ~300 operations per byte. Built with --fmad=false (so
// that the kernels match their plain versions), every add and multiply
// issues alone: the FP32 pipes' ceiling for this code is half the 67 TFLOP/s
// that counts an FMA as two operations, so a sweep reaches at most ~50% of
// the bound that chip_smoke.py reports.
//
// What the design does about it: it keeps the card full and sweeps only
// what must be swept, without touching a pair's arithmetic.
//   - Split rays within a warp. A group of P threads (P a power of two, at
//     most 32, inside one warp) sweeps one ray: part p takes spheres
//     s == p (mod P) from the table staged in shared memory, and the parts
//     merge with __shfl_xor_sync on the lexicographic minimum of (t, idx)
//     (rtw_sweep_part, rtw_merge_closest). The one-thread-per-ray loop
//     filled 12% of the thread slots at the flagship's 32 400 lanes; K1
//     takes P from the ray count (the wrapper's rule: enough threads to fill
//     the SMs' resident slots), P = 1 at full-film widths.
//   - Skip the roots of pairs that miss: the square root and the two roots
//     sit behind `disc > 0` (rtw_sweep_pair), which changes no bit.
//   - K3 compacts the live lanes of each block: a block of 256 lanes packs
//     its live lane ids into shared memory in lane order (__ballot_sync,
//     __popc and a warp scan of the 8 per-warp counts), sweeps only those,
//     with P chosen per block from its live count (up to 4 rounds), and
//     writes (BIG, 0) to the dead lanes. A block with no live lane skips the table staging.
//     The TPU kernel skipped an all-dead (64, 128) tile and swept every
//     lane of the others.
// Each lane's result lands in its own slot: no atomics, no allocation, no
// grid-wide synchronisation, and the output does not depend on block
// order. The (t, idx) of the three kernels is bit for bit
// rtw_sweep_closest's, the one-thread loop that K13 keeps and that
// sweep_fetch_one_thread_kernel keeps as the split loop's reference.
//
// K1m (sweep_motion_kernel) is K1 for a moving scene (book 2's motion blur,
// Ray Tracing: The Next Week §2; no TPU kernel had a time): each ray has a
// shutter time (the strided state's time plane), and sphere s is centred at
// c0 + time * m. The table holds two float4 a sphere, (c0x, c0y, c0z, r^2)
// and (mx, my, mz, 0), so |c|^2 - r^2 cannot be precomputed as K1's ck is:
// each pair forms its centre and that term (rtw_sweep_pair_motion), 32
// float operations where K1's pair takes 20, then K1's pair test. It is
// K1's split sweep and launch (rtw_split_sweep<true>), with its own name in
// a trace; its (t, idx) is the one-thread loop's over the moved centres,
// bit for bit, at every P (intersect_kernel.py::sweep_motion_ref).

#include <cuda_runtime.h>

#include "sweep_core.cuh"

#define RTW_SWEEP_THREADS 256

// The split sweep of K1, K1m (kMoving) and K10 up to the merge: stages the
// sphere table in `sph` (shared memory; two float4 a sphere for K1m), then
// the group of P = 2^log2p threads that holds this thread sweeps ray i,
// part p of it (at its shutter time times[i] for K1m), and merges.
// Afterwards every thread of the group holds ray i's (t, idx), or (BIG, 0)
// where i is past the rays. Every thread of the block calls it.
template <bool kMoving>
__device__ __forceinline__ void rtw_split_sweep(
    float4* sph, const float4* __restrict__ spheres,
    const float* __restrict__ rays, const float* __restrict__ times,
    int n_rays, int n_spheres, float tmin, int log2p, long long& i, int& p,
    float& best_t, int& best_i) {
  constexpr int rows = kMoving ? 2 : 1;
  for (int s = threadIdx.x; s < rows * n_spheres; s += blockDim.x)
    sph[s] = spheres[s];
  __syncthreads();

  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int P = 1 << log2p;
  i = g >> log2p;
  p = (int)(g & (P - 1));
  best_t = RTW_BIG;
  best_i = 0;
  if (i < n_rays) {
    const size_t n = n_rays;
    if constexpr (kMoving)
      rtw_sweep_part_motion(sph, n_spheres, p, P, times[i], rays[i],
                            rays[n + i], rays[2 * n + i], rays[3 * n + i],
                            rays[4 * n + i], rays[5 * n + i], tmin, best_t,
                            best_i);
    else
      rtw_sweep_part(sph, n_spheres, p, P, rays[i], rays[n + i],
                     rays[2 * n + i], rays[3 * n + i], rays[4 * n + i],
                     rays[5 * n + i], tmin, best_t, best_i);
  }
  rtw_merge_closest(best_t, best_i, P);  // every lane of the warp
}

__global__ void __launch_bounds__(RTW_SWEEP_THREADS)
    sweep_kernel(const float* __restrict__ rays,
                 const float4* __restrict__ spheres, int n_rays,
                 int n_spheres, float tmin, int log2p,
                 float* __restrict__ t_out, int* __restrict__ idx_out) {
  extern __shared__ float4 sph[];
  long long i;
  int p, best_i;
  float best_t;
  rtw_split_sweep<false>(sph, spheres, rays, nullptr, n_rays, n_spheres,
                         tmin, log2p, i, p, best_t, best_i);
  if (i < n_rays && p == 0) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
  }
}

// K1m: K1 over the moving table, each ray at its shutter time.
__global__ void __launch_bounds__(RTW_SWEEP_THREADS)
    sweep_motion_kernel(const float* __restrict__ rays,
                        const float* __restrict__ times,
                        const float4* __restrict__ spheres, int n_rays,
                        int n_spheres, float tmin, int log2p,
                        float* __restrict__ t_out,
                        int* __restrict__ idx_out) {
  extern __shared__ float4 sph[];
  long long i;
  int p, best_i;
  float best_t;
  rtw_split_sweep<true>(sph, spheres, rays, times, n_rays, n_spheres, tmin,
                        log2p, i, p, best_t, best_i);
  if (i < n_rays && p == 0) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
  }
}

// The launch of K1, K1m and K10: log2 of `parts` (a power of two in
// [1, 32]), the block count, and the sphere table's shared memory (`rows`
// float4 a sphere) reserved for `kernel`. Returns the error, or
// cudaSuccess.
static cudaError_t rtw_split_launch(const void* kernel, int n_rays,
                                    int n_spheres, int rows, int parts,
                                    int* log2p, int* blocks, size_t* smem) {
  if (parts < 1 || parts > 32 || (parts & (parts - 1)))
    return cudaErrorInvalidValue;
  *log2p = __builtin_ctz(parts);
  const long long threads = (long long)n_rays << *log2p;
  *blocks = (int)((threads + RTW_SWEEP_THREADS - 1) / RTW_SWEEP_THREADS);
  *smem = (size_t)n_spheres * rows * sizeof(float4);
  return rtw_reserve_smem(kernel, *smem);
}

// rays: [6, n_rays] f32 planes (ox, oy, oz, dx, dy, dz); spheres: [n, 4] f32
// rows (cx, cy, cz, ck); parts: P, a power of two in [1, 32]. Launches on
// `stream`; returns the launch's error.
extern "C" int rtw_sweep(const float* rays, const float* spheres, int n_rays,
                         int n_spheres, float tmin, float* t_out, int* idx_out,
                         int parts, void* stream) {
  if (n_rays <= 0) return 0;
  int log2p, blocks;
  size_t smem;
  cudaError_t e = rtw_split_launch((const void*)sweep_kernel, n_rays,
                                   n_spheres, 1, parts, &log2p, &blocks,
                                   &smem);
  if (e != cudaSuccess) return (int)e;
  sweep_kernel<<<blocks, RTW_SWEEP_THREADS, smem, (cudaStream_t)stream>>>(
      rays, reinterpret_cast<const float4*>(spheres), n_rays, n_spheres, tmin,
      log2p, t_out, idx_out);
  return (int)cudaGetLastError();
}

// K1m. rays: [6, n_rays] f32 planes; times: [n_rays] f32; spheres: [n, 8]
// f32 rows (c0x, c0y, c0z, r^2, mx, my, mz, 0); parts as rtw_sweep's.
extern "C" int rtw_sweep_motion(const float* rays, const float* times,
                                const float* spheres, int n_rays,
                                int n_spheres, float tmin, float* t_out,
                                int* idx_out, int parts, void* stream) {
  if (n_rays <= 0) return 0;
  int log2p, blocks;
  size_t smem;
  cudaError_t e = rtw_split_launch((const void*)sweep_motion_kernel, n_rays,
                                   n_spheres, 2, parts, &log2p, &blocks,
                                   &smem);
  if (e != cudaSuccess) return (int)e;
  sweep_motion_kernel<<<blocks, RTW_SWEEP_THREADS, smem,
                        (cudaStream_t)stream>>>(
      rays, times, reinterpret_cast<const float4*>(spheres), n_rays,
      n_spheres, tmin, log2p, t_out, idx_out);
  return (int)cudaGetLastError();
}

// K3. Each block takes 256 lanes, one per thread. `parts` is P for every
// block, or 0: each block takes the largest P <= min(p_cap, 16) with
// n_live * P <= 4 * 256, at most 4 rounds of its live lanes (a dense block
// takes P = 4, a sparse one 16; P = 32 loses to 16 on sparse blocks and one
// round at P = 1 to four at P = 4 on dense ones, PERF.md). The bound of 8
// blocks per SM holds the kernel to 32 registers (34 unbounded, which fits
// 6 blocks), without a spill.
__global__ void __launch_bounds__(RTW_SWEEP_THREADS, 8)
    sweep_masked_kernel(const float* __restrict__ rays,
                        const int* __restrict__ alive,
                        const float4* __restrict__ spheres, int n_rays,
                        int n_spheres, float tmin, int parts, int p_cap,
                        float* __restrict__ t_out,
                        int* __restrict__ idx_out) {
  constexpr int NW = RTW_SWEEP_THREADS / 32;
  extern __shared__ float4 sph[];
  __shared__ int ids[RTW_SWEEP_THREADS];
  __shared__ int base[NW + 1];  // per-warp offsets; base[NW] = total
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // Dead lanes get (BIG, 0); each warp counts its live lanes.
  const long long i0 = (long long)blockIdx.x * RTW_SWEEP_THREADS + threadIdx.x;
  const bool in = i0 < n_rays;
  const bool live = in && alive[i0] != 0;
  if (in && !live) {
    t_out[i0] = RTW_BIG;
    idx_out[i0] = 0;
  }
  const unsigned m = __ballot_sync(0xffffffffu, live);
  if (lane == 0) base[warp] = __popc(m);
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the NW per-warp counts
    const int v = lane < NW ? base[lane] : 0;
    int incl = v;
    for (int off = 1; off < NW; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += u;
    }
    if (lane < NW) base[lane] = incl - v;
    if (lane == NW - 1) base[NW] = incl;
  }
  __syncthreads();
  const int n_live = base[NW];
  if (n_live == 0) return;  // the whole block is dead: no staging

  // Pack the live lane ids in lane order, and stage the sphere table.
  if (live) ids[base[warp] + __popc(m & ((1u << lane) - 1u))] = (int)i0;
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) sph[s] = spheres[s];
  __syncthreads();

  int P = parts;
  if (P == 0) {
    P = p_cap < 16 ? p_cap : 16;
    while (P > 1 && n_live * P > 4 * RTW_SWEEP_THREADS) P >>= 1;
  }
  const int log2p = __ffs(P) - 1;
  const int per_round = RTW_SWEEP_THREADS >> log2p;
  const int p = threadIdx.x & (P - 1);
  const size_t n = n_rays;
  for (int r0 = 0; r0 < n_live; r0 += per_round) {  // block-uniform
    const int j = r0 + (threadIdx.x >> log2p);
    float best_t = RTW_BIG;
    int best_i = 0, i = 0;
    if (j < n_live) {
      i = ids[j];
      rtw_sweep_part(sph, n_spheres, p, P, rays[i], rays[n + i],
                     rays[2 * n + i], rays[3 * n + i], rays[4 * n + i],
                     rays[5 * n + i], tmin, best_t, best_i);
    }
    rtw_merge_closest(best_t, best_i, P);  // every lane of the warp
    if (j < n_live && p == 0) {
      t_out[i] = best_t;
      idx_out[i] = best_i;
    }
  }
}

// rays: [6, n_rays] f32 planes; alive: [n_rays] i32; spheres: [n, 4] f32;
// parts: 0 (per block) or a power of two in [1, 32].
extern "C" int rtw_sweep_masked(const float* rays, const int* alive,
                                const float* spheres, int n_rays,
                                int n_spheres, float tmin, float* t_out,
                                int* idx_out, int parts, void* stream) {
  if (n_rays <= 0) return 0;
  if (parts < 0 || parts > 32 || (parts & (parts - 1)))
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)(((long long)n_rays + RTW_SWEEP_THREADS - 1) /
                           RTW_SWEEP_THREADS);
  const size_t smem = (size_t)n_spheres * sizeof(float4);
  cudaError_t e = rtw_reserve_smem((const void*)sweep_masked_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sweep_masked_kernel<<<blocks, RTW_SWEEP_THREADS, smem,
                        (cudaStream_t)stream>>>(
      rays, alive, reinterpret_cast<const float4*>(spheres), n_rays,
      n_spheres, tmin, parts, rtw_parts_cap(n_spheres), t_out, idx_out);
  return (int)cudaGetLastError();
}

// K10: the closest-hit sweep fused with the fetch of the winner's attributes.
//
// Replaces the TPU kernel raytracingweekend_jl_tpu/ops/pallas/intersect_kernel.py
// :: _sweep_fetch_kernel (launched by _sweep_fetch_forward), the
// `fused_attrs=True` route of the fixed-depth wavefront.
//
// What it computes: K1's closest hit (t, idx), bit for bit; then the
// winner's 10 attributes in materials.attr_mat column order (center xyz,
// radius, albedo rgb, fuzz, ir, mat as a float) as [10, R] planes. A miss
// writes (BIG, 0) and ten zeros, the TPU kernel's raw outputs; the wrapper
// applies the miss defaults.
//
// What bounds it: as K1, arithmetic (~20 flops per ray and sphere); it
// writes 40 more bytes per ray than K1.
//
// Design: the TPU carried ten running selects per sphere because its vector
// unit had no gather. Here K1's launch does the sweep (256 threads, the
// sphere table alone in shared memory, P threads of a warp per ray with the
// roots behind `disc > 0`, P from the wrapper's rule), and after the merge
// the group's first thread writes (t, idx) and reads the winner's row of
// the [N, 10] table (19.5 KB at 488 spheres, held in L1 and L2) through the
// read-only path, as rtw_fetch_row does, and writes the ten planes. No
// attribute table is staged: a shared one costs every block 19.5 KB of
// copying for one row read per ray.
__global__ void __launch_bounds__(RTW_SWEEP_THREADS)
    sweep_fetch_kernel(const float* __restrict__ rays,
                       const float4* __restrict__ spheres,
                       const float* __restrict__ amat, int n_rays,
                       int n_spheres, float tmin, int log2p,
                       float* __restrict__ t_out, int* __restrict__ idx_out,
                       float* __restrict__ attrs_out) {
  extern __shared__ float4 sph[];
  long long i;
  int p, best_i;
  float best_t;
  rtw_split_sweep<false>(sph, spheres, rays, nullptr, n_rays, n_spheres,
                         tmin, log2p, i, p, best_t, best_i);
  const size_t n = n_rays;
  if (i < n_rays && p == 0) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
    const bool hit = best_t < RTW_BIG;
    const float* row = amat + 10 * (size_t)best_i;
#pragma unroll
    for (int j = 0; j < 10; ++j)
      attrs_out[j * n + i] = hit ? __ldg(row + j) : 0.0f;
  }
}

// rays: [6, n_rays] f32 planes; spheres: [n, 4] f32 rows (cx, cy, cz, ck);
// amat: [n, 10] f32 rows (materials.attr_mat); attrs: [10, n_rays] f32;
// parts: P, a power of two in [1, 32].
extern "C" int rtw_sweep_fetch(const float* rays, const float* spheres,
                               const float* amat, int n_rays, int n_spheres,
                               float tmin, float* t_out, int* idx_out,
                               float* attrs_out, int parts, void* stream) {
  if (n_rays <= 0) return 0;
  int log2p, blocks;
  size_t smem;
  cudaError_t e = rtw_split_launch((const void*)sweep_fetch_kernel, n_rays,
                                   n_spheres, 1, parts, &log2p, &blocks,
                                   &smem);
  if (e != cudaSuccess) return (int)e;
  sweep_fetch_kernel<<<blocks, RTW_SWEEP_THREADS, smem,
                       (cudaStream_t)stream>>>(
      rays, reinterpret_cast<const float4*>(spheres), amat, n_rays, n_spheres,
      tmin, log2p, t_out, idx_out, attrs_out);
  return (int)cudaGetLastError();
}

// The previous K10, kept as the independent reference of the split
// schedule: one thread per ray through rtw_sweep_closest (the roots on
// every pair), 128 threads per block, the sphere and attribute tables
// staged in shared memory (56 bytes per sphere). No route launches it; the
// card checks hold K1, K3 and K10 bit for bit against it.
__global__ void sweep_fetch_one_thread_kernel(
    const float* __restrict__ rays, const float4* __restrict__ spheres,
    const float* __restrict__ amat, int n_rays, int n_spheres, float tmin,
    float* __restrict__ t_out, int* __restrict__ idx_out,
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

#define RTW_ONE_THREAD_THREADS 128

// Arguments as rtw_sweep_fetch's, without parts.
extern "C" int rtw_sweep_fetch_one_thread(const float* rays,
                                          const float* spheres,
                                          const float* amat, int n_rays,
                                          int n_spheres, float tmin,
                                          float* t_out, int* idx_out,
                                          float* attrs_out, void* stream) {
  if (n_rays <= 0) return 0;
  const int blocks = (n_rays + RTW_ONE_THREAD_THREADS - 1) /
                     RTW_ONE_THREAD_THREADS;
  const size_t smem = (size_t)n_spheres * (sizeof(float4) + 10 * sizeof(float));
  cudaError_t e =
      rtw_reserve_smem((const void*)sweep_fetch_one_thread_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  sweep_fetch_one_thread_kernel<<<blocks, RTW_ONE_THREAD_THREADS, smem,
                                  (cudaStream_t)stream>>>(
      rays, reinterpret_cast<const float4*>(spheres), amat, n_rays, n_spheres,
      tmin, t_out, idx_out, attrs_out);
  return (int)cudaGetLastError();
}

// The registers per thread of kernel `which` (0: K1, 1: K3, 2: K10, 3: the
// one-thread reference, 4: K1m), the blocks of it that one SM holds at the launch's
// block size and shared memory for `n_spheres`, and the device's SM count.
extern "C" int rtw_sweep_occupancy(int which, int n_spheres, int* regs,
                                   int* blocks_per_sm, int* sm_count) {
  const void* k;
  int threads = RTW_SWEEP_THREADS;
  size_t smem = (size_t)n_spheres * sizeof(float4);
  if (which == 0) {
    k = (const void*)sweep_kernel;
  } else if (which == 1) {
    k = (const void*)sweep_masked_kernel;
  } else if (which == 2) {
    k = (const void*)sweep_fetch_kernel;
  } else if (which == 3) {
    k = (const void*)sweep_fetch_one_thread_kernel;
    threads = RTW_ONE_THREAD_THREADS;
    smem += (size_t)n_spheres * 10 * sizeof(float);
  } else if (which == 4) {
    k = (const void*)sweep_motion_kernel;
    smem *= 2;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaFuncAttributes a = {};
  cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e == cudaSuccess) e = rtw_reserve_smem(k, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                      threads, smem);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  *regs = a.numRegs;
  return (int)e;
}

extern "C" const char* rtw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
