// K4: one record iteration of the persistent-record gradient path, with
// its winner fetch, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// raytracingweekend_jl_tpu/ops/pallas/persist_grad_kernel.py ::
// _persist_record_kernel (launched by persist_record_step), whose state
// machine is _advance_record_bank, and the winner fetch the TPU ran before
// it in XLA (materials.fetch_attr_planes, a one-hot matrix product there).
// The plain PyTorch version is
// raytracingweekend_jl_tpu_torch/ops/cuda/persist_grad_kernel.py ::
// persist_record_fetch_ref (the gather, then persist_record_step_ref).
//
// What it computes, per lane: each lane owns S rays spaced W lanes apart
// (its strips) and traces them one after another. It reads its winner's 10
// attributes from the sweep's index, shades the swept bounce
// (shade_core.cuh), banks T * sky(d) of a missing ray into that strip's
// radiance planes, advances a continuing ray, and refills a terminated lane
// with its next strip's camera ray. Before the update it writes slot `slot`
// of the residual record: the bounce's inputs o, d, T, the hit distance t,
// the packed event flags act | hit<<1 | term<<2 | regen<<3 | strip<<4
// (stored bit for bit in a float plane), and, for the full 21-plane record,
// the winner's 10 attributes (sphere 0's row on a miss, where the sweep's
// index is 0, as the gather gives). An inactive lane changes nothing and
// writes a zero record.
//
// What bounds it on the card: memory traffic. A live lane reads ~90 bytes
// (state, t, idx, its next strip's ray; its 40-byte table row comes from
// L1) and writes ~120 (state and 21 record words); at the flagship width
// (262 144 lanes) one launch moves ~35 MB, about 10 us of HBM time.
//
// Design: one thread per lane, [plane, lane] layout so every access of a
// warp is one coalesced segment per plane.
//   - The winner's row is read from the [N, 10] table through the
//     read-only path (as K2), in place of ten planes written by a gather
//     launch and read back.
//   - The record is stored with the evict-first hint (__stcs): only the
//     replay reads it, after the phase, while the next iteration rereads
//     the state, which keeps the default policy.
// Two other designs gave the same bits and measured slower at the flagship
// step's iterations 20 and 40 (scripts/torch_k2_k4_variants.py builds and
// times them): a copy of the table in each block's shared memory, and each
// block's live lanes compacted onto full warps (a ballot, a scan of the
// warp counts and a barrier per block cost more than the idle threads of
// one thread per lane). The TPU kernel banked and refilled with masked
// blends over all S strips (9S planes read and written per lane); here a
// lane reads and writes only the strip it needs. Record offsets are
// 64-bit: n_slots x 21 x W grows with the image. Draws: 5 uniforms,
// Philox4x32-10 keyed by (seed, absolute iteration) with the lane as the
// counter, so the replay kernels redraw exactly these numbers at any
// launch shape; or read from `u5` when given.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "shade_core.cuh"
#include "sweep_core.cuh"

// A record word: with STREAM, stored with the evict-first hint.
template <bool STREAM>
__device__ __forceinline__ void rtw_rec_store(float* p, float v) {
  if (STREAM)
    __stcs(p, v);
  else
    *p = v;
}

// An inactive lane's record slot: n_rec zero planes.
template <bool STREAM>
__device__ __forceinline__ void rtw_zero_record(int i, size_t n, float* rec,
                                                int n_rec) {
  for (int p = 0; p < n_rec; ++p) rtw_rec_store<STREAM>(rec + p * n + i, 0.0f);
}

// The record state machine of one active lane (_advance_record_bank): K4's
// body, shared with the fused record step K11. Given the swept hit distance
// t, the winner's 10 attributes a and the 5 uniforms u, it reads the lane's
// state from sf/si, writes slot planes 0..n_rec-1 of `rec`, banks a miss
// into `rad`, advances or refills, and writes the state back. STREAM: the
// record stores carry the evict-first hint (K4; K11 keeps the default).
template <bool STREAM>
__device__ __forceinline__ void rtw_record_advance(
    int i, size_t n, float t, const float* a, const float* u,
    const float* __restrict__ strips, float* __restrict__ sf,
    int* __restrict__ si, float* __restrict__ rad, float* __restrict__ rec,
    int n_rec, int S, int max_depth) {
  float ox = sf[0 * n + i], oy = sf[1 * n + i], oz = sf[2 * n + i];
  float dx = sf[3 * n + i], dy = sf[4 * n + i], dz = sf[5 * n + i];
  float tx = sf[6 * n + i], ty = sf[7 * n + i], tz = sf[8 * n + i];
  int bo = si[0 * n + i], sp = si[1 * n + i];

  float bkr = 0.0f, bkg = 0.0f, bkb = 0.0f;
  const RtwShade s = rtw_shade_core(u, t, a, ox, oy, oz, dx, dy, dz, tx, ty,
                                    tz, true, bkr, bkg, bkb);
  const int newb = bo + 1;
  const bool cont = s.hitm && (newb < max_depth);
  const bool exhausted = s.hitm && !cont;
  const bool term = s.miss || exhausted;
  const int nxt_s = sp + 1;
  const bool can = term && (nxt_s < S);

  // Residual record: this iteration's inputs and packed events.
  const int flags = 1 + ((s.hitm ? 1 : 0) << 1) + ((term ? 1 : 0) << 2)
                    + ((can ? 1 : 0) << 3) + (sp << 4);
  const float r10[11] = {ox, oy, oz, dx, dy, dz, tx, ty, tz, t,
                         __int_as_float(flags)};
#pragma unroll
  for (int j = 0; j < 11; ++j) rtw_rec_store<STREAM>(rec + j * n + i, r10[j]);
  if (n_rec == 21) {
#pragma unroll
    for (int j = 0; j < 10; ++j)
      rtw_rec_store<STREAM>(rec + (11 + j) * n + i, a[j]);
  }

  // Bank the terminating ray's radiance into its strip's planes.
  if (s.miss) {
    float* r = rad + (size_t)(3 * sp) * n + i;
    r[0] = bkr;
    r[n] = bkg;
    r[2 * n] = bkb;
  }

  // Advance on continue.
  if (cont) {
    ox = s.px; oy = s.py; oz = s.pz;
    dx = s.ndx; dy = s.ndy; dz = s.ndz;
    tx = tx * a[4]; ty = ty * a[5]; tz = tz * a[6];
    bo = newb;
  }

  // Refill from the next strip's camera ray.
  if (can) {
    const float* q = strips + (size_t)(6 * nxt_s) * n + i;
    ox = q[0]; oy = q[n]; oz = q[2 * n];
    dx = q[3 * n]; dy = q[4 * n]; dz = q[5 * n];
    tx = 1.0f; ty = 1.0f; tz = 1.0f;
    bo = 0;
    sp = nxt_s;
  }
  const bool act = !term || can;

  sf[0 * n + i] = ox; sf[1 * n + i] = oy; sf[2 * n + i] = oz;
  sf[3 * n + i] = dx; sf[4 * n + i] = dy; sf[5 * n + i] = dz;
  sf[6 * n + i] = tx; sf[7 * n + i] = ty; sf[8 * n + i] = tz;
  si[0 * n + i] = bo; si[1 * n + i] = sp; si[2 * n + i] = act ? 1 : 0;
}

// The lane's 5 uniforms: from u5 [5, W] when given, else Philox keyed by
// (seed, iteration) with the lane as the counter.
__device__ __forceinline__ void rtw_record_uniforms(
    int i, size_t n, const float* __restrict__ u5, uint32_t seed,
    uint32_t iteration, float* u) {
  if (u5) {
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = u5[j * n + i];
  } else {
    rtw_uniforms<5>(seed, iteration, (uint32_t)i, u);
  }
}

__global__ void persist_record_kernel(
    const float* __restrict__ t_in, const int* __restrict__ idx,
    const float* __restrict__ amat, const float* __restrict__ strips,
    float* __restrict__ sf, int* __restrict__ si, float* __restrict__ rad,
    float* __restrict__ rec, int n_rec, const float* __restrict__ u5,
    int n_lanes, int S, int max_depth, uint32_t seed, uint32_t iteration) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  if (si[2 * n + i] == 0) {
    rtw_zero_record<true>(i, n, rec, n_rec);
    return;
  }
  float u[5];
  rtw_record_uniforms(i, n, u5, seed, iteration, u);
  float a[10];
  rtw_fetch_row(idx, amat, i, a);
  rtw_record_advance<true>(i, n, t_in[i], a, u, strips, sf, si, rad, rec,
                           n_rec, S, max_depth);
}

// t [W] f32; idx [W] i32: the sweep's winners, rows of amat [N, 10] f32;
// strips [6S, W] f32; sf [9, W] f32 (o, d, T), si [3, W] i32 (bounce,
// strip, active) and rad [3S, W] f32 are updated in place; rec points at
// one record slot [n_rec, W] (n_rec 21 or 11). u5 [5, W] f32 may be NULL
// (in-kernel Philox).
extern "C" int rtw_persist_record(const float* t, const int* idx,
                                  const float* amat, const float* strips,
                                  float* sf, int* si, float* rad, float* rec,
                                  int n_rec, const float* u5, int n_lanes,
                                  int S, int max_depth, unsigned int seed,
                                  unsigned int iteration, void* stream) {
  if (n_lanes <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  persist_record_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      t, idx, amat, strips, sf, si, rad, rec, n_rec, u5, n_lanes, S,
      max_depth, seed, iteration);
  return (int)cudaGetLastError();
}

// K11: the single-dispatch record iteration (fused_step=True).
//
// Replaces the TPU kernel
// raytracingweekend_jl_tpu/ops/pallas/persist_grad_kernel.py ::
// _persist_record_fused_kernel (launched by persist_record_fused_step): the
// masked sweep (K3), the winner's attributes and the record step (K4) in
// one launch, with the winner index as an extra output plane (the TPU
// kernel's 22nd record plane). The plain PyTorch version is
// raytracingweekend_jl_tpu_torch/ops/cuda/persist_grad_kernel.py ::
// persist_record_fused_step_ref.
//
// What it computes, per lane: a dead lane writes a zero record and winner 0
// and changes nothing (K3 + K4's dead lanes). A live lane takes K3's closest
// hit (t and idx bit for bit), its winner's attributes (zeros on a miss,
// where K4 of the two-launch iteration reads sphere 0's row: every use of
// the attributes in the shade and in the replay is gated on the hit, so the
// record differs only in those ten miss-lane planes), then K4's record
// state machine (rtw_record_advance) with K4's draws.
//
// What bounds it on the card: arithmetic, as K3: ~20 flops per live lane
// and sphere against ~250 bytes of state and record per live lane; at the
// flagship step's 262 144 lanes and 488 spheres the sweep dominates. The
// live share falls from every lane at iteration 0 to a tail of nearly dead
// blocks, and fused_step=True runs every iteration at the full width.
//
// Design: K12's, with K4's step for K9's (mega.cu).
//   - Compact. Each block takes 128 lanes. Its dead lanes write their zero
//     record and winner 0 first (the slot buffer is not cleared); the block
//     packs the ids of its live lanes in lane order (__ballot_sync, __popc
//     and a warp scan of the 4 per-warp counts, as K3). A block with none
//     returns at once: no table staging.
//   - Sweep. Only the [N, 4] sphere table is staged (7.8 KB at 488
//     spheres). A group of P threads of a warp sweeps each packed lane
//     (rtw_sweep_part, the roots behind `disc > 0`, then rtw_merge_closest),
//     with P chosen per block as K3 chooses it: the largest P <= min(p_cap,
//     16) with n_live * P <= 4 * 128. The group's first thread keeps (t,
//     idx) in shared memory at the lane's packed position.
//   - Step. Thread j < n_live takes packed lane ids[j]: the winner's row by
//     index from the [N, 10] table through the read-only path (zeros on a
//     miss), the draws with the lane id as the Philox counter, K4's
//     rtw_record_advance (default stores), and the winner index.
// The ballot, the merge's shuffles and the barriers are reached by every
// thread of the block: the sweep's round count is block-uniform, and a
// thread with no lane joins the merge holding (BIG, 0). Philox keyed by
// (seed, iteration) with the lane as the counter draws the same numbers at
// any block size and packing.
#define RTW_K11_THREADS 128

__global__ void __launch_bounds__(RTW_K11_THREADS)
    persist_record_fused_kernel(
        const float* __restrict__ strips, float* __restrict__ sf,
        int* __restrict__ si, float* __restrict__ rad, float* __restrict__ rec,
        int* __restrict__ idx_out, const float4* __restrict__ spheres,
        const float* __restrict__ amat, int n_spheres, float tmin,
        const float* __restrict__ u5, int n_lanes, int S, int max_depth,
        uint32_t seed, uint32_t iteration, int p_cap) {
  constexpr int T = RTW_K11_THREADS, NW = T / 32;
  extern __shared__ float4 sph[];
  __shared__ int ids[T];
  __shared__ float win_t[T];
  __shared__ int win_i[T];
  __shared__ int base[NW + 1];  // per-warp offsets; base[NW] = total
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // Dead lanes write their zero record and winner 0; each warp counts its
  // live lanes.
  const int i0 = blockIdx.x * T + threadIdx.x;
  const size_t n = n_lanes;
  const bool in = i0 < n_lanes;
  const bool live = in && si[2 * n + i0] != 0;
  if (in && !live) {
    rtw_zero_record<false>(i0, n, rec, 21);
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
  if (live) ids[base[warp] + __popc(m & ((1u << lane) - 1u))] = i0;
  for (int s = threadIdx.x; s < n_spheres; s += T) sph[s] = spheres[s];
  __syncthreads();

  // Sweep the packed lanes, P threads each, in block-uniform rounds.
  int P = p_cap < 16 ? p_cap : 16;
  while (P > 1 && n_live * P > 4 * T) P >>= 1;
  const int log2p = __ffs(P) - 1;
  const int per_round = T >> log2p;
  const int p = threadIdx.x & (P - 1);
  for (int r0 = 0; r0 < n_live; r0 += per_round) {
    const int j = r0 + (threadIdx.x >> log2p);
    float best_t = RTW_BIG;
    int best_i = 0;
    if (j < n_live) {
      const int i = ids[j];
      rtw_sweep_part(sph, n_spheres, p, P, sf[0 * n + i], sf[1 * n + i],
                     sf[2 * n + i], sf[3 * n + i], sf[4 * n + i],
                     sf[5 * n + i], tmin, best_t, best_i);
    }
    rtw_merge_closest(best_t, best_i, P);  // every lane of the warp
    if (j < n_live && p == 0) {
      win_t[j] = best_t;
      win_i[j] = best_i;
    }
  }
  __syncthreads();

  // The record step of the packed lanes, one thread each.
  if (threadIdx.x >= n_live) return;
  const int i = ids[threadIdx.x];
  const float t = win_t[threadIdx.x];
  const int best_i = win_i[threadIdx.x];
  const bool hit = t < RTW_BIG;
  const float* row = amat + 10 * (size_t)best_i;
  float a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = hit ? __ldg(row + j) : 0.0f;
  float u[5];
  rtw_record_uniforms(i, n, u5, seed, iteration, u);
  rtw_record_advance<false>(i, n, t, a, u, strips, sf, si, rad, rec, 21, S,
                            max_depth);
  idx_out[i] = best_i;
}

// strips [6S, W] f32; sf [9, W] f32, si [3, W] i32 and rad [3S, W] f32 are
// updated in place; rec points at one 21-plane record slot [21, W]; idx
// [W] i32 receives the winners; spheres [N, 4] f32 (cx, cy, cz, ck), amat
// [N, 10] f32; u5 [5, W] f32 may be NULL (in-kernel Philox).
extern "C" int rtw_persist_record_fused(
    const float* strips, float* sf, int* si, float* rad, float* rec, int* idx,
    const float* spheres, const float* amat, int n_spheres, float tmin,
    const float* u5, int n_lanes, int S, int max_depth, unsigned int seed,
    unsigned int iteration, void* stream) {
  if (n_lanes <= 0) return 0;
  const int blocks = (n_lanes + RTW_K11_THREADS - 1) / RTW_K11_THREADS;
  const size_t smem = (size_t)n_spheres * sizeof(float4);
  cudaError_t e =
      rtw_reserve_smem((const void*)persist_record_fused_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  persist_record_fused_kernel<<<blocks, RTW_K11_THREADS, smem,
                                (cudaStream_t)stream>>>(
      strips, sf, si, rad, rec, idx, reinterpret_cast<const float4*>(spheres),
      amat, n_spheres, tmin, u5, n_lanes, S, max_depth, seed, iteration,
      rtw_parts_cap(n_spheres));
  return (int)cudaGetLastError();
}

// K11's registers per thread, the blocks of it that one SM holds at its
// block size and shared memory for `n_spheres`, and the device's SM count.
extern "C" int rtw_persist_record_fused_occupancy(int n_spheres, int* regs,
                                                  int* blocks_per_sm,
                                                  int* sm_count) {
  const size_t smem = (size_t)n_spheres * sizeof(float4);
  cudaFuncAttributes a = {};
  cudaError_t e = cudaFuncGetAttributes(&a, persist_record_fused_kernel);
  if (e == cudaSuccess)
    e = rtw_reserve_smem((const void*)persist_record_fused_kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, persist_record_fused_kernel, RTW_K11_THREADS, smem);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  *regs = a.numRegs;
  return (int)e;
}
