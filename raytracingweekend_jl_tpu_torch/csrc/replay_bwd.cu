// K7b and K7c: the replay (backward) kernels of the fixed-depth record for
// Hopper (sm_90a).
//
// K7c replaces raytracingweekend_jl_tpu/ops/pallas/grad_kernel.py ::
// _replay_bwd_fused_kernel (launched by replay_bwd_fused), the whole reverse
// bounce walk in one launch, the default. K7b replaces _replay_bwd_kernel
// (launched by replay_bwd_step), one reverse bounce per launch, the route
// with the fused replay off. Both run the bounce adjoint of
// bounce_adjoint.cuh on each recorded bounce. The plain PyTorch versions are
// replay_bwd_fused_ref and replay_bwd_step_ref in
// raytracingweekend_jl_tpu_torch/ops/cuda/grad_kernel.py.
//
// Per lane and bounce: a slot whose alive flag is 0 writes zero attribute
// rows and passes the carried cotangent through unchanged (the TPU kernels
// did this per dead (64, 128) block; the adjoint of a dead lane's
// pass-through is the identity). A live slot redraws the record kernel's 5
// uniforms, takes hit = t < BIG, and runs the bounce adjoint with hit lanes
// advancing and missing lanes banking the sky: the carried (o, d, T)
// cotangent of the bounce's outputs becomes that of its inputs, and the 9
// cotangent rows of the winner's (center, radius, albedo, fuzz, ir) are
// written. The fixed-depth chain is never cut: a path that died keeps its
// carry, which is zero there because nothing after its death depends on it.
//
// What bounds them on the card: memory traffic, on paper. Per live lane and
// bounce the replay reads the 21 record words and writes 9 attribute rows
// (~120 bytes) and runs ~400 flops with five transcendental calls; a dead
// slot reads its flag and writes 9 zero rows. The demo's 16-slot walk at
// 22 400 lanes (64 217 of 358 400 slots live) moves ~21 MB, ~6.4 us of HBM
// time. In practice K7c is bound by latency: each lane's walk is one
// dependent chain, 16 adjoints long for the deepest lanes, and the fit's
// 22 400 lanes are ~5 warps per SM, too few to hide it. Its record (~30 MB
// there) stays in L2 from the record phase, so the chain is the adjoint's
// arithmetic, not its loads.
//
// K7b: one thread per lane, one slot per launch; the cotangent is carried
// through device memory between launches. A launch is one adjoint per live
// lane: at the fit's 22 400 lanes its bytes take 0.7 us of HBM time, below
// what a launch costs (an empty kernel takes 1.8 us a launch back to back),
// so what a launch can lose is latency: each lane's loads, then its draws
// and one adjoint (~400 flops, five transcendentals) as one dependent
// chain. The kernel before the redesign (replay_bwd_step_previous_kernel,
// kept as the card's reference, on no route) loaded each lane's carry and
// radiance cotangent with its alive flag, and only after the flag the 20
// record words: two dependent round trips per live lane; 128-thread blocks
// gave the fit's 22 400 lanes 175 blocks on 132 SMs. The redesign
// (replay_bwd_step_kernel) issues every load of a lane at once (the flag,
// the 20 record words, the 9 carried and 3 radiance cotangents, the
// injected draws), as volatile loads the compiler cannot sink below the
// flag's test: one round trip. A dead lane then writes its 9 zero rows and
// stops (no carry store); a live lane draws and runs the adjoint. 64-thread
// blocks spread the fit's lanes over the 132 SMs (350 blocks). A dead lane
// pays 48 bytes it does not use, which at these widths costs less than the
// second round trip. scripts/torch_k7b_variants.py builds and times the
// designs it was chosen over (the flag first with the loads behind it,
// K12's compaction of a block's live lanes, K7c's lane pair, other block
// sizes): all lie within 13% of each other, near the launch floor.
//
// K7c: G threads of a warp per lane, G from the wrapper's rule (1 or 2).
//   - G = 1 (replay_bwd_fused_one_thread_kernel, the kernel before the
//     redesign): one thread per lane walks every slot newest first, reading
//     each slot's flag where the walk meets it, the carry in registers. At
//     widths that fill the card (131 071 lanes) its 80 registers and six
//     resident blocks per SM beat every staged form.
//   - G = 2 (replay_bwd_fused_kernel): the group's threads read the
//     lane's alive flags at once, G-strided, 32 slots to a chunk, and write
//     the zero rows of the dead ones; the group ORs its bits into the
//     chunk's live mask (__shfl_xor_sync, reached by every thread of the
//     warp: the chunk count is uniform, and a thread past the lanes holds
//     no bits). The block orders its lanes by their live slots, deepest
//     first (a counting sort in shared memory: which group walks which lane
//     is free, since each lane writes only its own rows), so a warp's
//     lanes end together. Then, for each batch of a lane's next G live
//     slots, thread k stages the k-th: its record words, its draws and its
//     forward half (rtw_adjoint_forward, the part of the adjoint that does
//     not read the carry), into shared memory, all G at once; the group's
//     first thread transposes them in order (rtw_adjoint_reverse) with the
//     9 carried and 3 radiance cotangents in registers. The forward halves
//     of a lane's slots, most of the adjoint's latency, leave its chain.
//     A dead slot costs nothing on the chain: the carry passes it
//     unchanged, as the plain version's blend gives.
// The expressions and their order are the one-thread kernel's (the adjoint
// split into its two halves evaluates the same operations), so cot and
// every dattr row are its bits, zeros included (a dead slot's rows +0.0).
// The draws are the record kernel's own: Philox4x32-10 keyed by (seed,
// bounce) with the lane as the counter, or read from u5. Offsets into the
// record are 64-bit. scripts/torch_k7c_k11_variants.py builds and times the
// designs this one was chosen over.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_adjoint.cuh"
#include "philox.cuh"

// One reverse bounce of one live lane. r: the record's o3 d3 T3 t; a: the
// winner's 10 attributes; g: the lane's radiance cotangent; cot: the carry,
// updated; d9: the attribute rows.
__device__ __forceinline__ void rtw_fixed_replay(const float* u, const float* r,
                                                 const float* a, const float* g,
                                                 float* cot, float* d9) {
  const bool hit = r[9] < RTW_BIG;
  rtw_bounce_adjoint(u, r, a, g, cot, hit, !hit, d9);
}

// Loads slot `rs` [21, n] of lane i and replays it; returns false (and
// writes nothing) for a dead slot.
__device__ __forceinline__ bool rtw_replay_slot(
    const float* __restrict__ rs, const float* __restrict__ us, size_t n,
    int i, uint32_t seed, uint32_t bounce, const float* g, float* cot,
    float* d9) {
  if (__float_as_int(rs[10 * n + i]) == 0) return false;
  float u[5];
  if (us) {
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = us[j * n + i];
  } else {
    rtw_uniforms<5>(seed, bounce, (uint32_t)i, u);
  }
  float r[10], a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) r[j] = rs[j * n + i];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = rs[(11 + j) * n + i];
  rtw_fixed_replay(u, r, a, g, cot, d9);
  return true;
}

#define RTW_K7C_THREADS 128

// What the transpose of one slot reads besides the carry: the slot's
// forward intermediates, its direction and throughput (r[3..8]), the
// winner's center, radius and albedo (a[0..6]), and whether it hit.
struct RtwK7cStage {
  RtwAdjFwd f;
  float r[6], a[7];
  bool hit;
};

// The record words o3 d3 T3 t (r) and the winner's attributes (a) of slot s
// [21, n] of lane i.
__device__ __forceinline__ void rtw_fixed_slot_words(
    const float* __restrict__ rec, size_t n, int i, int s, float* r,
    float* a) {
  const float* rs = rec + (size_t)s * 21 * n + i;
#pragma unroll
  for (int j = 0; j < 10; ++j) r[j] = rs[j * n];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = rs[(11 + j) * n];
}

// The 5 uniforms of slot s of lane i: from u5 [n_slots, 5, n] (INJ), else
// Philox keyed by (seed, s) with the lane as the counter.
template <bool INJ>
__device__ __forceinline__ void rtw_fixed_slot_uniforms(
    const float* __restrict__ u5, size_t n, int i, uint32_t seed, int s,
    float* u) {
  if (INJ) {
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = u5[((size_t)s * 5 + j) * n + i];
  } else {
    rtw_uniforms<5>(seed, (uint32_t)s, (uint32_t)i, u);
  }
}

// Stages slot s of lane i: its words, its draws and its forward half.
template <bool INJ>
__device__ __forceinline__ void rtw_fixed_stage(
    const float* __restrict__ rec, const float* __restrict__ u5, size_t n,
    int i, uint32_t seed, int s, RtwK7cStage& st) {
  float r[10], a[10], u[5];
  rtw_fixed_slot_words(rec, n, i, s, r, a);
  rtw_fixed_slot_uniforms<INJ>(u5, n, i, seed, s, u);
  const bool hit = r[9] < RTW_BIG;
  st.f = rtw_adjoint_forward(u, r, a, hit);
#pragma unroll
  for (int j = 0; j < 6; ++j) st.r[j] = r[3 + j];
#pragma unroll
  for (int j = 0; j < 7; ++j) st.a[j] = a[j];
  st.hit = hit;
}

// The transpose of a staged slot: the carry updated, the 9 rows returned.
__device__ __forceinline__ void rtw_fixed_transpose(const RtwK7cStage& st,
                                                    const float* g,
                                                    float* cot, float* d9) {
  float r[10], a[10];
#pragma unroll
  for (int j = 0; j < 6; ++j) r[3 + j] = st.r[j];
#pragma unroll
  for (int j = 0; j < 7; ++j) a[j] = st.a[j];
  rtw_adjoint_reverse(st.f, r, a, g, cot, st.hit, !st.hit, d9);
}

// The live mask of chunk [lo, hi] of lane i (bit b: slot hi - b), for the
// group of G threads that holds lane i: thread k reads the alive flags of
// slots hi - k, hi - k - G, ... and writes the zero rows of its dead ones;
// the group ORs its bits. Every thread of the warp calls it.
template <int G>
__device__ __forceinline__ unsigned rtw_k7c_chunk_mask(
    const float* __restrict__ rec, float* __restrict__ dattr, size_t n,
    int i, bool in, int k, int hi, int lo) {
  unsigned m = 0;
#pragma unroll
  for (int j = 0; j < 32 / G; ++j) {
    const int s = hi - k - j * G;
    if (in && s >= lo &&
        __float_as_int(rec[((size_t)s * 21 + 10) * n + i]) != 0)
      m |= 1u << (hi - s);
  }
#pragma unroll
  for (int j = 0; j < 32 / G; ++j) {
    const int s = hi - k - j * G;
    if (in && s >= lo && !((m >> (hi - s)) & 1u)) {
      float* da = dattr + (size_t)s * 9 * n + i;
#pragma unroll
      for (int q = 0; q < 9; ++q) da[q * n] = 0.0f;
    }
  }
#pragma unroll
  for (int off = 1; off < G; off <<= 1)
    m |= __shfl_xor_sync(0xffffffffu, m, off);
  return m;
}

// Transposes the live slots of chunk [.., hi] of lane i (mask m), newest
// first, the carry in the first thread's registers: for each batch of the
// lane's next G live slots, thread k stages the k-th (words, draws, forward
// half) into `stage`, all G at once, and the first thread transposes them
// in order. Every thread of the warp calls it: the batch count is the
// warp's most, and __syncwarp orders the stage's writes and reads.
template <int G, bool INJ>
__device__ __forceinline__ void rtw_k7c_walk_chunk(
    const float* __restrict__ rec, const float* __restrict__ u5,
    float* __restrict__ dattr, size_t n, int i, bool in, int k,
    uint32_t seed, int hi, unsigned m, const float* g, float* cot,
    RtwK7cStage* stage) {
  int batches = (__popc(m) + G - 1) / G;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    batches = max(batches, __shfl_xor_sync(0xffffffffu, batches, off));
  for (int b = 0; b < batches; ++b) {  // warp-uniform
    unsigned mk = m;  // thread k's slot: the k-th live slot of the batch
#pragma unroll
    for (int j = 0; j < G - 1; ++j)
      if (j < k) mk &= mk - 1;
    if (in && mk)
      rtw_fixed_stage<INJ>(rec, u5, n, i, seed, hi - (__ffs(mk) - 1),
                           stage[threadIdx.x]);
    __syncwarp();
    if (in && k == 0) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        if (!m) break;
        const int s = hi - (__ffs(m) - 1);
        m &= m - 1;
        float d9[9];
        rtw_fixed_transpose(stage[threadIdx.x + j], g, cot, d9);
        float* da = dattr + (size_t)s * 9 * n + i;
#pragma unroll
        for (int q = 0; q < 9; ++q) da[q * n] = d9[q];
      }
    } else {
#pragma unroll
      for (int j = 0; j < G; ++j) m &= m - 1;
    }
    __syncwarp();
  }
}

// K7c at G = 1: one thread per lane walks every slot newest first, the
// alive flag of each read where the walk meets it, the carry in registers
// (the kernel before the redesign, kept: at widths that fill the card it
// is faster than the batched walk, whose staging and forward-half
// registers cost it resident warps). rec [n_slots, 21, n]; g3 [3, n]; cot
// [9, n] in place; dattr [n_slots, 9, n] written; u5 [n_slots, 5, n] or
// NULL.
__global__ void replay_bwd_fused_one_thread_kernel(
    const float* __restrict__ rec, const float* __restrict__ g3,
    float* __restrict__ cot_io, float* __restrict__ dattr,
    const float* __restrict__ u5, int n_lanes, int n_slots, uint32_t seed) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  float cot[9], g[3], d9[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = g3[j * n + i];
  for (int slot = n_slots - 1; slot >= 0; --slot) {
    const float* us = u5 ? u5 + (size_t)slot * 5 * n : nullptr;
    float* da = dattr + (size_t)slot * 9 * n;
    if (rtw_replay_slot(rec + (size_t)slot * 21 * n, us, n, i, seed,
                        (uint32_t)slot, g, cot, d9)) {
#pragma unroll
      for (int j = 0; j < 9; ++j) da[j * n + i] = d9[j];
    } else {
#pragma unroll
      for (int j = 0; j < 9; ++j) da[j * n + i] = 0.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < 9; ++j) cot_io[j * n + i] = cot[j];
}

// K7c at G = 2. rec [n_slots, 21, n]; g3 [3, n]; cot [9, n] in place
// (the carry before the newest slot, then after slot 0); dattr [n_slots, 9,
// n] written; u5 [n_slots, 5, n] (INJ) or unused. G threads per lane, a block
// of RTW_K7C_THREADS / G lanes: the groups read the lanes' newest chunk of
// flags (writing its zero rows), the block orders its lanes by their live
// slots in that chunk, deepest first, and group j walks the j-th deepest.
template <int G, bool INJ>
__global__ void __launch_bounds__(RTW_K7C_THREADS)
    replay_bwd_fused_kernel(const float* __restrict__ rec,
                            const float* __restrict__ g3,
                            float* __restrict__ cot_io,
                            float* __restrict__ dattr,
                            const float* __restrict__ u5, int n_lanes,
                            int n_slots, uint32_t seed) {
  constexpr int L = RTW_K7C_THREADS / G;  // lanes per block
  __shared__ RtwK7cStage stage[RTW_K7C_THREADS];
  __shared__ int order[L];
  __shared__ unsigned masks[L];
  __shared__ int base[33];
  const int k = threadIdx.x % G, l = threadIdx.x / G;
  const int lane0 = blockIdx.x * L;
  const size_t n = n_lanes;

  // The newest chunk's mask of the block's lane lane0 + l.
  const int top = n_slots - 1;
  const int lo = top >= 31 ? top - 31 : 0;
  bool in = lane0 + l < n_lanes;
  unsigned m = rtw_k7c_chunk_mask<G>(rec, dattr, n, lane0 + l, in, k, top,
                                     lo);

  // Order the block's lanes by live slots, deepest first (a counting sort;
  // the order within a count is free: each lane writes only its own rows).
  if (threadIdx.x < 33) base[threadIdx.x] = 0;
  __syncthreads();
  const int key = 32 - __popc(m);
  int pos = 0;
  if (in && k == 0) pos = atomicAdd(&base[key], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int c = 0; c < 33; ++c) {
      const int v = base[c];
      base[c] = sum;
      sum += v;
    }
  }
  __syncthreads();
  if (in && k == 0) {
    order[base[key] + pos] = l;
    masks[base[key] + pos] = m;
  }
  __syncthreads();

  // Group l walks the l-th deepest lane.
  in = lane0 + l < n_lanes;
  const int i = in ? lane0 + order[l] : 0;
  m = in ? masks[l] : 0u;
  float cot[9], g[3];
  if (in && k == 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];
#pragma unroll
    for (int j = 0; j < 3; ++j) g[j] = g3[j * n + i];
  }
  rtw_k7c_walk_chunk<G, INJ>(rec, u5, dattr, n, i, in, k, seed, top, m, g,
                             cot, stage);
  for (int hi = top - 32; hi >= 0; hi -= 32) {  // warp-uniform
    m = rtw_k7c_chunk_mask<G>(rec, dattr, n, i, in, k, hi,
                              hi >= 31 ? hi - 31 : 0);
    rtw_k7c_walk_chunk<G, INJ>(rec, u5, dattr, n, i, in, k, seed, hi, m, g,
                               cot, stage);
  }
  if (in && k == 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) cot_io[j * n + i] = cot[j];
  }
}

// The kernel K7b was before its redesign, kept as the card's reference (no
// route runs it). One slot: rec [21, n] of bounce `bounce`; g3 [3, n]; cot
// [9, n] in place; dattr [9, n] written; u5 [5, n] or NULL. 128 threads per
// block.
__global__ void replay_bwd_step_previous_kernel(
    const float* __restrict__ rec, const float* __restrict__ g3,
    float* __restrict__ cot_io, float* __restrict__ dattr,
    const float* __restrict__ u5, int n_lanes, uint32_t seed,
    uint32_t bounce) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  float cot[9], g[3], d9[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = g3[j * n + i];
  if (rtw_replay_slot(rec, u5, n, i, seed, bounce, g, cot, d9)) {
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      cot_io[j * n + i] = cot[j];
      dattr[j * n + i] = d9[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < 9; ++j) dattr[j * n + i] = 0.0f;
  }
}

#define RTW_K7B_THREADS 64

// A load issued where it stands: volatile, so the compiler neither sinks it
// below a branch nor drops it (K7b's loads all go out before the alive
// flag is tested). ld.global.nc for data the kernel does not write.
__device__ __forceinline__ float rtw_ld_early_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float rtw_ld_early(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// K7b. One slot: rec [21, n] of bounce `bounce`; g3 [3, n]; cot [9, n] in
// place; dattr [9, n] written; u5 [5, n] (INJ) or unused. Every load of the
// lane goes out at once; a dead lane then writes its zero rows and stops,
// a live one draws and runs the adjoint. The arithmetic is
// rtw_fixed_replay's, so cot and every row are the previous kernel's bits.
template <bool INJ>
__global__ void __launch_bounds__(RTW_K7B_THREADS)
    replay_bwd_step_kernel(const float* __restrict__ rec,
                           const float* __restrict__ g3,
                           float* __restrict__ cot_io,
                           float* __restrict__ dattr,
                           const float* __restrict__ u5, int n_lanes,
                           uint32_t seed, uint32_t bounce) {
  const int i = blockIdx.x * RTW_K7B_THREADS + threadIdx.x;
  if (i >= n_lanes) return;
  const size_t n = n_lanes;
  float r[10], a[10], cot[9], g[3], u[5], d9[9];
  const float flag = rtw_ld_early_nc(rec + 10 * n + i);
#pragma unroll
  for (int j = 0; j < 10; ++j) r[j] = rtw_ld_early_nc(rec + j * n + i);
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = rtw_ld_early_nc(rec + (11 + j) * n + i);
#pragma unroll
  for (int j = 0; j < 9; ++j) cot[j] = rtw_ld_early(cot_io + j * n + i);
#pragma unroll
  for (int j = 0; j < 3; ++j) g[j] = rtw_ld_early_nc(g3 + j * n + i);
  if (INJ) {
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = rtw_ld_early_nc(u5 + j * n + i);
  }
  if (__float_as_int(flag) == 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) dattr[j * n + i] = 0.0f;
    return;
  }
  if (!INJ) rtw_uniforms<5>(seed, bounce, (uint32_t)i, u);
  rtw_fixed_replay(u, r, a, g, cot, d9);
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    cot_io[j * n + i] = cot[j];
    dattr[j * n + i] = d9[j];
  }
}

template <int G>
static const void* rtw_k7c_kernel(bool inj) {
  return inj ? (const void*)replay_bwd_fused_kernel<G, true>
             : (const void*)replay_bwd_fused_kernel<G, false>;
}

// K7c for a group size G in {1, 2} (else NULL).
static const void* rtw_k7c(int group, bool inj) {
  switch (group) {
    case 1: return (const void*)replay_bwd_fused_one_thread_kernel;
    case 2: return rtw_k7c_kernel<2>(inj);
    default: return nullptr;
  }
}

// group: G, the threads per lane, in {1, 2}.
extern "C" int rtw_replay_bwd_fused(const float* rec, const float* g3,
                                    float* cot, float* dattr, const float* u5,
                                    int n_lanes, int n_slots,
                                    unsigned int seed, int group,
                                    void* stream) {
  const void* k = rtw_k7c(group, u5 != nullptr);
  if (!k) return (int)cudaErrorInvalidValue;
  if (n_lanes <= 0 || n_slots <= 0) return 0;
  const long long threads = (long long)n_lanes * group;
  const int blocks = (int)((threads + RTW_K7C_THREADS - 1) / RTW_K7C_THREADS);
  void* args[] = {(void*)&rec, (void*)&g3, (void*)&cot, (void*)&dattr,
                  (void*)&u5, (void*)&n_lanes, (void*)&n_slots,
                  (void*)&seed};
  return (int)cudaLaunchKernel(k, dim3(blocks), dim3(RTW_K7C_THREADS), args,
                               0, (cudaStream_t)stream);
}

// K7c's registers per thread at group size `group` (Philox draws), the
// blocks of it one SM holds, its threads per block and the SM count.
extern "C" int rtw_replay_bwd_fused_occupancy(int group, int* regs,
                                              int* blocks_per_sm,
                                              int* threads, int* sm_count) {
  const void* k = rtw_k7c(group, false);
  if (!k) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a = {};
  cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                      RTW_K7C_THREADS, 0);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, dev);
  *regs = a.numRegs;
  *threads = RTW_K7C_THREADS;
  return (int)e;
}

extern "C" int rtw_replay_bwd_step(const float* rec, const float* g3,
                                   float* cot, float* dattr, const float* u5,
                                   int n_lanes, unsigned int seed,
                                   unsigned int bounce, void* stream) {
  if (n_lanes <= 0) return 0;
  const int blocks = (n_lanes + RTW_K7B_THREADS - 1) / RTW_K7B_THREADS;
  if (u5)
    replay_bwd_step_kernel<true>
        <<<blocks, RTW_K7B_THREADS, 0, (cudaStream_t)stream>>>(
            rec, g3, cot, dattr, u5, n_lanes, seed, bounce);
  else
    replay_bwd_step_kernel<false>
        <<<blocks, RTW_K7B_THREADS, 0, (cudaStream_t)stream>>>(
            rec, g3, cot, dattr, u5, n_lanes, seed, bounce);
  return (int)cudaGetLastError();
}

// The previous K7b (the card's reference), same arguments.
extern "C" int rtw_replay_bwd_step_previous(const float* rec, const float* g3,
                                            float* cot, float* dattr,
                                            const float* u5, int n_lanes,
                                            unsigned int seed,
                                            unsigned int bounce,
                                            void* stream) {
  if (n_lanes <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  replay_bwd_step_previous_kernel<<<blocks, threads, 0,
                                    (cudaStream_t)stream>>>(
      rec, g3, cot, dattr, u5, n_lanes, seed, bounce);
  return (int)cudaGetLastError();
}

// K7b's registers per thread (Philox draws), the blocks of it one SM holds
// and its threads per block.
extern "C" int rtw_replay_bwd_step_occupancy(int* regs, int* blocks_per_sm,
                                             int* threads) {
  const void* k = (const void*)replay_bwd_step_kernel<false>;
  cudaFuncAttributes a = {};
  cudaError_t e = cudaFuncGetAttributes(&a, k);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                      RTW_K7B_THREADS, 0);
  *regs = a.numRegs;
  *threads = RTW_K7B_THREADS;
  return (int)e;
}
