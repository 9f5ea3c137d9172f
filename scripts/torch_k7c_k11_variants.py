"""K7c (``replay_bwd_fused``) and K11 (``persist_record_fused_kernel``)
beside the designs they were chosen over, on the card: what each change of
their redesign does alone, and why the shipped kernels are what they are.

The shipped sources (``csrc/replay_bwd.cu``, ``csrc/persist_record.cu``) are
built as they stand (``shipped``) and rewritten into variants, each built by
its own ``nvcc -Xptxas -v`` (all at once), with the launcher's C signature
unchanged:

- K7c ``previous``: the kernel before the redesign (one thread per lane,
  each slot's alive flag read on the chain, then its record words, 128
  threads per block). The shipped K7c takes a group size G (threads per
  lane) at launch: 1 runs that same kernel, 2 and 4 the staged walk.
  ``shipped_nosort``: the staged walk without the block's depth order;
  ``shipped_odd``: its stage padded to an odd word stride (no bank
  conflicts on paper); ``shipped_t32``, ``_t64``: 32- or 64-thread
  blocks; ``shipped_b6``: a launch bound of 6 blocks per SM (80
  registers). ``walk``: the redesign's first form, one thread per lane (the
  first of G) walking only the live slots with the next live slot's words,
  draws and forward half computed beside the current transpose;
  ``walk_nofwd``: the same without the forward half.
- K11 ``previous``: the kernel before the redesign (one thread per lane
  over every lane, the one-thread sweep loop rtw_sweep_closest, the sphere
  and attribute tables staged in every block with a live lane).
  ``shipped_t256``: 256-lane blocks, not 128; ``shipped_b10``, ``_b12``: a
  launch bound of 10 or 12 blocks per SM (fewer registers);
  ``shipped_stream``: the record stored with the evict-first hint, as K4.

It prints each build's registers, spills and resident blocks. It holds
every build bit for bit: K7c (cot and every dattr row) against K7b's walk
(one launch per slot, the carry through device memory: the previous K7c's
function) on the fit's walk (the inverse demo's first pass, 22 400 lanes,
16 slots) and on 131 071 lanes (a 512x256 film of the same scene, less one
ray, the largest image the fixed-depth pair serves), at every G, injected
and Philox draws; K11 (every state word, record plane and winner) against
K3 then K4 (the miss lanes' attribute planes zeroed, which K11 stores as
zeros) at iterations 0, 20, 44 and 70 of the flagship fused step
(262 144 lanes, 8 strips), injected and Philox. It times every build with
``chip_smoke.batch_ms`` (one CUDA event pair around N launches, each on
its own copy of the state, and the profiler's per-launch mean), K11 beside
K3 + K4; five passes, every other one in reverse order; each time is the
median. Then K11's device time per fused step (the profiler) and the
step's wall time, previous and shipped in turns, the loss and the
gradients bitwise equal. The last lines give each change alone against
what it replaces, and the verdict: a change is kept where it is at least
1% faster at every shape timed (the shipped K7c, which runs the previous
kernel where the rule picks G = 1, where it is no more than 1% slower
there). One JSON object per line; a failed check raises.

    python3 scripts/torch_k7c_k11_variants.py    # one CUDA card and nvcc
"""

from __future__ import annotations

import ctypes
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as C  # noqa: E402
import raytracingweekend_jl_tpu_torch as pt  # noqa: E402
from raytracingweekend_jl_tpu_torch import rng  # noqa: E402
from raytracingweekend_jl_tpu_torch.camera import sample_pass_rays  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops import fused_grad as FG  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops import persist_grad as PG  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import build  # noqa: E402
from raytracingweekend_jl_tpu_torch.ops.cuda import (  # noqa: E402
    grad_kernel as GK, intersect_kernel as K1, persist_grad_kernel as PK)
from raytracingweekend_jl_tpu_torch.ops.materials import attr_mat  # noqa: E402

DEPTH, TMIN, SEED11 = 16, 1e-4, 0x5EED

# -- source rewrites ---------------------------------------------------------

#: The shipped K7c from its block-size define to the end of its occupancy
#: query; the shipped K11 from its block-size define to the end of the file.
K7C_SECTION = re.compile(r"#define RTW_K7C_THREADS 128\n.*?\n}\n\n"
                         r"(?=// The kernel K7b was before its redesign)",
                         re.S)
K7C_LAUNCHERS = re.compile(r"template <int G>\nstatic const void\* "
                           r"rtw_k7c_kernel.*?(?=extern \"C\" int "
                           r"rtw_replay_bwd_step\()", re.S)
K11_SECTION = re.compile(r"#define RTW_K11_THREADS 128\n.*\Z", re.S)

#: The kernels before the redesign, verbatim, with launchers of the shipped
#: C signatures (the previous K7c takes and ignores the group size).
PREVIOUS_K7C = """__global__ void replay_bwd_fused_kernel(const float* __restrict__ rec,
                                        const float* __restrict__ g3,
                                        float* __restrict__ cot_io,
                                        float* __restrict__ dattr,
                                        const float* __restrict__ u5,
                                        int n_lanes, int n_slots,
                                        uint32_t seed) {
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

"""
PREVIOUS_K7C_LAUNCH = """extern "C" int rtw_replay_bwd_fused(const float* rec, const float* g3,
                                    float* cot, float* dattr, const float* u5,
                                    int n_lanes, int n_slots,
                                    unsigned int seed, int group,
                                    void* stream) {
  (void)group;
  if (n_lanes <= 0 || n_slots <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  replay_bwd_fused_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      rec, g3, cot, dattr, u5, n_lanes, n_slots, seed);
  return (int)cudaGetLastError();
}

"""
#: The first redesign: one thread per lane (G threads, the first walking)
#: walks the live slots with the next live slot's words, draws and forward
#: half computed beside the current transpose.
WALK_K7C = """#define RTW_K7C_THREADS 128

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

// Walks the live slots of chunk [.., hi] of lane i, newest first: bit b of
// m is slot hi - b. While one slot is transposed, the next live slot's words
// are loaded and its forward intermediates computed: the two are
// independent, so the compiler interleaves them, and a slot's step on the
// chain is the longer of the two, not their sum.
template <bool INJ>
__device__ __forceinline__ void rtw_fixed_walk(
    const float* __restrict__ rec, const float* __restrict__ u5,
    float* __restrict__ dattr, size_t n, int i, uint32_t seed, int hi,
    unsigned m, const float* g, float* cot) {
  int s = hi - (__ffs(m) - 1);
  float r[10], a[10], u[5];
  rtw_fixed_slot_words(rec, n, i, s, r, a);
  rtw_fixed_slot_uniforms<INJ>(u5, n, i, seed, s, u);
  RtwAdjFwd f = rtw_adjoint_forward(u, r, a, r[9] < RTW_BIG);
  for (;;) {
    m &= m - 1;
    const int sn = m ? hi - (__ffs(m) - 1) : s;
    float nr[10], na[10], nu[5];
    rtw_fixed_slot_words(rec, n, i, sn, nr, na);
    rtw_fixed_slot_uniforms<INJ>(u5, n, i, seed, sn, nu);
    const RtwAdjFwd nf = rtw_adjoint_forward(nu, nr, na, nr[9] < RTW_BIG);
    const bool hit = r[9] < RTW_BIG;
    float d9[9];
    rtw_adjoint_reverse(f, r, a, g, cot, hit, !hit, d9);
    float* da = dattr + (size_t)s * 9 * n + i;
#pragma unroll
    for (int j = 0; j < 9; ++j) da[j * n] = d9[j];
    if (!m) break;
    s = sn;
    f = nf;
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      r[j] = nr[j];
      a[j] = na[j];
    }
  }
}

// K7c. rec [n_slots, 21, n]; g3 [3, n]; cot [9, n] in place (the carry
// before the newest slot, then after slot 0); dattr [n_slots, 9, n]
// written; u5 [n_slots, 5, n] (INJ) or unused. G threads per lane.
template <int G, bool INJ>
__global__ void __launch_bounds__(RTW_K7C_THREADS)
    replay_bwd_fused_kernel(const float* __restrict__ rec,
                            const float* __restrict__ g3,
                            float* __restrict__ cot_io,
                            float* __restrict__ dattr,
                            const float* __restrict__ u5, int n_lanes,
                            int n_slots, uint32_t seed) {
  const long long gt = (long long)blockIdx.x * RTW_K7C_THREADS + threadIdx.x;
  const int i = (int)(gt / G), k = (int)(gt % G);
  const bool in = i < n_lanes;
  const bool lead = in && k == 0;
  const size_t n = n_lanes;
  float cot[9], g[3];
  if (lead) {
#pragma unroll
    for (int j = 0; j < 9; ++j) cot[j] = cot_io[j * n + i];
#pragma unroll
    for (int j = 0; j < 3; ++j) g[j] = g3[j * n + i];
  }
  for (int hi = n_slots - 1; hi >= 0; hi -= 32) {  // warp-uniform
    const int lo = hi >= 31 ? hi - 31 : 0;
    // This thread's slots hi - k, hi - k - G, ...: their flags, then the
    // zero rows of the dead ones.
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
    if (lead && m)
      rtw_fixed_walk<INJ>(rec, u5, dattr, n, i, seed, hi, m, g, cot);
  }
  if (lead) {
#pragma unroll
    for (int j = 0; j < 9; ++j) cot_io[j * n + i] = cot[j];
  }
}

"""
PREVIOUS_K11 = """__global__ void persist_record_fused_kernel(
    const float* __restrict__ strips, float* __restrict__ sf,
    int* __restrict__ si, float* __restrict__ rad, float* __restrict__ rec,
    int* __restrict__ idx_out, const float4* __restrict__ spheres,
    const float* __restrict__ amat, int n_spheres, float tmin,
    const float* __restrict__ u5, int n_lanes, int S, int max_depth,
    uint32_t seed, uint32_t iteration) {
  extern __shared__ float4 sph[];
  float* sattr = reinterpret_cast<float*>(sph + n_spheres);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n = n_lanes;
  const bool live = i < n_lanes && si[2 * n + i] != 0;
  if (!__syncthreads_or(live)) {  // the whole block is dead
    if (i < n_lanes) {
      rtw_zero_record<false>(i, n, rec, 21);
      idx_out[i] = 0;
    }
    return;
  }
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) sph[s] = spheres[s];
  for (int j = threadIdx.x; j < 10 * n_spheres; j += blockDim.x)
    sattr[j] = amat[j];
  __syncthreads();
  if (i >= n_lanes) return;
  if (!live) {
    rtw_zero_record<false>(i, n, rec, 21);
    idx_out[i] = 0;
    return;
  }
  float best_t;
  int best_i;
  rtw_sweep_closest(sph, n_spheres, sf[0 * n + i], sf[1 * n + i],
                    sf[2 * n + i], sf[3 * n + i], sf[4 * n + i],
                    sf[5 * n + i], tmin, best_t, best_i);
  const bool hit = best_t < RTW_BIG;
  const float* row = sattr + 10 * best_i;
  float a[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) a[j] = hit ? row[j] : 0.0f;
  float u[5];
  rtw_record_uniforms(i, n, u5, seed, iteration, u);
  rtw_record_advance<false>(i, n, best_t, a, u, strips, sf, si, rad, rec, 21,
                            S, max_depth);
  idx_out[i] = best_i;
}

extern "C" int rtw_persist_record_fused(
    const float* strips, float* sf, int* si, float* rad, float* rec, int* idx,
    const float* spheres, const float* amat, int n_spheres, float tmin,
    const float* u5, int n_lanes, int S, int max_depth, unsigned int seed,
    unsigned int iteration, void* stream) {
  if (n_lanes <= 0) return 0;
  const int threads = 128;
  const int blocks = (n_lanes + threads - 1) / threads;
  const size_t smem = (size_t)n_spheres * (sizeof(float4) + 10 * sizeof(float));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        persist_record_fused_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  persist_record_fused_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      strips, sf, si, rad, rec, idx, reinterpret_cast<const float4*>(spheres),
      amat, n_spheres, tmin, u5, n_lanes, S, max_depth, seed, iteration);
  return (int)cudaGetLastError();
}
"""

#: The walk without the next slot's forward half beside the current
#: transpose: each slot's adjoint in one piece, as the first design had it.
K7C_FWD_WALK = """  RtwAdjFwd f = rtw_adjoint_forward(u, r, a, r[9] < RTW_BIG);
  for (;;) {
    m &= m - 1;
    const int sn = m ? hi - (__ffs(m) - 1) : s;
    float nr[10], na[10], nu[5];
    rtw_fixed_slot_words(rec, n, i, sn, nr, na);
    rtw_fixed_slot_uniforms<INJ>(u5, n, i, seed, sn, nu);
    const RtwAdjFwd nf = rtw_adjoint_forward(nu, nr, na, nr[9] < RTW_BIG);
    const bool hit = r[9] < RTW_BIG;
    float d9[9];
    rtw_adjoint_reverse(f, r, a, g, cot, hit, !hit, d9);
"""
K7C_ONE_PIECE_WALK = """  for (;;) {
    m &= m - 1;
    const int sn = m ? hi - (__ffs(m) - 1) : s;
    float nr[10], na[10], nu[5];
    rtw_fixed_slot_words(rec, n, i, sn, nr, na);
    rtw_fixed_slot_uniforms<INJ>(u5, n, i, seed, sn, nu);
    float d9[9];
    rtw_fixed_replay(u, r, a, g, cot, d9);
"""
K7C_FWD_SHIFT = "    s = sn;\n    f = nf;\n"
K7C_ONE_PIECE_SHIFT = "    s = sn;\n"
K7C_NEXT_U = """#pragma unroll
    for (int j = 0; j < 10; ++j) {
      r[j] = nr[j];
      a[j] = na[j];
    }
  }
}"""
K7C_NEXT_U_ONE_PIECE = """#pragma unroll
    for (int j = 0; j < 10; ++j) {
      r[j] = nr[j];
      a[j] = na[j];
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) u[j] = nu[j];
  }
}"""
K7C_THREADS = "#define RTW_K7C_THREADS 128\n"
K7C_BOUND = "__global__ void __launch_bounds__(RTW_K7C_THREADS)\n"
K7C_G1 = "    case 1: return (const void*)replay_bwd_fused_one_thread_kernel;\n"
K7C_G2 = "    case 2: return rtw_k7c_kernel<2>(inj);\n"
K7C_G4 = "    case 4: return rtw_k7c_kernel<4>(inj);\n"
K7C_G1_WALK = "    case 1: return rtw_k7c_kernel<1>(inj);\n"
K7C_STAGE_END = "  bool hit;\n};\n"
K7C_STAGE_ODD = ("  bool hit;\n  float pad;\n};\n"
                 "static_assert(sizeof(RtwK7cStage) % 8 == 4, \"odd\");\n")
K7C_SORT = re.compile(r"  if \(threadIdx\.x < 33\) base\[threadIdx\.x\] = 0;\n"
                      r".*?masks\[base\[key\] \+ pos\] = m;\n  }\n", re.S)
K7C_NO_SORT = """  if (in && k == 0) {
    order[l] = l;
    masks[l] = m;
  }
"""
K11_THREADS = "#define RTW_K11_THREADS 128\n"
K11_BOUND = "__global__ void __launch_bounds__(RTW_K11_THREADS)\n"
K11_ADVANCE = "rtw_record_advance<false>(i, n, t, a, u, strips, sf, si, rad, rec, 21, S,"
K11_ADVANCE_STREAM = "rtw_record_advance<true>(i, n, t, a, u, strips, sf, si, rad, rec, 21, S,"


def _sub(src: str, old, new: str) -> str:
    """``src`` with the one occurrence of ``old`` (a string or a compiled
    pattern) replaced by ``new``; raises unless there is exactly one."""
    if isinstance(old, re.Pattern):
        n = len(old.findall(src))
        out = old.sub(lambda m: new, src)
    else:
        n = src.count(old)
        out = src.replace(old, new)
    if n != 1:
        raise RuntimeError(f"rewrite target found {n} times: {old!r:.80}")
    return out


def k7c_source(src: str, name: str) -> str:
    """replay_bwd.cu of K7c's variant ``name``."""
    if name == "previous":
        return _sub(_sub(src, K7C_LAUNCHERS, PREVIOUS_K7C_LAUNCH),
                    K7C_SECTION, PREVIOUS_K7C)
    if name == "shipped":
        return src
    if name.startswith("walk"):
        src = _sub(_sub(src, K7C_SECTION, WALK_K7C), K7C_G1, K7C_G1_WALK)
        if name == "walk_nofwd":
            src = _sub(src, K7C_FWD_WALK, K7C_ONE_PIECE_WALK)
            src = _sub(src, K7C_FWD_SHIFT, K7C_ONE_PIECE_SHIFT)
            src = _sub(src, K7C_NEXT_U, K7C_NEXT_U_ONE_PIECE)
        return src
    change = name.removeprefix("shipped_")
    if change == "g4":
        return _sub(src, K7C_G2, K7C_G2 + K7C_G4)
    if change == "nosort":
        return _sub(src, K7C_SORT, K7C_NO_SORT)
    if change == "odd":
        return _sub(src, K7C_STAGE_END, K7C_STAGE_ODD)
    if change[0] == "t":
        return _sub(src, K7C_THREADS,
                    f"#define RTW_K7C_THREADS {int(change[1:])}\n")
    if change[0] == "b":
        return _sub(src, K7C_BOUND, "__global__ void __launch_bounds__("
                    f"RTW_K7C_THREADS, {int(change[1:])})\n")
    raise ValueError(name)


def k11_source(src: str, name: str) -> str:
    """persist_record.cu of K11's variant ``name``."""
    if name == "previous":
        return _sub(src, K11_SECTION, PREVIOUS_K11)
    if name == "shipped":
        return src
    change = name.removeprefix("shipped_")
    if change == "stream":
        return _sub(src, K11_ADVANCE, K11_ADVANCE_STREAM)
    if change[0] == "t":
        return _sub(src, K11_THREADS,
                    f"#define RTW_K11_THREADS {int(change[1:])}\n")
    if change[0] == "b":
        return _sub(src, K11_BOUND, "__global__ void __launch_bounds__("
                    f"RTW_K11_THREADS, {int(change[1:])})\n")
    raise ValueError(name)


#: The resident blocks of a build's kernel (G = 1, Philox for K7c), by the
#: CUDA runtime, appended to each variant's source.
OCCUPANCY = """
extern "C" int rtw_variant_occupancy(int n_spheres, int* blocks, int* threads) {{
  const void* k = (const void*){kernel};
  *threads = {threads};
  const size_t smem = {smem};
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)
    e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, *threads,
                                                      smem);
  return (int)e;
}}
"""


def occupancy_snippet(kernel: str, name: str) -> str:
    if kernel == "k7c":
        return OCCUPANCY.format(
            kernel="replay_bwd_fused_kernel" if name == "previous"
            else "replay_bwd_fused_kernel<1, false>" if name.startswith("walk")
            else "replay_bwd_fused_kernel<2, false>",
            threads="128" if name == "previous" else "RTW_K7C_THREADS",
            smem="0")
    per_sphere = ("(sizeof(float4) + 10 * sizeof(float))"
                  if name == "previous" else "sizeof(float4)")
    return OCCUPANCY.format(
        kernel="persist_record_fused_kernel",
        threads="128" if name == "previous" else "RTW_K11_THREADS",
        smem=f"(size_t)n_spheres * {per_sphere}")


K7C_BUILDS = ("shipped", "previous", "shipped_g4", "shipped_nosort",
              "shipped_odd",
              "walk", "walk_nofwd", "shipped_t32", "shipped_t64",
              "shipped_b6")
K11_BUILDS = ("shipped", "previous", "shipped_t256", "shipped_b10",
              "shipped_b12", "shipped_stream")

SOURCES = {"k7c": "replay_bwd.cu", "k11": "persist_record.cu"}
KERNELS = {"k7c": "replay_bwd_fused_kernel",
           "k11": "persist_record_fused_kernel"}
LAUNCHERS = {"k7c": "rtw_replay_bwd_fused", "k11": "rtw_persist_record_fused"}
PTXAS = re.compile(r"Function properties for (\w+)\s+(\d+) bytes stack "
                   r"frame, (\d+) bytes spill stores, (\d+) bytes spill "
                   r"loads\s+ptxas info\s*: Used (\d+) registers")


def build_variants(out: str, k7c_builds=K7C_BUILDS,
                   k11_builds=K11_BUILDS) -> tuple:
    """``({name: launcher} of K7c's builds, of K11's, {kernel/name: ptxas
    report and resident blocks})``: the builds named compiled into ``out``,
    one nvcc each, all at once."""
    srcs = {}
    for kernel, f in SOURCES.items():
        with open(os.path.join(build.CSRC_DIR, f)) as fh:
            srcs[kernel] = fh.read()
    rewrite = {"k7c": k7c_source, "k11": k11_source}
    jobs = {(k, n): rewrite[k](srcs[k], n) + occupancy_snippet(k, n)
            for k, names in (("k7c", k7c_builds), ("k11", k11_builds))
            for n in names}
    procs = {}
    for (kernel, name), text in jobs.items():
        d = os.path.join(out, f"{kernel}_{name}")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, SOURCES[kernel])
        with open(path, "w") as f:
            f.write(text)
        procs[(kernel, name)] = subprocess.Popen(
            [build._nvcc(), "-Xptxas", "-v", *build.NVCC_FLAGS, "-I", d,
             "-I", build.CSRC_DIR, "-shared", "-o",
             os.path.join(d, "lib.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {"k7c": {}, "k11": {}}
    report = {}
    n_sph = flagship_tables(torch.device("cuda"))[0].shape[0]
    for (kernel, name), p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {kernel} {name}:\n{log}")
        regs = {m.group(1): {"registers": int(m.group(5)),
                             "spill_store_bytes": int(m.group(3)),
                             "spill_load_bytes": int(m.group(4))}
                for m in PTXAS.finditer(log)
                if KERNELS[kernel] in m.group(1)}
        if not regs:
            raise RuntimeError(f"no ptxas report for {kernel} {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(out, f"{kernel}_{name}", "lib.so"))
        fn = getattr(lib, LAUNCHERS[kernel])
        fn.argtypes = build._SIGNATURES[LAUNCHERS[kernel]]
        fn.restype = ctypes.c_int
        occ = lib.rtw_variant_occupancy
        occ.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                        ctypes.POINTER(ctypes.c_int)]
        blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
        build.check(occ(n_sph, ctypes.byref(blocks), ctypes.byref(threads)),
                    f"{kernel} {name} occupancy")
        report[f"{kernel}/{name}"] = {
            "ptxas": regs, "threads_per_block": threads.value,
            "blocks_per_sm": blocks.value}
        libs[kernel][name] = fn
    return libs["k7c"], libs["k11"], report


def k7c_groups(name: str, rule: int | None = None) -> tuple:
    """The group sizes a K7c build is checked at (``rule``: None) or timed
    at (``rule``: the wrapper's G at the shape)."""
    if name.startswith(("previous", "walk")):
        return (1,)
    if name == "shipped":
        return GK.REPLAY_GROUPS
    if name == "shipped_g4":
        return (4,)
    if name in ("shipped_t32", "shipped_t64"):
        return GK.REPLAY_GROUPS if rule is None else (rule,)
    return (2,)


# -- launches ------------------------------------------------------------------

def k7c_launch(fn, rec, g3, cot, dattr, seed: int, group: int,
               u5=None) -> None:
    """One launch of a K7c build: the walk of ``rec`` into ``dattr``,
    ``cot`` in place."""
    K, _, R = rec.shape
    err = fn(rec.data_ptr(), g3.data_ptr(), cot.data_ptr(), dattr.data_ptr(),
             None if u5 is None else u5.data_ptr(), R, K, seed, group,
             torch.cuda.current_stream().cuda_stream)
    build.check(err, "K7c variant")


def k7b_walk(rec, g3, cot, dattr, seed: int, u5=None) -> None:
    """K7b's walk: one launch per slot, newest first, the carry in device
    memory (the previous K7c's function, bit for bit)."""
    for b in reversed(range(rec.shape[0])):
        GK.replay_bwd_step(rec[b], g3, cot, seed, b,
                           None if u5 is None else u5[b], out=dattr[b])


def k11_launch(fn, st, it: int, sf, si, rad, slot, idx, u5=None) -> None:
    """One launch of a K11 build at iteration ``it`` of the fused step."""
    sph, amat, strips = st["spheres"], st["amat"], st["strips"]
    err = fn(strips.data_ptr(), sf.data_ptr(), si.data_ptr(), rad.data_ptr(),
             slot.data_ptr(), idx.data_ptr(), sph.data_ptr(), amat.data_ptr(),
             sph.shape[0], TMIN, None if u5 is None else u5.data_ptr(),
             sf.shape[1], strips.shape[0] // 6, DEPTH, SEED11, it,
             torch.cuda.current_stream().cuda_stream)
    build.check(err, "K11 variant")


def k3_k4(st, it: int, sf, si, rad, slot, idx_out, u5=None) -> None:
    """The iteration K11 fuses: K3, then K4 (which fetches sphere 0's row
    on a miss lane; K11 stores zeros there: the planes are zeroed after)."""
    t, idx = K1.sweep_masked(sf[0:6], si[2], st["spheres"])
    PK.persist_record_step(t, idx, st["amat"], st["strips"], sf, si, rad,
                           slot, SEED11, it, DEPTH, u5)
    idx_out.copy_(idx)
    slot[11:21] = torch.where(t < K1.BIG, slot[11:21],
                              torch.zeros_like(slot[11:21]))


# -- inputs --------------------------------------------------------------------

K11_ITERATIONS = (0, 20, 44, 70)


def flagship_tables(dev) -> tuple:
    """The flagship scene's sphere and attribute tables on ``dev``."""
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    return K1.sphere_consts(scene), attr_mat(scene)


def fixed_record(scene, origin, direction, seed: int) -> torch.Tensor:
    """The fixed-depth record [16, 21, R] of rays ``origin``/``direction``
    through K3 and K7a (Philox draws)."""
    spheres, amat = K1.sphere_consts(scene), attr_mat(scene)
    st = FG.start_state(origin, direction)
    rec = torch.empty((DEPTH, GK.N_REC, origin.shape[0]),
                      device=origin.device)
    for b in range(DEPTH):
        t, idx = K1.sweep_masked(st[0:6], st[12].view(torch.int32), spheres)
        GK.record_shade_step(t, idx, amat, st, rec[b], seed, b)
    return rec


def k7c_states(dev) -> dict:
    """K7c's two walks: the fit's (the inverse demo's first pass: its start
    scene, 200x112, 22 400 lanes) and 131 071 lanes (the first 131 071
    camera rays of a 512x256 film of the same scene), each ``(rec, g3,
    seed)`` with a radiance cotangent drawn once."""
    _, scene0, cam, _, _ = C.inverse_demo()
    scene0, cam = pt.trim_scene(scene0.to(dev)), cam.to(dev)
    seed = rng.purpose_seed(0, rng.SCATTER_DIR, 0) & 0xFFFFFFFF
    g = torch.Generator(device=dev).manual_seed(17)
    out = {}
    for name, (w, h, n) in (("fit_22400", (200, 112, 22400)),
                            ("lanes_131071", (512, 256, 131071))):
        u, v = pt.pixel_coords(w, h, device=dev)
        o, d = sample_pass_rays(cam, u, v, 0, 0, 1, float(w), float(h))
        rec = fixed_record(scene0, o[:n], d[:n], seed)
        out[name] = (rec, torch.rand((3, n), generator=g, device=dev) * 2 - 1,
                     seed)
    return out


def k11_states(dev) -> dict:
    """The flagship fused step's record phase (1920x1080, spp 1, 8 strips,
    262 144 lanes) before iterations 0, 20, 44 and 70, advanced by K3 and
    K4: ``{"strips", "spheres", "amat", "at": {it: (sf, si, rad, live)}}``."""
    spheres, amat = flagship_tables(dev)
    u, v = pt.pixel_coords(1920, 1080, device=dev)
    o, d = pt.get_rays(pt.t_cam1(device=dev), u, v,
                       generator=torch.Generator(device=dev).manual_seed(7))
    strips, sf, si, rad = PG.start_planes(o, d, 8)
    st = {"strips": strips, "spheres": spheres, "amat": amat, "at": {}}
    slot = torch.empty((PK.N_REC, sf.shape[1]), device=dev)
    for it in range(max(K11_ITERATIONS) + 1):
        if it in K11_ITERATIONS:
            st["at"][it] = (sf.clone(), si.clone(), rad.clone(),
                            int((si[2] != 0).sum()))
        t, idx = K1.sweep_masked(sf[0:6], si[2], spheres)
        PK.persist_record_step(t, idx, amat, strips, sf, si, rad, slot,
                               SEED11, it, DEPTH)
    torch.cuda.synchronize()
    return st


def k11_outputs(sf, si, rad) -> list:
    W, dev = sf.shape[1], sf.device
    return [sf.clone(), si.clone(), rad.clone(),
            torch.full((PK.N_REC, W), 7.0, device=dev),
            torch.full((W,), 9, dtype=torch.int32, device=dev)]


# -- checks --------------------------------------------------------------------

def check_k7c(k7c_libs, states) -> dict:
    """Every K7c build at every G against K7b's walk, cot and every dattr
    row bit for bit, injected and Philox draws: the lanes that differ by
    case (all 0, or it raises)."""
    bad = {}
    for shape, (rec, g3, seed) in states.items():
        K, _, R = rec.shape
        g = torch.Generator(device=rec.device).manual_seed(3)
        for draws, u5 in (("injected", torch.rand((K, 5, R), generator=g,
                                                  device=rec.device)),
                          ("philox", None)):
            cot0 = torch.randn((9, R), generator=g, device=rec.device)
            ref = [cot0.clone(), torch.empty((K, 9, R), device=rec.device)]
            k7b_walk(rec, g3, *ref, seed, u5)
            for name, fn in k7c_libs.items():
                for G in k7c_groups(name):
                    got = [cot0.clone(), torch.full((K, 9, R), 7.0,
                                                    device=rec.device)]
                    k7c_launch(fn, rec, g3, *got, seed, G, u5)
                    torch.cuda.synchronize()
                    bad[f"{shape}/{draws}/{name}/g{G}"] = int(
                        C._bitwise_lanes(list(zip(got, ref)), R).sum())
    C.check(all(v == 0 for v in bad.values()),
            f"a K7c build differs from K7b's walk: "
            f"{ {k: v for k, v in bad.items() if v} }")
    return bad


def check_k11(k11_libs, st) -> dict:
    """Every K11 build against K3 + K4, every state word, record plane and
    winner bit for bit, at each iteration, injected and Philox draws."""
    g = torch.Generator(device=st["strips"].device).manual_seed(11)
    bad = {}
    for it, (sf, si, rad, _) in st["at"].items():
        W = sf.shape[1]
        for draws, u5 in (("injected", torch.rand((5, W), generator=g,
                                                  device=sf.device)),
                          ("philox", None)):
            ref = k11_outputs(sf, si, rad)
            k3_k4(st, it, *ref, u5)
            for name, fn in k11_libs.items():
                got = k11_outputs(sf, si, rad)
                k11_launch(fn, st, it, *got, u5)
                torch.cuda.synchronize()
                bad[f"it{it}/{draws}/{name}"] = int(C._bitwise_lanes(
                    list(zip(got, ref)), W).sum())
    C.check(all(v == 0 for v in bad.values()),
            f"a K11 build differs from K3 + K4: "
            f"{ {k: v for k, v in bad.items() if v} }")
    return bad


# -- times ---------------------------------------------------------------------

K7C_RE = r"\breplay_bwd_fused_(one_thread_)?kernel\b"
K11_RE = r"\bpersist_record_fused_kernel\b"
K3_K4_RE = (r"\bsweep_masked_kernel\b|\bpersist_record_kernel\b|"
            r"where|copy|elementwise")


def _timed_in_order(runs: dict, reverse: bool) -> dict:
    names = list(runs)[::-1] if reverse else list(runs)
    out = {name: C.batch_ms(*runs[name]) for name in names}
    return {name: out[name] for name in runs}


def k7c_times(k7c_libs, states, reverse: bool, n: int = 20) -> dict:
    """Every K7c build by ``batch_ms`` on each walk (Philox draws, the
    carry zeroed, each launch on its own carry): the previous kernel, the
    shipped one at every G, the other builds at the wrapper's G."""
    out = {}
    for shape, (rec, g3, seed) in states.items():
        K, _, R = rec.shape
        rule = GK.replay_group(R, GK._resident_threads(rec.device))
        make = lambda: (torch.zeros((9, R), device=rec.device),
                        torch.empty((K, 9, R), device=rec.device))
        runs = {}
        for name, fn in k7c_libs.items():
            for G in k7c_groups(name, rule):
                runs[f"{name}/g{G}"] = (
                    lambda c, d, fn=fn, G=G: k7c_launch(fn, rec, g3, c, d,
                                                        seed, G),
                    make, n, K7C_RE)
        out[shape] = {"lanes": R, "live_slots": int(
            (rec[:, 10].view(torch.int32) != 0).sum()), "rule_group": rule,
            **_timed_in_order(runs, reverse)}
    return out


def k11_times(k11_libs, st, reverse: bool, n: int = 20) -> dict:
    """Every K11 build at each iteration by ``batch_ms``, each launch on
    its own copy of the state, with K3 + K4 beside them."""
    out = {}
    for it, (sf, si, rad, live) in st["at"].items():
        make = lambda: k11_outputs(sf, si, rad)
        runs = {name: (lambda *o, fn=fn: k11_launch(fn, st, it, *o), make, n,
                       K11_RE)
                for name, fn in k11_libs.items()}
        runs["k3_k4"] = (lambda *o: k3_k4(st, it, *o), make, n, K3_K4_RE)
        out[f"iteration{it}"] = {"live_lanes": live,
                                 **_timed_in_order(runs, reverse)}
        torch.cuda.empty_cache()
    return out


def _median_tables(passes: list) -> dict:
    """The median ``event_ms`` and ``profiler_ms`` of each timed entry (of
    the passes whose profiler kept the launches' records)."""
    def walk(xs):
        if isinstance(xs[0], dict) and "event_ms" in xs[0]:
            return {k: statistics.median(v) if (v := [
                x[k] for x in xs if x[k] is not None]) else None
                for k in ("event_ms", "profiler_ms")}
        if isinstance(xs[0], dict):
            return {k: walk([x[k] for x in xs]) for k in xs[0]}
        return xs[0]
    return walk(passes)


# -- per fused step ------------------------------------------------------------

class patched:
    """Routes the kernel library's launcher ``name`` to ``fn`` (a variant
    build's) inside the block."""

    def __init__(self, name: str, fn):
        self.name, self.fn = name, fn

    def __enter__(self):
        self.lib = build.load()
        self.real = getattr(self.lib, self.name)
        setattr(self.lib, self.name, self.fn)

    def __exit__(self, *exc):
        setattr(self.lib, self.name, self.real)


def fused_step_tables(dev, k11_libs, builds=("previous", "shipped"),
                      repeats: int = 3) -> dict:
    """The flagship gradient step through the fused record step
    (``trace_recorded_persist(fused_step=True)``: 1920x1080 camera rays,
    spp 1, 8 strips, strict; K11 and K5) with each K11 build in turns: wall
    seconds (host clock) and K11's device time and launches per step (the
    profiler), medians of ``repeats``; the loss and the five gradient
    fields of every build bit for bit the first one's."""
    from torch.profiler import ProfilerActivity, profile
    scene = pt.trim_scene(pt.scene_random_spheres(seed=1, device=dev))
    cam = pt.t_cam1(device=dev)
    u, v = pt.pixel_coords(1920, 1080, device=dev)
    o, d = pt.get_rays(cam, u, v,
                       generator=torch.Generator(device=dev).manual_seed(3))
    target = pt.render_radiance(scene, cam, 1920, 1, seed=123, device=dev,
                                persistent=True).reshape(-1, 3)
    bad = scene._replace(albedo=torch.clamp(scene.albedo * 0.8, 0, 1))

    def step():
        leaves = [getattr(bad, f).clone().requires_grad_()
                  for f in pt.DIFF_FIELDS]
        sc = bad._replace(**dict(zip(pt.DIFF_FIELDS, leaves)))
        r = PG.trace_recorded_persist(sc, o, d, 77, DEPTH, TMIN, 8, None,
                                      fused_step=True, strict=True)
        loss = torch.mean((r - target) ** 2)
        return (loss.detach(), *torch.autograd.grad(loss, leaves))

    rows = {b: {"wall_s": [], "k11_device_ms": [], "k11_launches": []}
            for b in builds}
    ref = None
    for r in range(repeats):
        for b in (builds if r % 2 == 0 else builds[::-1]):
            with patched("rtw_persist_record_fused", k11_libs[b]):
                step()  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = step()
                torch.cuda.synchronize()
                rows[b]["wall_s"].append(time.perf_counter() - t0)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    step()
                    torch.cuda.synchronize()
            ev = [(e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if re.search(K11_RE, e.key) and e.count]
            rows[b]["k11_device_ms"].append(sum(us for us, _ in ev) / 1e3)
            rows[b]["k11_launches"].append(sum(c for _, c in ev))
            if ref is None:
                ref = out
            C.check(all(torch.equal(C._bits(x), C._bits(y))
                        for x, y in zip(out, ref)),
                    f"the fused step with K11 {b} differs")
    return {b: {k: statistics.median(v) for k, v in row.items()}
            for b, row in rows.items()}


# -- verdict -------------------------------------------------------------------

#: (change, against) of each change alone, per kernel
#: (K7c's pairs name the group size the rule picks at each shape as "rule")
K7C_ALONE = (("shipped/rule", "previous/g1"), ("shipped/g2", "shipped/g1"),
             ("shipped_g4/g4", "shipped/g2"),
             ("shipped/g2", "shipped_nosort/g2"),
             ("shipped_odd/g2", "shipped/g2"), ("shipped_b6/g2", "shipped/g2"),
             ("walk/g1", "previous/g1"), ("walk_nofwd/g1", "previous/g1"),
             ("walk/g1", "walk_nofwd/g1"), ("shipped/rule", "walk/g1"),
             ("shipped_t32/rule", "shipped/rule"),
             ("shipped_t64/rule", "shipped/rule"))
K11_ALONE = (("shipped", "previous"), ("shipped", "k3_k4"),
             ("shipped_t256", "shipped"), ("shipped_b10", "shipped"),
             ("shipped_b12", "shipped"), ("shipped_stream", "shipped"))


def changes_alone(tabs: dict) -> dict:
    """Each change's ``event_ms`` over what it replaces, per shape (the
    pairs of builds that were timed)."""
    out = {}
    for kernel, pairs in (("k7c", K7C_ALONE), ("k11", K11_ALONE)):
        out[kernel] = []
        for shape, t in tabs[kernel].items():
            rule = t.get("rule_group")
            t = {k.replace(f"/g{rule}", "/rule")
                 if k.startswith(("shipped_t32/", "shipped_t64/"))
                 else k: v for k, v in t.items()} | (
                {"shipped/rule": t[f"shipped/g{rule}"]} if rule else {})
            for c, b in pairs:
                if c in t and b in t:
                    out[kernel].append({"shape": shape, "change": c,
                                        "against": b, "rule_group": rule,
                                        "ratio": t[c]["event_ms"]
                                        / t[b]["event_ms"]})
    return out


#: A change is kept where it takes at most this share of what it replaces
#: at every shape: repeated medians of one build move by up to ~1%.
KEEP_RATIO = 0.99


def verdict(alone: dict) -> dict:
    """Which change is kept: at least 1% faster at every shape timed. The
    shipped K7c at the wrapper's G runs the previous kernel where the rule
    picks G = 1: there it is kept if it is no more than 1% slower."""
    def kept(kernel, c, b):
        rows = [r for r in alone[kernel]
                if (r["change"], r["against"]) == (c, b)]
        return bool(rows) and all(
            r["ratio"] <= (2 - KEEP_RATIO if c == "shipped/rule"
                           and r["rule_group"] == 1 else KEEP_RATIO)
            for r in rows)
    return {"k7c": {f"{c} over {b}": kept("k7c", c, b) for c, b in K7C_ALONE},
            "k11": {f"{c} over {b}": kept("k11", c, b) for c, b in K11_ALONE},
            "rule": "a change is kept where it is at least 1% faster "
                    "(event_ms) at every shape timed against what it "
                    "replaces; the shipped K7c at the wrapper's G where it "
                    "is no more than 1% slower at the shapes whose G is 1 "
                    "(the previous kernel)"}


def run_pass_set(dev, passes: int, k7c_builds=K7C_BUILDS,
                 k11_builds=K11_BUILDS, step_repeats: int = 3,
                 libs: dict | None = None) -> dict:
    """Build, check and time the builds named (``passes`` timing passes),
    then the fused step per K11 build. The phases' JSON objects as a
    dict; ``libs`` (a dict), when given, receives the builds' launchers
    under ``"k7c"`` and ``"k11"``."""
    states7 = k7c_states(dev)
    st11 = k11_states(dev)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    k7c_libs, k11_libs, report = build_variants(
        tempfile.mkdtemp(dir=os.path.join(ROOT, "build")), k7c_builds,
        k11_builds)
    if libs is not None:
        libs.update(k7c=k7c_libs, k11=k11_libs)
    bad7 = check_k7c(k7c_libs, states7)
    bad11 = check_k11(k11_libs, st11)
    tabs = _median_tables([
        {"k7c": k7c_times(k7c_libs, states7, bool(r % 2)),
         "k11": k11_times(k11_libs, st11, bool(r % 2))}
        for r in range(passes)])
    steps = fused_step_tables(dev, k11_libs, repeats=step_repeats)
    alone = changes_alone(tabs)
    n_sph = st11["spheres"].shape[0]
    return {"ptxas": report,
            "occupancy": {"k11": PK.persist_record_fused_occupancy(n_sph,
                                                                   dev),
                          **{f"k7c_g{G}": GK.replay_bwd_fused_occupancy(G,
                                                                       dev)
                             for G in GK.REPLAY_GROUPS}},
            "checks": {"k7c_cases": len(bad7),
                       "k7c_lanes_differing": sum(bad7.values()),
                       "k11_cases": len(bad11),
                       "k11_lanes_differing": sum(bad11.values()),
                       "k11_live_lanes": {it: x[3] for it, x
                                          in st11["at"].items()},
                       "tolerance": "K7c's cot and every dattr row bit for "
                                    "bit K7b's walk; K11's every state "
                                    "word, record plane and winner bit for "
                                    "bit K3 + K4's (miss lanes' attribute "
                                    "planes zero)"},
            "times": tabs, "fused_step": steps,
            "changes_alone": alone, "verdict": verdict(alone)}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = C.card_line()
    print(card, flush=True)
    build.load()
    out = run_pass_set(dev, 5)
    C.emit({"phase": "ptxas", **out["ptxas"], "occupancy": out["occupancy"]})
    C.emit({"phase": "variants_checks", **out["checks"]})
    C.emit({"phase": "variant_times", "card": card, "passes": 5,
            **out["times"],
            "note": "medians of 5 passes (every other one in reverse "
                    "order); event_ms: one event pair around the launches, "
                    "each on its own copy of the state; profiler_ms: the "
                    "profiler's per-launch mean (k3_k4: the sweep, the "
                    "record step and the miss planes' zeroing summed)"})
    C.emit({"phase": "fused_step", "card": card, **out["fused_step"]})
    C.emit({"phase": "changes_alone", **out["changes_alone"]})
    C.emit({"phase": "verdict", **out["verdict"]})
    print(C.card_line(), flush=True)
    C.emit({"ok": True, "device": {"platform": "gpu",
                                   "kind": torch.cuda.get_device_name(0),
                                   "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
