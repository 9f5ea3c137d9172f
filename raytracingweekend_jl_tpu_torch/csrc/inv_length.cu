// The kernels' normalisation helper, rtw_inv_length (shade_core.cuh), on a
// run of float bit patterns: the check that it gives the bits of its plain
// version, ops/vecmath.py::inv_length, on every non-negative float
// (chip_smoke.py's inv_length_exhaustive). On no route.

#include <cstdint>

#include "shade_core.cuh"

__global__ void inv_length_bits_kernel(uint32_t start, int n,
                                       float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = rtw_inv_length(__uint_as_float(start + (uint32_t)i));
}

// out[i] = rtw_inv_length(the float whose bits are start + i), i < n.
extern "C" int rtw_inv_length_bits(unsigned int start, int n, float* out,
                                   void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  inv_length_bits_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      start, n, out);
  return (int)cudaGetLastError();
}
