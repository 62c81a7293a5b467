// Folded checkout of a delta chain on Hopper: base - (q_1 + ... + q_k) * scale
// in one pass.
//
// Replaces the TPU kernel repro/kernels/chain_apply.py::chain_apply_2d
// (_chain_apply_kernel).
//
// Bound by bytes: it reads the f32 base and k int32 deltas and writes the
// f32 output, 8 + 4k B per element, for k + 2 operations. The k deltas of
// an element are summed in a register (int32, wrapping like numpy's int32
// add, so exact and order-free), then dequantized once with two separate
// roundings, which makes the result equal a host_dequant of the exact sum.
#include "common.cuh"

__global__ void chain_apply_kernel(const float* __restrict__ base,
                                   const int32_t* __restrict__ qs,
                                   float* __restrict__ out, int64_t n, int k,
                                   float scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t total = 0;
    for (int j = 0; j < k; ++j) total += (uint32_t)qs[(int64_t)j * n + i];
    out[i] = dequantize(base[i], (int32_t)total, scale);
  }
}

// out = base - f32(sum_j qs[j]) * scale; qs is a (k, n) int32 stack.
extern "C" int mgit_chain_apply(const float* base, const int32_t* qs, float* out,
                                int64_t n, int k, float scale, int device,
                                cudaStream_t stream) {
  cudaSetDevice(device);
  chain_apply_kernel<<<grid_for(n, device), kThreads, 0, stream>>>(base, qs, out, n, k, scale);
  return (int)cudaGetLastError();
}
