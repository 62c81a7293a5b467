// Algorithm 1's lossy step on Hopper: quantize a delta, and apply one back.
//
// Replaces two TPU kernels of the reference package:
//   repro/kernels/delta_quantize.py::delta_quantize_2d (_delta_quantize_kernel)
//   repro/kernels/delta_quantize.py::dequant_apply_2d  (_dequant_apply_kernel)
//
// Bound by bytes: quantize reads two f32 and writes one int32 per element
// (12 B) for four operations; dequant reads an f32 and an int32 and writes
// an f32 (12 B) for three. The TPU versions pad to (rows, 1024) tiles and
// reduce zero counts per tile; here the tensor stays flat, the loop bound
// masks the tail, and the zero count is one counter per launch, so the
// count equals the reference's padding-corrected sum.
#include "common.cuh"

__global__ void delta_quantize_kernel(const float* __restrict__ p1,
                                      const float* __restrict__ p2,
                                      int32_t* __restrict__ q,
                                      int* __restrict__ zeros, int64_t n,
                                      float scale) {
  int nz = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int v = quantize(p1[i], p2[i], scale);
    q[i] = v;
    nz += (v == 0);
  }
  block_count_add(nz, 0, zeros, nullptr);
}

__global__ void dequant_apply_kernel(const float* __restrict__ p1,
                                     const int32_t* __restrict__ q,
                                     float* __restrict__ out, int64_t n,
                                     float scale) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = dequantize(p1[i], q[i], scale);
  }
}

// q = floor((p1 - p2) / scale + 0.5); *zeros += count(q == 0).
// *zeros must hold 0 before the launch.
extern "C" int mgit_delta_quantize(const float* p1, const float* p2, int32_t* q,
                                   int* zeros, int64_t n, float scale,
                                   int device, cudaStream_t stream) {
  cudaSetDevice(device);
  delta_quantize_kernel<<<grid_for(n, device), kThreads, 0, stream>>>(p1, p2, q, zeros, n, scale);
  return (int)cudaGetLastError();
}

// out = p1 - f32(q) * scale.
extern "C" int mgit_dequant_apply(const float* p1, const int32_t* q, float* out,
                                  int64_t n, float scale, int device,
                                  cudaStream_t stream) {
  cudaSetDevice(device);
  dequant_apply_kernel<<<grid_for(n, device), kThreads, 0, stream>>>(p1, q, out, n, scale);
  return (int)cudaGetLastError();
}
