// The commit's fused snapshot pass on Hopper: quantize, narrow to int8 and
// count, in one read of each input.
//
// Replaces the TPU kernel repro/kernels/snapshot_fused.py::snapshot_fused_2d
// (_snapshot_kernel). That kernel also wrote a fingerprint partial of p2,
// which its wrapper always discarded; this one does not compute it.
//
// Bound by bytes: it reads two f32 and writes one int8 per element (9 B)
// for six operations. The zero count and the overflow count (q that does
// not fit int8, which sends the caller to the int32 fallback) are reduced
// per block and added with one atomicAdd per block each; the tensor stays
// flat, so there is no padding to correct for.
#include "common.cuh"

__global__ void snapshot_fused_kernel(const float* __restrict__ p1,
                                      const float* __restrict__ p2,
                                      int8_t* __restrict__ q8,
                                      int* __restrict__ counts, int64_t n,
                                      float scale) {
  int nz = 0, ovf = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int v = quantize(p1[i], p2[i], scale);
    const int c = min(max(v, -127), 127);
    q8[i] = (int8_t)c;
    nz += (v == 0);
    ovf += (v != c);
  }
  block_count_add(nz, ovf, counts, counts + 1);
}

// q8 = int8(clip(q, -127, 127)) with q = floor((p1 - p2) / scale + 0.5);
// counts[0] += count(q == 0), counts[1] += count(q outside int8).
// counts must hold {0, 0} before the launch.
extern "C" int mgit_snapshot_fused(const float* p1, const float* p2, int8_t* q8,
                                   int* counts, int64_t n, float scale,
                                   int device, cudaStream_t stream) {
  cudaSetDevice(device);
  snapshot_fused_kernel<<<grid_for(n, device), kThreads, 0, stream>>>(p1, p2, q8, counts, n, scale);
  return (int)cudaGetLastError();
}
